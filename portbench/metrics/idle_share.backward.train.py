"""The share of the profiled span in which the device was idle while
the host was inside `train.backward`: part of idle_share.train."""

from portbench import spans


def read(record):
    return spans.idle_share_in(record, "train.backward")
