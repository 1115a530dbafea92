"""The share of the profiled span in which the device was idle while
the host was inside `forward.sampling` (TTST's draws and k-means, CWS):
part of idle_share.serve."""

from portbench import spans


def read(record):
    return spans.idle_share_in(record, "forward.sampling")
