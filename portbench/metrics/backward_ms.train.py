"""A fine-tune step's backward (`train.backward`), device ms on the
stream between the span's two events, averaged over the profiled steps'
`train.step` spans."""

from portbench import spans


def read(record):
    return spans.per_top(record, "train.step", "train.backward")
