"""A fine-tune step's forward (`train.forward`: inputs, encoder,
decoders, both losses), device ms on the stream between the span's two
events, averaged over the profiled steps' `train.step` spans."""

from portbench import spans


def read(record):
    return spans.per_top(record, "train.step", "train.forward")
