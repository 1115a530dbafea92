"""The model's part of a request's forward (`forward.model`: inputs,
encoder, goal decoder, the sigmoid), device ms on the stream between the
span's two events, averaged over the profiled requests' `forward`
spans."""

from portbench import spans


def read(record):
    return spans.per_top(record, "forward", "forward.model")
