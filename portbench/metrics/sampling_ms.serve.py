"""The sampling layer's part of a request's forward (`forward.sampling`:
TTST's draws and k-means, CWS), device ms on the stream between the
span's two events, averaged over the profiled requests' `forward`
spans."""

from portbench import spans


def read(record):
    return spans.per_top(record, "forward", "forward.sampling")
