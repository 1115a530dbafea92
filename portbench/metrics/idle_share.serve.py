"""The share of the profiled span in which nothing ran on the device
(the union of the trace's device activities, subtracted)."""


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
