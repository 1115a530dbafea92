"""The program's own spans (mst_tpu_torch.utils.profiling) over a traced
window: the readers of the span metrics share these.

The program records spans only while a profiler records, so those of a
traced run are its profiled requests or steps. A request's spans are
kept where its top-level span overlaps the trace's window (`t0`, `t1`,
Unix seconds, the clock of the spans' host times). A program without
the spans gives None.
"""


def window_spans(record):
    """-> the spans of the requests the trace covers, in the order they
    opened, or None without a trace or a span recorder."""
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    try:
        from mst_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    every = spans()
    tops = {s["index"] for s in every if s["parent"] is None
            and s["start_ns"] * 1e-9 < trace.t1
            and s["end_ns"] * 1e-9 > trace.t0}
    return [s for s in every if s["request"] in tops]


def per_top(record, top, name, value=lambda s: s["device_ms"]):
    """The sum of `value` over the spans named `name`, over the number of
    top-level spans named `top` in the window; None where there are
    none."""
    found = window_spans(record)
    if not found:
        return None
    n = sum(s["name"] == top and s["parent"] is None for s in found)
    if not n:
        return None
    return sum(value(s) for s in found if s["name"] == name) / n


def idle_share_in(record, name):
    """The device-idle time of the window (the complement of the trace's
    busy intervals) that falls inside the host intervals of the spans
    named `name`, as % of the window; None where there are none."""
    found = window_spans(record)
    if not found:
        return None
    host = sorted((s["start_ns"] * 1e-9, s["end_ns"] * 1e-9)
                  for s in found if s["name"] == name)
    if not host:
        return None
    trace = record["trace"]
    edges = [trace.t0] + [x for iv in trace.busy_intervals() for x in iv] \
        + [trace.t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    merged = []
    for a, b in host:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    inside = sum(max(0.0, min(b, d) - max(a, c))
                 for a, b in merged for c, d in idle)
    return 100.0 * inside / trace.window_s
