"""The whole request's share of the card's f32 peak: the model FLOPs of
the profiled requests (counts.serve_flops, from the configuration's
shapes) over the profiled span times 67 TFLOP/s."""

from portbench import counts


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    flops = sum(counts.serve_flops(record["net"], record["H"], record["W"],
                                   b, record["K"])
                for b in record["profiled"])
    return 100.0 * flops / (trace.window_s * counts.F32_FLOP_PER_S)
