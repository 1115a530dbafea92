"""The whole fine-tune step's share of the card's f32 peak: the model
FLOPs of the profiled steps (counts.train_flops, from the configuration's
shapes) over the profiled span times 67 TFLOP/s."""

from portbench import counts


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    flops = record["profiled"] * counts.train_flops(
        record["net"], record["H"], record["W"], record["B"])
    return 100.0 * flops / (trace.window_s * counts.F32_FLOP_PER_S)
