"""The fused predictor + soft-argmax kernel's share of its roofline over
the profiled requests: the least time of each call (R = K B rows of the
decode's finest activations, C input channels, P maps; bytes bound)
summed, over the kernel's device time in the trace."""

from portbench import counts


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    spent = trace.kernel_s("fused_predict")
    if spent <= 0:
        return None
    net = record["net"]
    least = sum(counts.fused_predict_s(record["K"] * b, record["H"],
                                       record["W"], net.decoder_channels[-1],
                                       net.pred_len)
                for b in record["profiled"])
    return 100.0 * least / spent
