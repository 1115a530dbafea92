"""The rows soft-argmax kernel's share of its roofline over the profiled
fine-tune steps: two calls a step (the trajectory maps, B P rows, and
the goal map's last channel, B rows, each of H W f32 logits), their least
times summed, over the kernel's device time in the trace."""

from portbench import counts


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    spent = trace.kernel_s("softargmax_rows")
    if spent <= 0:
        return None
    hw = record["H"] * record["W"]
    b, p = record["B"], record["net"].pred_len
    least = record["profiled"] * (counts.softargmax_rows_s(b * p, hw)
                                  + counts.softargmax_rows_s(b, hw))
    return 100.0 * least / spent
