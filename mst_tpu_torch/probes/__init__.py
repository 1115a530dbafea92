"""Probes on the card: do the hand-written conv kernels and the decoder
chain beat cuDNN at the finest decoder level's shapes?

    python -m mst_tpu_torch.probes.conv_probe    # one CUDA card
    python -m mst_tpu_torch.probes.chain_probe
    python -m mst_tpu_torch.probes.chain_probe --cpu   # correctness only

The counterparts of benchmarks/pallas_conv_probe.py and
benchmarks/pallas_chain_probe.py. Each `run(device=None)` makes its inputs
from a seed on the device, holds every kernel against its plain version,
times kernels, plain version and a library yardstick with CUDA events, and
returns one record per kernel. Without a card they raise unless asked for
the CPU, where they check the plain versions at small shapes.
"""

import argparse

import torch


def time_ms(fn, iters):
    """Mean device time of fn over iters calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Bf16Count:
    """The launches of a wrapper's bf16 kernel (its launches_bf16), read
    and set as a wrapper's launches are."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, n):
        self.fn.launches_bf16 = n


def kernel_wrappers():
    """{kernel name: its wrapper} for all six kernels, the two serving
    kernels' bf16 instantiations (Bf16Count) and the partial-statistics
    variants of the fused kernel (the spatial mesh's decode tail) and of
    the rows kernel (the spatial train step's top-1 metrics), each in f32
    and bf16; each one's `launches` counts the launches of its kernel."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_partial)
    from mst_tpu_torch.ops.kernels.softargmax_rows import (
        softargmax2d_rows, softargmax2d_rows_partial)
    from mst_tpu_torch.probes import chain_probe, conv_probe

    return {"softargmax_rows": softargmax2d_rows,
            "fused_predict": fused_predictor_softargmax,
            **dict(conv_probe.KERNELS), **dict(chain_probe.KERNELS),
            "softargmax_rows_bf16": Bf16Count(softargmax2d_rows),
            "fused_predict_bf16": Bf16Count(fused_predictor_softargmax),
            "fused_predict_partial": fused_predictor_softargmax_partial,
            "softargmax_rows_partial": softargmax2d_rows_partial,
            "softargmax_rows_partial_bf16": Bf16Count(
                softargmax2d_rows_partial)}


def max_abs_diff(a, b):
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def main_of(run, description):
    """A probe's command line: `--cpu` asks for the CPU shapes."""
    def main(argv=None):
        parser = argparse.ArgumentParser(description=description)
        parser.add_argument("--cpu", action="store_true",
                            help="correctness only, plain versions on the "
                            "CPU at small shapes")
        args = parser.parse_args(argv)
        run("cpu" if args.cpu else None)
        return 0
    return main
