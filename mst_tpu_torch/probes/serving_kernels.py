"""Times of the serving path's two kernels on one CUDA card: CUDA-event
time and device time per call.

    python3 mst_tpu_torch/probes/serving_kernels.py [--tree DIR] [--label L]

The rows soft-argmax at TTST's shape (8, 352, 480) and the fused
predictor + soft-argmax at the eval decode tail's (160, 352, 480, 32) x
(32, P) for P = 12 and P = 30. `--tree DIR` imports the kernels from
another checkout of the repository (an unpacked `git archive` of an
earlier commit), so two trees can be timed in turns within one call on one
card. The file imports nothing of the package itself: it runs against any
tree whose wrappers keep the public functions `softargmax2d_rows(x)` and
`fused_predictor_softargmax(x, w, b)`. One JSON line a kernel and shape.

`time_call` is the measurement chip_smoke.py uses for these kernels: the
event time is the mean over `iters` back-to-back calls (host launch cost
included where it exceeds the kernel's); the device time is
torch.profiler's kernel time over the same loop, divided by the calls,
with the kernels each call launched.
"""

import argparse
import json
import os
import subprocess
import sys

ROWS_SHAPE = (8, 352, 480)
FUSED_SHAPE = (160, 352, 480, 32)


def time_call(fn, iters):
    """-> {"ms": event ms a call, "device_ms": device ms a call,
    "kernels_per_call": distinct kernels a call, "kernels": {name: count}}
    over `iters` calls after two warm-ups. The device time is the sum over
    the kernels of each one's self_device_time_total over its count (the
    profiler may miss a launch, so it is not divided by `iters`); each
    kernel's count is at most `iters` when a call launches it once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total / e.count for e in kernels)
    return {"ms": ms, "device_ms": device_ms / 1e3 if kernels else None,
            "kernels_per_call": len(kernels),
            "kernels": {e.key[:80]: e.count for e in kernels}}


def fused_inputs(P, seed=1, shape=FUSED_SHAPE):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    R, H, W, C = shape
    x = torch.randn((R, H, W, C), generator=g, device="cuda").relu_()
    w = torch.randn((C, P), generator=g, device="cuda") * 0.3
    b = torch.randn((P,), generator=g, device="cuda")
    return x, w, b


def measure(label):
    """Both kernels of the tree on sys.path, printed as JSON lines."""
    import torch

    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.ops.kernels.fused_predict import \
        fused_predictor_softargmax
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows

    resolve_device("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(ROWS_SHAPE, generator=g, device="cuda") * 4
    rec = time_call(lambda: softargmax2d_rows(x), 200)
    print(json.dumps({"tree": label, "kernel": "softargmax_rows",
                      "shape": list(ROWS_SHAPE), **rec}), flush=True)
    del x
    for P in (12, 30):
        x, w, b = fused_inputs(P)
        rec = time_call(lambda: fused_predictor_softargmax(x, w, b), 20)
        print(json.dumps({"tree": label, "kernel": "fused_predict",
                          "shape": list(FUSED_SHAPE), "P": P, **rec}),
              flush=True)
        del x, w, b
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None,
                        help="checkout to import the kernels from (default: "
                        "the one holding this file)")
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("serving_kernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    measure(args.label or tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
