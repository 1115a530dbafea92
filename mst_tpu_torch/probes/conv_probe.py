"""The conv probe: can a hand-written 3x3 conv beat cuDNN's at the finest
decoder level's shape, x (KB=160, 176, 240, 128) x w (3, 3, 128, 128), bf16,
SAME?

The counterpart of benchmarks/pallas_conv_probe.py (`main`, :147): the two
kernels of ops/kernels/conv3x3.py (conv3x3_taps for pallas_conv3x3,
conv3x3_im2col for pallas_conv3x3_v2) against their plain version, and the
yardstick, one cuDNN call (`torch.nn.functional.conv2d` on the
channels_last view), which the port never calls.

    python -m mst_tpu_torch.probes.conv_probe         # one CUDA card
    python -m mst_tpu_torch.probes.conv_probe --cpu   # correctness only
"""

import sys

import torch
import torch.nn.functional as F

from mst_tpu_torch import resolve_device
from mst_tpu_torch.ops.kernels.conv3x3 import (conv3x3_im2col, conv3x3_plain,
                                               conv3x3_taps)
from mst_tpu_torch.probes import main_of, max_abs_diff, time_ms

FULL = (160, 176, 240, 128, 128)  # KB, H, W, C, Co (pallas_conv_probe:153)
CPU = (2, 16, 32, 8, 8)           # the TPU probe's --cpu shape (:152)
# On the card the plain version rounds the exact sum to bf16 and the kernel
# its f32 sum (off by a few f32 ulps), so an output may be one bf16 ulp off
# where the sum lies that close to a rounding boundary: 2^-5 for |y| in
# [4, 8). With these inputs' scales y has a std of sqrt(9 * 128 * 0.5^2 *
# 0.05^2) = 0.85, so |y| >= 8 would be a 9-sigma draw. The TPU probe
# allowed 0.15 (:187).
TOL = 2.0 ** -5
CPU_TOL = 1e-4  # f32: the plain version against the library conv
KERNELS = (("conv3x3_taps", conv3x3_taps),
           ("conv3x3_im2col", conv3x3_im2col))


def make_inputs(shape, dtype, device, seed=0):
    """x ~ 0.5 N(0, 1) and w ~ 0.05 N(0, 1), made on the device (as
    pallas_conv_probe.py:160-164)."""
    B, H, W, C, Co = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((B, H, W, C), generator=g, device=device) * 0.5
         ).to(dtype)
    w = (torch.randn((3, 3, C, Co), generator=g, device=device) * 0.05
         ).to(dtype)
    return x, w


def library_weight(w):
    """library_conv3x3's weight: HWIO as channels_last OIHW."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_conv3x3(x, w_oihw):
    """The yardstick: one cuDNN conv on the channels_last NCHW view of the
    NHWC x -> the NHWC view of its output."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1).permute(
        0, 2, 3, 1)


def run(device=None):
    """Check and (on the card) time both kernels at the probe's shape;
    -> [{"name", "max_abs_err", "ms", "plain_ms", "library_ms"}] (the
    times only on the card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    shape = FULL if on_card else CPU
    tol = TOL if on_card else CPU_TOL
    x, w = make_inputs(shape, torch.bfloat16 if on_card else torch.float32,
                       dev)
    w_oihw = library_weight(w)
    print(f"[conv probe] {dev}: x {tuple(x.shape)} {x.dtype}, w "
          f"{tuple(w.shape)}", flush=True)
    want = conv3x3_plain(x, w)

    def off(got):
        """Max |got - plain|, and the share of outputs that differ from
        the plain version's (on the card: the correctly rounded bf16)."""
        return (max_abs_diff(got, want),
                float((got != want).to(torch.float32).mean()))

    err, share = off(library_conv3x3(x, w_oihw))
    print(f"[conv probe] library conv max abs err vs plain: {err:.4g}, "
          f"{share:.3e} of outputs differ")
    if not on_card and err > CPU_TOL:
        raise RuntimeError(f"conv probe: plain conv disagrees with the "
                           f"library conv by {err}")
    records = []
    for name, fn in KERNELS:
        err, share = off(fn(x, w))
        print(f"[conv probe] {name} max abs err vs plain: {err:.4g} "
              f"(tol {tol}), {share:.3e} of outputs differ", flush=True)
        if not err <= tol:
            raise RuntimeError(f"conv probe: {name} disagrees with its "
                               f"plain version by {err}")
        records.append({"name": name, "max_abs_err": err})
    del want
    if not on_card:
        print("(CPU: correctness only)")
        return records

    B, H, W, C, Co = shape
    tflop = 2 * B * H * W * 9 * C * Co / 1e12
    plain_ms = time_ms(lambda: conv3x3_plain(x, w), 3)
    library_ms = time_ms(lambda: library_conv3x3(x, w_oihw), 10)
    for name, ms in (("plain", plain_ms), ("library conv (cuDNN)", library_ms)):
        print(f"{name}: {ms:.3f} ms ({tflop / ms * 1e3:.1f} TF/s)")
    for r, (name, fn) in zip(records, KERNELS):
        r["ms"] = time_ms(lambda fn=fn: fn(x, w), 10)
        r["plain_ms"] = plain_ms
        r["library_ms"] = library_ms
        print(f"{name}: {r['ms']:.3f} ms ({tflop / r['ms'] * 1e3:.1f} TF/s)",
              flush=True)
    return records


main = main_of(run, __doc__.splitlines()[0])

if __name__ == "__main__":
    sys.exit(main())
