"""The chain probe: does a kernel that runs the whole finest decoder level
(conv3x3 64 -> 128 + ReLU, conv3x3 128 -> 128 + ReLU, 1x1 predictor
128 -> 4*12, packed online soft-argmax), keeping its planes out of device
memory, beat cuDNN's chain at x (KB=160, 176, 240, 64), bf16?

The counterpart of benchmarks/pallas_chain_probe.py (`main`, :279): the
two kernels of ops/kernels/decoder_chain.py (chain_plane for
pallas_chain, chain_stream for pallas_chain_v2) against their plain
version, and the yardstick, the eager chain of cuDNN conv -> conv ->
matmul -> plain packed soft-argmax, which the port never calls.

    python -m mst_tpu_torch.probes.chain_probe         # one CUDA card
    python -m mst_tpu_torch.probes.chain_probe --cpu   # correctness only
"""

import sys

import torch
import torch.nn.functional as F

from mst_tpu_torch import resolve_device
from mst_tpu_torch.ops.kernels.decoder_chain import (chain_plain, chain_plane,
                                                     chain_stream)
from mst_tpu_torch.ops.softargmax import softargmax2d_packed
from mst_tpu_torch.probes import main_of, max_abs_diff, time_ms

FULL = (160, 176, 240, 64, 128, 12)  # KB, Hp, Wp, C, CA, P (:284-286)
CPU = (2, 32, 24, 8, 16, 3)          # the TPU probe's --cpu shape
TOL = 0.05      # px, kernels against their plain version (the TPU's, :324)
CPU_TOL = 1e-3  # px, the plain chain against the library chain in f32
KERNELS = (("chain_plane", chain_plane), ("chain_stream", chain_stream))


def make_inputs(shape, dtype, device, seed=0):
    """x, wa, ba, wb, bb, wpred, bpred with the TPU probe's scales
    (pallas_chain_probe.py:288-298), made on the device; biases f32."""
    KB, Hp, Wp, C, CA, P = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def mk(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=g, device=device) * scale
                ).to(dt)

    return (mk((KB, Hp, Wp, C), 0.5), mk((3, 3, C, CA), 0.08),
            mk((CA,), 0.1, torch.float32), mk((3, 3, CA, CA), 0.08),
            mk((CA,), 0.1, torch.float32), mk((CA, 4 * P), 0.2),
            mk((4 * P,), 0.1, torch.float32))


def library_inputs(x, wa, ba, wb, bb, wpred, bpred):
    """library_chain's operands: the conv weights as channels_last OIHW."""
    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    return x, oihw(wa), ba, oihw(wb), bb, wpred, bpred


def library_chain(x, wa_oihw, ba, wb_oihw, bb, wpred, bpred, n_pred):
    """The yardstick: cuDNN convs with bias on the channels_last NCHW view,
    ReLU, the predictor as one matmul, the plain packed soft-argmax ->
    (KB, 2, P)."""
    a = F.conv2d(x.permute(0, 3, 1, 2), wa_oihw, ba.to(x.dtype),
                 padding=1).relu_()
    b = F.conv2d(a, wb_oihw, bb.to(x.dtype), padding=1).relu_()
    logits = (b.permute(0, 2, 3, 1) @ wpred).to(torch.float32) + bpred
    return softargmax2d_packed(logits, n_pred).transpose(1, 2)


def run(device=None):
    """Check and (on the card) time both chain kernels at the probe's
    shape; -> [{"name", "max_abs_err", "ms", "plain_ms", "library_ms"}]
    (the times only on the card; library_ms is None: no one library call
    computes the chain)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    shape = FULL if on_card else CPU
    tol = TOL if on_card else CPU_TOL
    P = shape[-1]
    args = make_inputs(shape, torch.bfloat16 if on_card else torch.float32,
                       dev)
    lib_args = library_inputs(*args) + (P,)
    print(f"[chain probe] {dev}: x {tuple(args[0].shape)} "
          f"{args[0].dtype}, P {P}", flush=True)
    want = chain_plain(*args, P)
    err = max_abs_diff(library_chain(*lib_args), want)
    print(f"[chain probe] library chain max abs coord err vs plain: "
          f"{err:.5f} px")
    if not on_card and err > CPU_TOL:
        raise RuntimeError(f"chain probe: plain chain disagrees with the "
                           f"library chain by {err} px")
    records = []
    for name, fn in KERNELS:
        err = max_abs_diff(fn(*args, P), want)
        print(f"[chain probe] {name} max abs coord err vs plain: {err:.5f} "
              f"px (tol {tol})", flush=True)
        if not err <= tol:
            raise RuntimeError(f"chain probe: {name} disagrees with its "
                               f"plain version by {err} px")
        records.append({"name": name, "max_abs_err": err,
                        "library_ms": None})
    if not on_card:
        print("(CPU: correctness only)")
        return records

    KB, Hp, Wp, C, CA, _ = shape
    tflop = 2 * KB * Hp * Wp * (9 * C * CA + 9 * CA * CA + CA * 4 * P) / 1e12
    plain_ms = time_ms(lambda: chain_plain(*args, P), 3)
    library_ms = time_ms(lambda: library_chain(*lib_args), 5)
    for name, ms in (("plain", plain_ms),
                     ("library chain (cuDNN conv -> conv -> matmul -> packed"
                      " soft-argmax)", library_ms)):
        print(f"{name}: {ms:.3f} ms ({tflop / ms * 1e3:.1f} TF/s)")
    for r, (name, fn) in zip(records, KERNELS):
        r["ms"] = time_ms(lambda fn=fn: fn(*args, P), 5)
        r["plain_ms"] = plain_ms
        print(f"{name}: {r['ms']:.3f} ms ({tflop / r['ms'] * 1e3:.1f} TF/s)",
              flush=True)
    return records


main = main_of(run, __doc__.splitlines()[0])

if __name__ == "__main__":
    sys.exit(main())
