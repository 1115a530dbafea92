#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mst_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every kernel from the sources in this checkout (one nvcc each,
     all started together, for csrc/fused_predict.cu, and csrc/conv3x3.cu
     and csrc/decoder_chain.cu, both on csrc/conv_wgmma.cuh, with their
     ptxas registers, spills, warnings and dynamic shared memory; Triton's
     JIT for the rows soft-argmax);
  3. hold each kernel against its plain PyTorch version at the eval
     path's shapes, a ragged shape and a peaked map, and time kernel,
     plain version and bound with CUDA events;
  4. a small-width reference: the same weights and waypoint draws through
     the port on the card (kernels) and on the CPU (plain versions);
  5. the main path: Predictor at the full width of sdd_shortterm_eval.yaml
     (K = 20, TTST on, B = 8, 352 x 480, random weights from a seed)
     answers 4 requests and 1 request with a LoRA style; both kernels'
     launch counts must rise here; then the fused kernel against its plain
     version on one request's own decode-tail operands;
  6. where one more request's time goes: its two stages on the host clock,
     and a torch.profiler trace (kernel time, device busy share, top
     kernels);
  7. the probe paths at their full shapes, through
     mst_tpu_torch.probes.{conv,chain}_probe.run(): the two 3x3 conv
     kernels (x (160, 176, 240, 128) bf16) and the two decoder-chain
     kernels (x (160, 176, 240, 64), P = 12) against their plain versions,
     timed beside their yardsticks (a conv kernel that moves more outputs
     off the correctly rounded value than cuDNN fails); each probe's launch
     counts must rise; then the conv and chain kernels on ragged shapes at
     C = 32, 64, 96 and 128, an image smaller than a tile and many small
     images (several groups of chain_plane; the chains at P = 5, so 4P =
     20 of the predictor's 64 columns), the chains' uniform-logits closed
     form at full shape, and a torch.profiler breakdown of each
     yardstick and each chain kernel.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

ROWS_TOL = 1e-3   # px, rows soft-argmax vs its plain version (f32)
FUSED_TOL = 1e-2  # px, fused predictor + soft-argmax vs its plain version
# px: with wpred = 0 every map is uniform and the answer is a closed form;
# only f32 sums of the coordinates stand between
UNIFORM_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled):
    """'_ZN<n><namespace><n><name>[I<Li<v>E...>E]...' -> 'name<v,...>'."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    n = re.match(r"\d+", mangled[i:])
    if not n:
        return mangled
    start = i + n.end()
    name = mangled[start:start + int(n.group())]
    args = re.match(r"I((?:Li\d+E)+)E", mangled[start + int(n.group()):])
    if args:
        name += "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def print_ptxas(logs):
    """Each kernel's registers, shared memory and spills from -Xptxas -v,
    and any warning (a setmaxnreg that ptxas ignored, say)."""
    for line in "".join(logs.values()).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            print(f"ptxas: {kernel_name(entry.group(1))}")
        elif "registers" in line or "spill" in line or "warning" in line:
            print(f"ptxas:   {line.replace('ptxas info    :', '').strip()}")


def check_rows_kernel(torch):
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)
    from mst_tpu_torch.probes import time_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 352, 480), generator=g, device="cuda") * 4
    ragged = torch.randn((3, 40, 56), generator=g, device="cuda") * 3
    peaked = torch.full((1, 32, 64), -30.0, device="cuda")
    peaked[0, 17, 42] = 30.0
    err = 0.0
    for name, t in (("slice", x), ("ragged", ragged), ("peaked", peaked)):
        got, want = softargmax2d_rows(t), plain(t)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        print(f"rows soft-argmax {name} {tuple(t.shape)}: max |kernel - "
              f"plain| = {e:.3e} px (tol {ROWS_TOL})")
        check(e <= ROWS_TOL, f"rows kernel disagrees on {name}")
        err = max(err, e)
    e = float((softargmax2d_rows(peaked)[0]
               - torch.tensor([42.0, 17.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"rows kernel misses the peak by {e}")
    R, H, W = x.shape
    ms = time_ms(lambda: softargmax2d_rows(x), 200)
    plain_ms = time_ms(lambda: plain(x), 200)
    b_ms, b_by = bound(R * H * W * 4 + R * 2 * 4, R * H * W * 8)
    return {"name": "softargmax_rows", "route": "triton",
            "source": "mst_tpu_torch/ops/kernels/softargmax_rows.py",
            "replaces": "mst_tpu/ops/pallas/softargmax.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_fused_kernel(torch):
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.probes import time_ms

    g = torch.Generator(device="cuda").manual_seed(1)

    def case(R, H, W, C, P):
        x = torch.randn((R, H, W, C), generator=g, device="cuda").relu_()
        w = torch.randn((C, P), generator=g, device="cuda") * 0.3
        b = torch.randn((P,), generator=g, device="cuda")
        return x, w, b

    R, H, W, C, P = 160, 352, 480, 32, 12  # the eval decode tail, K*B = 160
    sl = case(R, H, W, C, P)
    peak = torch.zeros((2, 16, 24, 8), device="cuda")
    peak[:, 7, 10, :3] = 60.0
    peak_w = torch.eye(8, 3, device="cuda")
    cases = (("slice", sl), ("ragged", case(3, 40, 56, 32, 12)),
             ("odd channels", case(2, 24, 40, 6, 5)),
             ("peaked", (peak, peak_w, torch.zeros(3, device="cuda"))))
    err = 0.0
    for name, (x, w, b) in cases:
        got = fused_predictor_softargmax(x, w, b)
        want = fused_predictor_softargmax_plain(x, w, b)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        print(f"fused predictor {name} {tuple(x.shape)} x {tuple(w.shape)}: "
              f"max |kernel - plain| = {e:.3e} px (tol {FUSED_TOL})")
        check(e <= FUSED_TOL, f"fused kernel disagrees on {name}")
        err = max(err, e)
    got = fused_predictor_softargmax(*cases[-1][1])
    e = float((got - torch.tensor([10.0, 7.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"fused kernel misses the peak by {e}")
    x, w, b = sl
    ms = time_ms(lambda: fused_predictor_softargmax(x, w, b), 20)
    plain_ms = time_ms(
        lambda: fused_predictor_softargmax_plain(x, w, b), 5)
    b_ms, b_by = bound(x.numel() * 4 + (w.numel() + b.numel()) * 4
                       + R * P * 2 * 4,
                       R * H * W * P * (2 * C + 8))
    del sl, cases, x, w, b
    return {"name": "fused_predict", "route": "cuda",
            "source": "mst_tpu_torch/csrc/fused_predict.cu",
            "replaces": "mst_tpu/ops/pallas/fused_predict.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def small_reference(torch):
    """The port on the card against the port on the CPU at small width:
    same weights and the same waypoint draws; returns the max trajectory
    difference in model-space pixels."""
    import numpy as np

    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet, tree_map
    from mst_tpu_torch.train.steps import make_eval_step

    params = get_params("sdd_shortterm_eval.yaml", dict(
        encoder_channels=[8, 8, 16, 16, 16],
        decoder_channels=[16, 16, 16, 8, 8], use_TTST=True))
    mcfg = ynet_config(params)
    rng = np.random.default_rng(0)
    batch = {"semantic": rng.normal(size=(1, 64, 96, 6)),
             "traj": rng.uniform(10, 50, size=(4, 20, 2)),
             "mask": np.ones(4)}
    w_cpu = init_ynet(torch.Generator().manual_seed(0), mcfg)
    w_gpu = tree_map(lambda t: t.cuda(), w_cpu)
    b_cpu = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    step = make_eval_step(mcfg, step_config(params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats, wps = step.forward(w_gpu, b_gpu, gen)
    got = step.decode_trajs(w_gpu, feats, wps).cpu()
    feats_cpu, _ = step.forward(w_cpu, b_cpu, torch.Generator())
    want = step.decode_trajs(w_cpu, feats_cpu, wps.cpu())
    check(bool(torch.isfinite(got).all()), "non-finite trajectories")
    return float((got - want).abs().max())


def check_path_tail(torch, pred, semantic, observed, seed):
    """Kernel 2 against its plain version on the main path's own decode-tail
    operands (the pre-predictor activations of one request's K draws), and
    the path's trajectories against the plain tail's. -> max |kernel -
    plain| in model px."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.train.steps import make_eval_step

    feats, wps = pred.forward(semantic, observed, seed=seed)
    x, w, b = make_eval_step(pred.mcfg, pred.scfg).prepredictor(
        pred.params, feats)(wps)
    got = fused_predictor_softargmax(x, w, b)
    want = fused_predictor_softargmax_plain(x, w, b)
    err = float((got - want).abs().max())
    print(f"fused predictor on the path's operands {tuple(x.shape)} x "
          f"{tuple(w.shape)}: max |kernel - plain| = {err:.3e} px "
          f"(tol {FUSED_TOL})")
    check(err <= FUSED_TOL, "fused kernel disagrees on the path's operands")
    rf = pred.scfg.resize_factor
    path = pred.decode(feats, wps) * rf
    diff = float((path - want.reshape(path.shape)).abs().max())
    print(f"path decode vs plain tail, same draws: max |difference| = "
          f"{diff:.3e} model px (tol {FUSED_TOL})")
    check(diff <= FUSED_TOL, "the path's decode disagrees with the plain "
          "tail")
    return max(err, diff)


PROBE_KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "conv3x3_taps": ("mst_tpu_torch/csrc/conv3x3.cu",
                     "benchmarks/pallas_conv_probe.py:59"),
    "conv3x3_im2col": ("mst_tpu_torch/csrc/conv3x3.cu",
                       "benchmarks/pallas_conv_probe.py:111"),
    "chain_plane": ("mst_tpu_torch/csrc/decoder_chain.cu",
                    "benchmarks/pallas_chain_probe.py:233"),
    "chain_stream": ("mst_tpu_torch/csrc/decoder_chain.cu",
                     "benchmarks/pallas_chain_probe.py:199"),
}


def probe_paths(torch):
    """Phase 7: both probe paths at full shape, each driven with its
    kernels' counts set to 0 just before and read just after; -> one
    record per kernel, with its bound at the probe's shape."""
    from mst_tpu_torch.probes import chain_probe, conv_probe

    records = []
    for probe in (conv_probe, chain_probe):
        fns = dict(probe.KERNELS)
        for fn in fns.values():
            fn.launches = 0
        recs = probe.run()
        launches = {name: fn.launches for name, fn in fns.items()}
        print(f"{probe.__name__} path launches: {launches}")
        for r in recs:
            r["launches"] = launches[r["name"]]
            check(r["launches"] > 0, f"{r['name']} never ran on its path")
        records += recs
        torch.cuda.empty_cache()

    B, H, W, C, Co = conv_probe.FULL
    conv_bound = bound(2 * (B * H * W * C + 9 * C * Co + B * H * W * Co),
                       2 * B * H * W * 9 * C * Co, BF16_FLOP_PER_S)
    KB, Hp, Wp, C, CA, P = chain_probe.FULL
    chain_bound = bound(
        2 * (KB * Hp * Wp * C + 9 * C * CA + 9 * CA * CA + CA * 4 * P)
        + 4 * (2 * CA + 4 * P) + 4 * KB * 2 * P,
        2 * KB * Hp * Wp * (9 * C * CA + 9 * CA * CA + CA * 4 * P),
        BF16_FLOP_PER_S)
    for r in records:
        source, replaces = PROBE_KERNELS[r["name"]]
        r.update(route="cuda", source=source, replaces=replaces)
        r["bound_ms"], r["bound_by"] = (
            conv_bound if r["name"].startswith("conv") else chain_bound)
    return records


# (B, H, W, C) of the conv kernels' edge cases: H and W divisible by no
# tile at every C the wrappers take (C = 32 and 96 fill a 64-channel block
# partly), an image smaller than one tile, and 400 images of two tiles,
# so that each persistent block walks several images
CONV_EDGE_CASES = ((3, 37, 53, 128), (3, 37, 53, 32), (2, 37, 53, 64),
                   (2, 37, 53, 96), (1, 5, 7, 64), (400, 12, 20, 128))
# (KB, Hp, Wp, C, P) of the chain kernels' edge cases: the convs' shapes at
# P = 5 (4P = 20 of the predictor's 64 padded columns), and 160 ragged
# images of 12 tiles, which chain_plane runs in several groups
# (plane_group) and each persistent block of both walks across images
CHAIN_EDGE_CASES = tuple(s + (5,) for s in CONV_EDGE_CASES[:5]) + (
    (160, 40, 56, 64, 12),)


def probe_edge_cases(torch, records):
    """After the counts were read: the probe kernels on edge cases
    (CONV_EDGE_CASES, CHAIN_EDGE_CASES) and, at the chain probe's full
    shape, the uniform-logits closed form X = (2 Wp - 1) / 2, Y = (2 Hp -
    1) / 2."""
    from mst_tpu_torch.ops.kernels import _build
    from mst_tpu_torch.ops.kernels.conv3x3 import conv3x3_plain
    from mst_tpu_torch.ops.kernels.decoder_chain import (chain_plain,
                                                         chain_tiles,
                                                         plane_group)
    from mst_tpu_torch.probes import chain_probe, conv_probe

    fns = dict(conv_probe.KERNELS + chain_probe.KERNELS)
    by_name = {r["name"]: r for r in records}
    for shape in CONV_EDGE_CASES:
        x, w = conv_probe.make_inputs(shape + (128,), torch.bfloat16, "cuda",
                                      seed=1)
        want = conv3x3_plain(x, w)
        for name, _ in conv_probe.KERNELS:
            e = float((fns[name](x, w).float() - want.float()).abs().max())
            print(f"{name} {tuple(x.shape)}: max |kernel - plain| = "
                  f"{e:.3e} (tol {conv_probe.TOL})")
            check(e <= conv_probe.TOL, f"{name} disagrees on {shape}")
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                               e)
        del x, w, want
    lib_tiles = _build.load("decoder_chain").decoder_chain_tiles
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for KB, Hp, Wp, C, P in CHAIN_EDGE_CASES + (chain_probe.FULL[:4]
                                                + (None,),):
        check(chain_tiles(Hp, Wp) == lib_tiles(Hp, Wp),
              f"chain_tiles({Hp}, {Wp}) differs from the library's")
        if P is None:  # the full shape: the tile count only
            continue
        args = chain_probe.make_inputs((KB, Hp, Wp, C, 128, P),
                                       torch.bfloat16, "cuda", seed=1)
        want = chain_plain(*args, P)
        groups = -(-KB // plane_group(KB, Hp, Wp, sms))
        for name, _ in chain_probe.KERNELS:
            e = float((fns[name](*args, P) - want).abs().max())
            print(f"{name} {tuple(args[0].shape)}, P {P}, "
                  f"{chain_tiles(Hp, Wp)} tiles an image, {groups} plane "
                  f"group(s): max |kernel - plain| = {e:.3e} px (tol "
                  f"{chain_probe.TOL})")
            check(e <= chain_probe.TOL, f"{name} disagrees on "
                  f"{(KB, Hp, Wp, C, P)}")
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                               e)
        del args, want
    x, wa, ba, wb, bb, wpred, bpred = chain_probe.make_inputs(
        chain_probe.FULL, torch.bfloat16, "cuda", seed=2)
    KB, Hp, Wp, _, _, P = chain_probe.FULL
    closed = torch.tensor([(2 * Wp - 1) / 2, (2 * Hp - 1) / 2],
                          device="cuda")[None, :, None]
    for name, _ in chain_probe.KERNELS:
        got = fns[name](x, wa, ba, wb, bb, torch.zeros_like(wpred),
                        torch.zeros_like(bpred), P)
        e = float((got - closed).abs().max())
        print(f"{name} uniform logits {tuple(x.shape)}: max |kernel - "
              f"closed form| = {e:.3e} px (tol {UNIFORM_TOL})")
        check(e <= UNIFORM_TOL, f"{name} misses the uniform closed form")


def probe_breakdown(torch):
    """Where the probes' time goes: one cuDNN conv, one library chain and
    each chain kernel at the probes' shapes, each traced by torch.profiler
    after a warm-up call (kernel time by name)."""
    from torch.profiler import ProfilerActivity, profile

    from mst_tpu_torch.probes import chain_probe, conv_probe

    x, w = conv_probe.make_inputs(conv_probe.FULL, torch.bfloat16, "cuda")
    w_oihw = conv_probe.library_weight(w)
    chain_args = chain_probe.make_inputs(chain_probe.FULL, torch.bfloat16,
                                         "cuda") + (chain_probe.FULL[-1],)
    args = chain_probe.library_inputs(*chain_args[:-1]) + chain_args[-1:]
    runs = [("library conv", lambda: conv_probe.library_conv3x3(x, w_oihw)),
            ("library chain", lambda: chain_probe.library_chain(*args))]
    runs += [(name, lambda fn=fn: fn(*chain_args))
             for name, fn in chain_probe.KERNELS]
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"{label}: {total:.3f} ms of kernels in one traced call")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} "
                  f"{e.key[:90]}")


def print_smem():
    """Dynamic shared memory a block of each conv and chain kernel asks
    for, at the probes' channel counts (ptxas -v shows only static)."""
    from mst_tpu_torch.ops.kernels import _build

    for lib, fn, kernels, channels in (
            ("conv3x3", "conv3x3_smem_bytes",
             ("conv3x3_taps", "conv3x3_im2col"), (32, 64, 96, 128)),
            ("decoder_chain", "decoder_chain_smem_bytes",
             ("chain_plane_stage_a", "chain_plane_tail", "chain_stream"),
             (32, 64, 96, 128))):
        f = getattr(_build.load(lib), fn)
        f.argtypes = [ctypes.c_int, ctypes.c_int]
        f.restype = ctypes.c_int
        for i, name in enumerate(kernels):
            sizes = ", ".join(f"{f(i, C)} (C = {C})" for C in channels)
            print(f"dynamic shared memory: {name} {sizes} bytes a block")


def where_time_goes(torch, pred, semantic, observed):
    """One more request, split into its two stages on the host clock (each
    ending in a synchronize), then traced by torch.profiler: total kernel
    time over the traced request's wall time, and the kernels that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, wps = pred.forward(semantic, observed, seed=7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred.decode(feats, wps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"stages: forward + sampling {1e3 * (t1 - t0):.1f} ms, "
          f"K decodes {1e3 * (t2 - t1):.1f} ms")
    del feats, wps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(semantic, observed, seed=8)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profiler: no device time recorded (device busy share not "
              "measured)")
        return
    print(f"profiler: {busy_ms:.1f} ms of kernels in a {wall_ms:.1f} ms "
          f"traced request (device busy {100 * busy_ms / wall_ms:.0f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mst_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mst_tpu_torch package is missing ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np

    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.config import get_params
    from mst_tpu_torch.ops.kernels import _build
    from mst_tpu_torch.ops.kernels.fused_predict import \
        fused_predictor_softargmax
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows
    from mst_tpu_torch.serve import Predictor

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    resolve_device("cuda")  # TF32 off for the f32 path

    # ---- 2. build
    t0 = time.perf_counter()
    print_ptxas(_build.build(["fused_predict", "conv3x3", "decoder_chain"]))
    print_smem()
    t1 = time.perf_counter()
    softargmax2d_rows(torch.zeros((1, 8, 8), device="cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"build: nvcc fused_predict.cu, conv3x3.cu, decoder_chain.cu "
          f"{t1 - t0:.1f} s, triton rows kernel {t2 - t1:.1f} s")

    # ---- 3. kernels against their plain versions
    records = [check_rows_kernel(torch), check_fused_kernel(torch)]
    for r in records:
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        print(json.dumps(r))
    torch.cuda.empty_cache()

    # ---- 4. small-width reference: card against CPU
    err = small_reference(torch)
    print(f"small-width reference: max |card - cpu| trajectory = "
          f"{err:.3e} model px (tol {FUSED_TOL})")
    check(err <= FUSED_TOL, "the port on the card disagrees with the CPU")

    # ---- 5. the main path at SDD short-term width
    params = get_params("sdd_shortterm_eval.yaml", dict(
        use_TTST=True, train_net="mosa_2", position=["0", "1", "2", "3",
                                                     "4"]))
    base = Predictor(params, seed=0)
    rng = np.random.default_rng(0)
    H, W, B = 352, 480, 8
    logits = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    semantic = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    start = rng.uniform([100, 80], [W - 100, H - 80], size=(B, 1, 2))
    steps = rng.normal(scale=3.0, size=(B, params["obs_len"], 2))
    observed = (start + np.cumsum(steps, axis=1)).astype(np.float32)
    delta = {}
    for i in range(len(params["encoder_channels"])):
        for conv in ("conv0", "conv1") if i else ("conv0",):
            shape = base.params["encoder"]["stages"][str(i)][conv][
                "lora_B"].shape
            delta[f"encoder/stages/{i}/{conv}/lora_B"] = rng.normal(
                scale=0.05, size=tuple(shape)).astype(np.float32)

    softargmax2d_rows.launches = 0
    fused_predictor_softargmax.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        delta_path = os.path.join(tmp, "mosa_2_style.npz")
        np.savez(delta_path, **delta)
        base.add_style("mosa_2_style", delta_path)
    for label, fn in (
            ("request 0", lambda: base.predict(semantic, observed, seed=0)),
            ("request 1", lambda: base.predict(semantic, observed, seed=1)),
            ("request 2", lambda: base.predict(semantic, observed, seed=2)),
            ("request 3, style mosa_2", lambda: base.predict(
                semantic, observed, seed=0, style="mosa_2_style")),
            ("request 4", lambda: base.predict(semantic, observed, seed=3))):
        t0 = time.perf_counter()
        out = fn()
        dt = (time.perf_counter() - t0) * 1e3
        outs.append(out)
        tr, wp = out["trajectories"], out["waypoints"]
        print(f"{label}: {dt:.1f} ms, trajectories {tr.shape}, "
              f"waypoints {wp.shape}")
        rf = params["resize_factor"]
        for name, a in (("trajectories", tr), ("waypoints", wp)):
            check(np.isfinite(a).all(), f"{label}: non-finite {name}")
            check((a >= 0).all() and (a[..., 0] <= (W - 1) / rf).all()
                  and (a[..., 1] <= (H - 1) / rf).all(),
                  f"{label}: {name} outside the image")
        check(tr.shape == (20, B, params["pred_len"], 2), f"{label}: shape")
    style_moved = float(np.abs(outs[3]["trajectories"]
                               - outs[0]["trajectories"]).max())
    print(f"style vs base, same seed: max |difference| = {style_moved:.3f} "
          "raw px")
    check(style_moved > 0, "the LoRA style changed nothing")
    launches = {"softargmax_rows": softargmax2d_rows.launches,
                "fused_predict": fused_predictor_softargmax.launches}
    print(f"main-path launches: {launches}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    for r in records:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never ran on the main path")

    # ---- 5b. the decode tail of the path against its plain version (after
    # the counts were read: these launches are comparisons)
    err = check_path_tail(torch, base, semantic, observed, seed=0)
    fused_rec = next(r for r in records if r["name"] == "fused_predict")
    fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"], err)

    # ---- 6. where a request's time goes
    where_time_goes(torch, base, semantic, observed)

    # ---- 7. the probe paths: the conv and decoder-chain kernels
    del base
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    probe_records = probe_paths(torch)
    probe_edge_cases(torch, probe_records)
    for r in probe_records:
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    probe_breakdown(torch)
    print(f"probe phase: {time.perf_counter() - t0:.1f} s")
    records += probe_records

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
