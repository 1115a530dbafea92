#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mst_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build both kernels from the sources in this checkout (nvcc for
     csrc/fused_predict.cu, Triton's JIT for the rows soft-argmax);
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
     kernels).
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ROWS_TOL = 1e-3   # px, rows soft-argmax vs its plain version (f32)
FUSED_TOL = 1e-2  # px, fused predictor + soft-argmax vs its plain version


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, iters):
    """Mean device time of fn over iters launches, after a warm-up."""
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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_rows_kernel(torch):
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)

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
    ms = time_ms(torch, lambda: softargmax2d_rows(x), 200)
    plain_ms = time_ms(torch, lambda: plain(x), 200)
    b_ms, b_by = bound(R * H * W * 4 + R * 2 * 4, R * H * W * 8)
    return {"name": "softargmax_rows", "route": "triton",
            "source": "mst_tpu_torch/ops/kernels/softargmax_rows.py",
            "replaces": "mst_tpu/ops/pallas/softargmax.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_fused_kernel(torch):
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)

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
    ms = time_ms(torch, lambda: fused_predictor_softargmax(x, w, b), 20)
    plain_ms = time_ms(
        torch, lambda: fused_predictor_softargmax_plain(x, w, b), 5)
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
    logs = _build.build(["fused_predict"])
    for line in "".join(logs.values()).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:  # the mangled name carries the template's capacity
            cap = re.search(r"ILi(\d+)E", entry.group(1))
            name = re.sub(r"^_Z\w*?N\w*?\d+(fused_predict_\w+?)(I|E|P).*",
                          r"\1", entry.group(1))
            print(f"ptxas: {name}" + (f"<{cap.group(1)}>" if cap else ""))
        elif "registers" in line or "spill" in line:
            print(f"ptxas:   {line.replace('ptxas info    :', '').strip()}")
    t1 = time.perf_counter()
    softargmax2d_rows(torch.zeros((1, 8, 8), device="cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"build: nvcc fused_predict.cu {t1 - t0:.1f} s, "
          f"triton rows kernel {t2 - t1:.1f} s")

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
