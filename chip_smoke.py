#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mst_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions,
     and whether pandas, cv2 and PIL import;
  2. build every kernel from the sources in this checkout (one nvcc each,
     all started together, for csrc/fused_predict.cu and
     csrc/softargmax_rows.cu, and csrc/conv3x3.cu and csrc/decoder_chain.cu,
     both on csrc/conv_wgmma.cuh, with their ptxas registers, spills,
     warnings and dynamic shared memory), and hold the serving kernels'
     work splits in Python (what the CPU tests check) against the
     libraries' own;
  3. hold the serving path's two kernels against their plain PyTorch
     versions at the eval path's shapes (the fused kernel at P = 12 and
     P = 30) and on edge cases (rows: one row, H*W % 4 != 0, 200 rows,
     rows shorter than the cluster, a peaked map; fused: a ragged shape,
     an image smaller than a stage, C = 6, a view off 16-byte alignment, a
     peaked map), failing on a non-finite row; time kernel (CUDA events,
     and device time from torch.profiler, which must show one kernel a
     call), plain version and bound;
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
  6b. the few-shot fine-tune path: the train step on the card against the
     CPU at small width (three mosa_2 steps, losses at 1e-4 relative), then
     5 steps of mosa_2 on positions 0-4 at the full width of
     sdd_shortterm_train.yaml (B = 8 with two padded rows, 352 x 480,
     random weights from seed 0, Adam at lr 1e-3): per-step losses and
     host-clock ms, finite losses, frozen leaves bit-identical, lora_B
     moved from step 1 and lora_A from step 2, the rows kernel launched
     twice a step (its metrics) and every other kernel never (all six
     counts set to 0 before the steps and read after them); the peak
     device memory, the rows kernel against its plain version on the
     path's own maps, a torch.profiler trace of one more step; then the
     trainable-only delta (exactly the 18 LoRA leaves) saved, registered
     with phase 5's Predictor as a style and served once;
  6c. the Experiment loop as the CLIs drive it (experiment_loop): at the
     full width of sdd_shortterm_train.yaml with the identity backbone's 3
     classes, on in-memory synthetic scenes at 352 x 480 (neither pandas
     nor cv2), a 2-epoch scratch train run, the init check (exact), a
     3-epoch mosa_2 fine-tune with validation, and a base + delta 2-round
     TTST test; per-epoch losses and ADE/FDE, host seconds of data, steps
     and validation, peak memory, every kernel's launches against the
     count the code gives, no eval_k_chunk shrink, a trace of one more
     fine-tune epoch, and the delta (LoRA leaves only) served as a
     Predictor style;
  6d. Y-Net-Mod and the adapters (ynet_mod_path): at small width, card
     against CPU for mosa_1 on the fusion network's scene, motion and
     fusion branches, parallelLayer_3x3 on 0-4 and serial on 1-2 (three
     Adam steps: losses at 1e-4 relative, the serial BN state at 1e-3 of
     each leaf's max; one eval batch of the same weights, trajectories at
     1e-2 px); then at the full width of inD_longterm_train.yaml with
     network fusion, n_fusion 2 (B = 10 at 320 x 576, random weights from
     seed 0): 5 mosa_1 steps with Adam at lr 5e-3, the delta added as a
     style to a fusion Predictor (K = 20, pred_len 30), 5 requests of
     B = 10; step and request host ms, peak memory, every kernel's count
     set to 0 before and read after (rows 2 a step, fused 1 a request,
     others 0), a torch.profiler trace of one more step and one more
     request, and the fused kernel at P = 30 against its plain version
     on the path's own operands, timed;
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
     yardstick and each chain kernel;
  8. the deployment path (deployment_path) at phase 5's width, with its
     scene map, rows and LoRA delta: export_model from an Experiment
     (random weights from seed 0), LoadedModel against a Predictor of the
     same weights (1e-4 raw px); the HTTP daemon (run_server in a thread,
     max_wait_ms 5) under 1 client x 10 full-B requests and 8 clients x 10
     requests of 1-2 rows over two seeds, with and without the style:
     every response finite and inside the image, every full-B one equal
     to a direct predict (1e-4 raw px); all six kernels' counts set to 0
     before the traffic and read after (rows and fused once a dispatch,
     the others never); a direct predict on a side stream during a
     dispatch against the serial runs, and fused_predict queued on two
     streams behind one gate event, every output against the plain
     version and the trace showing the two streams' launches overlap; a
     burst at max_queue 2 shed with
     503s; max_styles 2 evicting the oldest of 3; the memory of two
     resident styles; check --bench 5; a small-width serial model
     directory card against CPU (FUSED_TOL), its init statistics moving
     the trajectories by over 10x that. Latencies, requests/s and rows a
     dispatch are printed beside the card's name and power limit.
The line before the last is the per-kernel JSON record (launches on each
kernel's own path, train_launches on the fine-tune path, loop_launches
on the Experiment loop's, ymod_launches on Y-Net-Mod's and
serve_launches on the daemon's); the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import ctypes
import json
import os
import re
import shutil
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


def print_optional_packages():
    """Whether the packages the port reads data with when they are there
    (pandas for the pickles, cv2 to decode images) and PIL import here."""
    import importlib

    for name in ("pandas", "cv2", "PIL"):
        try:
            mod = importlib.import_module(name)
            print(f"package {name}: {getattr(mod, '__version__', '?')}")
        except ImportError as e:
            print(f"package {name}: not importable ({e})")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(mangled):
    """'_ZN<n><namespace><n><name>[I<L{i,b}<v>E...>E]...' ->
    'name<v,...>' (a bool argument as 0 or 1)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    n = re.match(r"\d+", mangled[i:])
    if not n:
        return mangled
    start = i + n.end()
    name = mangled[start:start + int(n.group())]
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + int(n.group()):])
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) \
            + ">"
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


def check_splits():
    """Each serving kernel's work split in Python (what the CPU tests
    check) against its library's own, and the library's constants."""
    from mst_tpu_torch.ops.kernels import fused_predict as fp
    from mst_tpu_torch.ops.kernels import softargmax_rows as sr

    lib = fp._library()
    for R, HW, blocks in ((160, 352 * 480, 132), (5, 1536, 7), (1, 200, 132),
                          (3, 5, 15), (200, 7, 3), (1, 16 * 8, 128)):
        check(fp.library_split(R, HW, blocks) == fp.fused_work(R, HW, blocks),
              f"fused_work({R}, {HW}, {blocks}) differs from the library's")
    for C in (1, 6, 32, 128):
        check(lib.fused_predict_stage_pixels(C) == fp.stage_pixels(C),
              f"stage_pixels({C}) differs from the library's")
    for P in range(1, fp.MAX_CHANNELS + 1):
        check(lib.fused_predict_group_width(P) == fp.group_width(P)
              and lib.fused_predict_pixels_per_thread(P)
              == fp.pixels_per_thread(P),
              f"group_width or pixels_per_thread({P}) differs from the "
              "library's")
    check(sr._library().softargmax_rows_cluster() == sr.CLUSTER,
          "the rows kernel's cluster size differs from CLUSTER")
    for HW in (1, 3, 5, 64, 37 * 53, 40 * 56, 352 * 480):
        for lead in range(4):
            want = [sr.row_split(HW, lead, sr.CLUSTER, k)
                    for k in range(sr.CLUSTER)]
            check(sr.library_split(HW, lead, sr.CLUSTER) == want,
                  f"row_split({HW}, {lead}) differs from the library's")
    print("work splits: fused_work, stage_pixels, group_width, "
          "pixels_per_thread and row_split match the libraries")


def check_cases(torch, label, fn, plain, cases, tol):
    """fn against plain on each (name, args): finite, within tol; -> the
    max error. A non-finite output names its row."""
    err = 0.0
    for name, args in cases:
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        bad = (~torch.isfinite(got)).reshape(got.shape[0], -1).any(1)
        check(not bool(bad.any()), f"{label} {name}: non-finite output in "
              f"row(s) {bad.nonzero().flatten().tolist()[:8]}")
        e = float((got - want).abs().max())
        print(f"{label} {name} {tuple(args[0].shape)}: max |kernel - "
              f"plain| = {e:.3e} px (tol {tol})")
        check(e <= tol, f"{label} disagrees on {name}")
        err = max(err, e)
    return err


def check_one_kernel(label, rec, iters):
    """The profiler saw one kernel, launched at most once a call (it may
    miss a launch)."""
    check(rec["kernels_per_call"] == 1
          and max(rec["kernels"].values()) <= iters,
          f"{label} is not one kernel a call: {rec['kernels']} in {iters} "
          "calls")


def print_times(label, rec, b_ms):
    print(f"{label}: event {rec['ms']:.4f} ms, device {rec['device_ms']:.4f}"
          f" ms a call ({rec['kernels_per_call']:g} kernel(s): "
          f"{rec['kernels']}), bound {b_ms:.4f} ms, share of the bound "
          f"{100 * b_ms / rec['device_ms']:.1f}% (device), "
          f"{100 * b_ms / rec['ms']:.1f}% (event)")


def check_rows_kernel(torch):
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.probes.serving_kernels import ROWS_SHAPE, time_call

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(ROWS_SHAPE, generator=g, device="cuda") * 4
    peaked = torch.full((1, 32, 64), -30.0, device="cuda")
    peaked[0, 17, 42] = 30.0
    cases = [("slice", x),
             ("one row", torch.randn((1, 352, 480), generator=g,
                                     device="cuda") * 4),
             ("H*W % 4 != 0", torch.randn((3, 37, 53), generator=g,
                                          device="cuda") * 3),
             ("200 rows", torch.randn((200, 40, 56), generator=g,
                                      device="cuda") * 3),
             ("rows shorter than the cluster", torch.randn(
                 (5, 3, 5), generator=g, device="cuda") * 3),
             ("peaked", peaked)]
    err = check_cases(torch, "rows soft-argmax", softargmax2d_rows, plain,
                      [(n, (t,)) for n, t in cases], ROWS_TOL)
    e = float((softargmax2d_rows(peaked)[0]
               - torch.tensor([42.0, 17.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"rows kernel misses the peak by {e}")
    R, H, W = x.shape
    rec = time_call(lambda: softargmax2d_rows(x), 200)
    check_one_kernel("the rows soft-argmax", rec, 200)
    plain_ms = time_ms(lambda: plain(x), 200)
    b_ms, b_by = bound(R * H * W * 4 + R * 2 * 4, R * H * W * 8)
    print_times(f"softargmax_rows {tuple(x.shape)}", rec, b_ms)
    return {"name": "softargmax_rows", "route": "cuda",
            "source": "mst_tpu_torch/csrc/softargmax_rows.cu",
            "replaces": "mst_tpu/ops/pallas/softargmax.py:63",
            "max_abs_err": err, "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def fused_bound(R, H, W, C, P):
    return bound(R * H * W * C * 4 + (C * P + P) * 4 + R * P * 2 * 4,
                 R * H * W * P * (2 * C + 8))


def check_fused_kernel(torch):
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.probes.serving_kernels import (FUSED_SHAPE,
                                                      fused_inputs, time_call)

    g = torch.Generator(device="cuda").manual_seed(2)

    def case(R, H, W, C, P, offset=0):
        """Inputs; with offset, x is a view that starts `offset` floats
        into its buffer (a data pointer off 16-byte alignment)."""
        buf = torch.randn(R * H * W * C + offset, generator=g, device="cuda")
        x = buf[offset:].view(R, H, W, C).relu_()
        w = torch.randn((C, P), generator=g, device="cuda") * 0.3
        b = torch.randn((P,), generator=g, device="cuda")
        return x, w, b

    peak = torch.zeros((2, 16, 24, 8), device="cuda")
    peak[:, 7, 10, :3] = 60.0
    peak_w = torch.eye(8, 3, device="cuda")
    unaligned = case(2, 40, 56, 32, 12, offset=1)
    check(unaligned[0].data_ptr() % 16 != 0, "the unaligned view is aligned")
    cases = [("ragged", case(3, 40, 56, 32, 12)),
             ("one image smaller than a stage", case(1, 10, 20, 32, 12)),
             ("odd channels", case(2, 24, 40, 6, 5)),
             ("unaligned view", unaligned),
             ("peaked", (peak, peak_w, torch.zeros(3, device="cuda")))]
    err = check_cases(torch, "fused predictor", fused_predictor_softargmax,
                      fused_predictor_softargmax_plain, cases, FUSED_TOL)
    got = fused_predictor_softargmax(*cases[-1][1])
    e = float((got - torch.tensor([10.0, 7.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"fused kernel misses the peak by {e}")
    del cases, unaligned
    times = {}
    for P in (30, 12):  # the record is P = 12, the eval decode tail's
        x, w, b = fused_inputs(P)
        err = max(err, check_cases(
            torch, "fused predictor", fused_predictor_softargmax,
            fused_predictor_softargmax_plain, [(f"full shape, P {P}",
                                                (x, w, b))], FUSED_TOL))
        rec = time_call(lambda: fused_predictor_softargmax(x, w, b), 20)
        check_one_kernel("the fused predictor", rec, 20)
        rec["plain_ms"] = time_ms(
            lambda: fused_predictor_softargmax_plain(x, w, b), 5)
        rec["bound"] = fused_bound(*FUSED_SHAPE, P)
        print_times(f"fused_predict {FUSED_SHAPE} x ({FUSED_SHAPE[-1]}, {P})",
                    rec, rec["bound"][0])
        print(f"fused_predict P {P}: plain {rec['plain_ms']:.4f} ms")
        times[P] = rec
        del x, w, b
        torch.cuda.empty_cache()
    rec = times[12]
    return {"name": "fused_predict", "route": "cuda",
            "source": "mst_tpu_torch/csrc/fused_predict.cu",
            "replaces": "mst_tpu/ops/pallas/fused_predict.py:109",
            "max_abs_err": err, "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
            "library_ms": None, "P30": {
                k: times[30][k] for k in ("ms", "device_ms", "plain_ms")}}


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
    w_cpu, s_cpu = init_ynet(torch.Generator().manual_seed(0), mcfg)
    w_gpu, s_gpu = (tree_map(lambda t: t.cuda(), tree)
                    for tree in (w_cpu, s_cpu))
    b_cpu = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in batch.items()}
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    step = make_eval_step(mcfg, step_config(params))
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats, wps = step.forward(w_gpu, s_gpu, b_gpu, gen)
    got = step.decode_trajs(w_gpu, feats, wps).cpu()
    feats_cpu, _ = step.forward(w_cpu, s_cpu, b_cpu, torch.Generator())
    want = step.decode_trajs(w_cpu, feats_cpu, wps.cpu())
    check(bool(torch.isfinite(got).all()), "non-finite trajectories")
    return float((got - want).abs().max())


def check_path_tail(torch, pred, semantic, observed, seed, timed=False):
    """Kernel 2 against its plain version on the main path's own decode-tail
    operands (the pre-predictor activations of one request's K draws), and
    the path's trajectories against the plain tail's. -> max |kernel -
    plain| in model px; with timed, (that, {ms, device_ms, plain_ms,
    bound_ms, shape}) of the kernel on those operands."""
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
    if not timed:
        return max(err, diff)
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.probes.serving_kernels import time_call

    R, H, W, C = x.shape
    rec = time_call(lambda: fused_predictor_softargmax(x, w, b), 20)
    check_one_kernel("the fused predictor", rec, 20)
    rec["plain_ms"] = time_ms(
        lambda: fused_predictor_softargmax_plain(x, w, b), 3)
    rec["bound_ms"] = fused_bound(R, H, W, C, w.shape[1])[0]
    rec["shape"] = f"{tuple(x.shape)} x {tuple(w.shape)}"
    print_times(f"fused_predict on the path's operands {rec['shape']}", rec,
                rec["bound_ms"])
    print(f"fused_predict on the path's operands: plain "
          f"{rec['plain_ms']:.4f} ms")
    return max(err, diff), rec


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
    """Dynamic shared memory a block of the fused kernel and of each conv
    and chain kernel asks for, at the path's and the probes' channel counts
    (ptxas -v shows only static)."""
    from mst_tpu_torch.ops.kernels import _build
    from mst_tpu_torch.ops.kernels import fused_predict as fp

    f = fp._library().fused_predict_smem_bytes
    sizes = ", ".join(f"{f(C, P)} (C = {C}, P = {P})"
                      for C, P in ((32, 12), (32, 30), (128, 32)))
    print(f"dynamic shared memory: fused_predict_kernel {sizes} bytes a "
          "block")
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


def print_trace(torch, label, fn, conv_ops=0):
    """fn() traced by torch.profiler (fn ends in a synchronize or a host
    copy): total kernel time over its wall time, the kernels that take the
    most device time and, with conv_ops, the convolution operators (forward
    and backward, by input shapes) whose kernels take the most. -> (kernel
    ms, wall ms), or None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=conv_ops > 0) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profiler: no device time recorded (device busy share not "
              "measured)")
        return None
    print(f"profiler: {busy_ms:.1f} ms of kernels in a {wall_ms:.1f} ms "
          f"traced {label} (device busy {100 * busy_ms / wall_ms:.0f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::cudnn_convolution",
                          "aten::convolution_backward")]
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:conv_ops]:
        shapes = [s for s in e.input_shapes if s][:3]
        print(f"  op {e.device_time_total / 1e3:8.2f} ms  x{e.count:<3d} "
              f"{e.key} {shapes}")
    return busy_ms, wall_ms


def where_time_goes(torch, pred, semantic, observed):
    """One more request, split into its two stages on the host clock (each
    ending in a synchronize), then traced by torch.profiler."""
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
    print_trace(torch, "request",
                lambda: pred.predict(semantic, observed, seed=8))


POSITIONS = ["0", "1", "2", "3", "4"]
LOSS_KEYS = ("loss", "goal_loss", "traj_loss")
TRAIN_TOL = 1e-4  # relative, the losses on the card against the CPU
TRAIN_STEPS = 5


def small_train_reference(torch):
    """The fine-tune step on the card against the CPU at the CPU tests'
    width (mosa_2 on positions 0-4): the same seeded weights and inputs
    through three steps; -> the largest relative loss difference."""
    import numpy as np

    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import setup_training

    params = get_params("sdd_shortterm_train.yaml", dict(
        encoder_channels=[8, 8, 16, 16, 16],
        decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
        waypoints=[5, 11], train_net="mosa_2", position=POSITIONS, lr=1e-3))
    mcfg = ynet_config(params)
    rng = np.random.default_rng(0)
    batch = {"semantic": rng.normal(size=(1, 64, 96, 3)),
             "traj": rng.uniform(5, 60, size=(4, 20, 2)),
             "mask": np.array([1.0, 1.0, 1.0, 0.0])}
    losses = {}
    for dev in ("cuda", "cpu"):
        weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg,
                                   dev)
        setup = setup_training(weights, params, steps_per_epoch=1)
        step = make_train_step(mcfg, step_config(params))
        b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        losses[dev] = []
        for _ in range(3):
            state, m = step(weights, state, setup["optimizer"],
                            setup["scheduler"], b)
            losses[dev].append([float(m[k]) for k in LOSS_KEYS])
    for i, (a, c) in enumerate(zip(losses["cuda"], losses["cpu"])):
        print(f"small-width step {i}: card {a}, cpu {c}")
    return max(abs(a - c) / abs(c) for ra, rc in zip(losses["cuda"],
                                                     losses["cpu"])
               for a, c in zip(ra, rc))


def kernel_wrappers():
    """{kernel name: its wrapper} for all six kernels; each wrapper's
    `launches` counts the launches of its kernel."""
    from mst_tpu_torch.ops.kernels.fused_predict import \
        fused_predictor_softargmax
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows
    from mst_tpu_torch.probes import chain_probe, conv_probe

    return {"softargmax_rows": softargmax2d_rows,
            "fused_predict": fused_predictor_softargmax,
            **dict(conv_probe.KERNELS), **dict(chain_probe.KERNELS)}


def check_rows_on_path(torch, label, step, weights, state, batch, rows_rec):
    """The rows kernel against its plain version on a train step's own
    maps, as its top-1 metrics feed it: the trajectory map (B * pred_len
    rows) and the last goal map (B rows), each timed beside its bound; the
    largest error goes into rows_rec['max_abs_err']."""
    from mst_tpu_torch.ops.kernels.softargmax_rows import (
        plain, softargmax2d_rows)
    from mst_tpu_torch.probes import time_ms

    with torch.no_grad():
        _, _, goal_map, traj_map, _ = step.forward(weights, state, batch)
    for name, x in (("traj", traj_map.permute(0, 3, 1, 2).contiguous()),
                    ("goal", goal_map[..., -1:].permute(0, 3, 1, 2)
                     .contiguous())):
        e = float((softargmax2d_rows(x) - plain(x)).abs().max())
        R, HW = x.shape[0] * x.shape[1], x.shape[2] * x.shape[3]
        b_ms, _ = bound(R * HW * 4 + R * 2 * 4, R * HW * 8)
        print(f"softargmax_rows on the {label} {name} maps {tuple(x.shape)} "
              f"({R} rows): max |kernel - plain| = {e:.3e} px (tol "
              f"{ROWS_TOL}); {time_ms(lambda: softargmax2d_rows(x), 50):.4f}"
              f" ms, plain {time_ms(lambda: plain(x), 20):.4f} ms, bound "
              f"{b_ms:.4f} ms")
        check(e <= ROWS_TOL, f"rows kernel disagrees on the {label} {name} "
              "maps")
        rows_rec["max_abs_err"] = max(rows_rec["max_abs_err"], e)


def fine_tune_path(torch, pred, semantic, observed, base_out, rows_rec):
    """The few-shot fine-tune path at SDD short-term width: mosa_2 on
    positions 0-4, B = 8 at 352 x 480, Adam at lr 1e-3, TRAIN_STEPS steps
    from random weights (seed 0, the same base as `pred`) on bench.py's
    input draws with two padded rows; the rows kernel's launches counted
    over the steps. Then the rows kernel against its plain version on the
    path's own maps, a trace of one more step, and the delta it saved
    served by `pred` as a style. -> ({kernel name: launches over the
    steps} for every kernel wrapper, each counted from 0; the steps' host
    ms)."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import save_params, setup_training

    params = get_params("sdd_shortterm_train.yaml", dict(
        train_net="mosa_2", position=POSITIONS, lr=1e-3))
    mcfg = ynet_config(params)
    H, W, B = 352, 480, 8
    rng = np.random.default_rng(0)  # as bench.py:47-55
    sem = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    total = params["obs_len"] + params["pred_len"]
    lo, hi = 0.2 * min(H, W), 0.6 * min(H, W)
    traj = rng.uniform(lo, hi, size=(B, total, 2))
    mask = np.ones(B)
    mask[-2:] = 0.0  # two padded rows
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
             for k, v in (("semantic", sem), ("traj", traj),
                          ("mask", mask))}
    weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg, "cuda")
    setup = setup_training(weights, params, steps_per_epoch=1)
    step = make_train_step(mcfg, step_config(params))
    flat = io.flatten(weights)
    trained = [k for k, v in flat.items() if v.requires_grad]
    check(trained and all(k.endswith(("lora_A", "lora_B"))
                          for k in trained), "mosa_2 trains other leaves")
    before = {k: v.detach().clone() for k, v in flat.items()}
    print(f"fine-tune: {setup['n_trainable']} trainable parameters in "
          f"{len(trained)} leaves, batch ({B}, {H}, {W}), "
          f"mask {mask.tolist()}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    prev = {k: before[k] for k in trained}
    step_ms = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(weights, state, setup["optimizer"],
                        setup["scheduler"], batch)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        step_ms.append(dt)
        vals = {k: float(v) for k, v in m.items()}
        print(f"fine-tune step {i}: {dt:.1f} ms, " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()),
              f"fine-tune step {i}: non-finite metrics {vals}")
        for k in trained:
            moved = not torch.equal(flat[k], prev[k])
            if k.endswith("lora_B") or i > 0:
                check(moved, f"fine-tune step {i}: {k} did not move")
            else:  # lora_B starts at 0, so lora_A's first gradient is 0
                check(not moved, f"fine-tune step 0: {k} moved")
            prev[k] = flat[k].detach().clone()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"fine-tune path launches: {launches}")
    check(launches["softargmax_rows"] == 2 * TRAIN_STEPS,
          "the rows kernel did not run twice a fine-tune step")
    for name, n in launches.items():
        check(name == "softargmax_rows" or n == 0,
              f"{name} ran on the fine-tune path")
    print(f"fine-tune peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, v in before.items():
        if k not in trained:
            check(torch.equal(flat[k], v), f"frozen leaf {k} changed")
    del before, prev

    check_rows_on_path(torch, "fine-tune", step, weights, state, batch,
                       rows_rec)

    def one_step():
        step(weights, state, setup["optimizer"], setup["scheduler"], batch)
        torch.cuda.synchronize()

    print_trace(torch, "fine-tune step", one_step, conv_ops=8)

    # the loop closes: the delta serves as a style
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mosa_2_finetuned.npz")
        save_params(path, weights, params)
        with np.load(path) as z:
            keys = set(z.files)
        want = {k for k in flat if "lora_" in k}
        check(keys == want and len(want) == 18,
              f"the delta holds {sorted(keys ^ want)[:4]} beyond or short "
              "of the lora_A/lora_B leaves of positions 0-4")
        pred.add_style("fine_tuned", path)
    out = pred.predict(semantic, observed, seed=0, style="fine_tuned")
    tr = out["trajectories"]
    rf = params["resize_factor"]
    check(np.isfinite(tr).all() and (tr >= 0).all()
          and (tr[..., 0] <= (W - 1) / rf).all()
          and (tr[..., 1] <= (H - 1) / rf).all(),
          "the fine-tuned style's trajectories are not finite and inside "
          "the image")
    moved = float(np.abs(tr - base_out["trajectories"]).max())
    print(f"fine-tuned style vs base, same seed: max |difference| = "
          f"{moved:.4f} raw px")
    check(moved > 0, "the fine-tuned delta changed nothing")
    return launches, step_ms


LOOP_SCENE_HW = (1408, 1920)  # raw; x 0.25 -> 352 x 480, the other phases'
LOOP_TRACKS = 36  # a scene; splits of 40 / 16 / 16 tracks
LOOP_B = 8


def loop_params(tmp, flags):
    """(args, params) as the CLIs build them from flags, at the full width
    of sdd_shortterm_train.yaml with the identity backbone's 3 classes."""
    from mst_tpu_torch.config import get_params, get_parser

    args = get_parser(True).parse_args([
        "--config_filename", "sdd_shortterm_train.yaml", "--seed", "1",
        "--batch_size", str(LOOP_B), "--dataset_path", "synth",
        "--load_data", "predefined", "--ckpt_path",
        os.path.join(tmp, "ckpts")] + flags)
    return args, get_params(args=args, overrides={"n_semantic_classes": 3})


def experiment_loop(torch, wrappers, step_ms_6b):
    """Phase 6c: the Experiment loop on the card, driven as the CLIs drive
    it, on in-memory synthetic scenes (2 scenes of 1408 x 1920, so 352 x 480
    after resize_factor 0.25) split 40 / 16 / 16 tracks, B = 8:
    a 2-epoch scratch train run (the base checkpoint), the init check and a
    3-epoch mosa_2 fine-tune on positions 0-4 (n_train_batch 2, steps [1],
    validation with TTST off), then restore_model with base + delta and a
    2-round test with TTST on. Every kernel count is set to 0 before and
    read after, and must equal what the code launches: the rows kernel 2
    a train step (the top-1 metrics) and 1 a TTST test batch (the goal
    point), the fused kernel 1 an eval batch (the decode tail, K in one
    chunk), every other kernel 0. Then a trace of one more fine-tune
    epoch, and the delta served as a Predictor style. -> {kernel: launches}.
    """
    import numpy as np

    from mst_tpu_torch.config import get_experiment_name
    from mst_tpu_torch.data import splits
    from mst_tpu_torch.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch.serve import Predictor
    from mst_tpu_torch.train.trainer import Experiment, restore_model

    t0 = time.perf_counter()
    tracks, images = make_synthetic_dataset(
        seed=0, n_scenes=2, n_traj=LOOP_TRACKS, img_hw=LOOP_SCENE_HW)
    np.random.seed(0)
    train, val, test = splits.dataset_split_by_ratio(tracks, 16, 16,
                                                     shuffle=True)
    train_ft = splits.limit_samples(train, 2, LOOP_B)
    print(f"loop data: {len(train.meta_ids())} / {len(val.meta_ids())} / "
          f"{len(test.meta_ids())} tracks (fine-tune "
          f"{len(train_ft.meta_ids())}), scenes {LOOP_SCENE_HW}, made in "
          f"{time.perf_counter() - t0:.2f} s")

    tmp = tempfile.mkdtemp()
    try:
        scratch_args, scratch = loop_params(tmp, [
            "--train_net", "train", "--n_epoch", "2", "--lr", "1e-4"])
        scratch_name = get_experiment_name(scratch_args,
                                           len(train.meta_ids()))
        base = os.path.join(tmp, "ckpts", scratch_name + ".npz")
        ft_args, ft = loop_params(tmp, [
            "--train_net", "mosa_2", "--position", *POSITIONS,
            "--fine_tune", "--n_train_batch", "2", "--steps", "1",
            "--n_epoch", "3", "--lr", "3e-3", "--pretrained_ckpt", base])
        ft_name = get_experiment_name(ft_args, len(train_ft.meta_ids()))
        delta = os.path.join(tmp, "ckpts", ft_name + ".npz")
        test_params = dict(ft, use_TTST=True, n_round=2)

        # the counts the code gives (batches do not depend on the shuffle)
        probe = Experiment(scratch, images=images)
        n = {name: len(probe.prepare_data(t, None, "val"))
             for name, t in (("train", train), ("train_ft", train_ft),
                             ("val", val), ("test", test))}
        del probe
        want = dict.fromkeys(wrappers, 0)
        want["softargmax_rows"] = (2 * 2 * n["train"] + 2 * 3 * n["train_ft"]
                                   + 2 * n["test"])
        want["fused_predict"] = (2 * n["val"] + 2 * n["test"]
                                 + 3 * n["val"] + 2 * n["test"])
        print(f"loop batches: {n}; expected launches {want}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        runs = {}
        t = time.perf_counter()
        exp = Experiment(scratch, images=images)
        exp.train(train, val, None, None, scratch_name)
        runs["scratch"] = (exp, time.perf_counter() - t)

        model = Experiment(ft, images=images)
        model.load_params(base)
        twin = Experiment(dict(ft, position=[]), images=images)
        twin.load_params(base)
        test_batches = model.prepare_data(test, None, "test")
        t = time.perf_counter()
        ade_pre, fde_pre, _, _ = twin.test(None, None, batches=test_batches)
        ade_cur, fde_cur, _, _ = model.test(None, None, batches=test_batches)
        init_s = time.perf_counter() - t
        print(f"init check: adapter-free {ade_pre!r} / {fde_pre!r}, mosa_2 "
              f"{ade_cur!r} / {fde_cur!r}")
        check(ade_pre == ade_cur and fde_pre == fde_cur,
              "the init check failed: the zero-delta mosa_2 model scores "
              "differently from its adapter-free twin")
        t = time.perf_counter()
        model.train(train_ft, val, None, None, ft_name)
        runs["fine-tune"] = (model, time.perf_counter() - t)

        tested = restore_model(test_params, True, base, delta, images=images)
        t = time.perf_counter()
        avg_ade, avg_fde, rounds, _ = tested.test(None, None,
                                                  batches=test_batches)
        test_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        print(f"loop launches: {launches}")
        check(launches == want, f"the loop launched {launches}, the code "
              f"gives {want}")
        print(f"loop peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        for label, (e, wall) in runs.items():
            print(f"{label}: {wall:.2f} s, data preparation and upload "
                  f"{e.prepare_seconds:.3f} s, best epoch {e.best_epoch}")
            for r in e.epoch_log:
                check(np.isfinite(r["loss"]),
                      f"{label} epoch {r['epoch']}: loss {r['loss']}")
                print(f"  epoch {r['epoch']}: loss {r['loss']:.4f}, train "
                      f"ADE/FDE {r['train_ade']:.3f} / {r['train_fde']:.3f}, "
                      f"val ADE/FDE {r['val_ade']:.3f} / {r['val_fde']:.3f}; "
                      f"{r['n_steps']} steps {r['steps_seconds']:.3f} s "
                      f"({1e3 * r['steps_seconds'] / r['n_steps']:.1f} ms a "
                      f"step), validation {r['val_seconds']:.3f} s "
                      f"({1e3 * r['val_seconds'] / n['val']:.1f} ms a batch)")
        steady = [1e3 * r["steps_seconds"] / r["n_steps"]
                  for r in model.epoch_log[1:]]
        print(f"mean fine-tune step in the loop (epochs 1-2): "
              f"{np.mean(steady):.1f} ms; phase 6b's isolated steps 1-"
              f"{len(step_ms_6b) - 1}: {np.mean(step_ms_6b[1:]):.1f} ms")
        print(f"init check {init_s:.2f} s ({1e3 * init_s / (2 * n['test']):.1f}"
              f" ms a TTST-off test batch); test {test_s:.2f} s "
              f"({1e3 * test_s / (2 * n['test']):.1f} ms a TTST-on batch); "
              f"average ADE/FDE {avg_ade:.3f} / {avg_fde:.3f}, rounds "
              f"{[f'{a:.3f}' for a in tested.eval_ADE]}")
        check(all(np.isfinite(m["ade"]).all() and len(m["ade"]) == 16
                  for m in rounds), "test rows not finite or not 16 a round")
        shrinks = sum(e.n_shrinks for e in (exp, model, twin, tested))
        print(f"eval_k_chunk shrinks: {shrinks}")
        check(shrinks == 0, "the shrink ladder fired")

        # one more fine-tune epoch, traced: a train() call of 1 epoch, whose
        # data preparation and upload run on the host before the epoch
        one = Experiment(dict(ft, n_epoch=1), images=images)
        one.load_params(base)
        traced = print_trace(torch, "fine-tune train() of 1 epoch", lambda: (
            one.train(train_ft, val, None, None, ft_name + "_traced"),
            torch.cuda.synchronize()))
        if traced:
            busy_ms, wall_ms = traced
            r = one.epoch_log[0]
            epoch_ms = 1e3 * (r["steps_seconds"] + r["val_seconds"])
            print(f"traced epoch: steps {1e3 * r['steps_seconds']:.1f} ms + "
                  f"validation {1e3 * r['val_seconds']:.1f} ms; data "
                  f"preparation and upload {1e3 * one.prepare_seconds:.1f} "
                  f"ms before it; the rest of the call (set-up, saves) "
                  f"{wall_ms - epoch_ms - 1e3 * one.prepare_seconds:.1f} ms;"
                  f" kernels over the epoch's wall time "
                  f"{100 * busy_ms / epoch_ms:.0f}%")

        # the delta: LoRA leaves only, served as a style
        with np.load(delta) as z:
            keys = set(z.files)
        check(keys and all(k.rsplit("/", 1)[-1] in ("lora_A", "lora_B")
                           for k in keys),
              f"the delta holds other leaves: {sorted(keys)[:4]}")
        pred = Predictor(dict(test_params, train_net="mosa_2"), base,
                         seed=0)
        pred.add_style("loop", delta)
        b = tested.prepare_data(test, None, "test")[0]
        obs = b.trajectories[:, :scratch["obs_len"]]
        outs = [pred.predict(b.image[None], obs, seed=0, style=s)
                for s in (None, "loop")]
        moved = float(np.abs(outs[1]["trajectories"]
                             - outs[0]["trajectories"]).max())
        check(all(np.isfinite(o["trajectories"]).all() for o in outs),
              "the loop's style gives non-finite trajectories")
        print(f"the loop's delta ({len(keys)} LoRA leaves) as a Predictor "
              f"style vs the base, same seed: max |difference| = "
              f"{moved:.4f} raw px")
        check(moved > 0, "the loop's delta changed nothing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


FUSION_POS = ["scene", "motion", "fusion"]
# Y-Net-Mod as the paper's inD scripts run it (tune_mosa_S_A_F.sh): the
# fusion encoder with 2 fused stages, MoSA rank 1 in every branch
YMOD = dict(network="fusion", n_fusion=2, train_net="mosa_1",
            position=FUSION_POS)
YMOD_HW, YMOD_B, YMOD_LR = (320, 576), 10, 5e-3  # bench.py:41's ind shape
YMOD_STEPS = 5
# the small-width card-against-CPU cases: (label, flags)
VARIANT_CASES = (("mosa_1 on scene motion fusion", YMOD),
                 ("parallelLayer_3x3 on 0-4",
                  dict(train_net="parallelLayer_3x3", position=POSITIONS)),
                 ("serial on 1-2", dict(train_net="serial",
                                        position=["1", "2"])))
STATE_TOL = 1e-3  # the serial BN state, card against CPU, of each leaf's max


def small_variant_reference(torch):
    """Phase 6d's first part: each of VARIANT_CASES at the CPU tests' width
    (inD long-term steps: obs 5, pred 30; 64 x 96, B = 4 with a padded
    row) from the same seeded weights, three Adam steps (lr 1e-3) on the
    card and on the CPU: the losses, and the BN state the steps return;
    then one eval batch of the CPU's trained weights and state on both,
    the card's waypoint draws decoded on both. -> the largest relative
    loss difference, the largest state difference relative to each leaf's
    max, and the largest trajectory difference (model px)."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet, tree_map
    from mst_tpu_torch.train.steps import make_eval_step, make_train_step
    from mst_tpu_torch.train.trainer import setup_training

    rng = np.random.default_rng(0)
    batch = {"semantic": rng.normal(size=(1, 64, 96, 6)),
             "traj": rng.uniform(5, 60, size=(4, 35, 2)),
             "mask": np.array([1.0, 1.0, 1.0, 0.0])}
    loss_err = state_err = traj_err = 0.0
    for label, flags in VARIANT_CASES:
        params = get_params("inD_longterm_train.yaml", dict(
            encoder_channels=[8, 8, 16, 16, 16],
            decoder_channels=[16, 16, 16, 8, 8], lr=1e-3, **flags))
        mcfg = ynet_config(params)
        runs = {}
        for dev in ("cuda", "cpu"):
            weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg,
                                       dev)
            setup = setup_training(weights, params, steps_per_epoch=1)
            step = make_train_step(mcfg, step_config(params))
            b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
            losses = []
            for _ in range(3):
                state, m = step(weights, state, setup["optimizer"],
                                setup["scheduler"], b)
                losses.append([float(m[k]) for k in LOSS_KEYS])
            runs[dev] = (weights, state, b, losses)
        (_, s_gpu, b_gpu, l_gpu), (w_cpu, s_cpu, b_cpu, l_cpu) = \
            runs["cuda"], runs["cpu"]
        rel = max(abs(a - c) / abs(c) for ra, rc in zip(l_gpu, l_cpu)
                  for a, c in zip(ra, rc))
        st_gpu, st_cpu = io.state_to_numpy(s_gpu), io.state_to_numpy(s_cpu)
        check(st_gpu.keys() == st_cpu.keys()
              and bool(st_cpu) == (label.startswith("serial")),
              f"{label}: the state's leaves {sorted(st_gpu)[:3]}")
        st = max([float(np.abs(st_gpu[k] - v).max()
                        / max(np.abs(v).max(), 1e-12))
                  for k, v in st_cpu.items()] + [0.0])
        check(all(int(st_gpu[k]) == 3 for k in st_gpu
                  if k.endswith("num_batches")), f"{label}: num_batches")
        # one eval batch: the CPU's trained weights and state on both
        es = make_eval_step(mcfg, step_config(params))
        w_gpu, s_gpu = (tree_map(lambda t: t.detach().cuda(), tree)
                        for tree in (w_cpu, s_cpu))
        with torch.no_grad():
            feats, wps = es.forward(
                w_gpu, s_gpu, b_gpu, torch.Generator(device="cuda")
                .manual_seed(0))
            got = es.decode_trajs(w_gpu, feats, wps).cpu()
            feats_cpu, _ = es.forward(w_cpu, s_cpu, b_cpu, torch.Generator())
            want = es.decode_trajs(w_cpu, feats_cpu, wps.cpu())
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite eval")
        tr = float((got - want).abs().max())
        print(f"small-width {label}: losses card {l_gpu[-1]}, cpu "
              f"{l_cpu[-1]} (step 2); max relative |card - cpu| loss "
              f"{rel:.3e}, state {st:.3e} ({len(st_cpu)} leaves), eval "
              f"trajectories {tr:.3e} model px")
        loss_err, state_err, traj_err = (max(loss_err, rel),
                                         max(state_err, st),
                                         max(traj_err, tr))
    return loss_err, state_err, traj_err


def ynet_mod_path(torch, wrappers, card, rows_rec):
    """Phase 6d's full-width part: Y-Net-Mod (inD_longterm_train.yaml's
    width, YMOD) from random weights (seed 0). YMOD_STEPS mosa_1 steps
    with Adam at YMOD_LR on B = YMOD_B at YMOD_HW (bench.py:47-55's draws,
    one padded row); the delta saved and added as a style to a fusion
    Predictor (inD_longterm_eval.yaml: K = 20, TTST off); 5 requests of
    B = YMOD_B, 4 styled and 1 base. Every kernel's count is set to 0
    before the steps and read after the requests: the rows kernel twice
    a step, the fused kernel once a request, the others never. Then the
    fused kernel at P = 30 against its plain version on the path's own
    operands, timed, and a torch.profiler trace of one more step and one
    more request. The rows kernel against its plain version on a step's
    own maps (B * pred_len and B rows), its error into rows_rec. ->
    ({kernel: launches}, that timing)."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.serve import Predictor
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import save_params, setup_training

    params = get_params("inD_longterm_train.yaml", dict(YMOD, lr=YMOD_LR))
    mcfg = ynet_config(params)
    (H, W), B = YMOD_HW, YMOD_B
    rng = np.random.default_rng(0)
    sem = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    total = params["obs_len"] + params["pred_len"]
    lo, hi = 0.2 * min(H, W), 0.6 * min(H, W)
    traj = rng.uniform(lo, hi, size=(B, total, 2))
    mask = np.ones(B)
    mask[-1] = 0.0
    batch = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
             for k, v in (("semantic", sem), ("traj", traj),
                          ("mask", mask))}
    weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg, "cuda")
    check(state == {}, "Y-Net-Mod with mosa_1 has a model state")
    setup = setup_training(weights, params, steps_per_epoch=1)
    step = make_train_step(mcfg, step_config(params))
    flat = io.flatten(weights)
    trained = [k for k, v in flat.items() if v.requires_grad]
    check(trained and all(k.endswith(("lora_A", "lora_B"))
                          and k.split("/")[1] in ("scene_stages",
                                                  "motion_stages",
                                                  "fusion_stages")
                          for k in trained),
          f"mosa_1 on {FUSION_POS} trains {trained[:3]}")
    pred = Predictor(get_params("inD_longterm_eval.yaml", YMOD), seed=0)
    logits = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    semantic = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    start = rng.uniform([100, 80], [W - 100, H - 80], size=(B, 1, 2))
    walk = rng.normal(scale=3.0, size=(B, params["obs_len"], 2))
    observed = (start + np.cumsum(walk, axis=1)).astype(np.float32)
    print(f"Y-Net-Mod: {setup['n_trainable']} trainable parameters in "
          f"{len(trained)} leaves, batch ({B}, {H}, {W}), mask "
          f"{mask.tolist()}, lr {YMOD_LR}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    prev = {k: flat[k].detach().clone() for k in trained}
    step_ms = []
    for i in range(YMOD_STEPS):
        t0 = time.perf_counter()
        state, m = step(weights, state, setup["optimizer"],
                        setup["scheduler"], batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        vals = {k: float(v) for k, v in m.items()}
        print(f"Y-Net-Mod step {i}: {step_ms[-1]:.1f} ms, " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()),
              f"Y-Net-Mod step {i}: non-finite metrics {vals}")
        for k in trained:
            moved = not torch.equal(flat[k], prev[k])
            if k.endswith("lora_B") or i > 0:
                check(moved, f"Y-Net-Mod step {i}: {k} did not move")
            prev[k] = flat[k].detach().clone()
    train_peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ymod_mosa_1.npz")
        save_params(path, weights, params)
        with np.load(path) as z:
            keys = set(z.files)
        check(keys == set(trained), "the delta is not the trained leaves")
        pred.add_style("ymod", path)
    torch.cuda.reset_peak_memory_stats()
    request_ms, outs = [], []
    rf = params["resize_factor"]
    for label, seed, style in (("request 0, style", 0, "ymod"),
                               ("request 1, style", 1, "ymod"),
                               ("request 2, style", 2, "ymod"),
                               ("request 3, style", 3, "ymod"),
                               ("request 4, base", 0, None)):
        t0 = time.perf_counter()
        out = pred.predict(semantic, observed, seed=seed, style=style)
        request_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
        tr = out["trajectories"]
        print(f"Y-Net-Mod {label}: {request_ms[-1]:.1f} ms, trajectories "
              f"{tr.shape}")
        check(tr.shape == (20, B, params["pred_len"], 2), f"{label}: shape")
        check(np.isfinite(tr).all() and (tr >= 0).all()
              and (tr[..., 0] <= (W - 1) / rf).all()
              and (tr[..., 1] <= (H - 1) / rf).all(),
              f"{label}: trajectories not finite or outside the image")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"Y-Net-Mod path launches: {launches}")
    want = dict.fromkeys(wrappers, 0)
    want.update(softargmax_rows=2 * YMOD_STEPS, fused_predict=5)
    check(launches == want, f"the Y-Net-Mod path launched {launches}, the "
          f"code gives {want}")
    moved = float(np.abs(outs[0]["trajectories"]
                         - outs[4]["trajectories"]).max())
    print(f"Y-Net-Mod style vs base, same seed: max |difference| = "
          f"{moved:.4f} raw px")
    check(moved > 0, "the Y-Net-Mod delta changed nothing")
    check_rows_on_path(torch, "Y-Net-Mod", step, weights, state, batch,
                       rows_rec)
    print(f"Y-Net-Mod ({card}): steps {[round(t, 1) for t in step_ms]} ms "
          f"(steps 1-{YMOD_STEPS - 1} mean {np.mean(step_ms[1:]):.1f} ms), "
          f"requests {[round(t, 1) for t in request_ms]} ms (1-4 mean "
          f"{np.mean(request_ms[1:]):.1f} ms); peak device memory "
          f"{train_peak / 2**30:.2f} GiB training, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB serving")

    def one_step():
        step(weights, state, setup["optimizer"], setup["scheduler"], batch)
        torch.cuda.synchronize()

    print_trace(torch, "Y-Net-Mod step", one_step, conv_ops=8)
    del weights, setup, step, prev, flat
    print_trace(torch, "Y-Net-Mod request", lambda: pred.predict(
        semantic, observed, seed=5, style="ymod"))
    err, rec = check_path_tail(torch, pred, semantic, observed, seed=0,
                               timed=True)
    rec["max_abs_err"] = err
    return launches, rec


# ---- phase 8: the deployment path
DEPLOY_TOL = 1e-4  # raw px: the model directory and the daemon against a
# direct predict of the same weights, rows and seed on the same card
DEPLOY_REQUESTS = 10  # a client
DEPLOY_CLIENTS = 8
DEPLOY_BENCH = 5  # check --bench N


def http_request(port, path, payload=None, method=None, expect=(200,)):
    """One request to the daemon -> (status, JSON body, headers, host
    seconds); a status outside `expect` fails the run."""
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body, headers = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        code, body, headers = e.code, e.read(), e.headers
    dt = time.perf_counter() - t0
    out = json.loads(body)
    check(code in expect, f"{method or 'GET/POST'} {path}: HTTP {code} "
          f"{out}")
    return code, out, headers, dt


def start_server(**kw):
    """run_server in a thread on port 0 -> (ready, thread): ready.server
    and ready.batcher. A failure to start fails the run."""
    import threading

    from mst_tpu_torch.serve_http import run_server

    ready, failed = threading.Event(), []

    def serve():
        try:
            run_server(port=0, ready_event=ready, **kw)
        except BaseException as e:  # handed to the main thread below
            failed.append(e)
            ready.set()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    check(ready.wait(timeout=300), "the daemon did not start")
    if failed:
        raise failed[0]
    return ready, thread


def stop_server(ready, thread):
    ready.server.shutdown()
    ready.batcher.stop()
    thread.join(timeout=60)
    check(not thread.is_alive(), "the daemon's thread did not stop")


def check_in_image(label, a, H, W, rf):
    import numpy as np

    check(np.isfinite(a).all(), f"{label}: non-finite values")
    check((a >= 0).all() and (a[..., 0] <= (W - 1) / rf).all()
          and (a[..., 1] <= (H - 1) / rf).all(), f"{label}: outside the "
          "image")


def pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serial_state_check(torch, tmp):
    """A small-width serial model (phase 6d's, inD long-term on positions
    1-2) with every adapter leaf nonzero and its BN statistics moved,
    exported and loaded on the card and on the CPU: the card's waypoint
    draws decoded on both (trajectories within FUSED_TOL), and by the same
    weights with init_ynet's statistics, which must differ by over 10x
    FUSED_TOL. -> (card against CPU, moved by the state), raw px."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params
    from mst_tpu_torch.models.ynet import is_adapter_leaf
    from mst_tpu_torch.serve import LoadedModel, export_model
    from mst_tpu_torch.train.trainer import Experiment

    params = get_params("inD_longterm_eval.yaml", dict(
        encoder_channels=[8, 8, 16, 16, 16],
        decoder_channels=[16, 16, 16, 8, 8], train_net="serial",
        position=["1", "2"], n_goal=5, seed=0))
    exp = Experiment(params, device="cpu")
    rng = np.random.default_rng(0)
    flat = io.params_to_numpy(exp.model_params)
    for k, v in flat.items():
        if is_adapter_leaf(k):
            flat[k] = rng.normal(size=v.shape).astype(np.float32)
            if k.endswith("bn/weight"):
                flat[k] += 1.0
    init_state = exp.model_state
    st = io.state_to_numpy(init_state)
    for k, v in st.items():
        if k.endswith("running_mean"):
            st[k] = rng.normal(scale=2.0, size=v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            st[k] = rng.uniform(0.05, 0.5, size=v.shape).astype(np.float32)
        else:
            st[k] = np.full(v.shape, 3, v.dtype)
    exp.model_params = io.params_from_numpy(flat)
    exp.model_state = io.state_from_numpy(st)
    export_model(exp, f"{tmp}/serial", 64, 96, 4)
    exp.model_state = init_state
    export_model(exp, f"{tmp}/serial_init", 64, 96, 4)
    card = LoadedModel(f"{tmp}/serial", device="cuda")
    cpu = LoadedModel(f"{tmp}/serial", device="cpu")
    init = LoadedModel(f"{tmp}/serial_init", device="cpu")
    check(len(io.flatten(card.state)) == len(st) == 6,
          f"the serial model's state: {sorted(io.flatten(card.state))}")
    semantic = rng.normal(size=(1, 64, 96, 6))
    observed = rng.uniform(10, 50, size=(4, params["obs_len"], 2))
    feats, wps = card.forward(semantic, observed, seed=0)
    got = card.decode(feats, wps).cpu()
    check(bool(torch.isfinite(got).all()), "serial: non-finite trajectories")
    want = cpu.decode(cpu.forward(semantic, observed)[0], wps.cpu())
    other = init.decode(init.forward(semantic, observed)[0], wps.cpu())
    return float((got - want).abs().max()), float((other - want).abs().max())


# fused_predict on two streams at once: (R, H, W, C, P, launches a stream);
# the eval decode tail's shape, and a short one whose blocks interleave
ARRIVAL_CASES = ((160, 352, 480, 32, 12, 8), (8, 32, 48, 32, 12, 200))
GATE_CYCLES = 10**9  # the gate kernel's spin: about 0.5 s at the H100's clock


def check_stream_arrivals(torch):
    """fused_predict's arrival counters with the overlap made certain on
    the device: a gate kernel on a third stream holds the default stream
    and a side stream, each with its launches queued behind one event and
    no host sync between them, so that when the gate opens both streams
    run their launches together. Every output is held against the plain
    version (FUSED_TOL); the gate must still be shut when the last launch
    is queued, and the profiler's trace must show launches of the two
    streams whose device intervals overlap. Counters shared by the two
    streams (one buffer a device) make outputs wrong here."""
    from torch.profiler import ProfilerActivity, profile

    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)

    g = torch.Generator(device="cuda").manual_seed(9)
    main, gate, side = (torch.cuda.current_stream(), torch.cuda.Stream(),
                        torch.cuda.Stream())
    for R, H, W, C, P, n in ARRIVAL_CASES:
        inputs = [(torch.randn((R, H, W, C), generator=g,
                               device="cuda").relu_(),
                   torch.randn((C, P), generator=g, device="cuda") * 0.3,
                   torch.randn((P,), generator=g, device="cuda"))
                  for _ in range(2)]
        want = [fused_predictor_softargmax_plain(*a) for a in inputs]
        for stream, args in zip((main, side), inputs):
            with torch.cuda.stream(stream):  # each stream's counters made
                fused_predictor_softargmax(*args)
        outs = ([], [])
        opened = torch.cuda.Event()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(gate):
                torch.cuda._sleep(GATE_CYCLES)
                opened.record()
            main.wait_event(opened)
            side.wait_event(opened)
            t0 = time.perf_counter()
            for _ in range(n):
                for out, stream, args in zip(outs, (main, side), inputs):
                    with torch.cuda.stream(stream):
                        out.append(fused_predictor_softargmax(*args))
            t_issue = time.perf_counter() - t0
            shut = not opened.query()
            torch.cuda.synchronize()
        errs = [float((o - w).abs().max()) for out, w in zip(outs, want)
                for o in out]
        wrong = sum(not e <= FUSED_TOL for e in errs)  # a NaN is wrong
        spans = {}
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() == torch.autograd.DeviceType.CUDA
                    and "fused_predict_kernel" in e.name()):
                spans.setdefault(e.device_resource_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        a, b = (list(spans.values()) + [[], []])[:2]
        overlapping = sum(any(s0 < e1 and s1 < e0 for s1, e1 in a)
                          for s0, e0 in b)
        print(f"fused_predict on two streams gated on one event, "
              f"{(R, H, W, C)} x ({C}, {P}), {n} launches a stream: "
              f"queued in {t_issue * 1e3:.1f} ms, the gate "
              f"{'still shut' if shut else 'already open'}; the trace: "
              f"{[len(v) for v in spans.values()]} launches on "
              f"{len(spans)} stream(s), {overlapping} of one stream's "
              f"overlapping one of the other's; {wrong} of {len(errs)} "
              f"outputs off the plain version (max |difference| "
              f"{max(errs):.3e} px, tol {FUSED_TOL})")
        check(wrong == 0, "fused_predict on two streams disagrees with its "
              "plain version: the streams share arrival counters")
        check(shut and len(spans) == 2 and overlapping > 0,
              "the two streams' launches were not shown to overlap")
        del inputs, want, outs
    torch.cuda.empty_cache()


def deployment_path(torch, wrappers, card, semantic, observed, delta):
    """Phase 8: the deployment path at phase 5's width (sdd_shortterm_eval
    with TTST, mosa_2 on 0-4, K = 20, B = 8 at 352 x 480, random weights
    from seed 0, phase 5's scene map, rows and LoRA delta). Export from an
    Experiment, LoadedModel against Predictor, the HTTP daemon under one
    and DEPLOY_CLIENTS clients (every full-B response against a direct
    predict; both serving kernels launched once a dispatch, every count
    zeroed before the traffic and read after), a direct predict on a side
    stream during a dispatch, fused_predict on two streams gated on one
    event (check_stream_arrivals), an overload burst at max_queue 2, max_styles
    2, the memory of two resident styles, check --bench, and the serial
    state check. -> {kernel name: launches over the daemon's traffic}."""
    import threading

    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params
    from mst_tpu_torch.serve import LoadedModel, Predictor, export_model
    from mst_tpu_torch.serve import check as serve_check
    from mst_tpu_torch.train.trainer import Experiment

    semantic = semantic.astype(np.float32)
    B, (H, W) = observed.shape[0], semantic.shape[1:3]
    tmp = tempfile.mkdtemp(prefix="mst_deploy_")
    try:
        params = get_params("sdd_shortterm_eval.yaml", dict(
            use_TTST=True, train_net="mosa_2", position=POSITIONS, seed=0))
        rf = params["resize_factor"]
        mdir, delta_path = f"{tmp}/model", f"{tmp}/mosa_2_style.npz"
        np.savez(delta_path, **delta)
        # ---- 1. export, load, against Predictor
        t0 = time.perf_counter()
        export_model(Experiment(params), mdir, H, W, B)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = LoadedModel(mdir)
        t_load = time.perf_counter() - t0
        model.add_style("mosa_2", delta_path)
        pred = Predictor(params, seed=0)
        pred.add_style("mosa_2", delta_path)
        sizes = {f: os.path.getsize(f"{mdir}/{f}") for f in sorted(
            os.listdir(mdir))}
        err = 0.0
        for seed, style in ((0, None), (1, "mosa_2")):
            a = model.predict(semantic, observed, seed=seed, style=style)
            b = pred.predict(semantic, observed, seed=seed, style=style)
            err = max([err] + [float(np.abs(a[k] - b[k]).max()) for k in a])
        print(f"deploy: export {t_export:.2f} s {sizes}, load "
              f"{t_load:.2f} s; LoadedModel against Predictor (2 requests, "
              f"one styled): max |difference| = {err:.3e} raw px (tol "
              f"{DEPLOY_TOL})")
        check(err <= DEPLOY_TOL, "the model directory serves other "
              "predictions than the Predictor")
        del pred, a, b

        # ---- 2. the daemon
        scene_path = f"{tmp}/scene.npy"
        np.save(scene_path, semantic)
        ready, thread = start_server(
            model_dir=mdir, styles=[f"mosa_2={delta_path}"],
            scenes=[f"sdd={scene_path}"], max_wait_ms=5.0)
        port, batcher = ready.server.server_address[1], ready.batcher
        _, health, _, _ = http_request(port, "/healthz")
        check(health["batch_size"] == B and health["styles"] == ["mosa_2"]
              and health["scenes"] == ["sdd"], f"healthz: {health}")

        # the dispatcher's predicts on the host clock (each ends in the
        # host copy), to split an HTTP request's latency
        dispatch_s, served_predict = [], batcher.model.predict

        def timed_predict(*args, **kw):
            t0 = time.perf_counter()
            out = served_predict(*args, **kw)
            dispatch_s.append(time.perf_counter() - t0)
            return out

        batcher.model.predict = timed_predict

        # ---- 3. traffic, every kernel's count zeroed before and read after
        rng = np.random.default_rng(8)
        for w in wrappers.values():
            w.launches = 0
        full, lat1 = [], []
        for i in range(DEPLOY_REQUESTS):
            rows = (observed + rng.normal(scale=2.0, size=observed.shape)
                    ).astype(np.float32)
            style = "mosa_2" if i % 2 else None
            _, out, _, dt = http_request(port, "/predict", {
                "scene": "sdd", "observed": rows.tolist(), "seed": 100 + i,
                "style": style})
            lat1.append(dt)
            full.append((rows, 100 + i, style, out))
        d1, rows1 = batcher.dispatches, batcher.dispatched_rows
        dispatch1 = list(dispatch_s)
        lat8, results, lock = [], [], threading.Lock()

        def client(c):
            crng = np.random.default_rng(100 + c)
            for r in range(DEPLOY_REQUESTS):
                n = 1 + (c + r) % 2
                j = crng.integers(0, B - n + 1)
                rows = (observed[j:j + n] + crng.normal(
                    scale=2.0, size=(n,) + observed.shape[1:])
                        ).astype(np.float32)
                _, out, _, dt = http_request(port, "/predict", {
                    "scene": "sdd", "observed": rows.tolist(),
                    "seed": (c + r) % 2,
                    "style": "mosa_2" if c % 2 else None})
                with lock:
                    lat8.append(dt)
                    results.append((n, out))

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(DEPLOY_CLIENTS)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
            check(not th.is_alive(), "a client did not finish")
        t8 = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        dispatches = batcher.dispatches
        check(len(results) == DEPLOY_CLIENTS * DEPLOY_REQUESTS,
              f"{len(results)} of the clients' requests answered")
        print(f"deploy: {dispatches} dispatches ({d1} for the 1-client "
              f"requests, {dispatches - d1} for the {len(results)} "
              f"8-client ones), launches {launches}")
        check(launches["softargmax_rows"] == launches["fused_predict"]
              == dispatches > 0 and not any(
                  v for k, v in launches.items()
                  if k not in ("softargmax_rows", "fused_predict")),
              "the serving kernels' launches are not one each a dispatch")

        # ---- after the counts: every response against a direct predict
        for n, out in results:
            for k in ("trajectories", "waypoints"):
                a = np.asarray(out[k])
                check(a.shape[0] == n, f"8 clients: {k} {a.shape}")
                check_in_image(f"8 clients: {k}", a, H, W, rf)
        err, lat_direct = 0.0, []
        for rows, seed, style, out in full:
            t0 = time.perf_counter()
            direct = model.predict(semantic, rows, seed=seed, style=style)
            lat_direct.append(time.perf_counter() - t0)
            for k in ("trajectories", "waypoints"):
                a = np.asarray(out[k])
                check_in_image(f"1 client: {k}", a, H, W, rf)
                err = max(err, float(np.abs(
                    a - np.moveaxis(direct[k], 1, 0)).max()))
        print(f"deploy: {len(full)} full-B HTTP responses against direct "
              f"predict: max |difference| = {err:.3e} raw px (tol "
              f"{DEPLOY_TOL})")
        check(err <= DEPLOY_TOL, "the daemon disagrees with direct predict")
        print(f"deploy timings ({card}): HTTP latency 1 client p50 "
              f"{pct(lat1, 50):.1f} ms p95 {pct(lat1, 95):.1f} ms; "
              f"{DEPLOY_CLIENTS} clients p50 {pct(lat8, 50):.1f} ms p95 "
              f"{pct(lat8, 95):.1f} ms; direct predict p50 "
              f"{pct(lat_direct, 50):.1f} ms p95 {pct(lat_direct, 95):.1f}"
              f" ms; {DEPLOY_CLIENTS} clients: {len(results) / t8:.2f} "
              f"requests/s, "
              f"{(batcher.dispatched_rows - rows1) / (dispatches - d1):.2f}"
              f" rows a dispatch ({dispatches - d1} dispatches in "
              f"{t8:.2f} s); 1 client: {rows1 / d1:.2f} rows a dispatch")
        t0 = time.perf_counter()
        json.dumps(full[0][3])
        t_json = time.perf_counter() - t0
        print("deploy, 1 client, request by request (ms): HTTP "
              f"{[round(x * 1e3, 1) for x in lat1]}, the dispatcher's "
              f"predict {[round(x * 1e3, 1) for x in dispatch1]}, direct "
              f"predict {[round(x * 1e3, 1) for x in lat_direct]}; median "
              "HTTP - dispatcher's predict "
              f"{pct(np.subtract(lat1, dispatch1), 50):.1f} ms, median "
              "dispatcher's predict - direct "
              f"{pct(np.subtract(dispatch1, lat_direct), 50):.1f} ms; "
              f"json.dumps of a full-B response {t_json * 1e3:.2f} ms")

        # ---- a direct predict on a side stream during a dispatch
        side = torch.cuda.Stream()
        err, overlap = 0.0, []
        for i in range(3):
            rows_h, rows_s = full[i][0], full[i + 3][0]
            box = {}

            def request():
                box["t0"] = time.perf_counter()
                box["out"] = http_request(port, "/predict", {
                    "scene": "sdd", "observed": rows_h.tolist(),
                    "seed": 500 + i})[1]
                box["t1"] = time.perf_counter()

            th = threading.Thread(target=request)
            th.start()
            while batcher.depth() == 0 and th.is_alive():
                time.sleep(0.001)
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                on_side = model.predict(semantic, rows_s, seed=600 + i)
            t1 = time.perf_counter()
            th.join(timeout=300)
            check(not th.is_alive(), "the side-stream request hung")
            overlap.append(min(t1, box["t1"]) - max(t0, box["t0"]))
            serial_s = model.predict(semantic, rows_s, seed=600 + i)
            serial_h = model.predict(semantic, rows_h, seed=500 + i)
            for k in ("trajectories", "waypoints"):
                err = max(err, float(np.abs(on_side[k] - serial_s[k]).max()),
                          float(np.abs(np.asarray(box["out"][k]) - np.moveaxis(
                              serial_h[k], 1, 0)).max()))
        print(f"deploy: direct predict on a side stream during a dispatch "
              f"(overlap on the host clock "
              f"{', '.join(f'{o * 1e3:.0f}' for o in overlap)} ms):"
              f" max |difference| from the serial runs = {err:.3e} raw px "
              f"(tol {DEPLOY_TOL})")
        check(err <= DEPLOY_TOL and max(overlap) > 0, "a side-stream predict "
              "and a dispatch disagree with their serial runs")
        stop_server(ready, thread)
        # the same kernel on two streams, the overlap certain on the device
        check_stream_arrivals(torch)

        # ---- 4. overload at max_queue 2, and max_styles 2
        ready, thread = start_server(
            model_dir=mdir, scenes=[f"sdd={scene_path}"], max_wait_ms=5.0,
            max_queue=2, max_styles=2)
        port = ready.server.server_address[1]
        codes, retry = [], []
        barrier = threading.Barrier(DEPLOY_CLIENTS)

        def burst(c):
            barrier.wait(timeout=60)
            code, _, headers, _ = http_request(
                port, "/predict", {"observed": observed.tolist(), "seed": c},
                expect=(200, 503))
            with lock:
                codes.append(code)
                retry.append(headers.get("Retry-After"))

        clients = [threading.Thread(target=burst, args=(c,))
                   for c in range(DEPLOY_CLIENTS)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
            check(not th.is_alive(), "a burst client did not finish")
        shed = [r for c, r in zip(codes, retry) if c == 503]
        print(f"deploy: burst of {DEPLOY_CLIENTS} at max_queue 2: "
              f"{codes.count(200)} answered, {len(shed)} shed with 503 "
              f"(Retry-After {set(shed)})")
        check(len(shed) > 0 and codes.count(200) > 0
              and set(shed) == {"1"}, "the burst was not shed with 503s")
        evicted = [http_request(port, f"/styles/{name}",
                                {"delta_path": delta_path})[1]
                   for name in ("a", "b", "c")]
        print(f"deploy: max_styles 2, registrations a, b, c: evicted "
              f"{[e['evicted'] for e in evicted]}, resident "
              f"{evicted[-1]['styles']}")
        check([e["evicted"] for e in evicted] == [[], [], ["a"]]
              and evicted[-1]["styles"] == ["b", "c"],
              "max_styles did not evict the oldest style")
        stop_server(ready, thread)

        # ---- 5. memory: the base, then two styles resident
        del model
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        model = LoadedModel(mdir)
        m1 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.predict(semantic, observed, seed=0)
        peak_base = torch.cuda.max_memory_allocated()
        model.add_style("a", delta_path)
        model.add_style("b", delta_path)
        m2 = torch.cuda.memory_allocated()
        base, styled = io.flatten(model.params), io.flatten(
            model._styles["a"])
        shared = sum(styled[k] is v for k, v in base.items())
        torch.cuda.reset_peak_memory_stats()
        model.predict(semantic, observed, seed=0, style="a")
        peak_styles = torch.cuda.max_memory_allocated()
        delta_bytes = sum(v.nbytes for v in delta.values())
        print(f"deploy memory: base weights and state {(m1 - m0) / 2**20:.2f}"
              f" MiB, two styles +{(m2 - m1) / 2**20:.3f} MiB (deltas "
              f"{2 * delta_bytes / 2**20:.3f} MiB; {shared} of {len(base)} "
              f"tensors shared); peak over a request "
              f"{peak_base / 2**30:.3f} GiB with the base alone, "
              f"{peak_styles / 2**30:.3f} GiB with two styles resident")
        check(shared == len(base) - len(delta)
              and m2 - m1 <= 2 * delta_bytes + 2**20
              and peak_styles - peak_base <= 4 * 2**20,
              "a style costs more than its delta")

        # ---- 6. check --bench, in-process
        stats = serve_check(model, seed=0, bench=DEPLOY_BENCH)
        print(f"deploy: check --bench {DEPLOY_BENCH} ({card}): "
              f"{stats['traj_per_sec']} traj/s closed loop, "
              f"{stats['pipelined_traj_per_sec']} pipelined")
        del model
        torch.cuda.empty_cache()

        # ---- 7. the state of a serial model
        err, moved = serial_state_check(torch, tmp)
        print(f"deploy: serial model directory, card against CPU: max "
              f"|difference| = {err:.3e} raw px (tol {FUSED_TOL}); the "
              f"init statistics move it by {moved:.3f} raw px (must exceed "
              f"{10 * FUSED_TOL})")
        check(err <= FUSED_TOL and moved > 10 * FUSED_TOL,
              "the serial model's exported state is not what it serves")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print_optional_packages()
    resolve_device("cuda")  # TF32 off for the f32 path

    # ---- 2. build
    t0 = time.perf_counter()
    sources = ["fused_predict", "softargmax_rows", "conv3x3", "decoder_chain"]
    print_ptxas(_build.build(sources))
    print(f"build: nvcc {', '.join(s + '.cu' for s in sources)} in "
          f"parallel, {time.perf_counter() - t0:.1f} s")
    print_smem()
    check_splits()

    # ---- 3. kernels against their plain versions
    records = [check_rows_kernel(torch), check_fused_kernel(torch)]
    for r in records:
        print(f"{r['name']}: {r['ms']:.4f} ms (device {r['device_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
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
        for name, a in (("trajectories", tr), ("waypoints", wp)):
            check_in_image(f"{label}: {name}", a, H, W,
                           params["resize_factor"])
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

    # ---- 6b. the fine-tune path: card against CPU at small width, then
    # TRAIN_STEPS full-width mosa_2 steps whose delta `base` serves
    t0 = time.perf_counter()
    err = small_train_reference(torch)
    print(f"small-width fine-tune: max relative |card - cpu| loss = "
          f"{err:.3e} (tol {TRAIN_TOL})")
    check(err <= TRAIN_TOL, "the fine-tune step on the card disagrees with "
          "the CPU")
    rows_rec = next(r for r in records if r["name"] == "softargmax_rows")
    train_launches, step_ms = fine_tune_path(torch, base, semantic, observed,
                                             outs[0], rows_rec)
    print(f"fine-tune phase: {time.perf_counter() - t0:.1f} s")

    # ---- 6c. the Experiment loop: scratch train, fine-tune, test
    del base
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loop_launches = experiment_loop(torch, kernel_wrappers(), step_ms)
    print(f"loop phase: {time.perf_counter() - t0:.1f} s")

    # ---- 6d. Y-Net-Mod: card against CPU at small width for three
    # strategies, then the fusion network at full width
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_err, state_err, traj_err = small_variant_reference(torch)
    print(f"small-width variants: max relative |card - cpu| loss = "
          f"{loss_err:.3e} (tol {TRAIN_TOL}), state {state_err:.3e} (tol "
          f"{STATE_TOL}), eval trajectories {traj_err:.3e} model px (tol "
          f"{FUSED_TOL})")
    check(loss_err <= TRAIN_TOL and state_err <= STATE_TOL
          and traj_err <= FUSED_TOL,
          "a variant on the card disagrees with the CPU")
    ymod_launches, ymod_tail = ynet_mod_path(torch, kernel_wrappers(), card,
                                             rows_rec)
    fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"],
                                   ymod_tail["max_abs_err"])
    print(f"Y-Net-Mod phase: {time.perf_counter() - t0:.1f} s")

    # ---- 7. the probe paths: the conv and decoder-chain kernels
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

    # ---- 8. the deployment path: model directory, LoadedModel, the daemon
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_launches = deployment_path(torch, kernel_wrappers(), card,
                                     semantic, observed, delta)
    print(f"deploy phase: {time.perf_counter() - t0:.1f} s")

    for r in records:
        r["train_launches"] = train_launches[r["name"]]
        r["loop_launches"] = loop_launches[r["name"]]
        r["ymod_launches"] = ymod_launches[r["name"]]
        r["serve_launches"] = serve_launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "train_launches", "loop_launches", "ymod_launches",
            "serve_launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
