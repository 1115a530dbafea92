#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (mst_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions,
     and whether pandas, cv2 and PIL import;
  2. build every kernel from the sources in this checkout (one nvcc each,
     all started together, for csrc/fused_predict.cu,
     csrc/softargmax_rows.cu and csrc/kmeans.cu, and csrc/conv3x3.cu and
     csrc/decoder_chain.cu, both on csrc/conv_wgmma.cuh, with their
     ptxas registers, spills,
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
     call), plain version and bound; TTST's k-means kernel against its
     plain version (ops/kmeans.lloyd, the torch while_loop) on the same
     CUDA tensors at TTST's shapes (B = 1, 4, 8, 16 rows of N = 10,000
     whole-pixel draws of goal maps, k = 19): trips, assignments and
     centres bit for bit; timed at B = 8 as the serving kernels are;
  4. a small-width reference: the same weights and waypoint draws through
     the port on the card (kernels) and on the CPU (plain versions);
  5. the main path: Predictor at the full width of sdd_shortterm_eval.yaml
     (K = 20, TTST on, B = 8, 352 x 480, random weights from a seed)
     answers 4 requests and 1 request with a LoRA style; both serving
     kernels' launch counts must rise here, and the k-means kernel's must
     be one a request; then the fused kernel against its plain
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
     twice a step (its metrics) and every other kernel never (all
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
     to a direct predict (1e-4 raw px); every kernel's count set to 0
     before the traffic and read after (rows, fused and k-means once a
     dispatch, the others never); a direct predict on a side stream during a
     dispatch against the serial runs, and fused_predict queued on two
     streams behind one gate event, every output against the plain
     version and the trace showing the two streams' launches overlap; a
     burst at max_queue 2 shed with
     503s; max_styles 2 evicting the oldest of 3; the memory of two
     resident styles; check --bench 5; a small-width serial model
     directory card against CPU (FUSED_TOL), its init statistics moving
     the trajectories by over 10x that. Latencies, requests/s and rows a
     dispatch are printed beside the card's name and power limit.
  9. the segmentation backbone (small_segmentation_reference,
     segmentation_path): at small width (a shallow backbone with the real
     widths, batch norms moved), card against CPU for three steps each of
     segmentation_head and segmentation_bn with the backbone in the step
     and of train with it in train mode (e_unfreeze; losses at 1e-4
     relative, the 'segmentation_bn' state at 1e-3), one eval batch with
     it in the step (1e-2 px) and use_features_only's 16 channels (1e-4);
     then the full ResNet101 U-Net (random weights from seed 0, the batch
     norms' statistics those of the other synthetic scene's activations)
     written as data/sdd/sdd_segmentation.npz under a
     temporary working directory, where the shipped configs find it: one
     352 x 480 scene card against the CPU and a float64 forward (the
     card's probabilities within twice the CPU f32's distance from
     float64, at least 1e-4; the argmax agreement printed), CUDA-event ms
     over 10 calls beside its bound
     (torch's FLOP count at 67 TFLOP/s f32), peak memory; then, with all
     kernels' counts set to 0 before and read after,
     sdd_shortterm_eval.yaml / _train.yaml as shipped (6 classes) on phase
     6c's synthetic RGB scenes: a 2-round TTST test (the backbone once a
     scene), 3 segmentation_head steps (the head moves, every other leaf
     bit-identical), a 2-epoch run with e_unfreeze 1 (the 114 batch norms'
     statistics adapt, the backbone's parameters stay) and
     `python -m mst_tpu_torch.serve export --segment_in_step` of its
     checkpoint, whose LoadedModel answers one request on the raw scene
     within 1e-4 raw px of a Predictor on the segmented map (rows and fused
     as the code launches them, the others never); the rows kernel on a
     segmentation_head step's maps and the fused kernel on the directory's
     request against their plain versions; a torch.profiler trace of one
     segmented test batch with the backbone's share.
  10. from raw annotations to a resumed run (raw_to_resumed), at the full
     width of sdd_shortterm_train.yaml (352 x 480, B = 8, 3 classes): phase
     6c's scenes written as SDD annotations and reference.jpg files; the
     builder CLIs (`python -m mst_tpu_torch.data.sdd`, then --reload
     --varf agent_type, then data.split_dataset), their pickles equal to
     the pandas chain's, and the native windowing timed against the chain
     at 1M rows; the train CLI runs A (4 epochs,
     smooth-val, a training state every epoch), C (2 epochs) and R
     (--resume to 4): what C held as it wrote epoch 2's state equals, bit
     for bit, what R holds after the restore, and R's leaves and val
     histories equal A's bit for bit (cuDNN's deterministic algorithms;
     a second uninterrupted run that measured the card's noise went to
     keep the script's time, and never saw any); then an
     ETH world (5 scenes of oracle.png masks and homographies): the
     validation cut's 30 // B scenes, a 1-epoch mosa_2 fine-tune and a
     --eth_world_coords test, world ADE/FDE on the card against the CPU on
     the same draws (1e-4 relative); each CLI run's kernel launches
     against what the code gives, the rows kernel on a train step's maps
     and the fused kernel on the ETH path's operands against their plain
     versions; host seconds of the build, split, epochs and resume, and
     the peak memory. Every CLI of the phase runs as its main() in this
     process (run_main; as a process each paid ~9-15 s of start), with
     cuDNN's deterministic algorithms.
  11. bf16, remat, cross-scene batching and forward_test (its kernel
     checks run beside phase 3's, the rest before phase 10, while
     torch.profiler still records every launch): both serving kernels
     on bf16 operands against their plain versions (the fused
     kernel at (160, 352x480, 32) x (32, 12) and Y-Net-Mod's (200,
     320x576, 32) x (32, 30), 1e-3 px; the rows kernel on (8, 352x480),
     1e-4 px; edge cases: ragged rows, rows off 16-byte alignment, C = 6,
     a bf16 bias, a peaked map; each timed beside its bf16 bound; f16
     refused); phase 5's request in bf16 beside f32 (3 requests each,
     the same seeds: ms, the trajectories' distance, launches: rows f32
     and fused bf16 once a request, others 0; each traced by kernel name,
     counting cuDNN's nchwkcrs_nchw, nchwToNhwc, nhwcToNchw and FFT
     kernels); phase 6b's fine-tune as 5 steps each in f32 (twice: the
     card's noise), bf16 and f32 --remat (ms, losses against the f32
     run's, peak memory, launches, the bf16 rows kernel on a step's own
     maps, a traced step of each); phase 6c's scenes through Experiment
     with a shallow backbone per scene and with --cross_scene_batching
     (batch counts, the rows-weighted train loss sum at the same weights
     within 1e-5, 2 scene maps segmented a test, one test round's
     ADE/FDE within 15%, launches); forward_test on one scene at small
     width, the noisy probe with its three input gradients, card against
     CPU.
  12. --fused and the grid (fused_and_grid_path; after phase 11, before
     phase 10), on phase 6c's scenes at sdd_shortterm_train.yaml's width
     (mosa_2 on 0-4, B = 8 at 352 x 480, random weights from a seed),
     cuDNN deterministic: 12a trains the same 4 epochs (chunks of 2,
     smooth-val) through the loop and through --fused, in f32 and in
     bf16, and holds the fused run to the loop bit for bit (losses, val
     ADE/FDE, best epoch, weights); the replays run under
     torch.cuda.set_sync_debug_mode("error"); capture seconds, replays,
     launches a replay and a chunk, the fused run's launches against the
     code's (warm-up + replays), seconds an epoch of both, peak memory,
     a traced 2-epoch chunk; the rows kernel captured on a step's own
     maps, replayed on two fillings against its plain version. 12b runs
     `python -m mst_tpu_torch.grid`'s run_grid on the same scenes as
     files (2 seeds x 2 lrs, 3 epochs, 2 runs a program: a full-width
     run's epoch peaks at ~17 GiB) and holds each run to its own
     train-CLI run: the best epoch, the val history (1e-5 relative) and
     the saved weights (GRID_STEP_TOL of the learning rate), beside two
     loop runs on cuDNN's default algorithms; the same grid split by a
     forced memory error (MST_GRID_FORCE_OOM_ABOVE 1, MST_GRID_CHUNK_CAP
     1) at the same bars; fused_predict through its vmap rule (2 x 160
     rows, shared and own weights) and the rows kernel (2 x 96 rows)
     against one call a run; the grid's seconds against the loop runs',
     its peak memory and launches.
  13. the serialized program (serialized_program_path; after phase 12,
     before phase 10): one key's draws on the card against the CPU's bit
     for bit (bits, uniforms, randints, exponentials, and the exponential
     of all 2^24 uniforms); then phase 5's model (random weights from
     seed 0) with phase 5's LoRA delta as a style, in f32 and in bf16,
     and phase 6d's Y-Net-Mod at inD_longterm_eval.yaml's width with TTST
     and CWS on (B = 10 at 320 x 576, P = 30, a random LoRA style), each
     written by `python -m mst_tpu_torch.serve export` (timed: forward.pt2
     and decode.pt2 through torch.export) and refused on the CPU; a fresh
     process with mst_tpu_torch.models, .train and .config blocked loads
     each directory (timed) and answers 4 requests and 1 styled, every
     count zeroed before and read after (both serving kernels must rise
     in each, the k-means kernel once a request); every output finite,
     inside the image and within 1e-4 raw px of the eager Predictor of the
     same weights and keys; a program request against an eager one,
     median of 5 each.
  14. data parallelism over a mesh (mesh_path; after phase 13, before
     phase 10), on phase 6c's scenes at sdd_shortterm_train.yaml's width,
     cuDNN deterministic, its ranks child processes started as torchrun
     starts them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT;
     mesh_rank_main): (a) a world of 1 on NCCL runs the train CLI with
     --mesh_shape 1, and with --fused --mesh_shape 1 (its CUDA graph
     captures the NCCL all-reduces), each bit-equal to the same flow
     without a mesh in this process (weights, metrics log, printed
     results); (b) a world of 2 sharing the card (gloo on CUDA tensors)
     runs 3 mosa_2 steps, a serial-adapter step and a K = 20 TTST
     validation pass on phase 6b's batch (B = 8, the last two rows
     padding: 4 and 2 valid rows a rank) against this process's world of
     1: losses 1e-5 relative, leaves 1e-4 of their max where every
     step's |g| > 1e-3 max|g|, the serial BN statistics 1e-6, each rank's
     TTST draws bit-equal to its rows of the world of 1's, ADE/FDE 1e-5
     relative and best_traj 1e-4 model px on the rows whose samples did
     not move (at most a third may), both kernels launched on each rank;
     step and validation ms of both worlds (no scaling figure: the ranks
     share one card), and a world of 1's serial step timed with the
     port's batch norm and with cuDNN's in its place; (c) the world of 2's torch.distributed.checkpoint
     restored here bit for bit; (d) the grid (2 seeds x 1 lr, 1 epoch,
     one run a rank) against the same grid here at phase 12's bars;
     (e)-(f) the spatial mesh's eval and training in that world (PRs
     17-18); (g) the ResNet101 U-Net in the step on that (1, 2) mesh,
     each rank on its slab of the image (a TTST pass, segmentation_bn
     steps in train mode, the backbone alone on a 1408 x 1920 image, and
     the train CLI of segmentation_head) against the world of 1 here.
  15. the eval step's sample payload, the evaluator tools and two suites
     of scripts/ (analysis_path; last), on phase 6c's scenes at
     sdd_shortterm_eval.yaml's width (352 x 480, B = 8, TTST on, mosa_2 on
     0-4, 3 classes): (a) Experiment.test(return_samples=True), its
     payload's shapes and host bytes, and at small width card against CPU
     on the same weights (goal maps 1e-4 of max); (b) compare_checkpoints
     of a base and base + mosa_2 delta, lora_importance over the delta's
     9 LoRA layers (11 test passes), the swap oracle bit for bit, seconds
     a pass; (c) capture_activations (small width card against CPU, 1e-4
     of each map's max; full width timed), the rows, fused and k-means
     kernels once an eval batch of (a) and (b); both serving kernels at
     the harness's miniature shapes (32 x 64 maps, C = 8 into the fused
     kernel) against their plain versions; (d) generalize.sh and
     tune_mosa.sh of scripts/sdd/ped_to_biker through
     mst_tpu_torch.utils.scripts_e2e on the card, side by side, jax and
     mst_tpu unimportable, each suite process printing its kernel
     launches as it ends.
The line before the last is the per-kernel JSON record (launches on each
kernel's own path, train_launches on the fine-tune path, loop_launches
on the Experiment loop's, ymod_launches on Y-Net-Mod's, serve_launches
on the daemon's, seg_launches on the segmentation backbone's,
res_launches over phase 10's CLI runs, p11_launches over phase
11's requests, steps and cross-scene test, p12_launches over phase
12's fused runs (eager warm-up + replays) and grid, p13_launches over
phase 13's program-only process, p14_launches, each rank's count over
phase 14's world of 2, p14g_launches, each rank's count over 14g's TTST
pass and train steps, and p15_launches over phase 15's full-width
evaluations and its two suites' processes; the bf16 records'
launches count phase 11's bf16 requests and steps); the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import contextlib
import ctypes
import io as io_text
import json
import math
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
        for eb in (4, 2):
            check(lib.fused_predict_stage_pixels(C, eb)
                  == fp.stage_pixels(C, eb),
                  f"stage_pixels({C}, {eb}) differs from the library's")
    for P in range(1, fp.MAX_CHANNELS + 1):
        check(lib.fused_predict_group_width(P) == fp.group_width(P)
              and lib.fused_predict_pixels_per_thread(P)
              == fp.pixels_per_thread(P),
              f"group_width or pixels_per_thread({P}) differs from the "
              "library's")
    check(sr._library().softargmax_rows_cluster() == sr.CLUSTER,
          "the rows kernel's cluster size differs from CLUSTER")
    for HW in (1, 3, 5, 64, 37 * 53, 40 * 56, 352 * 480):
        for vec in (4, 8):  # f32, bf16
            for lead in range(vec):
                want = [sr.row_split(HW, lead, sr.CLUSTER, k, vec)
                        for k in range(sr.CLUSTER)]
                check(sr.library_split(HW, lead, sr.CLUSTER, vec) == want,
                      f"row_split({HW}, {lead}, vec {vec}) differs from the "
                      "library's")
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


# TTST's k-means (train/steps._ttst_goals): 10,000 goal samples a row into
# n_goal - 1 = 19 centres, tol 1e-3, at most 1,000 trips; requests of 1-16
# agents
KMEANS_N, KMEANS_K, KMEANS_TOL, KMEANS_ITERS = 10000, 19, 1e-3, 1000
KMEANS_BS = (1, 4, 8, 16)


def kmeans_inputs(torch, B, seed):
    """TTST's k-means operands for B rows: KMEANS_N whole-pixel draws
    (with replacement, rel_threshold 0.002) of B random smooth goal maps
    at 352 x 480, and batched_kmeans' initial centres and reseed table
    from the same key -> (X, centres, reseed), contiguous on the card."""
    from mst_tpu_torch.ops.sampling import Key, key_from_seed, sample_heatmap

    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((B, 1, 352, 480), generator=g, device="cuda")
    maps = torch.nn.functional.avg_pool2d(noise ** 16, 41, 1, 20)[:, 0]
    key = Key(key_from_seed(seed, "cuda"))
    X = sample_heatmap(maps, KMEANS_N, rel_threshold=0.002,
                       replacement=True, generator=key)
    rows = torch.arange(B, device="cuda")[:, None]
    idx = key.bits((B, KMEANS_N)).topk(KMEANS_K, dim=1).indices
    reseed = key.randint(KMEANS_N, (B, KMEANS_K), counter=torch.arange(
        KMEANS_ITERS, device="cuda"))
    return X.contiguous(), X[rows, idx].contiguous(), reseed.contiguous()


def check_kmeans_kernel(torch):
    """TTST's k-means kernel against its plain version (ops/kmeans.lloyd,
    the torch while_loop) on the same CUDA tensors at TTST's shapes (B in
    KMEANS_BS): each row's trips, the assignments and the centres bit for
    bit (whole-pixel sums are exact in f32 in any order); then timed at
    B = 8 (CUDA events, and one kernel a call in the profiler's device
    time) beside the plain version and the bound of its most trips."""
    from mst_tpu_torch.ops.kernels.kmeans import lloyd2d
    from mst_tpu_torch.ops.kmeans import lloyd, pairwise_sq_dist
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.probes.serving_kernels import time_call

    def kernel(X, c0, reseed):
        return lloyd2d(X, c0, reseed, KMEANS_TOL, KMEANS_ITERS)

    def plain(X, c0, reseed):
        return lloyd(X, c0, reseed, KMEANS_TOL, KMEANS_ITERS,
                     pairwise_sq_dist)[:3]

    trips = {}
    for B in KMEANS_BS:
        args = kmeans_inputs(torch, B, seed=B)
        got, want = kernel(*args), plain(*args)
        for name, a, b in zip(("assignments", "centres", "trips"), got,
                              want):
            check(torch.equal(a, b), f"k-means kernel, B = {B}: its {name} "
                  "differ from the while_loop's (trips "
                  f"{got[2].tolist()} against {want[2].tolist()})")
        trips[B] = got[2].tolist()
    print(f"k-means kernel against the while_loop at B = {KMEANS_BS}, "
          f"N = {KMEANS_N}, k = {KMEANS_K}: trips, assignments and centres "
          f"bit for bit; trips by row {trips}")
    R = 8
    args = kmeans_inputs(torch, R, seed=R)
    rec = time_call(lambda: kernel(*args), 20)
    check_one_kernel("the k-means kernel", rec, 20)
    plain_ms = time_ms(lambda: plain(*args), 3)
    n, N, k = max(trips[R]), KMEANS_N, KMEANS_K
    # a trip reads no HBM beyond its centres (the points stay in shared
    # memory); per point and centre 2 subtractions, 2 products, a sum and
    # a comparison, and 3 sums a point into its cluster
    b_ms, b_by = bound(R * N * 8 + R * k * 8 + R * (N + 1) * 8
                       + n * R * k * 8, n * R * N * (6 * k + 3))
    print_times(f"kmeans ({R}, {N}, 2) to {k} centres, {n} trips", rec,
                b_ms)
    print(f"kmeans: plain (while_loop) {plain_ms:.4f} ms")
    return {"name": "kmeans", "route": "cuda",
            "source": "mst_tpu_torch/csrc/kmeans.cu",
            "replaces": "none (mst_tpu/ops/kmeans.py's vmap of "
                        "lax.while_loop, through XLA)",
            "max_abs_err": 0.0, "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ---- phase 11: bf16, remat, cross-scene batching, forward_test
ROWS_BF16_TOL = 1e-4  # px, the rows kernel on bf16 logits vs its plain one
FUSED_BF16_TOL = 1e-3  # px, the fused kernel on bf16 operands vs its plain one
YMOD_FUSED_SHAPE = (200, 320, 576, 32)  # Y-Net-Mod's decode tail, P = 30


def rows_bound(R, HW, elem_bytes):
    return bound(R * HW * elem_bytes + R * 2 * 4, R * HW * 8)


def fused_bound_bf16(R, H, W, C, P):
    """bf16 x and weight, f32 bias and output: the 2C operations a logit
    of the bf16 products (f32 accumulate) at the card's bf16 rate, its 8
    of f32 statistics at the f32 rate, counted as f32 operations."""
    n = R * H * W * P
    return bound(R * H * W * C * 2 + C * P * 2 + P * 4 + R * P * 2 * 4,
                 2 * C * n * F32_FLOP_PER_S / BF16_FLOP_PER_S + 8 * n)


def time_kernel(torch, label, fn, plain_fn, iters, plain_iters, b):
    """Event and device ms of fn (one kernel a call), the plain version's
    ms, printed beside the bound b = (ms, by)."""
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.probes.serving_kernels import time_call

    for _ in range(PROFILER_TRIES):
        rec = time_call(fn, iters)
        if rec["kernels"]:
            break
        print(f"{label}: the profiler recorded no kernel; again")
    check_one_kernel(label, rec, iters)
    rec["plain_ms"] = time_ms(plain_fn, plain_iters)
    rec["bound_ms"], rec["bound_by"] = b
    print_times(label, rec, b[0])
    print(f"{label}: plain {rec['plain_ms']:.4f} ms")
    return rec


def check_bf16_kernels(torch):
    """Both serving kernels on bf16 operands against their plain versions
    (which widen the bf16 values and compute in f32): the rows kernel on
    (8, 352x480) logits and edge cases (H*W % 8 != 0, rows off 16-byte
    alignment, rows shorter than the cluster, a peaked map); the fused
    kernel at the eval decode tail's (160, 352x480, 32) x (32, 12), at
    Y-Net-Mod's (200, 320x576, 32) x (32, 30), and on edge cases (ragged,
    an image smaller than a stage, C = 6, a view off 16-byte alignment, a
    peaked map). Each full shape timed beside its bf16 bound. -> [rows
    record, fused record] for the JSON line."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)
    from mst_tpu_torch.probes.serving_kernels import FUSED_SHAPE, ROWS_SHAPE

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, scale=1.0, offset=0):
        """bf16 normals; with offset, a view `offset` elements into its
        buffer (a data pointer off 16-byte alignment)."""
        n = 1
        for d in shape:
            n *= d
        buf = torch.randn(n + offset, generator=g, device="cuda") * scale
        return buf.to(bf)[offset:].view(shape)

    x = randn(*ROWS_SHAPE, scale=4.0)
    peaked = torch.full((1, 32, 64), -30.0, device="cuda", dtype=bf)
    peaked[0, 17, 42] = 30.0
    unaligned = randn(5, 40, 56, scale=3.0, offset=3)
    check(unaligned.data_ptr() % 16 != 0, "the unaligned rows are aligned")
    err = check_cases(torch, "rows soft-argmax bf16", softargmax2d_rows,
                      plain, [(n, (t,)) for n, t in (
                          ("slice", x),
                          ("H*W % 8 != 0", randn(3, 37, 53, scale=3.0)),
                          ("rows off 16-byte alignment", unaligned),
                          ("rows shorter than the cluster",
                           randn(5, 3, 5, scale=3.0)),
                          ("peaked", peaked))], ROWS_BF16_TOL)
    e = float((softargmax2d_rows(peaked)[0]
               - torch.tensor([42.0, 17.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"the bf16 rows kernel misses the peak by {e}")
    R, H, W = x.shape
    rec = time_kernel(torch, f"softargmax_rows bf16 {tuple(x.shape)}",
                      lambda: softargmax2d_rows(x), lambda: plain(x), 200,
                      200, rows_bound(R, H * W, 2))
    rows = {"name": "softargmax_rows_bf16", "route": "cuda",
            "source": "mst_tpu_torch/csrc/softargmax_rows.cu",
            "replaces": "mst_tpu/ops/pallas/softargmax.py:63",
            "max_abs_err": err, "library_ms": None,
            **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by")}}
    del x, unaligned

    def case(R, H, W, C, P, offset=0):
        x = randn(R, H, W, C, offset=offset).relu_()
        w = (torch.randn((C, P), generator=g, device="cuda") * 0.3).to(bf)
        b = torch.randn((P,), generator=g, device="cuda")
        return x, w, b

    pk = torch.zeros((2, 16, 24, 8), device="cuda", dtype=bf)
    pk[:, 7, 10, :3] = 60.0
    unaligned = case(2, 40, 56, 32, 12, offset=1)
    check(unaligned[0].data_ptr() % 16 != 0, "the unaligned view is aligned")
    cases = [("ragged", case(3, 40, 56, 32, 12)),
             ("one image smaller than a stage", case(1, 10, 20, 32, 12)),
             ("odd channels", case(2, 24, 40, 6, 5)),
             ("unaligned view", unaligned),
             ("a bf16 bias", (*case(2, 24, 40, 32, 12)[:2],
                              torch.randn(12, generator=g, device="cuda")
                              .to(bf))),
             ("peaked", (pk, torch.eye(8, 3, device="cuda", dtype=bf),
                         torch.zeros(3, device="cuda")))]
    err = check_cases(torch, "fused predictor bf16",
                      fused_predictor_softargmax,
                      fused_predictor_softargmax_plain, cases, FUSED_BF16_TOL)
    got = fused_predictor_softargmax(*cases[-1][1])
    e = float((got - torch.tensor([10.0, 7.0], device="cuda")).abs().max())
    check(e <= 1e-2, f"the bf16 fused kernel misses the peak by {e}")
    del cases, unaligned
    times = {}
    for shape, P in ((YMOD_FUSED_SHAPE, 30), (FUSED_SHAPE, 12)):
        x, w, b = case(*shape, P)
        err = max(err, check_cases(
            torch, "fused predictor bf16", fused_predictor_softargmax,
            fused_predictor_softargmax_plain,
            [(f"full shape, P {P}", (x, w, b))], FUSED_BF16_TOL))
        times[P] = time_kernel(
            torch, f"fused_predict bf16 {shape} x ({shape[-1]}, {P})",
            lambda: fused_predictor_softargmax(x, w, b),
            lambda: fused_predictor_softargmax_plain(x, w, b), 20, 3,
            fused_bound_bf16(*shape, P))
        del x, w, b
        torch.cuda.empty_cache()
    # any other dtype raises on the card
    for label, fn, args in (
            ("rows", softargmax2d_rows, (peaked.half(),)),
            ("fused", fused_predictor_softargmax,
             (pk.half(), torch.eye(8, 3, device="cuda").half(),
              torch.zeros(3, device="cuda")))):
        try:
            fn(*args)
        except ValueError:
            continue
        check(False, f"the {label} kernel took f16")
    rec = times[12]
    fused = {"name": "fused_predict_bf16", "route": "cuda",
             "source": "mst_tpu_torch/csrc/fused_predict.cu",
             "replaces": "mst_tpu/ops/pallas/fused_predict.py:109",
             "max_abs_err": err, "library_ms": None,
             **{k: rec[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
             "ymod": {k: times[30][k] for k in ("ms", "device_ms", "plain_ms",
                                                "bound_ms")}}
    return [rows, fused]


BF16_LOSS_RTOL = 2e-2  # a bf16 step's loss against the f32 step's
BF16_STEPS = 5
REMAT_STEP0_RTOL = 1e-6  # the first remat step's loss against the f32 one's
REMAT_RTOL = 1e-5  # later steps', or twice the card's run-to-run noise (the
# bilinear backward's atomics reach the weights through Adam)
CROSS_LOSS_RTOL = 1e-5  # the rows-weighted loss sums, cross-scene vs per scene
CROSS_ADE_RTOL = 0.15  # one test round, other draws
PROBE_LOSS_RTOL = 1e-5  # forward_test card against CPU
PROBE_MAP_TOL = 1e-4  # of each map's max
PROBE_GRAD_TOL = 1e-4  # relative L2 of each input gradient (a ReLU input
# or a max-pool's runner-up near its kink may take the other side in one
# f32 run, which a max would see)
# cuDNN's f32 NCHW convs on channels_last tensors, their transposes and
# its FFT tiling, which each trace counts by name
NCHW_KERNELS = ("nchwkcrs_nchw", "nchwToNhwc", "nhwcToNchw", "fft")
PROFILER_TRIES = 3  # a trace that records no kernel is taken again


def count_launches(wrappers, fn):
    """fn() with every kernel's count set to 0 before and read after."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def bf16_requests(torch, wrappers, card, semantic, observed):
    """Phase 11b: phase 5's request (sdd_shortterm_eval, TTST, mosa_2 on
    0-4, B = 8 at 352 x 480, random weights from seed 0) in bf16 beside
    f32, the same seeds: host ms, the trajectories' distance from the f32
    request's, the launches (rows f32 once a request: TTST's goal point on
    the f32 goal logits; fused bf16 once: the decode tail; others 0), and
    each request traced by kernel name. -> launches."""
    import numpy as np

    from mst_tpu_torch.config import get_params
    from mst_tpu_torch.serve import Predictor

    params = get_params("sdd_shortterm_eval.yaml", dict(
        use_TTST=True, train_net="mosa_2", position=POSITIONS))
    H, W = semantic.shape[1:3]
    out = {}
    for dtype in ("float32", "bfloat16"):
        pred = Predictor(dict(params, compute_dtype=dtype), seed=0)
        pred.predict(semantic, observed, seed=0)  # first call: cuDNN's setup
        torch.cuda.synchronize()
        ms = []

        def requests():
            res = []
            for seed in range(3):
                t0 = time.perf_counter()
                res.append(pred.predict(semantic, observed, seed=seed))
                ms.append(1e3 * (time.perf_counter() - t0))
            return res

        res, launches = count_launches(wrappers, requests)
        for r in res:
            for k, a in r.items():
                check_in_image(f"{dtype} request: {k}", a, H, W,
                               params["resize_factor"])
        print(f"request {dtype} ({card}): " + ", ".join(
            f"{m:.1f}" for m in ms) + f" ms; launches {launches}")
        out[dtype] = dict(res=res, launches=launches, ms=ms)
        check(print_trace(torch, f"{dtype} request ({card})",
                          lambda: pred.predict(semantic, observed, seed=9))
              is not None, f"no trace of a {dtype} request")
        del pred
        torch.cuda.empty_cache()
    want = dict.fromkeys(wrappers, 0)
    want["softargmax_rows"] = want["fused_predict_bf16"] = 3
    want["kmeans"] = 3  # TTST's k-means on the f32 goal samples
    check(out["bfloat16"]["launches"] == want, "the bf16 requests launched "
          f"{out['bfloat16']['launches']}, the code gives {want}")
    for seed in range(3):
        d = np.abs(out["bfloat16"]["res"][seed]["trajectories"]
                   - out["float32"]["res"][seed]["trajectories"])
        print(f"bf16 - f32 request, seed {seed}: trajectories max "
              f"{d.max():.3f}, mean {d.mean():.3f} raw px")
    return out["bfloat16"]["launches"]


def bf16_and_remat_steps(torch, wrappers, card, rows_rec):
    """Phase 11c: phase 6b's fine-tune (mosa_2 on 0-4, B = 8 with two
    padded rows at 352 x 480, Adam at lr 1e-3, random weights from seed 0):
    BF16_STEPS steps each in f32 (twice: the card's run-to-run noise), in
    bf16 and in f32 with --remat, from the same weights: host ms, losses
    against the f32 run's, peak memory; the launches of the bf16 and remat
    steps (rows bf16 twice a bf16 step, rows f32 twice a remat step,
    others 0); the rows kernel on a bf16 step's own maps (96 and 8 rows)
    against its plain version; a traced step of each by kernel name.
    -> launches."""
    import numpy as np

    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import setup_training

    params = get_params("sdd_shortterm_train.yaml", dict(
        train_net="mosa_2", position=POSITIONS, lr=1e-3))
    H, W, B = 352, 480, 8
    batch = fine_tune_batch(torch, params, H, W, B)  # phase 6b's batch
    runs, launches = {}, dict.fromkeys(wrappers, 0)
    for label, over in (("f32", {}), ("f32 again", {}),
                        ("bf16", dict(compute_dtype="bfloat16")),
                        ("f32 remat", dict(remat=True))):
        p = dict(params, **over)
        mcfg = ynet_config(p)
        weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg,
                                   "cuda")
        setup = setup_training(weights, p, steps_per_epoch=1)
        step = make_train_step(mcfg, step_config(p))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []

        def steps():
            nonlocal state
            for _ in range(BF16_STEPS):
                t0 = time.perf_counter()
                state, m = step(weights, state, setup["optimizer"],
                                batch)
                losses.append(float(m["loss"]))
                ms.append(1e3 * (time.perf_counter() - t0))

        _, n = count_launches(wrappers, steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(np.isfinite(losses).all(), f"{label}: non-finite losses")
        print(f"{label} steps ({card}): " + ", ".join(
            f"{m:.1f}" for m in ms) + f" ms; losses " + ", ".join(
            f"{v:.6f}" for v in losses) + f"; peak {peak:.2f} GiB; "
            f"launches {n}")
        runs[label] = dict(losses=np.array(losses), peak=peak)
        if label in ("bf16", "f32 remat"):
            want = dict.fromkeys(wrappers, 0)
            want["softargmax_rows_bf16" if label == "bf16"
                 else "softargmax_rows"] = 2 * BF16_STEPS
            check(n == want, f"the {label} steps launched {n}, the code "
                  f"gives {want}")
            for k, v in n.items():
                launches[k] += v
        if label == "bf16":
            with torch.no_grad():
                _, _, goal_map, traj_map, _ = step.forward(weights, state,
                                                           batch)
            for name, x in (("traj", traj_map.permute(0, 3, 1, 2)
                             .contiguous()),
                            ("goal", goal_map[..., -1:].permute(0, 3, 1, 2)
                             .contiguous())):
                check(x.dtype == torch.bfloat16, "the bf16 step's maps "
                      f"are {x.dtype}")
                e = float((softargmax2d_rows(x) - plain(x)).abs().max())
                R = x.shape[0] * x.shape[1]
                b_ms, _ = rows_bound(R, H * W, 2)
                print(f"softargmax_rows bf16 on the step's {name} maps "
                      f"{tuple(x.shape)} ({R} rows): max |kernel - plain| "
                      f"= {e:.3e} px (tol {ROWS_BF16_TOL}); "
                      f"{time_ms(lambda: softargmax2d_rows(x), 50):.4f} ms,"
                      f" plain {time_ms(lambda: plain(x), 20):.4f} ms, bound"
                      f" {b_ms:.4f} ms")
                check(e <= ROWS_BF16_TOL, f"the bf16 rows kernel disagrees "
                      f"on the step's {name} maps")
                rows_rec["max_abs_err"] = max(rows_rec["max_abs_err"], e)
            del goal_map, traj_map, x
        if label in ("f32", "bf16", "f32 remat"):
            check(print_trace(torch, f"{label} step ({card})", lambda: (
                step(weights, state, setup["optimizer"],
                     batch),
                torch.cuda.synchronize())) is not None,
                f"no trace of a {label} step")
        del weights, setup, step
        torch.cuda.empty_cache()
    f32 = runs["f32"]["losses"]
    noise = np.abs(runs["f32 again"]["losses"] - f32) / f32
    remat = np.abs(runs["f32 remat"]["losses"] - f32) / f32
    bf16 = np.abs(runs["bf16"]["losses"] - f32) / f32
    print(f"losses relative to the f32 run's: second f32 run {noise.max():.3e}"
          f", remat {', '.join(f'{v:.3e}' for v in remat)}, bf16 "
          f"{', '.join(f'{v:.3e}' for v in bf16)}; peak GiB f32 "
          f"{runs['f32']['peak']:.2f}, bf16 {runs['bf16']['peak']:.2f}, "
          f"remat {runs['f32 remat']['peak']:.2f}")
    check(remat[0] <= REMAT_STEP0_RTOL and remat.max() <= max(
        REMAT_RTOL, 2 * noise.max()), "the remat losses leave the f32 "
          "steps' beyond the card's noise")
    check(bf16[0] <= BF16_LOSS_RTOL, "the bf16 step's loss is off the f32 "
          "step's")
    check(runs["f32 remat"]["peak"] < runs["f32"]["peak"],
          "remat holds no less memory than the plain step")
    return launches


def shallow_backbone(path, n_classes=3):
    """A backbone npz at path: the U-Net's real widths, one block a stage
    (random weights from seed 0), so a scene segments in milliseconds."""
    import numpy as np
    import torch

    from mst_tpu_torch import io
    from mst_tpu_torch.models.unet import unet_init

    np.savez(path, **io.params_to_numpy(unet_init(
        torch.Generator().manual_seed(0), n_classes=n_classes,
        layers=(1, 1, 1, 1))))
    return path


def cross_scene_path(torch, wrappers, card):
    """Phase 11d: phase 6c's scenes (2 of 1408 x 1920 -> 352 x 480, 40 /
    16 / 16 tracks, B = 8, sdd_shortterm_train.yaml's width, 3 classes)
    through Experiment with a shallow segmentation backbone, per scene and
    with --cross_scene_batching, from the same weights: the batch counts,
    the rows-weighted sum of the train losses at those weights, the scene
    maps segmented, one test round's ADE/FDE, and the test's launches
    (fused once a test batch, others 0). -> the cross-scene test's
    launches."""
    import numpy as np

    from mst_tpu_torch.config import step_config
    from mst_tpu_torch.data.scenes import BucketedBatch
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import Experiment

    images, train, _, test = loop_data()
    tmp = tempfile.mkdtemp()
    try:
        _, params = loop_params(tmp, ["--train_net", "train"])
        params["segmentation_model_fp"] = shallow_backbone(
            os.path.join(tmp, "sdd_segmentation.npz"))
        out = {}
        for cross in (False, True):
            exp = Experiment(dict(params, cross_scene_batching=cross),
                             images=images)
            check(exp.mcfg.segmentation == "unet", "no backbone")
            batches = exp.prepare_data(train, None, "train",
                                       rng=np.random.default_rng(1))
            check(all(isinstance(b, BucketedBatch) == cross
                      for b in batches), "the wrong kind of batch")
            step = make_train_step(exp.mcfg, step_config(exp.params))
            cache, total = {}, 0.0
            with torch.no_grad():
                for b, db in exp._device_batches(batches):
                    gl, tl, _, _, _ = step.forward(
                        exp.model_params, exp.model_state,
                        exp._step_batch(b, db, cache))
                    total += float(gl + tl) * float(b.mask.sum())
            exp.n_segmented = 0
            t0 = time.perf_counter()
            (ade, fde, metrics, _), launches = count_launches(
                wrappers, lambda: exp.test(test, None))
            test_s = time.perf_counter() - t0
            n_test = len(exp.prepare_data(test, None, "test"))
            print(f"{'cross-scene' if cross else 'per-scene'} ({card}): "
                  f"{len(batches)} train and {n_test} test batches, "
                  f"rows-weighted loss sum {total:.4f}, {exp.n_segmented} "
                  f"scene maps segmented, test ADE {ade:.4f} FDE {fde:.4f}"
                  f" in {test_s:.2f} s, launches {launches}")
            want = dict.fromkeys(wrappers, 0)
            want["fused_predict"] = n_test
            want["softargmax_rows"] = want["kmeans"] = (
                n_test if exp.params.get("use_TTST") else 0)
            check(launches == want, f"the test launched {launches}, the "
                  f"code gives {want}")
            check(exp.n_segmented == 2, "the backbone ran other than once "
                  "a scene")
            check(sorted(metrics[0]["metaId"]) == sorted(test.meta_ids()),
                  "the test rows differ from the test tracks")
            out[cross] = dict(n=(len(batches), n_test), total=total,
                              ade=ade, fde=fde, launches=launches)
            del exp
        a, b = out[False], out[True]
        check(b["n"][0] <= a["n"][0] and b["n"][1] <= a["n"][1],
              "cross-scene batching made more batches")
        e = abs(b["total"] - a["total"]) / abs(a["total"])
        print(f"cross-scene - per-scene: loss sum {e:.3e} relative (tol "
              f"{CROSS_LOSS_RTOL}); ADE {b['ade'] / a['ade'] - 1:+.3%}, FDE "
              f"{b['fde'] / a['fde'] - 1:+.3%} (other draws; tol "
              f"{CROSS_ADE_RTOL:.0%})")
        check(e <= CROSS_LOSS_RTOL, "the cross-scene losses differ")
        check(abs(b["ade"] / a["ade"] - 1) <= CROSS_ADE_RTOL
              and abs(b["fde"] / a["fde"] - 1) <= CROSS_ADE_RTOL,
              "the cross-scene test's ADE/FDE is off the per-scene one's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out[True]["launches"]


def forward_test_path(torch, card):
    """Phase 11e: Experiment.forward_test on one scene of phase 6c's (352 x
    480, its 16 test tracks' scene) at small width with mosa_2 on 0-4
    (lora_B moved off zero), the noisy probe (noisy_std_frac 0.1 on the
    observed and semantic maps, the same injected draws) with its three
    input gradients, on the card against the CPU on the same weights."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.models.ynet import tree_map
    from mst_tpu_torch.train.trainer import Experiment

    images, _, _, test = loop_data()
    one = test.take(test.sceneId == test.scene_ids()[0])
    tmp = tempfile.mkdtemp()
    try:
        _, params = loop_params(tmp, ["--train_net", "mosa_2", "--position",
                                      *POSITIONS])
        params.update(encoder_channels=[8, 8, 16, 16, 16],
                      decoder_channels=[16, 16, 16, 8, 8])
        card_exp = Experiment(params, images=images)
        g = torch.Generator().manual_seed(3)
        for k, v in io.flatten(card_exp.model_params).items():
            if k.endswith("lora_B"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
        cpu_exp = Experiment(params, images=images, device="cpu")
        cpu_exp.model_params = tree_map(lambda t: t.cpu(),
                                        card_exp.model_params)
        batches = card_exp.prepare_data(one, None, "test")
        n = int(sum(b.mask.sum() for b in batches))
        H, W, C = batches[0].image.shape
        rng = np.random.default_rng(5)
        noise = {"traj": rng.normal(size=(n, H, W, params["obs_len"])),
                 "semantic": rng.normal(size=(1, H, W, C))}
        inputs = ("scene", "semantic", "traj")
        kw = dict(set_input=inputs, noisy_std_frac=0.1, noise=noise)
        t0 = time.perf_counter()
        got = card_exp.forward_test(one, None, input_grads=True, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        want = cpu_exp.forward_test(one, None, input_grads=True, **kw)
        maps = card_exp.forward_test(one, None, decision="map", **kw)
        cpu_maps = cpu_exp.forward_test(one, None, decision="map", **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errs = {}
    for name, g_, w_ in (("goal_loss", got[0], want[0]),
                         ("traj_loss", got[1], want[1])):
        errs[name] = abs(float(g_) - float(w_)) / abs(float(w_))
    for name, g_, w_ in zip(("goal map", "traj map", "semantic"), maps,
                            cpu_maps):
        errs[name] = float((g_.cpu() - w_).abs().max() / w_.abs().max())
    for name in inputs:
        g_, w_ = got[3][name].cpu(), want[3][name]
        errs[name + " grad"] = float((g_ - w_).norm() / w_.norm())
    print(f"forward_test on one scene ({n} tracks, {H} x {W}; {card}): "
          f"card {1e3 * card_s:.1f} ms; card against CPU: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    check(all(errs[k] <= PROBE_LOSS_RTOL for k in ("goal_loss",
                                                   "traj_loss")),
          "forward_test's losses on the card disagree with the CPU")
    check(all(errs[k] <= PROBE_MAP_TOL for k in ("goal map", "traj map",
                                                 "semantic")),
          "forward_test's maps on the card disagree with the CPU")
    check(all(errs[k + " grad"] <= PROBE_GRAD_TOL for k in inputs),
          "forward_test's input gradients on the card disagree with the "
          "CPU")


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

    for _ in range(PROFILER_TRIES):  # an empty trace is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=conv_ops > 0) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profiler: no device time recorded (device busy share not "
              "measured)")
        return None
    print(f"profiler: {busy_ms:.1f} ms of kernels in a {wall_ms:.1f} ms "
          f"traced {label} (device busy {100 * busy_ms / wall_ms:.0f}%)")
    layouts = []
    for pat in NCHW_KERNELS:
        hit = [e for e in kernels if pat.lower() in e.key.lower()]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        layouts.append(f"{pat} {ms:.2f} ms x{sum(e.count for e in hit)}")
    print("  by name: " + ", ".join(layouts))
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
                            b)
            losses[dev].append([float(m[k]) for k in LOSS_KEYS])
    for i, (a, c) in enumerate(zip(losses["cuda"], losses["cpu"])):
        print(f"small-width step {i}: card {a}, cpu {c}")
    return max(abs(a - c) / abs(c) for ra, rc in zip(losses["cuda"],
                                                     losses["cpu"])
               for a, c in zip(ra, rc))


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


def fine_tune_batch(torch, params, H, W, B):
    """bench.py's input draws (bench.py:47-55) on the card: a normal scene
    map, tracks inside the image, the last two of B rows padding."""
    import numpy as np

    rng = np.random.default_rng(0)
    sem = rng.normal(size=(1, H, W, params["n_semantic_classes"]))
    total = params["obs_len"] + params["pred_len"]
    lo, hi = 0.2 * min(H, W), 0.6 * min(H, W)
    traj = rng.uniform(lo, hi, size=(B, total, 2))
    mask = np.ones(B)
    mask[-2:] = 0.0
    return {k: torch.tensor(v, dtype=torch.float32, device="cuda")
            for k, v in (("semantic", sem), ("traj", traj), ("mask", mask))}


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
    from mst_tpu_torch.probes import kernel_wrappers
    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.train.steps import make_train_step
    from mst_tpu_torch.train.trainer import save_params, setup_training

    params = get_params("sdd_shortterm_train.yaml", dict(
        train_net="mosa_2", position=POSITIONS, lr=1e-3))
    mcfg = ynet_config(params)
    H, W, B = 352, 480, 8
    batch = fine_tune_batch(torch, params, H, W, B)
    mask = batch["mask"].cpu().numpy()
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
                        batch)
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
        step(weights, state, setup["optimizer"], batch)
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


def loop_data():
    """Phase 6c's scenes: 2 synthetic scenes of LOOP_SCENE_HW, their tracks
    split 40 / 16 / 16 under np.random.seed(0) -> (images, train, val,
    test)."""
    import numpy as np

    from mst_tpu_torch.data import splits
    from mst_tpu_torch.data.synthetic import make_synthetic_dataset

    tracks, images = make_synthetic_dataset(
        seed=0, n_scenes=2, n_traj=LOOP_TRACKS, img_hw=LOOP_SCENE_HW)
    np.random.seed(0)
    return (images, *splits.dataset_split_by_ratio(tracks, 16, 16,
                                                   shuffle=True))


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
    from mst_tpu_torch.serve import Predictor
    from mst_tpu_torch.train.trainer import Experiment, restore_model

    t0 = time.perf_counter()
    images, train, val, test = loop_data()
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
        want["kmeans"] = 2 * n["test"]  # the TTST test's 2 rounds
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
                                b)
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
                        batch)
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
        step(weights, state, setup["optimizer"], batch)
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
    # a directory's programs serve on the device type they were exported
    # for: one export from the CPU, one from the card
    export_model(exp, f"{tmp}/serial_cpu", 64, 96, 4)
    on_card = Experiment(params)
    on_card.model_params = io.params_from_numpy(flat, "cuda")
    on_card.model_state = io.state_from_numpy(st, "cuda")
    export_model(on_card, f"{tmp}/serial", 64, 96, 4)
    exp.model_state = init_state
    export_model(exp, f"{tmp}/serial_init", 64, 96, 4)
    card = LoadedModel(f"{tmp}/serial", device="cuda")
    cpu = LoadedModel(f"{tmp}/serial_cpu", device="cpu")
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
              == launches["kmeans"] == dispatches > 0 and not any(
                  v for k, v in launches.items()
                  if k not in ("softargmax_rows", "fused_predict",
                               "kmeans")),
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


# ---- phase 9: the segmentation backbone

# class probabilities at ResNet101 depth: the card's distance from a
# float64 forward within twice the CPU f32 forward's own, and within
# SEG_TOL where that is smaller (the CPU's f32 probabilities were 1.9e-4
# from float64 on phase 9's scenes, the card's 2.7e-4: f32 rounding over
# ~100 convs)
SEG_TOL = 1e-4
SEG_MAP_TOL = 1e-4  # small-width features and logits, of each one's max
SEG_STEPS = 3  # segmentation_head steps at full width
SEG_SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
                 decoder_channels=[16, 16, 16, 8, 8], waypoints=[11],
                 n_goal=4, n_traj=1, lr=1e-3)


# the three stride-2 3x3 convs (block 0's conv2 of layer2-4) at a 352 x
# 480 scene's shapes: (channels, rows, columns) of each one's input
STRIDE2_SHAPES = ((128, 88, 120), (256, 44, 60), (512, 22, 30))
STRIDE2_TOL = 1e-5  # f32 on the card, of the float64 output's max


def check_stride2_convs(torch, bb, card):
    """The backbone's stride-2 3x3 convs with bb's weights on seeded ReLU
    outputs of STRIDE2_SHAPES, in f32 on the card through unet.conv
    (mst_tpu's SAME: an explicit zero row and column at the bottom and
    right), against a float64 conv on the CPU padded (0, 1) explicitly;
    each timed beside cuDNN's conv padded (1, 1), torchvision's, on the
    same input -> the largest |card - float64| of the output's max."""
    import numpy as np
    import torch.nn.functional as F

    from mst_tpu_torch.models import unet
    from mst_tpu_torch.probes import time_ms

    worst = 0.0
    for li, (c, h, w) in zip((2, 3, 4), STRIDE2_SHAPES):
        weight = bb["encoder"][f"layer{li}"]["0"]["conv2"]["weight"]
        check(tuple(weight.shape) == (c, c, 3, 3),
              f"layer{li}'s stride-2 conv is {tuple(weight.shape)}")
        x = np.maximum(np.random.default_rng(li).normal(
            size=(1, c, h, w)), 0).astype(np.float32)
        xc = torch.tensor(x, device="cuda").contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            got = unet.conv({"weight": weight}, xc, 2)
            want = F.conv2d(F.pad(torch.tensor(x).double(), (0, 1, 0, 1)),
                            weight.cpu().double(), stride=2)
            ms = time_ms(lambda: unet.conv({"weight": weight}, xc, 2), 20)
            vision_ms = time_ms(lambda: F.conv2d(xc, weight, stride=2,
                                                 padding=1), 20)
        check(tuple(got.shape) == tuple(want.shape) == (1, c, h // 2,
                                                        w // 2),
              f"layer{li}'s stride-2 conv gives {tuple(got.shape)}")
        err = float((got.cpu().double() - want).abs().max()
                    / want.abs().max())
        worst = max(worst, err)
        print(f"stride-2 conv of layer{li} on ({c}, {h}, {w}), SAME (0, 1)"
              f": max |card f32 - cpu float64| / max = {err:.3e}; "
              f"{ms:.4f} ms ({card}; CUDA events, 20 calls) against "
              f"{vision_ms:.4f} ms padded (1, 1) without the copy")
    check(worst <= STRIDE2_TOL, f"a stride-2 conv on the card is {worst:.3e}"
          f" of its max from float64 (bar {STRIDE2_TOL})")
    return worst


def moved_backbone(torch, layers, seed, calibrate=None):
    """The port's unet_init at `layers` (seed 0) with every batch norm's
    weight, bias and running statistics and the head's bias drawn from
    `seed`: numpy leaves in the npz layout, as the converter writes a
    released backbone. With calibrate (an NHWC image), the running
    statistics are then those of the image's activations (one train-mode
    pass with momentum 1), as a trained network's match its data: at
    ResNet101 depth random statistics let the activations grow block by
    block until the class logits tie at a scale where f32 rounding flips
    the softmax."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.models import unet

    rng = np.random.default_rng(seed)
    flat = io.params_to_numpy(unet.unet_init(
        torch.Generator().manual_seed(0), layers=layers))
    for k, v in flat.items():
        if k.endswith(("running_mean", "/bias")):
            flat[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            flat[k] = rng.uniform(0.7, 1.5, v.shape).astype(np.float32)
        elif v.ndim == 1:  # batch-norm weights
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    if calibrate is not None:
        params = io.params_from_numpy(flat)
        bn, updates = unet.make_bn(None, train=True, momentum=1.0)
        with torch.no_grad():
            unet.decoder_apply(params["decoder"], unet.encoder_apply(
                params["encoder"], torch.tensor(calibrate), bn=bn), bn=bn)
        for path, stats in updates.items():
            for leaf, v in stats.items():
                flat[f"{path}/{leaf}"] = v.numpy()
    return flat


def small_segmentation_reference(torch):
    """Phase 9's first part, card against CPU at the CPU tests' width: a
    shallow backbone (layers (1, 1, 1, 1), the real widths, batch norms
    moved) under sdd_shortterm_train.yaml's Y-Net at small width with its
    6 classes, one raw 64 x 96 scene, B = 4 with a padded row. Three Adam
    steps each of segmentation_head and segmentation_bn (the backbone in
    the step) and of train with the backbone in train mode (e_unfreeze:
    the losses and the 'segmentation_bn' state); one eval batch with the
    backbone in the step (the card's draws decoded on both); the 16
    decoder channels of use_features_only and the goal logits after them.
    -> (relative loss, state (of each leaf's max), trajectory (model px)
    and feature / logit (of each one's max) differences)."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, step_config, ynet_config
    from mst_tpu_torch.models import segmentation as seg_lib
    from mst_tpu_torch.models.unet import extract_bn_stats
    from mst_tpu_torch.models.ynet import (init_ynet, pred_features,
                                           pred_goal, tree_map)
    from mst_tpu_torch.train.steps import (_prepare_inputs, make_eval_step,
                                           make_train_step)
    from mst_tpu_torch.train.trainer import setup_training

    tmp = tempfile.mkdtemp(prefix="mst_seg_small_")
    try:
        seg = os.path.join(tmp, "sdd_segmentation.npz")
        np.savez(seg, **moved_backbone(torch, (1, 1, 1, 1), 1))
        rng = np.random.default_rng(0)
        batch = {"semantic": rng.normal(size=(1, 64, 96, 3)),
                 "traj": rng.uniform(5, 60, size=(4, 20, 2)),
                 "mask": np.array([1.0, 1.0, 1.0, 0.0])}
        loss_err = state_err = traj_err = map_err = 0.0
        for train_net, over in (("segmentation_head",
                                 dict(segment_in_step=True)),
                                ("segmentation_bn",
                                 dict(segment_in_step=True)),
                                ("train", dict(segment_in_step=True,
                                               segment_train_mode=True))):
            params = get_params("sdd_shortterm_train.yaml", dict(
                SEG_SMALL, train_net=train_net, segmentation_model_fp=seg))
            mcfg = ynet_config(params)
            runs = {}
            for dev in ("cuda", "cpu"):
                weights, state = init_ynet(torch.Generator().manual_seed(0),
                                           mcfg, dev)
                weights["segmentation"] = seg_lib.load_params(seg, dev)
                if over.get("segment_train_mode"):
                    state = {"segmentation_bn": extract_bn_stats(
                        weights["segmentation"])}
                setup = setup_training(weights, params, steps_per_epoch=1)
                step = make_train_step(mcfg, step_config(params, **over))
                b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                     for k, v in batch.items()}
                losses = []
                for _ in range(3):
                    state, m = step(weights, state, setup["optimizer"],
                                    b)
                    losses.append([float(m[k]) for k in LOSS_KEYS])
                runs[dev] = (weights, state, b, losses)
            (_, s_gpu, b_gpu, l_gpu), (w_cpu, s_cpu, b_cpu, l_cpu) = \
                runs["cuda"], runs["cpu"]
            rel = max(abs(a - c) / abs(c) for ra, rc in zip(l_gpu, l_cpu)
                      for a, c in zip(ra, rc))
            st_gpu, st_cpu = (io.state_to_numpy(s) for s in (s_gpu, s_cpu))
            check(st_gpu.keys() == st_cpu.keys() and bool(st_cpu) == (
                train_net == "train"), f"{train_net}: the state's leaves")
            st = max([float(np.abs(st_gpu[k] - v).max()
                            / max(np.abs(v).max(), 1e-12))
                      for k, v in st_cpu.items()] + [0.0])
            print(f"small-width {train_net} (backbone in the step"
                  f"{', train mode' if st_cpu else ''}): losses card "
                  f"{l_gpu[-1]}, cpu {l_cpu[-1]} (step 2); max relative "
                  f"|card - cpu| loss {rel:.3e}, state {st:.3e} "
                  f"({len(st_cpu)} leaves)")
            loss_err, state_err = max(loss_err, rel), max(state_err, st)

        # one eval batch with the backbone in the step: the CPU's weights
        es = make_eval_step(mcfg, step_config(params, segment_in_step=True))
        w_gpu = tree_map(lambda t: t.detach().cuda(), w_cpu)
        with torch.no_grad():
            feats, wps = es.forward(w_gpu, {}, b_gpu, torch.Generator(
                device="cuda").manual_seed(0))
            got = es.decode_trajs(w_gpu, feats, wps).cpu()
            feats_cpu, _ = es.forward(w_cpu, {}, b_cpu, torch.Generator())
            want = es.decode_trajs(w_cpu, feats_cpu, wps.cpu())
        check(bool(torch.isfinite(got).all()), "segmented eval: non-finite")
        traj_err = float((got - want).abs().max())
        print(f"small-width eval batch, backbone in the step: max |card - "
              f"cpu| trajectory {traj_err:.3e} model px")

        # use_features_only: 16 channels into the Y-Net
        params = get_params("sdd_shortterm_train.yaml", dict(
            SEG_SMALL, use_features_only=True, segmentation_model_fp=seg))
        mcfg = ynet_config(params)
        check(mcfg.n_semantic_classes == 16, "use_features_only: not 16")
        scfg = step_config(params, segment_in_step=True)
        outs = {}
        for dev, b in (("cuda", b_gpu), ("cpu", b_cpu)):
            weights, _ = init_ynet(torch.Generator().manual_seed(0), mcfg,
                                   dev)
            weights["segmentation"] = seg_lib.load_params(seg, dev)
            with torch.no_grad():
                sem, obs, _ = _prepare_inputs(mcfg, scfg, weights,
                                              b["semantic"], b["traj"])
                f, _ = pred_features(weights, {}, mcfg, sem, obs)
                outs[dev] = (sem.cpu(), pred_goal(weights, f).cpu())
        for name, a, c in zip(("features", "goal logits"), outs["cuda"],
                              outs["cpu"]):
            e = float((a - c).abs().max() / c.abs().max())
            print(f"small-width use_features_only: {name} {tuple(c.shape)}"
                  f", max |card - cpu| / max = {e:.3e}")
            map_err = max(map_err, e)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return loss_err, state_err, traj_err, map_err


def trace_backbone_share(torch, label, fn, backbone="segmentation backbone"):
    """fn() under torch.profiler, the backbone inside a record_function
    range named `backbone`: the kernel time, the share of it launched
    inside the range, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda
               and e.key != backbone]
    if not kernels:
        print("profiler: no device time recorded (the backbone's share not "
              "measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    seg_ms = sum(e.device_time_total for e in events
                 if e.key == backbone and e.device_type != cuda) / 1e3
    span_ms = sum(e.self_device_time_total for e in events
                  if e.key == backbone and e.device_type == cuda) / 1e3
    print(f"profiler: {busy_ms:.2f} ms of kernels in a {wall_ms:.1f} ms "
          f"traced {label} (device busy {100 * busy_ms / wall_ms:.0f}%); "
          f"launched inside the backbone's range {seg_ms:.2f} ms "
          f"({100 * seg_ms / busy_ms:.1f}%), the range's span on the device "
          f"{span_ms:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def segmentation_path(torch, wrappers, card, rows_rec, fused_rec):
    """Phase 9's full-width part. The full ResNet101 U-Net (random weights
    from seed 0, batch norms moved and their statistics calibrated on the
    other scene: moved_backbone) written as data/sdd/sdd_segmentation.npz
    under a temporary working directory, where the shipped configs'
    data_dir ('data/') finds it; phase 6c's synthetic RGB scenes (1408 x
    1920 -> 352 x 480). The backbone alone: one scene card against CPU,
    CUDA-event ms beside its bound, peak memory. Then, with every kernel's
    count set to 0 before and read after: sdd_shortterm_eval.yaml (6
    classes) with TTST on, a 2-round test (the backbone once a scene);
    SEG_STEPS segmentation_head steps (the head moves, every other leaf
    stays); a 2-epoch train run with e_unfreeze 1 (the backbone's
    statistics adapt, its parameters stay); `python -m mst_tpu_torch.serve
    export --segment_in_step` of that run's checkpoint, whose LoadedModel
    answers one request on the raw scene as a Predictor does on the
    segmented map. Then each serving kernel against its plain version on
    the path's own operands, and a trace of one segmented test batch. ->
    {kernel name: launches on the path}."""
    import numpy as np
    from torch.profiler import record_function
    from torch.utils.flop_counter import FlopCounterMode

    from mst_tpu_torch import io, serve
    from mst_tpu_torch.config import get_params, step_config
    from mst_tpu_torch.data import images as images_lib
    from mst_tpu_torch.data import splits
    from mst_tpu_torch.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch.models import segmentation as seg_lib
    from mst_tpu_torch.models.unet import extract_bn_stats, unet_apply
    from mst_tpu_torch.probes import time_ms
    from mst_tpu_torch.train.steps import make_eval_step, make_train_step
    from mst_tpu_torch.train.trainer import Experiment, setup_training

    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="mst_seg_")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "data", "sdd"))
        seg_fp = os.path.join(tmp, "data", "sdd", "sdd_segmentation.npz")
        tracks, raw = make_synthetic_dataset(
            seed=0, n_scenes=2, n_traj=LOOP_TRACKS, img_hw=LOOP_SCENE_HW)
        np.random.seed(0)
        train, val, test = splits.dataset_split_by_ratio(tracks, 16, 16,
                                                         shuffle=True)
        scenes = images_lib.preprocess_scene_images(raw, 0.25, 32)
        scene = scenes["synth_0"][None]
        # the statistics of the other scene's activations
        flat = moved_backbone(torch, (3, 4, 23, 3), 0,
                              calibrate=scenes["synth_1"][None])
        np.savez(seg_fp, **flat)
        del flat
        os.chdir(tmp)
        H, W = scene.shape[1:3]
        print(f"segmentation: backbone file written, data made in "
              f"{time.perf_counter() - t0:.1f} s; scene {scene.shape}")

        # ---- the backbone alone, card against CPU, timed
        bb = seg_lib.load_params(seg_fp, "cuda")
        bb_cpu = seg_lib.load_params(seg_fp, "cpu")
        img = torch.tensor(scene, device="cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bb64 = io.unflatten({k: v.double() if v.is_floating_point() else v
                             for k, v in io.flatten(bb_cpu).items()})
        with torch.no_grad():
            with FlopCounterMode(display=False) as fc:
                probs = unet_apply(bb, img)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            t = time.perf_counter()
            want = unet_apply(bb_cpu, torch.tensor(scene)).double()
            cpu_s = time.perf_counter() - t
            exact = unet_apply(bb64, torch.tensor(scene).double())
        got = probs.cpu().double()
        errs = {name: float((a - b).abs().max()) for name, a, b in (
            ("card - cpu", got, want), ("card - f64", got, exact),
            ("cpu - f64", want, exact))}
        agree = {name: 100 * float((a.argmax(-1) == b.argmax(-1))
                                   .double().mean())
                 for name, a, b in (("card - cpu", got, want),
                                    ("card - f64", got, exact))}
        tol = max(SEG_TOL, 2 * errs["cpu - f64"])
        print(f"backbone (ResNet101 U-Net, {len(io.flatten(bb))} leaves) on "
              f"{tuple(scene.shape)}: probabilities {tuple(got.shape)}; max "
              + ", ".join(f"|{k}| = {v:.3e}" for k, v in errs.items())
              + f" (the card's tol {tol:.3e}); argmax agreement "
              + ", ".join(f"{k} {v:.4f}%" for k, v in agree.items())
              + f" of pixels; rows sum to 1 within "
              f"{float((got.sum(-1) - 1).abs().max()):.2e}; cpu f32 forward "
              f"{cpu_s:.2f} s")
        check(errs["card - f64"] <= tol, "the backbone on the card is "
              "further from float64 than the CPU's f32 allows")
        del bb64, exact
        flops = fc.get_total_flops()
        nbytes = (sum(v.numel() * v.element_size()
                      for v in io.flatten(bb).values())
                  + img.numel() * 4 + probs.numel() * 4)
        b_ms, by = bound(nbytes, flops)
        with torch.no_grad():
            ms = time_ms(lambda: unet_apply(bb, img), 10)
        print(f"backbone forward ({card}): {ms:.3f} ms (CUDA events, 10 "
              f"calls after 2 warm-ups); bound {b_ms:.3f} ms ({by}: "
              f"{flops / 1e9:.2f} GFLOP at {F32_FLOP_PER_S / 1e12:.0f} "
              f"TFLOP/s f32, {nbytes / 2**20:.1f} MiB); {100 * b_ms / ms:.1f}%"
              f" of the bound; peak device memory over the forward "
              f"{peak / 2**30:.3f} GiB beyond the {before / 2**30:.3f} GiB "
              f"held")
        print_trace(torch, "backbone forward", lambda: (
            unet_apply(bb, img), torch.cuda.synchronize()), conv_ops=6)
        check_stride2_convs(torch, bb, card)
        del bb_cpu, probs, got, want

        # ---- the path, counted
        base = dict(seed=0, batch_size=LOOP_B, dataset_path="synth",
                    ckpt_path=os.path.join(tmp, "ckpts"))
        test_params = get_params("sdd_shortterm_eval.yaml", dict(
            base, use_TTST=True, n_round=2))
        check(os.path.samefile(test_params["segmentation_model_fp"], seg_fp),
              "the shipped config does not name the backbone file")
        t = time.perf_counter()
        tested = Experiment(test_params, images=raw)
        load_s = time.perf_counter() - t
        check(tested.mcfg.segmentation == "unet"
              and tested.mcfg.n_semantic_classes == 6,
              "the shipped config does not take the backbone's 6 classes")
        n = {name: len(tested.prepare_data(tr, None, "val"))
             for name, tr in (("train", train), ("val", val),
                              ("test", test))}
        n_test_scenes = len(test.scene_ids())
        want = dict.fromkeys(wrappers, 0)
        want["softargmax_rows"] = (2 * n["test"] + 2 * SEG_STEPS
                                   + 2 * 2 * n["train"])
        want["fused_predict"] = 2 * n["test"] + 2 * n["val"] + 2
        want["kmeans"] = 2 * n["test"]  # the TTST test's 2 rounds
        print(f"segmentation path batches {n}; expected launches {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0

        # a 2-round TTST test: the backbone once a scene
        t = time.perf_counter()
        ade, fde, rounds, _ = tested.test(test, None)
        test_s = time.perf_counter() - t
        print(f"TTST test, 2 rounds ({n['test']} batches a round): "
              f"{test_s:.2f} s ({1e3 * test_s / (2 * n['test']):.1f} ms a "
              f"batch), ADE/FDE {ade:.3f} / {fde:.3f}; the backbone ran "
              f"{tested.n_segmented} times for {n_test_scenes} scenes; the "
              f"Experiment with its backbone built in {load_s:.2f} s")
        check(tested.n_segmented == n_test_scenes,
              "the test segmented a scene more than once")
        check(all(np.isfinite(m["ade"]).all() and len(m["ade"]) == 16
                  for m in rounds), "test rows not finite or not 16 a round")

        # segmentation_head steps: the backbone in the step
        head = Experiment(get_params("sdd_shortterm_train.yaml", dict(
            base, train_net="segmentation_head", lr=1e-3)), images=raw)
        setup = setup_training(head.model_params, head.params, 1)
        step = make_train_step(head.mcfg, step_config(
            head.params, segment_in_step=True))
        b0, db = head._device_batches(head.prepare_data(train, None,
                                                        "val"))[0]
        batch = {"semantic": db["image"], "traj": db["traj"],
                 "mask": db["mask"]}
        leaves = io.flatten(head.model_params)
        trained = sorted(k for k, v in leaves.items() if v.requires_grad)
        check(trained == ["segmentation/segmentation_head/0/bias",
                          "segmentation/segmentation_head/0/weight"],
              f"segmentation_head trains {trained}")
        before = {k: v.detach().clone() for k, v in leaves.items()}
        state, step_ms = {}, []
        for i in range(SEG_STEPS):
            t = time.perf_counter()
            state, m = step(head.model_params, state, setup["optimizer"],
                            batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            vals = {k: float(v) for k, v in m.items()}
            print(f"segmentation_head step {i}: {step_ms[-1]:.1f} ms, "
                  + ", ".join(f"{k} {v:.6f}" for k, v in vals.items()))
            check(all(np.isfinite(v) for v in vals.values()),
                  f"segmentation_head step {i}: non-finite metrics")
        for k, v in leaves.items():
            moved = not torch.equal(v, before[k])
            check(moved == (k in trained),
                  f"segmentation_head: {k} {'moved' if moved else 'stayed'}")
        step_peak = torch.cuda.max_memory_allocated()
        del before

        # two epochs across e_unfreeze
        t = time.perf_counter()
        unfrozen = Experiment(get_params("sdd_shortterm_train.yaml", dict(
            base, n_epoch=2, e_unfreeze=1, lr=1e-4)), images=raw)
        inline = extract_bn_stats(unfrozen.model_params["segmentation"])
        backbone0 = {k: v.clone() for k, v in io.flatten(
            unfrozen.model_params["segmentation"]).items()}
        unfrozen.train(train, val, None, None, "unfreeze")
        unfreeze_s = time.perf_counter() - t
        adapted = io.flatten(unfrozen.model_state["segmentation_bn"])
        inline = io.flatten(inline)
        check(adapted.keys() == inline.keys() and len(adapted) == 2 * 114,
              f"segmentation_bn holds {len(adapted)} leaves")
        move = max(float((adapted[k] - v).abs().max()) for k, v in
                   inline.items())
        check(all(not torch.equal(adapted[k], v) for k, v in inline.items()),
              "a batch norm's statistics did not adapt past e_unfreeze")
        check(all(torch.equal(v, backbone0[k]) for k, v in io.flatten(
            unfrozen.model_params["segmentation"]).items()),
              "the backbone's parameters moved past e_unfreeze")
        for r in unfrozen.epoch_log:
            check(np.isfinite(r["loss"]), f"e_unfreeze epoch {r['epoch']}")
            print(f"e_unfreeze run epoch {r['epoch']}: loss {r['loss']:.4f}"
                  f", {r['n_steps']} steps {r['steps_seconds']:.3f} s "
                  f"({1e3 * r['steps_seconds'] / r['n_steps']:.1f} ms a "
                  f"step), validation {r['val_seconds']:.3f} s")
        print(f"e_unfreeze run: {unfreeze_s:.2f} s; 114 batch norms "
              f"adapted (max move {move:.4f}), the backbone's parameters "
              f"unchanged; scenes segmented {unfrozen.n_segmented}")

        # export --segment_in_step of that run's checkpoint, then one
        # request each
        ckpt = os.path.join(tmp, "ckpts", "unfreeze.npz")
        mdir = os.path.join(tmp, "model")
        argv = sys.argv
        sys.argv = ["mst_tpu_torch.serve", "export", "--config_filename",
                    "sdd_shortterm_eval.yaml", "--pretrained_ckpt", ckpt,
                    "--out_dir", mdir, "--height", str(H), "--width",
                    str(W), "--batch_size", str(LOOP_B),
                    "--segment_in_step"]
        t = time.perf_counter()
        try:
            serve._main()
        finally:
            sys.argv = argv
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        model = serve.LoadedModel(mdir)
        print(f"export {export_s:.2f} s, LoadedModel "
              f"{time.perf_counter() - t:.2f} s")
        check(model.manifest["semantic_shape"] == [1, H, W, 3]
              and model.manifest["segment_in_step"],
              "the exported directory does not take the raw scene")
        pred = serve.Predictor(get_params("sdd_shortterm_eval.yaml", base),
                               ckpt, seed=0)
        observed = b0.trajectories[:, :8]
        got = model.predict(scene, observed, seed=0)
        with torch.no_grad():
            sem = unet_apply(pred.params["segmentation"],
                             torch.tensor(scene, device="cuda"))
        ref = pred.predict(sem, observed, seed=0)
        diff = max(float(np.abs(got[k] - ref[k]).max()) for k in got)
        print(f"export --segment_in_step: LoadedModel on the raw scene vs "
              f"Predictor on the segmented map, same seed: max |difference|"
              f" = {diff:.3e} raw px (tol {DEPLOY_TOL})")
        check(diff <= DEPLOY_TOL, "the segment_in_step directory disagrees")
        check_in_image("segment_in_step request", got["trajectories"], H, W,
                       0.25)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        path_peak = torch.cuda.max_memory_allocated()
        print(f"segmentation path launches: {launches}")
        check(launches == want, f"the segmentation path launched "
              f"{launches}, the code gives {want}")
        print(f"segmentation path ({card}): segmentation_head steps "
              f"{[round(s, 1) for s in step_ms]} ms; peak device memory "
              f"{step_peak / 2**30:.2f} GiB to the steps, "
              f"{path_peak / 2**30:.2f} GiB after them")

        # ---- each serving kernel on the path's own operands, then where
        # a segmentation_head step's time goes
        check_rows_on_path(torch, "segmentation_head", step,
                           head.model_params, {}, batch, rows_rec)
        print_trace(torch, "segmentation_head step", lambda: (
            step(head.model_params, state, setup["optimizer"],
                 batch), torch.cuda.synchronize()),
            conv_ops=6)
        # (the directory runs programs: the Predictor, on the segmented
        # map, has the same decode-tail operands)
        err = check_path_tail(torch, pred, sem, observed, seed=0)
        fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"], err)

        # ---- where a segmented test batch's time goes
        es = make_eval_step(tested.mcfg, step_config(tested.params))
        items = tested._device_batches(tested.prepare_data(test, None,
                                                           "test"))
        b1, db1 = items[0]

        def segmented_batch():
            with torch.no_grad():
                with record_function("segmentation backbone"):
                    sem = seg_lib.apply(tested.model_params["segmentation"],
                                        db1["image"])
                es(tested.model_params, tested.model_state,
                   {"semantic": sem, "traj": db1["traj"],
                    "mask": db1["mask"]},
                   torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()

        segmented_batch()
        trace_backbone_share(torch, "segmented TTST test batch",
                             segmented_batch)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 10: from raw annotations to a resumed run
# ---------------------------------------------------------------------------

RES_EPOCHS, RES_CUT = 4, 2  # the uninterrupted runs; the cut before --resume
RES_FLAGS = ["--train_net", "train", "--lr", "1e-4", "--smooth_val",
             "--window_size", "3"]
ETH_TOL = 1e-4  # world ADE/FDE, card against the CPU, relative
WINDOW_ROWS = 1_000_000  # rows of the native-against-pandas windowing
ETH_SCENES = ("eth", "hotel", "students003", "uni_examples", "zara01")
# eth and hotel take (y, x), so their matrices differ in the two scales;
# the others are plain scales
ETH_HOMOGRAPHIES = {"eth": [[0.05, 0.0, 1.0], [0.0, 0.02, -2.0],
                            [0.0, 0.0, 1.0]],
                    "hotel": [[0.03, 0.001, 0.5], [0.002, 0.06, 1.5],
                              [0.0, 0.0, 1.0]],
                    "students003": [[0.02, 0, 0], [0, 0.02, 0], [0, 0, 1]],
                    "uni_examples": [[0.04, 0, 0], [0, 0.04, 0], [0, 0, 1]],
                    "zara01": [[0.03, 0, 0], [0, 0.03, 0], [0, 0, 1]]}

def held(trainable, optimizer, state, val_ade, val_fde, best, snapshots,
         best_val_ade, best_epoch):
    """What a run holds of its training state, on the host."""
    from mst_tpu_torch import io

    def cpu(d):
        return {k: v.detach().cpu().clone() for k, v in d.items()}

    return {"trainable": cpu(trainable),
            "adam": {k: cpu(optimizer.state.get(p, {}))
                     for k, p in trainable.items()},
            "lr": float(optimizer.lr()),
            "count": int(optimizer.count),
            "state": cpu(io.flatten(state or {})),
            "val_ADE": [float(a) for a in val_ade],
            "val_FDE": [float(a) for a in val_fde],
            "best": None if best is None else cpu(best),
            "snapshots": [cpu(s) for s in snapshots or []],
            "best_val_ade": float("inf") if best_val_ade is None
            else float(best_val_ade),
            "best_epoch": int(best_epoch or 0)}


@contextlib.contextmanager
def state_hooks(dump, dump_epoch):
    """The port's training-state calls wrapped: what a run holds when it
    writes the state of epoch dump_epoch goes to dump + '.saved', what a
    restore put in place to dump + '.restored' (torch.save)."""
    import torch

    from mst_tpu_torch.train import trainer

    cls = trainer.Experiment
    save, restore = cls.save_training_state, cls.restore_training_state

    def save_hook(self, path, trainable, optimizer, epoch,
                  val_history=None, model_state=None, val_fde_history=None,
                  best_snapshot=None, best_val_ade=None, best_epoch=None,
                  snapshots=None):
        save(self, path, trainable, optimizer, epoch, val_history,
             model_state, val_fde_history, best_snapshot, best_val_ade,
             best_epoch, snapshots)
        if epoch == dump_epoch:
            torch.save(held(trainable, optimizer, model_state,
                            val_history or [], val_fde_history or [],
                            best_snapshot, snapshots, best_val_ade,
                            best_epoch), dump + ".saved")

    def restore_hook(self, path, trainable, optimizer):
        epoch, x = restore(self, path, trainable, optimizer)
        torch.save(held(trainable, optimizer, x["model_state"],
                        x["val_ADE"], x["val_FDE"], x["best_snapshot"],
                        x["snapshots"], x["best_val_ade"], x["best_epoch"]),
                   dump + ".restored")
        return epoch, x

    cls.save_training_state, cls.restore_training_state = \
        save_hook, restore_hook
    try:
        yield
    finally:
        cls.save_training_state, cls.restore_training_state = save, restore


def run_main(label, module, args, cwd, wrappers, dump=None, dump_epoch=-1):
    """The CLI `python -m module args` as its main() in this process, from
    cwd, with cuDNN's deterministic algorithms (with the bilinear
    backward's fixed order, two runs of one recipe end on the same bits),
    and with dump the training-state calls wrapped (state_hooks) ->
    (stdout, host seconds, kernel launches, peak GiB). In this process a
    run pays no process start (~9-15 s) and no cold first epoch."""
    import importlib

    import torch

    from mst_tpu_torch.config import get_parser

    if module in ("mst_tpu_torch.train", "mst_tpu_torch.test"):
        is_train = module == "mst_tpu_torch.train"
        main = importlib.import_module(
            module + (".__main__" if is_train else "")).main
        parsed = get_parser(is_train).parse_args(args)

        def run():
            return main(parsed)
    else:
        main = importlib.import_module(module).main

        def run():
            return main(list(args))
    old_cwd, deterministic = os.getcwd(), torch.backends.cudnn.deterministic
    text = io_text.StringIO()
    hooks = (state_hooks(dump, dump_epoch) if dump is not None
             else contextlib.nullcontext())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        torch.backends.cudnn.deterministic = True
        with hooks, contextlib.redirect_stdout(text):
            _, launches = count_launches(wrappers, run)
        torch.cuda.synchronize()
    except BaseException:
        print(f"{label}: `{module}` failed; its output's tail:\n"
              f"{text.getvalue()[-3000:]}")
        raise
    finally:
        os.chdir(old_cwd)
        torch.backends.cudnn.deterministic = deterministic
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: `{module}` main() {dt:.1f} s host, peak device memory "
          f"{peak:.2f} GiB")
    return text.getvalue(), dt, launches, peak


def state_distance(a, b):
    """The largest |difference| of a trainable leaf of two training-state
    files' arrays, over that leaf's max in b."""
    import numpy as np

    keys = [k for k in b if k.startswith("trainable/")]
    check(keys and sorted(keys) == sorted(k for k in a
                                          if k.startswith("trainable/")),
          "the training-state files hold other trainable leaves")
    return max(float(np.abs(a[k] - b[k]).max())
               / max(float(np.abs(b[k]).max()), 1e-30) for k in keys)


def history_distance(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(a.shape == b.shape, "val histories of different lengths")
    return float((np.abs(a - b) / np.abs(b)).max())


def assert_same_held(saved, restored):
    """What the 2-epoch process held as it wrote its state against what the
    resumed process holds after the restore, bit for bit."""
    import torch

    def same(x, y, what):
        if isinstance(x, dict):
            check(isinstance(y, dict) and sorted(x) == sorted(y),
                  f"restore: {what} keys differ")
            for k in x:
                same(x[k], y[k], f"{what}/{k}")
        elif isinstance(x, list):
            check(isinstance(y, list) and len(x) == len(y),
                  f"restore: {what} lengths differ")
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{what}/{i}")
        elif isinstance(x, torch.Tensor):
            check(isinstance(y, torch.Tensor) and x.dtype == y.dtype
                  and x.shape == y.shape and torch.equal(x, y),
                  f"restore: {what} differs")
        else:
            check(x == y, f"restore: {what} {x!r} != {y!r}")

    same(saved, restored, "state")


def write_eth_world(root, images_hw, seed=1, n_traj=16):
    """ETH_SCENES as oracle.png class masks (blocks of 32 px, classes 0-2)
    under root/data/eth/images/<scene>, their homographies under
    root/data/eth_ucy, and tracks split 40 / 24 / 16 into
    root/data/eth/split/{train,val,test}.pkl -> the tracks."""
    import numpy as np

    import cv2
    import pandas as pd

    from mst_tpu_torch.data.synthetic import make_synthetic_dataset

    tracks, _ = make_synthetic_dataset(seed=seed, n_scenes=len(ETH_SCENES),
                                       n_traj=n_traj, img_hw=images_hw)
    names = {f"synth_{i}": s for i, s in enumerate(ETH_SCENES)}
    tracks = tracks.replace(sceneId=np.asarray(
        [names[s] for s in tracks.sceneId], object))
    rng = np.random.default_rng(seed)
    for scene in ETH_SCENES:
        d = os.path.join(root, "data", "eth", "images", scene)
        os.makedirs(d)
        blocks = rng.integers(0, 3, size=(images_hw[0] // 32,
                                          images_hw[1] // 32))
        cv2.imwrite(os.path.join(d, "oracle.png"),
                    np.kron(blocks, np.ones((32, 32))).astype(np.uint8))
    os.makedirs(os.path.join(root, "data", "eth_ucy"))
    for scene, mat in ETH_HOMOGRAPHIES.items():
        np.savetxt(os.path.join(root, "data", "eth_ucy", f"{scene}_H.txt"),
                   np.asarray(mat, np.float64))
    df = pd.DataFrame({"metaId": tracks.metaId, "sceneId": tracks.sceneId,
                       "frame": tracks.frame, "x": tracks.x, "y": tracks.y,
                       "label": "Pedestrian"})
    ids = np.random.default_rng(seed).permutation(np.unique(tracks.metaId))
    split = os.path.join(root, "data", "eth", "split")
    os.makedirs(split)
    for name, part in (("train", ids[:40]), ("val", ids[40:64]),
                       ("test", ids[64:])):
        df[df.metaId.isin(part)].to_pickle(os.path.join(split,
                                                        f"{name}.pkl"))
    return tracks


def time_windowing():
    """The native windowing against its pandas chain at WINDOW_ROWS rows
    (SDD's step 12, window 20, stride 20, with frame gaps): equal frames,
    host ms of each."""
    import numpy as np

    import pandas as pd

    from mst_tpu_torch import native
    from mst_tpu_torch.data.trajectories import window_chain

    rng = np.random.default_rng(0)
    n_tracks, length = WINDOW_ROWS // 250, 250
    frame = np.tile(np.arange(length), n_tracks)
    frame = frame + (frame >= 97) * (np.repeat(np.arange(n_tracks), length)
                                     % 2)  # a gap in every odd track
    df = pd.DataFrame({"metaId": np.repeat(np.arange(n_tracks), length),
                       "frame": frame, "x": rng.uniform(0, 1900, n_tracks
                                                        * length),
                       "y": rng.uniform(0, 1400, n_tracks * length),
                       "sceneId": "s_0", "label": "Pedestrian"})
    native.load_lib()  # the build is not timed
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = native.load_and_window_native(df, 12, 20, 20)
        ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    want = window_chain(df, 12, 20, 20)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    pd.testing.assert_frame_equal(got, want)
    print(f"windowing {len(df)} rows -> {len(got)} ({got.metaId.nunique()} "
          f"windows): native {min(ms):.1f} ms (best of 3: "
          f"{[round(m, 1) for m in ms]}), pandas chain {plain_ms:.1f} ms, "
          f"{plain_ms / min(ms):.1f}x; equal frames")
    return min(ms), plain_ms


def raw_to_resumed(torch, wrappers, card, rows_rec, fused_rec):
    """Phase 10: from raw annotations to a resumed run, at the full width
    of sdd_shortterm_train.yaml (352 x 480, B = 8, the identity backbone's
    3 classes). -> {kernel: launches over the phase's CLI runs}."""
    import numpy as np

    import pandas as pd

    from mst_tpu_torch.config import get_params, step_config
    from mst_tpu_torch.data import splits, trajectories
    from mst_tpu_torch.data.sdd import load_raw_sdd
    from mst_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                              write_sdd_annotations)
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.train.steps import make_eval_step, make_train_step
    from mst_tpu_torch.train.trainer import Experiment, restore_model

    import cv2
    import yaml

    tmp = tempfile.mkdtemp(prefix="mst_res_")
    try:
        # ---- the raw files: phase 6c's scenes as SDD annotations
        t0 = time.perf_counter()
        tracks, images = make_synthetic_dataset(
            seed=0, n_scenes=2, n_traj=LOOP_TRACKS, img_hw=LOOP_SCENE_HW)
        raw = os.path.join(tmp, "data", "sdd", "raw")
        n_rows = write_sdd_annotations(tracks, raw, step=12,
                                       labels=("Pedestrian",))
        for scene, im in images.items():
            name, idx = scene.split("_")
            cv2.imwrite(os.path.join(raw, "annotations", name, f"video{idx}",
                                     "reference.jpg"),
                        (im * 255).astype(np.uint8))
        print(f"raw SDD files: {n_rows} annotation rows of "
              f"{len(np.unique(tracks.metaId))} tracks (12 raw frames a "
              f"sample), 2 reference.jpg of {LOOP_SCENE_HW}, written in "
              f"{time.perf_counter() - t0:.2f} s")

        # ---- the builders, in scripts/sdd/preprocessing.sh's order
        _, build_s, _, _ = run_main("build", "mst_tpu_torch.data.sdd", [],
                                    tmp, wrappers)
        _, bucket_s, _, _ = run_main(
            "buckets", "mst_tpu_torch.data.sdd",
            ["--reload", "--varf", "agent_type", "--labels", "Pedestrian"],
            tmp, wrappers)
        bucket = os.path.join(tmp, "data/sdd/filter/shortterm/agent_type")
        _, split_s, _, _ = run_main(
            "split", "mst_tpu_torch.data.split_dataset",
            ["--data_dir", bucket, "--data_filename", "Pedestrian.pkl",
             "--val_split", "16", "--test_split", "16", "--seed", "1"], tmp,
            wrappers)
        # the same pickles from the pandas chain, in this process
        plain = os.path.join(tmp, "plain")
        chain = trajectories.window_chain(load_raw_sdd(raw), 12, 20, 20)
        pd.testing.assert_frame_equal(
            pd.read_pickle(os.path.join(raw, "data_8_12_2_5fps.pkl")), chain)
        trajectories.create_dataset_by_agent_type(chain, ["Pedestrian"],
                                                  plain)
        splits.split_train_val_test_randomly(plain, "Pedestrian.pkl", 16, 16,
                                             seed=1)
        for rel in ("Pedestrian.pkl", "Pedestrian/train.pkl",
                    "Pedestrian/val.pkl", "Pedestrian/test.pkl"):
            pd.testing.assert_frame_equal(
                pd.read_pickle(os.path.join(bucket, rel)),
                pd.read_pickle(os.path.join(plain, rel)))
        print(f"builder pickles: the windowed frame ({len(chain)} rows, "
              f"{chain.metaId.nunique()} windows) and the bucket and split "
              f"pickles equal the pandas chain's; host seconds build "
              f"{build_s:.1f}, buckets {bucket_s:.1f}, split {split_s:.1f} "
              f"(each its CLI's main() in this process)")
        native_ms, chain_ms = time_windowing()

        # ---- the config: the shipped yaml with the identity backbone's 3
        # classes
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "mst_tpu_torch", "configs",
                               "sdd_shortterm_train.yaml")) as f:
            shipped = yaml.safe_load(f)
        # the identity backbone's 3 classes; a training state every epoch
        shipped.update(n_semantic_classes=3, save_every_n=1)
        with open(os.path.join(tmp, "sdd3.yaml"), "w") as f:
            yaml.safe_dump(shipped, f)
        common = ["--config_filename", "sdd3.yaml", "--seed", "1",
                  "--batch_size", str(LOOP_B), "--dataset_path",
                  "filter/shortterm/agent_type/Pedestrian", "--load_data",
                  "predefined"]
        params = get_params("sdd_shortterm_train.yaml", {
            "n_semantic_classes": 3, "batch_size": LOOP_B, "seed": 1,
            "save_every_n": 1, "data_dir": os.path.join(tmp, "data")})
        sdd_images = os.path.join(raw, "annotations")
        data_path = os.path.join(bucket, "Pedestrian")
        train_t, val_t, test_t = (splits.read_pickle(os.path.join(
            data_path, f"{n}.pkl")) for n in ("train", "val", "test"))
        probe = Experiment(params)
        n = {name: len(probe.prepare_data(t, sdd_images, "val"))
             for name, t in (("train", train_t), ("val", val_t),
                             ("test", test_t))}
        del probe

        def want_launches(epochs, tests=1, train=None, val=None, test=None):
            w = dict.fromkeys(wrappers, 0)
            w["softargmax_rows"] = 2 * epochs * (train or n["train"])
            w["fused_predict"] = epochs * (val or n["val"]) + tests * (
                test or n["test"])
            return w

        res = dict.fromkeys(wrappers, 0)

        def tally(label, launches, want):
            print(f"{label}: launches {launches}")
            check(launches == want, f"{label} launched {launches}, the code "
                  f"gives {want}")
            for k, v in launches.items():
                res[k] += v

        # ---- A: the uninterrupted run; C: the cut; R: --resume
        name = "Seed_1__filter_shortterm_agent_type_Pedestrian__train__" \
            "original"
        runs = {}
        for label, ckpt, epochs, extra in (
                ("A", "ckpts_a", RES_EPOCHS, []),
                ("C", "ckpts_r", RES_CUT, []),
                ("R", "ckpts_r", RES_EPOCHS, ["--resume"])):
            out, secs, launches, peak = run_main(
                f"run {label}", "mst_tpu_torch.train",
                common + RES_FLAGS + [
                    "--n_epoch", str(epochs), "--ckpt_path", ckpt,
                    "--metrics_jsonl", f"{ckpt}_{label}.jsonl"] + extra,
                tmp, wrappers, dump=os.path.join(tmp, f"held_{label}"),
                dump_epoch=RES_CUT)
            done = epochs - (RES_CUT if label == "R" else 0)
            tally(f"run {label}", launches, want_launches(done))
            with open(os.path.join(tmp, f"{ckpt}_{label}.jsonl")) as f:
                log = [json.loads(line) for line in f]
            state = dict(np.load(os.path.join(
                tmp, ckpt, f"{name}__train_state.npz")))
            with open(os.path.join(tmp, ckpt,
                                   f"{name}__train_state.npz.json")) as f:
                meta = json.load(f)
            runs[label] = dict(log=log, state=state, meta=meta, secs=secs,
                               peak=peak, out=out)
            for r in log:
                check(np.isfinite(r["loss"]), f"run {label} epoch "
                      f"{r['epoch']}: loss {r['loss']}")
                print(f"  run {label} epoch {r['epoch']}: loss "
                      f"{r['loss']:.6f}, val ADE/FDE {r['val_ade']:.4f} / "
                      f"{r['val_fde']:.4f}; {r['n_steps']} steps "
                      f"{r['steps_seconds']:.3f} s, validation "
                      f"{r['val_seconds']:.3f} s")
        check("Resumed training state at epoch 2" in runs["R"]["out"],
              "run R did not resume")
        check([r["epoch"] for r in runs["R"]["log"]] == [2, 3],
              "run R did not start at epoch 2")
        check(runs["R"]["meta"]["epoch"] == RES_EPOCHS
              and runs["A"]["meta"]["epoch"] == RES_EPOCHS,
              "the final training states are not epoch 4's")

        # the restore is exact: what C held when it wrote epoch 2's state
        # is what R holds after loading it
        saved = torch.load(os.path.join(tmp, "held_C.saved"))
        restored = torch.load(os.path.join(tmp, "held_R.restored"))
        assert_same_held(saved, restored)
        n_adam = sum(len(v) for v in saved["adam"].values())
        print(f"restore: {len(saved['trainable'])} leaves, {n_adam} Adam "
              f"tensors (exp_avg, exp_avg_sq), LR {saved['lr']} at "
              f"step {saved['count']}, {len(saved['state'])}"
              f" state leaves, val history {saved['val_ADE']}, best "
              f"{'none' if saved['best'] is None else 'a snapshot'}, "
              f"{len(saved['snapshots'])} smooth-val snapshot(s): equal bit "
              f"for bit")

        # the resumed run ends on A's bits: the runs take cuDNN's
        # deterministic algorithms, so the card adds no run-to-run noise
        d_ra = state_distance(runs["R"]["state"], runs["A"]["state"])
        h = {key: history_distance(runs["R"]["meta"][key],
                                   runs["A"]["meta"][key])
             for key in ("val_ADE", "val_FDE")}
        print(f"resume against the uninterrupted run ({card}): leaves "
              f"|R - A| {d_ra:.3e} of each leaf's max; val ADE "
              f"{h['val_ADE']:.3e}, val FDE {h['val_FDE']:.3e} (relative); "
              f"bound 0")
        check(d_ra == 0 and all(r == 0 for r in h.values()),
              "the resumed run does not end on the uninterrupted run's bits")
        a_epochs = [r["steps_seconds"] + r["val_seconds"]
                    for r in runs["A"]["log"]]
        r_epochs = [r["steps_seconds"] + r["val_seconds"]
                    for r in runs["R"]["log"]]
        print(f"phase 10 host seconds ({card}): build {build_s:.1f}, "
              f"buckets {bucket_s:.1f}, split {split_s:.1f}; run A "
              f"{runs['A']['secs']:.1f} (epochs "
              f"{[round(s, 3) for s in a_epochs]}), C "
              f"{runs['C']['secs']:.1f}, R (--resume) "
              f"{runs['R']['secs']:.1f} (epochs "
              f"{[round(s, 3) for s in r_epochs]}); peak device memory "
              f"{max(r['peak'] for r in runs.values()):.2f} GiB; windowing "
              f"native {native_ms:.1f} ms, pandas {chain_ms:.1f} ms")

        # the rows kernel on a train step's own maps of this path
        exp = Experiment(params)
        exp.load_params(os.path.join(tmp, "ckpts_a", f"{name}.npz"))
        items = exp._device_batches(exp.prepare_data(
            train_t, sdd_images, "train", rng=np.random.default_rng(0)))
        b, db = items[0]
        check_rows_on_path(torch, "resumed path's", make_train_step(
            exp.mcfg, step_config(params)), exp.model_params,
            exp.model_state, exp._step_batch(b, db, {}), rows_rec)
        del exp, items

        # ---- ETH: a 1-epoch fine-tune and a test in world coordinates
        write_eth_world(tmp, LOOP_SCENE_HW)
        eth_cfg = dict(shipped, dataset_name="eth", use_raw_data=False)
        with open(os.path.join(tmp, "eth.yaml"), "w") as f:
            yaml.safe_dump(eth_cfg, f)
        base = os.path.join(tmp, "ckpts_a", f"{name}.npz")
        eth_common = ["--config_filename", "eth.yaml", "--seed", "1",
                      "--batch_size", str(LOOP_B), "--dataset_path", "split",
                      "--load_data", "predefined", "--eth_world_coords"]
        eth_params = get_params("sdd_shortterm_train.yaml", {
            "n_semantic_classes": 3, "batch_size": LOOP_B, "seed": 1,
            "dataset_name": "eth", "use_raw_data": False,
            "data_dir": os.path.join(tmp, "data"), "eth_world_coords": True,
            "train_net": "mosa_2", "position": POSITIONS,
            "fine_tune": True})
        eth_images = os.path.join(tmp, "data", "eth", "images")
        eth_t = {k: splits.read_pickle(os.path.join(
            tmp, "data", "eth", "split", f"{k}.pkl"))
            for k in ("train", "val", "test")}
        probe = Experiment(eth_params)
        val_batches = probe.prepare_data(eth_t["val"], eth_images, "val")
        cut = probe._validation_cut(val_batches)
        cut_scenes = sorted({b.scene_id for b in cut})
        all_scenes = sorted({b.scene_id for b in val_batches})
        print(f"ETH validation: {len(val_batches)} batches of "
              f"{len(all_scenes)} scenes; the cut keeps {len(cut)} batches "
              f"of {len(cut_scenes)} scenes (30 // {LOOP_B} = "
              f"{30 // LOOP_B})")
        check(len(cut_scenes) == 30 // LOOP_B < len(all_scenes),
              "the ETH validation cut does not hold 30 // B scenes")
        ne = {"train": len(probe.prepare_data(eth_t["train"], eth_images,
                                              "val")),
              "val": len(cut),
              "test": len(probe.prepare_data(eth_t["test"], eth_images,
                                             "val"))}
        del probe
        out, eth_s, launches, _ = run_main(
            "ETH fine-tune", "mst_tpu_torch.train",
            eth_common + ["--train_net", "mosa_2", "--position", *POSITIONS,
                          "--fine_tune", "--n_train_batch", "5",
                          "--n_epoch", "1", "--lr", "3e-3",
                          "--pretrained_ckpt", base, "--ckpt_path",
                          "ckpts_eth"], tmp, wrappers)
        tally("ETH fine-tune", launches, want_launches(
            1, train=ne["train"], val=ne["val"], test=ne["test"]))
        (delta,) = [os.path.join(tmp, "ckpts_eth", f)
                    for f in os.listdir(os.path.join(tmp, "ckpts_eth"))
                    if f.endswith("__original.npz")]
        out, test_s, launches, _ = run_main(
            "ETH test", "mst_tpu_torch.test",
            eth_common + ["--n_round", "1", "--pretrained_ckpt", base,
                          "--tuned_ckpt", delta], tmp, wrappers)
        tally("ETH test", launches, want_launches(0, test=ne["test"]))
        ades = [float(a) for a in re.findall(r"Test ADE: ([\d.eE+-]+)", out)]
        fdes = [float(a) for a in re.findall(r"Test FDE: ([\d.eE+-]+)", out)]
        print(f"ETH test (world coordinates, {card}): ADE {ades[-1]:.4f}, "
              f"FDE {fdes[-1]:.4f}; fine-tune {eth_s:.1f} s, test "
              f"{test_s:.1f} s host")
        check(ades and all(np.isfinite(ades + fdes))
              and 0 < ades[-1] < 50, "the ETH world metrics are not finite "
              "world distances")

        # world ADE/FDE on the card against the CPU, on the same draws, and
        # the fused kernel on this path's own operands
        models = {dev: restore_model(eth_params, True, base, delta,
                                     device=dev) for dev in ("cuda", "cpu")}
        card_exp = models["cuda"]
        batches = card_exp.prepare_data(eth_t["test"], eth_images, "test")
        fullest = max(batches, key=lambda b: b.mask.sum())
        b, db = card_exp._device_batches([fullest])[0]
        db = card_exp._step_batch(b, db, {})
        check(step_config(eth_params).world_coords,
              "the ETH step does not score in world coordinates")
        es = make_eval_step(card_exp.mcfg, step_config(eth_params))
        with torch.no_grad():
            feats, wps = es.forward(card_exp.model_params,
                                    card_exp.model_state, db,
                                    torch.Generator("cuda").manual_seed(0))
            got = es.decode_and_score(card_exp.model_params, feats, wps,
                                      db["traj"], db["mask"],
                                      db["homography"])
            x, w, bias = es.prepredictor(card_exp.model_params, feats)(wps)
            cpu = models["cpu"]
            cdb = {k: v.cpu() for k, v in db.items()}
            cfeats, _ = es.forward(cpu.model_params, cpu.model_state, cdb,
                                   torch.Generator().manual_seed(0))
            want = es.decode_and_score(cpu.model_params, cfeats, wps.cpu(),
                                       cdb["traj"], cdb["mask"],
                                       cdb["homography"])
        m = db["mask"].cpu().numpy() > 0
        errs = {k: float((np.abs(got[k].cpu().numpy() - want[k].numpy())
                          / np.abs(want[k].numpy()))[m].max())
                for k in ("ade", "fde")}
        print(f"ETH world ADE/FDE, card against CPU on one test batch's "
              f"draws ({int(m.sum())} rows): max relative |difference| ADE "
              f"{errs['ade']:.3e}, FDE {errs['fde']:.3e} (tol {ETH_TOL})")
        check(max(errs.values()) <= ETH_TOL,
              "ETH world metrics on the card disagree with the CPU")
        k_out = fused_predictor_softargmax(x, w, bias)
        k_plain = fused_predictor_softargmax_plain(x, w, bias)
        e = float((k_out - k_plain).abs().max())
        print(f"fused predictor on the ETH path's operands {tuple(x.shape)} "
              f"x {tuple(w.shape)}: max |kernel - plain| = {e:.3e} px (tol "
              f"{FUSED_TOL})")
        check(e <= FUSED_TOL, "fused kernel disagrees on the ETH path")
        fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"], e)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10 launches over its CLI runs: {res}")
    for k in ("softargmax_rows", "fused_predict"):
        check(res[k] > 0, f"{k} never ran on phase 10's path")
    return res



# ---------------------------------------------------------------------------
# phase 12: --fused as CUDA graphs, the grid under torch.func.vmap
# ---------------------------------------------------------------------------

P12_EPOCHS = 4  # 12a: chunks of 2 (save_every_n 2)
GRID_EPOCHS = 3
GRID_SEEDS = ("1", "2")
GRID_LRS = ("3e-3", "1e-3")
# 12b's bars, a grid run against its own loop run. The vmapped convs take
# the runs' LoRA-merged weights batched (grouped convs, other cuDNN
# algorithms), so bits differ, and Adam divides each update by
# sqrt(nu) + eps: where a gradient is near eps its update moves with the
# gradient's last bits. So the saved weights are held in units of the
# learning rate (a hundredth of one Adam step an element; lora_B starts
# at 0 and is only a few steps large), beside two loop runs on cuDNN's
# default algorithms; the val histories to 1e-5 relative, the best
# epochs equal
GRID_STEP_TOL = 1e-2
GRID_VAL_RTOL = 1e-5


def run_loop_or_fused(torch, wrappers, params, images, train, val, base,
                      name):
    """One fine-tune through Experiment.train from `base` -> (Experiment,
    host seconds, {kernel: launches}, peak GiB)."""
    from mst_tpu_torch.train.trainer import Experiment

    exp = Experiment(params, images=images)
    exp.load_params(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    exp.train(train, val, None, None, name)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: w.launches for k, w in wrappers.items()}
    return exp, wall, launches, torch.cuda.max_memory_allocated() / 2**30


def run_distance(torch, a, b):
    """Two Experiments' runs -> (bit-equal, {what: max distance}): the
    epochs' losses and val ADE/FDE (relative), the best epochs, and the
    final leaves (over each leaf's max)."""
    import numpy as np

    from mst_tpu_torch import io

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return float((np.abs(x - y) / np.maximum(np.abs(y), 1e-12)).max())

    la = [r["loss"] for r in a.epoch_log]
    lb = [r["loss"] for r in b.epoch_log]
    wa, wb = io.flatten(a.model_params), io.flatten(b.model_params)
    dist = {"loss": rel(la, lb), "val_ade": rel(a.val_ADE, b.val_ADE),
            "val_fde": rel(a.val_FDE, b.val_FDE),
            "best_epoch": abs(a.best_epoch - b.best_epoch),
            "weights": max(float((wa[k] - wb[k]).detach().abs().max())
                           / max(float(wb[k].detach().abs().max()), 1e-12)
                           for k in wb)}
    bit = (la == lb and a.val_ADE == b.val_ADE and a.val_FDE == b.val_FDE
           and a.best_epoch == b.best_epoch
           and all(torch.equal(wa[k], wb[k]) for k in wb))
    return bit, dist


def rows_in_replay(torch, exp):
    """The rows kernel captured in a CUDA graph on a train step's own maps
    (the fused run's weights and first packed batch), replayed on two
    fillings of its input, each against the plain version -> max px."""
    from mst_tpu_torch.config import step_config
    from mst_tpu_torch.ops.kernels import launches
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows
    from mst_tpu_torch.ops.softargmax import softargmax2d
    from mst_tpu_torch.train import fused as fused_lib
    from mst_tpu_torch.train.steps import make_train_step

    runner = exp.fused_runner
    batch = fused_lib.index_batch(
        runner.train_data,
        torch.zeros(1, dtype=torch.long, device=runner.device))
    with torch.no_grad():
        _, _, goal_map, traj_map, _ = make_train_step(
            exp.mcfg, step_config(exp.params)).forward(
                exp.model_params, exp.model_state, batch)
    maps = traj_map.permute(0, 3, 1, 2).contiguous()
    x = maps.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        softargmax2d_rows(x)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = launches.Graph()
    out = graph.capture(lambda: softargmax2d_rows(x), stream)
    err = 0.0
    for fill in (maps, goal_map[..., -1:].permute(0, 3, 1, 2).expand_as(
            maps) * 0.5 + maps * 0.5):
        x.copy_(fill)
        graph.replay()
        torch.cuda.synchronize()
        err = max(err, float((out - softargmax2d(x)).abs().max()))
    check(graph.per_replay == {(softargmax2d_rows, "launches"): 1},
          f"the captured rows graph holds {graph.per_replay}")
    return err, tuple(maps.shape)


def fused_loop_pair(torch, wrappers, card, images, train, val, base, tmp,
                    dtype):
    """12a in one compute dtype: the same 4-epoch fine-tune through the
    loop and through --fused -> (loop exp, fused exp, fused launches)."""
    import numpy as np

    from mst_tpu_torch.train import fused as fused_lib

    _, params = loop_params(tmp, [
        "--train_net", "mosa_2", "--position", *POSITIONS, "--fine_tune",
        "--n_train_batch", "2", "--n_epoch", str(P12_EPOCHS), "--lr",
        "3e-3", "--smooth_val", "--window_size", "3", "--compute_dtype",
        dtype])
    params["save_every_n"] = 2
    loop, loop_s, loop_l, loop_gib = run_loop_or_fused(
        torch, wrappers, params, images, train, val, base, f"loop_{dtype}")
    fused_lib.REPLAY_SYNC_DEBUG = "error"  # no sync inside the replays
    try:
        fused, fused_s, fused_l, fused_gib = run_loop_or_fused(
            torch, wrappers, dict(params, fused=True), images, train, val,
            base, f"fused_{dtype}")
    finally:
        fused_lib.REPLAY_SYNC_DEBUG = 0
    runner = fused.fused_runner
    check(runner is not None and runner.graph is not None,
          f"{dtype}: --fused did not run as a CUDA graph")
    bit, dist = run_distance(torch, fused, loop)
    print(f"12a {dtype}: fused against loop over {P12_EPOCHS} epochs: "
          f"bit-equal {bit}; distances {dist}; best epochs "
          f"{fused.best_epoch} / {loop.best_epoch}; the replays ran under "
          f"sync debug 'error'")
    check(bit, f"{dtype}: --fused differs from the loop: {dist}")
    n_train, n_val = runner.n_train, len(runner.val_batches)
    suffix = "_bf16" if dtype == "bfloat16" else ""
    per_replay = {f"{fn.__name__}.{name}": n
                  for (fn, name), n in runner.graph.per_replay.items()}
    per_chunk = {k: 2 * n for k, n in per_replay.items()}
    want = dict.fromkeys(wrappers, 0)
    want["softargmax_rows" + suffix] = 2 + 2 * n_train * P12_EPOCHS
    want["fused_predict" + suffix] = 1 + n_val * P12_EPOCHS
    print(f"12a {dtype}: {runner.replays} replays of one captured epoch "
          f"({n_train} steps, {n_val} validation batches), capture "
          f"{runner.capture_seconds:.2f} s; launches a replay {per_replay}, "
          f"a 2-epoch chunk {per_chunk}; the fused "
          f"run's launches (warm-up + replays) {fused_l}")
    check(fused_l == want, f"{dtype}: the fused run launched {fused_l}, "
          f"the code gives {want}")
    loop_ep = [r["steps_seconds"] + r["val_seconds"] for r in loop.epoch_log]
    fused_ep = [r["epoch_seconds"] for r in fused.epoch_log]
    print(f"12a {dtype} seconds an epoch: loop "
          f"{[f'{s:.3f}' for s in loop_ep]} (train() {loop_s:.2f} s), fused "
          f"{[f'{s:.3f}' for s in fused_ep]} (train() {fused_s:.2f} s, the "
          f"first chunk's with the capture); steady: loop "
          f"{np.mean(loop_ep[1:]):.3f}, fused {np.mean(fused_ep[2:]):.3f}; "
          f"peak {loop_gib:.2f} / {fused_gib:.2f} GiB; {card}")
    # one more chunk of the captured epoch, traced
    perms = np.stack([np.arange(n_train)] * 2)
    print_trace(torch, f"fused {dtype} 2-epoch chunk", lambda: runner(
        fused.model_params, fused.model_state, perms,
        range(P12_EPOCHS, P12_EPOCHS + 2)))
    return loop, fused, fused_l


def write_grid_world(root, images, train, val, test):
    """Phase 6c's scenes as files for the grid's CLI flow: reference.jpg
    under <root>/data/sdd/raw/annotations/synth/video<i>, the splits as
    pickled DataFrames under data/sdd/synth, and grid.yaml
    (sdd_shortterm_train.yaml with the identity backbone's 3 classes and
    this data_dir) -> the config's path."""
    import cv2
    import dataclasses

    import numpy as np
    import pandas as pd
    import yaml

    from mst_tpu_torch.config import CONFIG_DIR

    for scene, im in images.items():
        name, idx = scene.split("_")
        d = os.path.join(root, "data/sdd/raw/annotations", name, f"video{idx}")
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, "reference.jpg"),
                    (np.asarray(im) * 255).astype(np.uint8))
    ddir = os.path.join(root, "data/sdd/synth")
    os.makedirs(ddir)
    for split, t in (("train", train), ("val", val), ("test", test)):
        pd.DataFrame(dataclasses.asdict(t)).to_pickle(
            os.path.join(ddir, f"{split}.pkl"))
    with open(os.path.join(CONFIG_DIR, "sdd_shortterm_train.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(n_semantic_classes=3, data_dir=os.path.join(root, "data"))
    path = os.path.join(root, "grid.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def grid_path(torch, wrappers, card, images, train, val, test, tmp):
    """12b: a 2 seeds x 2 lrs grid of mosa_2 fine-tunes (3 epochs) through
    python -m mst_tpu_torch.grid's run_grid, each run against its own loop
    run (the train CLI's flow); the same grid split by a forced memory
    error; the kernels through their vmap rules -> grid launches."""
    import numpy as np

    from mst_tpu_torch import grid
    from mst_tpu_torch.config import (get_experiment_name,
                                      get_image_and_data_path, get_params,
                                      get_parser)
    from mst_tpu_torch.data.splits import prepare_dataset
    from mst_tpu_torch.train.trainer import Experiment
    from mst_tpu_torch.utils.seeding import set_random_seeds

    root = os.path.join(tmp, "grid")
    cfg = write_grid_world(root, images, train, val, test)
    base = os.path.join(root, "base.npz")
    Experiment(get_params(cfg, {"seed": 0})).save_params(base)
    common = ["--config_filename", cfg, "--batch_size", str(LOOP_B),
              "--dataset_path", "synth", "--load_data", "predefined",
              "--fine_tune", "--train_net", "mosa_2", "--position",
              *POSITIONS, "--pretrained_ckpt", base, "--n_epoch",
              str(GRID_EPOCHS), "--n_train_batch", "2", "--smooth_val",
              "--window_size", "1"]
    # a full-width epoch of one run peaks at ~17 GiB (the K = 20 decode of
    # its validation batches), so 2 runs a program fit the card's 80 GB and
    # 4 do not
    grid_flags = ["--runs_per_program", "2"]

    def sweep(tag, env):
        args = grid.get_parser().parse_args(common + grid_flags + [
            "--seeds", *GRID_SEEDS, "--lrs", *GRID_LRS, "--ckpt_path",
            os.path.join(root, tag), "--log_dir", os.path.join(root,
                                                              tag + "_logs")])
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            buf = io_text.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                summary = grid.run_grid(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = {k: w.launches for k, w in wrappers.items()}
        text = buf.getvalue()
        for line in text.splitlines():
            if line.startswith("[grid]"):
                print(f"12b {tag}: {line}")
        return summary, wall, launches, text, dict(
            grid.run_grid.stats,
            peak=torch.cuda.max_memory_allocated() / 2**30)

    summary, wall, launches, _, stats = sweep("grid", {})
    print(f"12b grid: {len(summary)} runs x {GRID_EPOCHS} epochs in "
          f"{wall:.2f} s (sweep {stats['sweep_seconds']:.2f} s, "
          f"{stats['replays']} replays, capture "
          f"{stats['capture_seconds']:.2f} s), peak {stats['peak']:.2f} GiB, "
          f"launches {launches}; {card}")

    def loop_run(seed, lr, ckpt):
        """The train CLI's flow for (seed, lr) in this process -> (its
        Experiment, test ADE, FDE, train() seconds, saved npz path)."""
        args = get_parser(True).parse_args(common + [
            "--seed", str(seed), "--lr", str(lr), "--ckpt_path",
            os.path.join(root, ckpt)])
        set_random_seeds(args.seed)
        params = get_params(args=args)
        image_path, data_path = get_image_and_data_path(params)
        tr, va, te = prepare_dataset(
            data_path, args.load_data, args.batch_size, args.n_train_batch,
            args.train_files, args.val_files, args.val_split,
            args.test_splits, args.shuffle, args.share_val_test, "train",
            False)
        name = get_experiment_name(args, tr.meta_ids().shape[0])
        with contextlib.redirect_stdout(io_text.StringIO()):
            exp = Experiment(params)
            exp.load_params(base)
            torch.cuda.synchronize()
            t = time.perf_counter()
            exp.train(tr, va, image_path, image_path, name)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            set_random_seeds(args.seed)
            ade, fde, _, _ = exp.test(te, image_path)
        return exp, ade, fde, wall, os.path.join(root, ckpt, name + ".npz")

    def step_distance(a, b, lr):
        """Two saved npz files' largest leaf difference, in learning
        rates."""
        with np.load(a) as x, np.load(b) as y:
            return max(float(np.abs(x[k] - y[k]).max()) for k in y.files) / lr

    # each run's own loop run (cuDNN deterministic, as the grid)
    loop_s = 0.0
    for s in summary:
        exp, ade, fde, run_s, path = loop_run(s["seed"], s["lr"], "loop")
        loop_s += run_s
        check(os.path.basename(path) == s["name"] + ".npz",
              f"the loop run saved {path}, the grid {s['name']}")
        werr = step_distance(os.path.join(root, "grid", s["name"] + ".npz"),
                             path, s["lr"])
        verr = max(abs(a - b) / abs(b) for a, b in zip(
            s["val_ADE"] + s["val_FDE"], exp.val_ADE + exp.val_FDE))
        terr = max(abs(s["ade"] - ade) / ade, abs(s["fde"] - fde) / fde)
        print(f"12b seed {s['seed']} lr {s['lr']}: best epoch "
              f"{s['best_epoch']} / loop {exp.best_epoch}; val history "
              f"{verr:.2e} relative, saved weights {werr:.2e} lr, test "
              f"ADE/FDE {terr:.2e} relative (loop {ade:.4f} / {fde:.4f})")
        check(s["best_epoch"] == exp.best_epoch
              and len(s["val_ADE"]) == len(exp.val_ADE)
              and verr <= GRID_VAL_RTOL and werr <= GRID_STEP_TOL,
              f"grid run {s['name']} differs from its loop run")
    print(f"12b: the grid's sweep {stats['sweep_seconds']:.2f} s (capture "
          f"{stats['capture_seconds']:.2f} s of it) against the 4 loop runs' "
          f"train() {loop_s:.2f} s")
    # the card's own noise: the first run's loop again on cuDNN's default
    # (non-deterministic) algorithms
    torch.backends.cudnn.deterministic = False
    try:
        s = summary[0]
        _, _, _, _, path = loop_run(s["seed"], s["lr"], "loop_default")
    finally:
        torch.backends.cudnn.deterministic = True
    print(f"12b: two loop runs of seed {s['seed']} lr {s['lr']} "
          f"(deterministic, default cuDNN algorithms) differ by "
          f"{step_distance(path, os.path.join(root, 'loop', os.path.basename(path)), s['lr']):.2e} lr")

    # the same grid, each 2-run program split by a forced memory error
    # after its first chunk
    split, split_wall, _, text, _ = sweep("split", {
        "MST_GRID_FORCE_OOM_ABOVE": "1", "MST_GRID_CHUNK_CAP": "1"})
    check("splitting the group" in text, "the forced split did not happen")
    worst = 0.0
    for a, b in zip(summary, split):
        werr = step_distance(os.path.join(root, "split", b["name"] + ".npz"),
                             os.path.join(root, "grid", a["name"] + ".npz"),
                             a["lr"])
        verr = max(abs(x - y) / abs(y) for x, y in zip(
            b["val_ADE"] + b["val_FDE"], a["val_ADE"] + a["val_FDE"]))
        worst = max(worst, werr, verr)
        check(a["best_epoch"] == b["best_epoch"] and verr <= GRID_VAL_RTOL
              and werr <= GRID_STEP_TOL,
              f"the split sweep's {b['name']} differs from the unsplit one")
    print(f"12b split sweep ({split_wall:.2f} s): equal to the unsplit "
          f"sweep within {worst:.2e} (weights in lr, val relative; 0 is "
          f"bit-equal)")
    return launches


def vmap_rules(torch):
    """Both kernels through their vmap rules over 2 runs, against one call
    a run: fused_predict at the eval decode tail's shape with one shared
    weight (folded into R) and with each run's own (one launch a run), the
    rows kernel on a step's maps -> max px."""
    from mst_tpu_torch.ops.kernels.fused_predict import \
        fused_predictor_softargmax as fused
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows

    g = torch.Generator(device="cuda").manual_seed(12)
    R, H, W, C, P = 160, 352, 480, 32, 12
    x = torch.randn((2, R, H, W, C), device="cuda", generator=g)
    w = torch.randn((2, C, P), device="cuda", generator=g) * 0.2
    b = torch.randn((2, P), device="cuda", generator=g)
    shared = torch.func.vmap(fused, in_dims=(0, None, None))(x, w[0], b[0])
    own = torch.func.vmap(fused, in_dims=(0, 0, 0))(x, w, b)
    err_shared = max(float((shared[r] - fused(x[r], w[0], b[0])).abs().max())
                     for r in range(2))
    err_own = max(float((own[r] - fused(x[r], w[r], b[r])).abs().max())
                  for r in range(2))
    del x
    maps = torch.randn((2, 8, 12, H, W), device="cuda", generator=g) * 3
    rows = torch.func.vmap(softargmax2d_rows)(maps)
    err_rows = max(float((rows[r] - softargmax2d_rows(maps[r])).abs().max())
                   for r in range(2))
    print(f"12b vmap rules against one call a run: fused_predict shared "
          f"weight (2 x {R} rows folded) {err_shared:.2e} px, own weights "
          f"{err_own:.2e} px, rows (2 x 96 rows) {err_rows:.2e} px")
    check(err_shared <= FUSED_TOL and err_own == 0.0
          and err_rows <= ROWS_TOL,
          "a kernel's vmap rule differs from its per-run calls")
    return max(err_shared, err_own), err_rows


def fused_and_grid_path(torch, wrappers, card, rows_rec, fused_rec):
    """Phase 12 -> {kernel: launches} over 12a's fused runs and 12b's
    grid."""
    from mst_tpu_torch.data import splits
    from mst_tpu_torch.train.trainer import Experiment

    images, train, val, test = loop_data()
    train_ft = splits.limit_samples(train, 2, LOOP_B)  # as phase 6c's
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp()
    total = dict.fromkeys(wrappers, 0)
    try:
        _, scratch = loop_params(tmp, ["--train_net", "train"])
        base = os.path.join(tmp, "base.npz")
        Experiment(scratch, images=images).save_params(base)
        for dtype in ("float32", "bfloat16"):
            _, fused, launches = fused_loop_pair(
                torch, wrappers, card, images, train_ft, val, base, tmp,
                dtype)
            total = {k: total[k] + launches[k] for k in total}
            if dtype == "float32":
                err, shape = rows_in_replay(torch, fused)
                print(f"12a: the rows kernel in a replay on a step's maps "
                      f"{shape} against its plain version: {err:.2e} px")
                check(err <= ROWS_TOL, "the rows kernel in a replay "
                      "disagrees with its plain version")
                rows_rec["max_abs_err"] = max(rows_rec["max_abs_err"], err)
            del fused
            torch.cuda.empty_cache()
        launches = grid_path(torch, wrappers, card, images, train_ft, val,
                             test, tmp)
        total = {k: total[k] + launches[k] for k in total}
        err_fused, err_rows = vmap_rules(torch)
        fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"], err_fused)
        rows_rec["max_abs_err"] = max(rows_rec["max_abs_err"], err_rows)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12 launches: {total}")
    for name in ("softargmax_rows", "fused_predict", "softargmax_rows_bf16",
                 "fused_predict_bf16"):
        check(total[name] > 0, f"{name} never ran in phase 12")
    return total


# ---- phase 13: the serialized program
P13_TOL = 1e-4  # raw px: a program request against the eager Predictor of
# the same weights and key on the same card (phase 8's bar)
P13_LATENCY_N = 5  # requests a side, program against eager
P13_REQUESTS = ((0, None), (1, None), (2, None), (3, None), (0, "style"))
# Y-Net-Mod's directory: phase 6d's network at inD_longterm_eval.yaml's
# width, with the long-term evaluation's TTST and CWS on so that both
# serving kernels run in its programs (the shipped yaml has both off)
P13_YMOD = dict(YMOD, use_TTST=True, use_CWS=True, seed=0)
# the fresh process that serves the directories: the port's model code
# blocked, so only loader.py, io.py and the kernels can load
PROGRAM_SERVE = r'''
import json, sys, time
BLOCKED = ("mst_tpu_torch.models", "mst_tpu_torch.train",
           "mst_tpu_torch.config")
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from mst_tpu_torch.loader import LoadedModel
from mst_tpu_torch.ops.kernels.fused_predict import \
    fused_predictor_softargmax as fused
from mst_tpu_torch.ops.kernels.kmeans import lloyd2d as kmeans
from mst_tpu_torch.ops.kernels.softargmax_rows import \
    softargmax2d_rows as rows
job = json.loads(sys.argv[2])
report = {}
for name in job["names"]:
    d = job["tmp"] + "/" + name
    with np.load(d + "_inputs.npz") as z:
        semantic, observed = z["semantic"], z["observed"]
    for fn in (rows, fused):
        fn.launches = fn.launches_bf16 = 0
    kmeans.launches = 0
    t0 = time.perf_counter()
    model = LoadedModel(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model.add_style("style", d + "_style.npz")
    served, ms = {}, []
    for i, (seed, style) in enumerate(job["requests"]):
        t0 = time.perf_counter()
        out = model.predict(semantic, observed, seed=seed, style=style)
        ms.append(1e3 * (time.perf_counter() - t0))
        for k, v in out.items():
            served[f"{i}/{k}"] = v
    np.savez(d + "_served.npz", **served)
    report[name] = {
        "load_s": load_s, "ms": ms, "device": str(model.device),
        "launches": {"softargmax_rows": rows.launches,
                     "softargmax_rows_bf16": rows.launches_bf16,
                     "fused_predict": fused.launches,
                     "fused_predict_bf16": fused.launches_bf16,
                     "kmeans": kmeans.launches}}
    del model
leaked = sorted(m for m in sys.modules if m.startswith(
    tuple(b + "." for b in BLOCKED)) and sys.modules[m] is not None)
print(json.dumps({"report": report, "leaked": leaked}))
'''


def check_key_draws(torch):
    """One key's draws on the card against the CPU's, bit for bit: the
    32-bit words and the uniforms at TTST's shape (8 rows x 10k), the
    exponentials at a (20, 8, 352 x 480) CWS draw, and the exponential of
    every one of the 2^24 possible uniforms. -> the number of elements
    held."""
    from mst_tpu_torch.ops.sampling import (Key, exponential_of_24_bits,
                                            key_from_seed)

    n = 0
    for seed in (0, 12345):
        card_key, cpu_key = Key(key_from_seed(seed, "cuda")), Key(
            key_from_seed(seed))
        for what, fn in (
                ("bits", lambda k: k.bits((8, 10000))),
                ("uniform", lambda k: k.uniform((8, 10000))),
                ("randint", lambda k: k.randint(10000, (8, 19), counter=7)),
                ("exponential", lambda k: k.exponential(torch.empty(
                    (20, 8, 352 * 480), device=k.key.device)))):
            got, want = fn(card_key).cpu(), fn(cpu_key)
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"key draws of seed {seed}: the card's {what} differ "
                  "from the CPU's")
            n += got.numel()
    m = torch.arange(1 << 24, dtype=torch.int64)
    got = exponential_of_24_bits(m.cuda()).cpu()
    want = exponential_of_24_bits(m)
    check(torch.equal(got, want), f"{int((got != want).sum())} of the 2^24 "
          "exponentials differ between the card and the CPU")
    check(bool((want > 0).all()) and bool(torch.isfinite(want).all()),
          "an exponential draw is 0 or not finite")
    return n + m.numel()


def lora_delta(params, rng):
    """A style: every lora_B leaf of the tree drawn from N(0, 0.05^2)."""
    import numpy as np

    from mst_tpu_torch import io

    return {k: rng.normal(scale=0.05, size=tuple(v.shape)).astype(np.float32)
            for k, v in io.flatten(params).items()
            if k.endswith("lora_B")}


def serialized_program_path(torch, wrappers, card, semantic, observed,
                            delta):
    """Phase 13: model directories with their programs (forward.pt2,
    decode.pt2) at full width: phase 5's model (sdd_shortterm_eval, TTST,
    mosa_2 on 0-4, K = 20, B = 8 at 352 x 480, random weights from seed
    0, phase 5's LoRA delta as the style) in f32 and in bf16, and phase
    6d's Y-Net-Mod (inD_longterm_eval width, fusion, n_fusion 2, mosa_1,
    TTST and CWS, B = 10 at 320 x 576, P = 30, a random LoRA style).
    Each is written by `python -m mst_tpu_torch.serve export` (timed),
    then served by a fresh process that cannot import the port's model
    code (PROGRAM_SERVE): the load timed, 4 requests and 1 styled, every
    count zeroed before and read after. Every output against the eager
    Predictor of the same weights and keys here (P13_TOL), finite; the
    directory refused on the CPU; the draws of a key card against CPU;
    program against eager latency. -> {kernel: launches in the serving
    processes}."""
    import numpy as np
    import yaml

    from mst_tpu_torch import io, serve
    from mst_tpu_torch.config import get_params

    draws = check_key_draws(torch)
    print(f"key draws: {draws} elements of the card's bits, uniforms, "
          "randints and exponentials (and all 2^24 exponentials) equal "
          "the CPU's bit for bit")
    rng = np.random.default_rng(13)
    (yh, yw), yb = YMOD_HW, YMOD_B
    ymod_params = get_params("inD_longterm_eval.yaml", P13_YMOD)
    logits = rng.normal(size=(1, yh, yw, ymod_params["n_semantic_classes"]))
    start = rng.uniform([100, 80], [yw - 100, yh - 80], size=(yb, 1, 2))
    walk = rng.normal(scale=3.0, size=(yb, ymod_params["obs_len"], 2))
    sdd = get_params("sdd_shortterm_eval.yaml", dict(
        use_TTST=True, train_net="mosa_2", position=POSITIONS, seed=0))
    cases = {
        "f32": (sdd, semantic, observed),
        "bf16": (dict(sdd, compute_dtype="bfloat16"), semantic, observed),
        "ymod": (ymod_params, np.exp(logits) / np.exp(logits).sum(
            -1, keepdims=True), start + np.cumsum(walk, axis=1))}
    tmp = tempfile.mkdtemp(prefix="mst_programs_")
    total = dict.fromkeys(wrappers, 0)
    try:
        dirs, preds, export_s = {}, {}, {}
        for name, (params, sem, obs) in cases.items():
            pred = serve.Predictor(params, seed=0)
            style = delta if name != "ymod" else lora_delta(
                pred.params, rng)
            ckpt, cfg = f"{tmp}/{name}_ckpt.npz", f"{tmp}/{name}.yaml"
            np.savez(ckpt, **io.params_to_numpy(pred.params))
            np.savez(f"{tmp}/{name}_style.npz", **style)
            np.savez(f"{tmp}/{name}_inputs.npz",
                     semantic=sem.astype(np.float32),
                     observed=obs.astype(np.float32))
            with open(cfg, "w") as f:
                yaml.safe_dump(params, f)
            pred.add_style("style", f"{tmp}/{name}_style.npz")
            preds[name] = pred
            dirs[name] = f"{tmp}/{name}"
            argv = sys.argv
            sys.argv = ["mst_tpu_torch.serve", "export", "--config_filename",
                        cfg, "--pretrained_ckpt", ckpt, "--out_dir",
                        dirs[name], "--height", str(sem.shape[1]),
                        "--width", str(sem.shape[2]), "--batch_size",
                        str(obs.shape[0])]
            t0 = time.perf_counter()
            try:
                serve._main()
            finally:
                sys.argv = argv
            export_s[name] = time.perf_counter() - t0
            with open(f"{dirs[name]}/manifest.json") as f:
                manifest = json.load(f)
            sizes = {f: os.path.getsize(f"{dirs[name]}/{f}")
                     for f in sorted(os.listdir(dirs[name]))}
            print(f"13 {name}: export {export_s[name]:.2f} s, "
                  f"{manifest['format']}, platforms "
                  f"{manifest['platforms']}, compute_dtype "
                  f"{manifest['compute_dtype']}, torch "
                  f"{manifest['torch_version']}, files {sizes}")
            check(manifest["platforms"] == ["cuda"]
                  and {"forward.pt2", "decode.pt2"} <= set(sizes),
                  f"{name}: the directory holds no program for the card")
            with np.load(f"{dirs[name]}/params.npz") as z, \
                    np.load(ckpt) as want:
                check(sorted(z.files) == sorted(want.files) and all(
                    np.array_equal(z[k], want[k]) for k in z.files),
                      f"{name}: params.npz is not the checkpoint")
            try:
                serve.LoadedModel(dirs[name], device="cpu")
            except ValueError as e:
                check("exported for ['cuda']" in str(e), f"{name}: {e}")
            else:
                check(False, f"{name}: a card's directory loaded on the CPU")
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", PROGRAM_SERVE,
             os.path.dirname(os.path.abspath(__file__)),
             json.dumps({"tmp": tmp, "names": list(dirs),
                         "requests": P13_REQUESTS})],
            capture_output=True, text=True, timeout=600)
        serve_s = time.perf_counter() - t0
        check(proc.returncode == 0, "the program-only process failed:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        check(got["leaked"] == [], f"model code loaded: {got['leaked']}")
        print(f"13: the program-only process ({serve_s:.1f} s, "
              "mst_tpu_torch.models, .train and .config blocked)")
        for name, rep in got["report"].items():
            params = cases[name][0]
            launches = rep["launches"]
            for k, v in launches.items():
                total[k] += v
            dtype_rows = "softargmax_rows"
            dtype_fused = ("fused_predict_bf16" if name == "bf16"
                           else "fused_predict")
            check(launches[dtype_rows] > 0 and launches[dtype_fused] > 0
                  and launches["kmeans"] == len(P13_REQUESTS),
                  f"{name}: the programs launched {launches} over "
                  f"{len(P13_REQUESTS)} TTST requests")
            rf = params["resize_factor"]
            sem, obs = cases[name][1], cases[name][2]
            err, exact = 0.0, True
            with np.load(f"{tmp}/{name}_served.npz") as served:
                for i, (seed, style) in enumerate(P13_REQUESTS):
                    want = preds[name].predict(sem, obs, seed=seed,
                                               style=style)
                    for k, v in want.items():
                        a = served[f"{i}/{k}"]
                        check(np.isfinite(a).all(), f"{name} request {i}: "
                              f"non-finite {k}")
                        check(a.shape == v.shape, f"{name}: {k} {a.shape}")
                        err = max(err, float(np.abs(a - v).max()))
                        exact = exact and np.array_equal(a, v)
                    check_in_image(f"13 {name} request {i}",
                                   served[f"{i}/trajectories"],
                                   sem.shape[1], sem.shape[2], rf)
            print(f"13 {name} ({rep['device']}): load {rep['load_s']:.2f} s,"
                  f" requests {[round(x, 1) for x in rep['ms']]} ms, "
                  f"launches {launches}; against the eager Predictor, same "
                  f"weights and keys: max |difference| = {err:.3e} raw px "
                  f"(tol {P13_TOL}), bit for bit: {exact}")
            check(err <= P13_TOL, f"{name}: the programs disagree with the "
                  "eager Predictor")

        # program against eager latency, in turns, in this process
        model = serve.LoadedModel(dirs["f32"])
        pred = preds["f32"]
        lat = {"program": [], "eager": []}
        for i in range(P13_LATENCY_N + 1):
            for label, m in (("program", model), ("eager", pred)):
                t0 = time.perf_counter()
                m.predict(semantic, observed, seed=20 + i)
                if i:  # the first of each is a warm-up
                    lat[label].append(time.perf_counter() - t0)
        print(f"13 latency ({card}): a K = 20 TTST request, median of "
              f"{P13_LATENCY_N}: program {pct(lat['program'], 50):.1f} ms "
              f"{[round(x * 1e3, 1) for x in lat['program']]}, eager "
              f"Predictor {pct(lat['eager'], 50):.1f} ms "
              f"{[round(x * 1e3, 1) for x in lat['eager']]}")
        print(f"13 seconds ({card}): export "
              + ", ".join(f"{k} {v:.2f}" for k, v in export_s.items())
              + "; load in the program-only process "
              + ", ".join(f"{k} {v['load_s']:.2f}"
                          for k, v in got["report"].items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13 launches: {total}")
    return total


# ---- phase 14: data parallelism over a mesh
# ---------------------------------------------------------------------------

P14_STEPS = 3
P14_LOSS_RTOL = 1e-5    # the world of 2's losses against the world of 1's
P14_LEAF_TOL = 1e-4     # its leaves after P14_STEPS Adam steps, of a leaf's
# max, where every step's |g| is above P14_SIG of its leaf's max: below,
# Adam's update is ~lr x sign(g) of a gradient that is mostly rounding,
# and the all-reduce sums in another order
P14_SIG = 1e-3
P14_STAT_TOL = 1e-6     # the serial adapters' running statistics
P14_VAL_RTOL = 1e-5     # the TTST pass's ADE/FDE on the rows that kept
P14_PX_TOL = 1e-4       # their samples, and best_traj, model px
# rows whose TTST samples move at a CDF boundary (their map differs in the
# last bits between batch sizes): at most this share of the valid rows
P14_MOVED_SHARE = 0.34
P14_EPOCHS = 2          # the CLI flows of the world of 1 (a)
P14_CLI_LR = "3e-3"     # the CLI flows' learning rate
P14_SCALE_STEPS = 10    # mesh_scaling's steps a world
# the split (1, 4) spatial train jobs' limits, in s: a rank's start, its
# model and its first (cold) step take 20-30 s of each; the (1, 2) steps
# take ~1.4 s past that and the (1, 2) train CLI ~8.4 s on one card, and
# on 4 cards the jobs took 28.6-38.5 s and 34.9 s whole (the --fused
# capture 14.2 s of it)
P14_SPATIAL_STEPS_S = 240
P14_SPATIAL_CLI_S = 300
# a rank of phase 14's worlds, run from the checkout's root
P14_RANK = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.arm_rank_dumps(); "
            "sys.exit(chip_smoke.mesh_rank_main(sys.argv[2]))")
RANK_DUMP_MARGIN_S = 30  # at most; a quarter of a shorter job's limit
RANK_TAIL = (2000, 6000)  # the bytes of a rank's stdout, stderr a failure shows
NCCL_TRACE = "nccl_trace_rank_"  # NCCL's flight recorder's dumps, + the rank


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def arm_rank_dumps():
    """In a rank of launch_ranks, first: a fatal signal (NCCL's watchdog
    aborts a rank whose collective timed out) dumps every thread's stack to
    stderr, and so does the time P14_DUMP_AT (s since the epoch), when
    NCCL's flight recorder is dumped too (flight_dump); NCCL's process
    groups, the 'space' and 'data' subgroups too, time a collective out
    after P14_PG_TIMEOUT_S s, when the watchdog dumps the flight recorder
    itself (TORCH_NCCL_DUMP_ON_TIMEOUT)."""
    import faulthandler
    import threading

    faulthandler.enable(all_threads=True)
    if os.environ.get("P14_DUMP_AT"):
        after = max(float(os.environ["P14_DUMP_AT"]) - time.time(), 0.1)
        faulthandler.dump_traceback_later(after)
        timer = threading.Timer(after, flight_dump)
        timer.daemon = True
        timer.start()
    if os.environ.get("P14_PG_TIMEOUT_S"):
        import datetime

        from torch.distributed import distributed_c10d

        # new_group's default, which DeviceMesh's subgroups take
        distributed_c10d.default_pg_nccl_timeout = datetime.timedelta(
            seconds=float(os.environ["P14_PG_TIMEOUT_S"]))


def flight_dump():
    """This rank's NCCL flight recorder (its last collectives by process
    group, with their state) into <P14_LOGS>/late/<NCCL_TRACE><rank>, in
    the watchdog's own format; nothing off NCCL."""
    try:
        import torch
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_backend() != "nccl":
            return
        c10d = torch._C._distributed_c10d
        dump = getattr(c10d, "_dump_nccl_trace", None) or c10d._dump_fr_trace
        late = os.path.join(os.environ["P14_LOGS"], "late")
        os.makedirs(late, exist_ok=True)
        with open(os.path.join(late, NCCL_TRACE + os.environ["RANK"]),
                  "wb") as f:
            f.write(dump())
        print("flight recorder dumped", file=sys.stderr, flush=True)
    except Exception as e:  # the stack dump beside it still stands
        print(f"flight recorder not dumped: {e!r}", file=sys.stderr,
              flush=True)


def flight_summary(path, last=4):
    """A rank's flight recorder dump -> lines: each process group's last
    `last` collectives (sequence number, op, input sizes, state)."""
    import pickle

    with open(path, "rb") as f:
        entries = pickle.load(f).get("entries", [])
    groups = {}
    for e in entries:
        pg = e.get("process_group", ("?", "?"))
        groups.setdefault(f"{pg[0]}:{pg[1]}", []).append(e)
    return [f"  pg {pg}: " + "; ".join(
        f"#{e.get('collective_seq_id')} {e.get('profiling_name')} "
        f"{e.get('input_sizes')} {e.get('state')}" for e in es[-last:])
        for pg, es in groups.items()]


def launch_ranks(world, argv, timeout, logs, env=None, own_card=False):
    """Start `world` processes of argv from the checkout's root as torchrun
    would (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/
    PORT) -> a function that waits for them and returns [(stdout, stderr)]
    by rank. Each rank writes its stdout and stderr to rank<r>.out and
    rank<r>.err under `logs`, files and not pipes: a rank whose output
    fills a pipe's buffer (64 KiB) blocks in write() until the parent
    reads it, and the parent read the ranks one after another, so a rank
    it was not reading yet could stop every other in its next collective.
    `timeout` s is the job's limit, and a margin of RANK_DUMP_MARGIN_S or
    a quarter of it, if less: a rank that called arm_rank_dumps dumps
    every thread a margin before the limit (from the start), NCCL's
    watchdog times a collective out two margins before it and dumps its
    flight recorder (NCCL_TRACE under logs). The wait kills every rank
    `timeout` s after it began, or a margin after the first rank that
    failed, and then fails with each rank's exit, the tail of its output
    and a summary of its flight recorder. env: more variables for the
    ranks. own_card: rank r sees card r alone
    (CUDA_VISIBLE_DEVICES), as launchers that give each task its own card
    do."""
    os.makedirs(logs, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    margin = min(RANK_DUMP_MARGIN_S, timeout / 4)
    env = dict(os.environ, **(env or {}), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), P14_LOGS=logs,
               P14_DUMP_AT=str(time.time() + timeout - margin),
               P14_PG_TIMEOUT_S=str(timeout - 2 * margin),
               TORCH_FR_BUFFER_SIZE="2000",
               TORCH_NCCL_DUMP_ON_TIMEOUT="1",
               TORCH_NCCL_DEBUG_INFO_TEMP_FILE=os.path.join(logs, NCCL_TRACE))
    files = [(os.path.join(logs, f"rank{r}.out"),
              os.path.join(logs, f"rank{r}.err")) for r in range(world)]
    procs = []
    for r, (out, err) in enumerate(files):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r), **(
                    {"CUDA_VISIBLE_DEVICES": str(r)} if own_card else {})),
                cwd=root, stdout=fo, stderr=fe, stdin=subprocess.DEVNULL))

    def wait():
        t0, failed_at = time.monotonic(), None
        try:
            while True:
                rcs = [p.poll() for p in procs]
                now = time.monotonic()
                if all(rc is not None for rc in rcs):
                    break
                if failed_at is None and any(rc for rc in rcs):
                    failed_at = now
                if now - t0 > timeout or (failed_at is not None
                                          and now - failed_at > margin):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        secs = time.monotonic() - t0
        texts = []
        for out, err in files:
            with open(out, errors="replace") as fo, \
                    open(err, errors="replace") as fe:
                texts.append((fo.read(), fe.read()))
        if all(p.returncode == 0 for p in procs):
            return texts
        lines = [f"a world of {world} failed after {secs:.1f} s of its "
                 f"{timeout} s (each rank's files under {logs}):"]
        for r, (p, (out, err)) in enumerate(zip(procs, texts)):
            lines.append(f"-- rank {r}: exit {p.returncode} (a negative "
                         f"exit is the signal that ended it), {len(out)} + "
                         f"{len(err)} bytes of stdout + stderr; their "
                         f"tails:\n{out[-RANK_TAIL[0]:]}\n{err[-RANK_TAIL[1]:]}")
        for d in (logs, os.path.join(logs, "late")):
            for name in sorted(os.listdir(d) if os.path.isdir(d) else ()):
                if name.startswith(NCCL_TRACE):
                    path = os.path.join(d, name)
                    try:
                        lines += [f"-- {path}:"] + flight_summary(path)
                    except Exception as e:
                        lines.append(f"-- {path}: not read ({e!r})")
        check(False, "\n".join(lines))
    return wait


def start_ranks(world, job, timeout, own_card=False, logs=None):
    """Start a world of `world` ranks on this card (launch_ranks), each
    running mesh_rank_main(job) -> a function that waits for them (the
    job's limit `timeout` s) and returns each rank's report. Each rank's
    output goes to `logs`, by default a new directory under job['tmp']."""
    if logs is None:
        logs = tempfile.mkdtemp(prefix=f"ranks_{job['kind']}_x{world}_",
                                dir=job["tmp"])
    root = os.path.dirname(os.path.abspath(__file__))
    wait_texts = launch_ranks(
        world, [sys.executable, "-c", P14_RANK, root, json.dumps(job)],
        timeout, logs, own_card=own_card)

    def wait():
        texts = wait_texts()
        reports = []
        for r, (out, _) in enumerate(texts):
            line = [ln for ln in out.splitlines() if ln.startswith("P14 ")]
            check(line, f"14: rank {r} reported nothing:\n{out[-3000:]}")
            reports.append(json.loads(line[-1][4:]))
        return reports
    return wait


def progress(msg):
    """In a rank of launch_ranks, a progress line (its job's log shows
    where it got to); nothing elsewhere."""
    if "RANK" in os.environ:
        print(f"[rank {os.environ['RANK']} {time.strftime('%H:%M:%S')}] "
              f"{msg}", file=sys.__stdout__, flush=True)


def release(torch):
    """Free what this process's dead objects hold on the card, cached
    blocks too, for the other processes that share it."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def p14_model(torch, train_net):
    """sdd_shortterm_train.yaml's model (mosa_2 on 0-4, or serial adapters
    on 1-2) from seed 0, lora_B and the adapters random from seed 1, the
    trainer's Adam (lr 1e-3) -> (params, weights, state, optimizer, named
    trainable leaves)."""
    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, ynet_config
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.train.trainer import setup_training

    position = POSITIONS if train_net == "mosa_2" else ["1", "2"]
    params = get_params("sdd_shortterm_train.yaml", dict(
        train_net=train_net, position=position, lr=1e-3, use_TTST=True))
    weights, state = init_ynet(torch.Generator().manual_seed(0),
                               ynet_config(params), "cuda")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in io.flatten(weights).items():
            if v.is_floating_point() and not v.any():
                v.copy_(0.05 * torch.randn(v.shape, generator=gen))
    setup = setup_training(weights, params, steps_per_epoch=1)
    named = {k: v for k, v in io.flatten(weights).items() if v.requires_grad}
    return params, weights, state, setup["optimizer"], named


def p14_rows(torch, b, mesh):
    """Phase 6b's batch (B = 8, the last two rows padding), this rank's
    rows of it on a mesh."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    if mesh is None:
        return b
    lo, hi = mesh_lib.batch_shards(mesh).rows(
        b["traj"].shape[0] // mesh.mesh.numel())
    return {k: v if k == "semantic" else v[lo:hi] for k, v in b.items()}


def p14_steps(torch, mesh, out_path, n_steps=P14_STEPS, n_evals=1):
    """(b) on this rank: n_steps mosa_2 steps, one serial-adapter step and
    one K = 20 TTST validation pass at full width on this rank's rows (on
    the model as p14_model makes it: the steps' weights differ between
    worlds in their last bits), each row's draws recorded (sampling.Rows)
    -> report (losses, ms, the last of the P14_STEPS steps' peak device
    memory above what was allocated as it began);
    arrays to out_path: the leaves after the first P14_STEPS steps and
    those steps' gradients, the serial state, the eval outputs and the
    draws. n_evals > 1 repeats the pass on the same draws, the report's
    val_ms and val_peak (its peak device memory above what was allocated
    as it began) the last's."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.ops import sampling
    from mst_tpu_torch.train.steps import make_eval_step, make_train_step

    H, W, B = 352, 480, 8
    arrays, report = {}, {"losses": [], "step_ms": []}
    params, weights, state, opt, named = p14_model(torch, "mosa_2")
    batch = p14_rows(torch, fine_tune_batch(torch, params, H, W, B), mesh)
    step = make_train_step(ynet_config(params), step_config(params), mesh)
    for i in range(n_steps):
        torch.cuda.synchronize()
        if i == P14_STEPS - 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = step(weights, state, opt, batch)
        torch.cuda.synchronize()
        report["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if i == P14_STEPS - 1:  # a step's peak above what it starts on
            report["step_peak"] = torch.cuda.max_memory_allocated() - base
        report["losses"].append(float(m["loss"]))
        if i < P14_STEPS:
            arrays.update({f"grad{i}/{k}": v.grad.cpu().numpy()
                           for k, v in named.items()})
        if i == P14_STEPS - 1:
            arrays.update({f"leaf/{k}": v.detach().cpu().numpy()
                           for k, v in named.items()})
    report["n"] = float(m["n"])

    sparams, sweights, sstate, sopt, _ = p14_model(torch, "serial")
    sstep = make_train_step(ynet_config(sparams), step_config(sparams), mesh)
    sstate, sm = sstep(sweights, sstate, sopt, batch)
    report["serial_loss"] = float(sm["loss"])
    arrays.update({f"state/{k}": v.cpu().numpy()
                   for k, v in io.flatten(sstate).items()})

    eval_step = make_eval_step(ynet_config(params), step_config(params),
                               mesh)
    _, weights, state, _, _ = p14_model(torch, "mosa_2")
    drawn = []
    narrow = sampling.Rows._narrow

    def recorded(self, t, batch_dim):
        out = narrow(self, t, batch_dim)
        drawn.append((out.cpu().numpy(), batch_dim))
        return out

    sampling.Rows._narrow = recorded
    try:
        for i in range(n_evals):
            gen = torch.Generator("cuda").manual_seed(eval_seed_p14())
            # a world of one draws through Rows of the whole batch, the
            # same draws as the generator's own
            source = gen if mesh is not None else sampling.Rows(gen, 0, B,
                                                                B)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            # eval_step's three parts, to keep the rows' samples
            feats, wps = eval_step.forward(weights, state, batch, source)
            out = eval_step.global_outputs(eval_step.decode_and_score(
                weights, feats, wps, batch["traj"], batch["mask"]))
            torch.cuda.synchronize()
            report["val_ms"] = 1e3 * (time.perf_counter() - t0)
            report["val_peak"] = torch.cuda.max_memory_allocated() - base
            sampling.Rows._narrow = narrow  # the first pass's draws
    finally:
        sampling.Rows._narrow = narrow
    arrays.update({f"eval/{k}": v.cpu().numpy() for k, v in out.items()})
    arrays["eval/wps"] = wps.cpu().numpy()  # this rank's rows
    for i, (d, dim) in enumerate(drawn):
        arrays[f"draw{i}"] = d
        arrays[f"drawdim{i}"] = np.asarray(dim)
    np.savez(out_path, **arrays)
    return report, named, opt


def eval_seed_p14():
    from mst_tpu_torch.train.trainer import eval_seed

    return eval_seed(1, 0, 0)


# 14a's flows in a world of 1 on NCCL: {tag: flags}; each against the same
# flow without a mesh (A0_FLOWS[A1_BASE[tag]])
A0_FLOWS = {"loop": [], "fused": ["--fused"]}
A1_SPATIAL = ["--mesh_shape", "1", "1", "--mesh_axes", "data", "space"]
A1_FLOWS = {"loop": ["--mesh_shape", "1"],
            "fused": ["--fused", "--mesh_shape", "1"],
            "spatial": A1_SPATIAL, "spatial_fused": ["--fused"] + A1_SPATIAL}
A1_BASE = {"loop": "loop", "fused": "fused", "spatial": "loop",
           "spatial_fused": "fused"}


def p14_cli_args(cfg, base, ckpt, flags):
    return ["--config_filename", cfg, "--batch_size", str(LOOP_B),
            "--dataset_path", "synth", "--load_data", "predefined",
            "--fine_tune", "--train_net", "mosa_2", "--position",
            *POSITIONS, "--pretrained_ckpt", base, "--n_epoch",
            str(P14_EPOCHS), "--n_train_batch", "2", "--lr", P14_CLI_LR,
            "--ckpt_path", ckpt, "--metrics_jsonl",
            os.path.join(ckpt, "metrics.jsonl"), "--device",
            "cuda"] + flags


def p14_train_cli(torch, args, record_grads=False):
    """The train CLI in this process -> (its stdout, whether its --fused
    runner captured a graph, a replay's launches; with record_grads, each
    optimizer step's |gradient| of each trainable leaf, {path: [numpy
    array a step]}, as 'grads')."""
    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_parser
    from mst_tpu_torch.train import fused, optim, trainer
    from mst_tpu_torch.train.__main__ import main as train_main

    seen, steps = {}, []
    train, adam_step = trainer.Experiment.train, optim.Adam.step
    capture, replay = fused.FusedEpochs._capture, fused.FusedEpochs._replay
    evaluate = trainer.Experiment._evaluate

    def captured(self, *a):
        progress("--fused: capture starts")
        capture(self, *a)
        progress(f"--fused: captured in {self.capture_seconds:.2f} s")

    def replayed(self, perm, e):
        out = replay(self, perm, e)
        progress(f"--fused: epoch {e} replayed")
        return out

    def evaluated(self, *a, **k):
        out = evaluate(self, *a, **k)
        progress("train CLI: a validation or test pass")
        return out

    def recorded(self):
        steps.append([p.grad.abs().cpu().numpy() for p in self.params])
        return adam_step(self)

    def hooked(self, *a, **k):
        if record_grads:
            optim.Adam.step = recorded
        try:
            out = train(self, *a, **k)
        finally:
            optim.Adam.step = adam_step
        if record_grads:  # the optimizer's leaves, in set_trainable's order
            names = [k for k, v in io.flatten(self.model_params).items()
                     if v.requires_grad]
            # in the checkpoints' layout (a conv's weight HWIO)
            seen["grads"] = {k: [io.params_to_numpy({k: torch.from_numpy(
                g[i])})[k] for g in steps] for i, k in enumerate(names)}
        runner = self.fused_runner
        seen.update(fused=runner is not None, captured=bool(
            runner is not None and runner.graph is not None),
            capture_s=runner.capture_seconds if runner is not None else 0.0,
            per_replay={
                f"{fn.__name__}.{n}": c for (fn, n), c in (
                    runner.graph.per_replay.items()
                    if runner is not None and runner.graph else ())})
        return out

    trainer.Experiment.train = hooked
    fused.FusedEpochs._capture, fused.FusedEpochs._replay = captured, replayed
    trainer.Experiment._evaluate = evaluated
    buf = io_text.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train_main(get_parser(True).parse_args(args))
    finally:
        trainer.Experiment.train = train
        fused.FusedEpochs._capture, fused.FusedEpochs._replay = capture, \
            replay
        trainer.Experiment._evaluate = evaluate
    progress("train CLI done")
    return buf.getvalue(), seen


def mesh_rank_main(job_json):
    """One rank of phase 14 (P14_RANK): job 'cli' runs the train CLI's
    flows with --mesh_shape 1 and with --mesh_shape 1 1 --mesh_axes data
    space (A1_FLOWS; a world of 1 on NCCL), job 'mesh' the world of 2's
    steps, validation, checkpoint save, spatial eval (p14_spatial and the
    test CLI, p14_spatial_cli, on a (1, 2) ('data', 'space') mesh of the
    same world), spatial training (p14_spatial_steps and the train CLI,
    p14_spatial_train_cli, on that mesh), the backbone in the step on it
    (p14_backbone, and the train CLI of segmentation_head) and grid on its
    mesh (gloo on the one card), job
    'steps' the steps and validation alone on a world of any size, job
    'spatial' the spatial eval on a (1, world) mesh, job 'spatial_steps'
    its train steps, job 'spatial_cli' its train CLI and job
    'spatial_backbone' p14_backbone on it (mesh_scaling). Prints 'P14 ' +
    its report, with its kernel launches, and progress lines as it
    goes."""
    import torch

    job = json.loads(job_json)
    torch.backends.cudnn.deterministic = True
    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.probes import kernel_wrappers

    resolve_device("cuda")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    rank = int(os.environ["RANK"])
    report = {"rank": rank}
    progress(f"job {job['kind']} starts")
    if job["kind"] == "cli":
        for tag, flags in A1_FLOWS.items():
            text, seen = p14_train_cli(torch, p14_cli_args(
                job["cfg"], job["base"], os.path.join(job["tmp"],
                                                      f"a1_{tag}"), flags))
            report[tag] = {"text": text, **seen}
        report["backend"] = torch.distributed.get_backend()
    elif job["kind"] == "spatial":
        shape = tuple(job["shape"])
        report["spatial"] = p14_spatial(torch, wrappers, os.path.join(
            job["tmp"], f"spatial_rank{rank}.npz"), shape)
        report["backend"] = torch.distributed.get_backend()
    elif job["kind"] == "spatial_backbone":
        report["backbone"] = p14_backbone(torch, wrappers, os.path.join(
            job["tmp"], f"backbone_rank{rank}.npz"), job["backbone"],
            tuple(job["shape"]))
        report["backend"] = torch.distributed.get_backend()
    elif job["kind"] == "spatial_steps":
        report["spatial_train"] = p14_spatial_steps(
            torch, wrappers, os.path.join(job["tmp"],
                                          f"spatial_train_rank{rank}.npz"),
            tuple(job["shape"]))
        report["backend"] = torch.distributed.get_backend()
    elif job["kind"] == "spatial_cli":
        report["spatial_train_cli"] = p14_spatial_train_cli(
            torch, wrappers, job["train"], tuple(job["shape"]))
        report["backend"] = torch.distributed.get_backend()
    elif job["kind"] == "steps":
        world = int(os.environ["WORLD_SIZE"])
        mesh = mesh_lib.mesh_from_shape([world], None, "cuda")
        report["backend"] = torch.distributed.get_backend()
        report.update(p14_steps(torch, mesh, os.path.join(
            job["tmp"], f"w{world}_rank{rank}.npz"), job["n_steps"],
            n_evals=2)[0])
    else:
        mesh = mesh_lib.mesh_from_shape([2], None, "cuda")
        report["backend"] = torch.distributed.get_backend()
        rep, named, opt = p14_steps(torch, mesh, os.path.join(
            job["tmp"], f"w2_rank{rank}.npz"))
        report.update(rep)
        from mst_tpu_torch.train import sharded_ckpt

        tree = {"trainable": named, "opt": {
            f"{i}/{k}": t for i, s in enumerate(opt.state.values())
            for k, t in s.items()}}
        sharded_ckpt.save_sharded(os.path.join(job["tmp"], "dcp"), tree)
        if rank == 0:
            import numpy as np

            from mst_tpu_torch import io

            np.savez(os.path.join(job["tmp"], "dcp_saved.npz"), **{
                k: v.detach().cpu().numpy()
                for k, v in io.flatten(tree).items()})
        from mst_tpu_torch import grid

        del named, opt, tree
        release(torch)  # the steps' cached blocks go before the spatial
        report["spatial"] = p14_spatial(torch, wrappers, os.path.join(
            job["tmp"], f"spatial_rank{rank}.npz"))
        release(torch)  # and the spatial pass's before the test CLI's
        report["spatial_cli"] = p14_spatial_cli(torch, wrappers,
                                                job["test"])
        release(torch)  # and the test CLI's before the spatial steps'
        report["spatial_train"] = p14_spatial_steps(
            torch, wrappers, os.path.join(job["tmp"],
                                          f"spatial_train_rank{rank}.npz"))
        release(torch)
        report["spatial_train_cli"] = p14_spatial_train_cli(
            torch, wrappers, job["train"])
        release(torch)  # and the train CLIs' before the backbone's
        report["backbone"] = p14_backbone(torch, wrappers, os.path.join(
            job["tmp"], f"backbone_rank{rank}.npz"), job["backbone"],
            P14_SPATIAL)
        release(torch)
        report["backbone_cli"] = p14_spatial_train_cli(
            torch, wrappers, job["backbone"]["train"])
        release(torch)  # and the backbone's before the grid's
        t0 = time.perf_counter()
        buf = io_text.StringIO()
        with contextlib.redirect_stdout(buf):
            report["grid"] = grid.run_grid(grid.get_parser().parse_args(
                job["grid"] + ["--mesh_shape", "2"]))
        report["grid_s"] = time.perf_counter() - t0
    report["launches"] = {k: w.launches for k, w in wrappers.items()}
    progress(f"job {job['kind']} done")
    mesh_lib.shutdown()
    print("P14 " + json.dumps(report), flush=True)
    return 0


def serial_bn_cost(torch, card, n_steps=6, rounds=2):
    """14b's serial-adapter step in a world of 1, timed with the port's
    train-mode batch norm (layers.global_batch_norm, the one formula of
    every world) and with cuDNN's F.batch_norm in its place, alternating,
    each round on a fresh model -> their median ms past each round's
    first step; their first losses agree to P14_LOSS_RTOL."""
    import numpy as np

    import torch.nn.functional as F

    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.train.steps import make_train_step

    def cudnn_bn(params, state, x, shards=None, momentum=0.1, eps=1e-5):
        mean = state["running_mean"].detach().clone()
        var = state["running_var"].detach().clone()
        y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var,
                         params["weight"].to(mean.dtype),
                         params["bias"].to(mean.dtype), True, momentum, eps)
        return y.permute(0, 2, 3, 1), {
            "running_mean": mean, "running_var": var,
            "num_batches": state["num_batches"] + 1}

    port_bn = layers.global_batch_norm
    ms, loss = {"port": [], "cudnn": []}, {}
    try:
        for _ in range(rounds):
            for name, bn in (("port", port_bn), ("cudnn", cudnn_bn)):
                layers.global_batch_norm = bn
                params, weights, state, opt, _ = p14_model(torch, "serial")
                batch = fine_tune_batch(torch, params, 352, 480, 8)
                step = make_train_step(ynet_config(params),
                                       step_config(params))
                for i in range(n_steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(weights, state, opt, batch)
                    torch.cuda.synchronize()
                    if i:
                        ms[name].append(1e3 * (time.perf_counter() - t0))
                    else:
                        loss.setdefault(name, float(m["loss"]))
    finally:
        layers.global_batch_norm = port_bn
    err = abs(loss["port"] - loss["cudnn"]) / abs(loss["cudnn"])
    check(err <= P14_LOSS_RTOL, f"14b serial: the two batch norms' losses "
          f"differ by {err}")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"14b serial step ms ({card}), world of 1, median of "
          f"{rounds} x {n_steps - 1}: the port's batch norm "
          f"{med['port']:.2f}, cuDNN's F.batch_norm in its place "
          f"{med['cudnn']:.2f}; first losses {err:.3e} relative apart")
    return med


def hold_world(tmp, one, rep1, reps, backend, label):
    """Phase 14b's checks of a world of ranks (their reports and their
    w<world>_rank<r>.npz in tmp) against the world of 1 (one, rep1):
    losses, leaves on the significant elements, the serial BN statistics
    and loss, each rank's draws its rows of the world of 1's, the TTST
    pass's outputs; both kernels launched on each rank. Prints them."""
    import numpy as np

    from mst_tpu_torch.config import get_params

    world = len(reps)
    check(all(r["backend"] == backend for r in reps),
          f"{label}: backends {[r['backend'] for r in reps]}")
    for r in reps:
        for k in ("softargmax_rows", "fused_predict", "kmeans"):
            check(r["launches"][k] > 0,
                  f"{label}: {k} never ran on rank {r['rank']}")
    loss_err = max(abs(a - b) / abs(b) for r in reps
                   for a, b in zip(r["losses"][:P14_STEPS],
                                   rep1["losses"]))
    check(loss_err <= P14_LOSS_RTOL and all(
        r["n"] == rep1["n"] == 6.0 for r in reps),
          f"{label}: losses {loss_err:.3e} off the world of 1's")
    ranks_out = [p14_read(os.path.join(tmp, f"w{world}_rank{r}.npz"))
                 for r in range(world)]
    leaf_err, flipped, n_el = 0.0, 0, 0
    for k in (k for k in one if k.startswith("leaf/")):
        name = k[len("leaf/"):]
        sig = np.ones(one[k].shape, bool)
        for i in range(P14_STEPS):
            g = np.abs(one[f"grad{i}/{name}"])
            sig &= g > P14_SIG * g.max()
        scale = max(np.abs(one[k]).max(), 1e-12)
        for out in ranks_out:
            check(np.array_equal(out[k], ranks_out[0][k]),
                  f"{label}: the ranks' {name} differ")
        d = np.abs(ranks_out[0][k] - one[k]) / scale
        leaf_err = max(leaf_err, float(d[sig].max(initial=0.0)))
        flipped += int((d[~sig] > P14_LEAF_TOL).sum())
        n_el += d.size
    check(leaf_err <= P14_LEAF_TOL,
          f"{label}: leaves {leaf_err:.3e} of their max off the world of 1")
    stat_err = max(float(np.abs(out[k].astype(np.float64) - one[k])
                         .max()) for out in ranks_out for k in one
                   if k.startswith("state/"))
    check(stat_err <= P14_STAT_TOL and any(
        k.endswith("running_var") for k in one),
          f"{label}: serial BN statistics {stat_err:.3e} off")
    serial_err = max(abs(r["serial_loss"] - rep1["serial_loss"])
                     / abs(rep1["serial_loss"]) for r in reps)
    check(serial_err <= P14_LOSS_RTOL, f"{label}: serial loss {serial_err}")
    # each rank's draws: its rows of the world of 1's, bit for bit
    n_draws = sum(1 for k in one if k.startswith("draw") and "dim" not
                  in k)
    for r, out in enumerate(ranks_out):
        check(sum(1 for k in out if k.startswith("draw") and "dim" not
                  in k) == n_draws and n_draws > 0,
              f"{label}: rank {r} drew {n_draws} times?")
        for i in range(n_draws):
            dim = int(one[f"drawdim{i}"])
            n = one[f"draw{i}"].shape[dim] // world
            want = np.take(one[f"draw{i}"], range(r * n, (r + 1) * n),
                           axis=dim)
            check(np.array_equal(out[f"draw{i}"], want),
                  f"{label}: rank {r}'s draw {i} is not its rows' draw")
    rf = get_params("sdd_shortterm_train.yaml")["resize_factor"]
    valid = one["eval/mask"] > 0
    for out in ranks_out:
        check(all(np.array_equal(out[f"eval/{k}"], ranks_out[0][
            f"eval/{k}"]) for k in ("ade", "fde", "best_traj")),
              f"{label}: the ranks' gathered eval outputs differ")
    out = ranks_out[0]
    # a row moved where its waypoint samples did (model px): a sample at a
    # CDF boundary of a map that differs in its last bits
    wps = np.concatenate([o["eval/wps"] for o in ranks_out], axis=1)
    moved = valid & (np.abs(wps - one["eval/wps"]).max(axis=(0, 2, 3))
                     > P14_PX_TOL)
    kept = valid & ~moved
    px = np.abs(out["eval/best_traj"] - one["eval/best_traj"]).max(
        axis=(1, 2)) * rf
    check(float(px[kept].max(initial=0.0)) <= P14_PX_TOL,
          f"{label}: best_traj {px[kept].max():.3e} model px off on rows "
          f"whose samples did not move")
    val_err = max(float(np.max(np.abs(out[f"eval/{k}"][kept]
                                      - one[f"eval/{k}"][kept])
                               / one[f"eval/{k}"][kept], initial=0.0))
                  for k in ("ade", "fde"))
    check(moved.sum() <= P14_MOVED_SHARE * valid.sum()
          and val_err <= P14_VAL_RTOL,
          f"{label}: TTST pass: {int(moved.sum())} of {int(valid.sum())} "
          f"rows moved, the others' ADE/FDE {val_err:.3e} off")
    per = len(valid) // world
    print(f"{label}: a world of {world} ({backend}), valid rows by rank "
          f"{[int(valid[r * per:(r + 1) * per].sum()) for r in range(world)]}"
          f" of {per} each: {P14_STEPS} mosa_2 steps' "
          f"losses {loss_err:.3e} relative off the world of 1's, leaves "
          f"{leaf_err:.3e} of their max where |g| > {P14_SIG} max|g| "
          f"({flipped} of {n_el} other elements off by more); serial "
          f"BN statistics {stat_err:.3e}, its loss {serial_err:.3e}; "
          f"{n_draws} TTST draws bit-equal by row on each rank; "
          f"{int(moved.sum())} of {int(valid.sum())} rows' samples "
          f"moved, the rest's ADE/FDE {val_err:.3e} relative, best_traj "
          f"{float(px[kept].max(initial=0.0)):.2e} model px")


# mesh_scaling's parts, in their order
SCALING_PARTS = ("worlds", "spatial", "spatial_steps", "spatial_cli",
                 "backbone")


def mesh_scaling(torch, card, worlds=(2, 4), n_steps=P14_SCALE_STEPS,
                 parts=SCALING_PARTS, logs=None):
    """Phase 14b across cards, not part of main(), in parts (SCALING_PARTS,
    each a job of its own through start_ranks): 'worlds', for each N of
    `worlds` a world of N ranks, each on a card of its own (NCCL), runs
    n_steps mosa_2 steps, a serial-adapter step and the K = 20 TTST pass
    on phase 6b's batch (B = 8, split N ways), held against this process's
    world of 1 as 14b holds the world of 2 (hold_world); the largest
    world's ranks each see their own card alone, and must still take NCCL;
    then the step's and the pass's ms of every world: strong scaling of
    one global batch. On a (1, max(worlds)) ('data', 'space') mesh over
    NCCL, a card a rank: 'spatial', the same TTST pass against the world
    of 1 (hold_spatial); 'spatial_steps', 14f's train steps
    (hold_spatial_steps); 'spatial_cli', the train CLI's --fused over
    phase 6c's scenes, captured with its halo all-reduces on every rank
    (ms and peak by rank); 'backbone', 14g's backbone in the step
    (hold_backbone: the TTST pass, the segmentation_bn steps in eval and
    train mode and the backbone alone on a 1408 x 1920 image, each rank's
    peak against the world of 1's). Each job's ranks write their output
    under `logs` (default: the run's temporary directory), a directory a
    job. Needs max(worlds) cards; on a host with four:

        python3 -c 'import chip_smoke; chip_smoke.mesh_scaling_main()'
    -> {N: (median step ms past the first, TTST pass ms)}."""
    import numpy as np

    check(torch.cuda.device_count() >= max(worlds),
          f"mesh_scaling: {torch.cuda.device_count()} cards for a world of "
          f"{max(worlds)}")
    check(set(parts) <= set(SCALING_PARTS), f"mesh_scaling: parts {parts}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp()
    logs = logs or os.path.join(tmp, "ranks")
    n = max(worlds)

    def ranks(part, job, limit, world=n, own_card=True):
        """The part's job on `world` ranks, its wall seconds printed."""
        t0 = time.perf_counter()
        reps = start_ranks(world, dict(job, tmp=tmp), limit, own_card,
                           os.path.join(logs, f"{part}_x{world}"))()
        print(f"14 x{world} {part}: the job took "
              f"{time.perf_counter() - t0:.1f} s of its {limit} s")
        return reps

    try:
        rep1, _, _ = p14_steps(torch, None, os.path.join(tmp, "w1.npz"),
                               n_steps, n_evals=2)
        one = p14_read(os.path.join(tmp, "w1.npz"))
        times = {1: (float(np.median(rep1["step_ms"][1:])), rep1["val_ms"])}
        for w in worlds if "worlds" in parts else ():
            release(torch)
            reps = ranks("steps", {"kind": "steps", "n_steps": n_steps}, 900,
                         w, own_card=w == n)
            hold_world(tmp, one, rep1, reps, "nccl", f"14 x{w}")
            times[w] = (float(np.median([x for r in reps
                                         for x in r["step_ms"][1:]])),
                        max(r["val_ms"] for r in reps))
            own = "; each rank sees its own card alone" if w == n else ""
            print(f"14 x{w} ms ({card}{own}): a mosa_2 step by rank "
                  f"{[[round(x, 1) for x in r['step_ms']] for r in reps]}; "
                  f"the TTST pass by rank "
                  f"{[round(r['val_ms'], 1) for r in reps]}")
        # the spatial eval over NCCL: one 'data' row of n 'space' ranks,
        # each on its own card
        if "spatial" in parts:
            release(torch)
            reps = ranks("spatial", {"kind": "spatial", "shape": [1, n]},
                         900)
            check(all(r["backend"] == "nccl" for r in reps),
                  f"14 x{n} spatial: backends {[r['backend'] for r in reps]}")
            hold_spatial(tmp, one, rep1, reps, card, (1, n),
                         f"14 x{n} spatial")
        # its train steps
        if "spatial_steps" in parts:
            release(torch)
            reps = ranks("spatial_steps", {"kind": "spatial_steps",
                                           "shape": [1, n]},
                         P14_SPATIAL_STEPS_S)
            check(all(r["backend"] == "nccl" for r in reps),
                  f"14 x{n} spatial steps: backends "
                  f"{[r['backend'] for r in reps]}")
            hold_spatial_steps(tmp, one, rep1, reps, card, (1, n),
                               f"14 x{n} spatial train")
        if {"spatial_cli", "backbone"} & set(parts):
            from mst_tpu_torch.data import splits

            images, train, val, test = loop_data()
        # the train CLI's --fused on it, whose graph captures the halo
        # all_reduces of the forward and the backward on every rank
        if "spatial_cli" in parts:
            release(torch)
            from mst_tpu_torch.config import get_params
            from mst_tpu_torch.train.trainer import Experiment

            cfg = write_grid_world(os.path.join(tmp, "world"), images,
                                   splits.limit_samples(train, 2, LOOP_B),
                                   val, test)
            base = os.path.join(tmp, "base.npz")
            Experiment(get_params(cfg, {"seed": 0}),
                       device="cuda").save_params(base)
            release(torch)
            reps = ranks("spatial_cli", {
                "kind": "spatial_cli", "shape": [1, n], "train": {
                    "fused": p14_cli_args(cfg, base, os.path.join(tmp, "f4"),
                                          ["--n_epoch", "2", "--fused"])}},
                P14_SPATIAL_CLI_S)
            check(all(r["backend"] == "nccl" for r in reps),
                  f"14 x{n} spatial --fused: backends "
                  f"{[r['backend'] for r in reps]}")
            clis = [rep["spatial_train_cli"]["fused"] for rep in reps]
            check(all(c["captured"] for c in clis),
                  f"14 x{n} spatial --fused: not captured on every rank")
            secs = [r["epoch_seconds"]
                    for r in epoch_records(os.path.join(tmp, "f4"))]
            print(f"14 x{n} spatial --fused ({card}; NCCL, a card a rank): "
                  f"the train CLI's 2 epochs captured as a CUDA graph on "
                  f"every rank, epoch s {[round(x, 4) for x in secs]} (the "
                  f"chunk's mean), capture s by rank "
                  f"{[round(c['capture_s'], 2) for c in clis]}, host s by "
                  f"rank {[round(c['s'], 1) for c in clis]}, peak by rank "
                  f"{[round(c['peak'] / 2**30, 3) for c in clis]} GiB, "
                  f"launches by rank "
                  f"{[{k: v for k, v in c['launches'].items() if v} for c in clis]}")
        # 14g's backbone in the step on the (1, n) mesh over NCCL
        if "backbone" in parts:
            from mst_tpu_torch.probes import kernel_wrappers

            release(torch)
            images_fp, backbone_fp, _ = write_backbone_world(
                torch, tmp, images, splits.limit_samples(train, 2, LOOP_B),
                val, test)
            bb_job = {"images": images_fp, "backbone": backbone_fp}
            rep_g1 = p14_backbone(torch, kernel_wrappers(), os.path.join(
                tmp, "backbone_w1.npz"), bb_job)
            one_g = p14_read(os.path.join(tmp, "backbone_w1.npz"))
            release(torch)
            reps = ranks("backbone", {"kind": "spatial_backbone",
                                      "shape": [1, n], "backbone": bb_job},
                         900)
            check(all(r["backend"] == "nccl" for r in reps),
                  f"14 x{n} backbone: backends {[r['backend'] for r in reps]}")
            hold_backbone(tmp, one_g, rep_g1, reps, card, (1, n),
                          f"14 x{n} spatial backbone")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"14 scaling of one global batch (B = 8, 352 x 480; {card}): "
          + "; ".join(f"{w} card(s): a step {t[0]:.1f} ms (median past the "
                      f"first), the TTST pass {t[1]:.1f} ms (its second "
                      f"call)" for w, t in times.items()))
    return times


def mesh_scaling_main(argv=None):
    """mesh_scaling on the host's cards, with the two serving kernels
    built from the checkout; prints the card's name and power limit.
    argv: --parts (some of SCALING_PARTS; default all), --logs (a
    directory for the ranks' output, which outlives the run)."""
    import argparse

    import torch

    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.ops.kernels import _build

    parser = argparse.ArgumentParser(prog="mesh_scaling_main")
    parser.add_argument("--parts", nargs="+", choices=SCALING_PARTS,
                        default=list(SCALING_PARTS))
    parser.add_argument("--logs", default=None)
    args = parser.parse_args(argv)
    resolve_device("cuda")
    _build.build(["fused_predict", "softargmax_rows"])
    card = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.split("\n")[:-1])  # each card's
    print(card)
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    mesh_scaling(torch, card, tuple(w for w in (2, 4) if w <= n),
                 parts=args.parts,
                 logs=args.logs and os.path.abspath(args.logs))
    print(f"mesh_scaling ({', '.join(args.parts)}): "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


# ---- phase 14e: the spatial ('data', 'space') mesh's eval
P14_SPATIAL = (1, 2)     # data x space, in phase 14's world of 2
PARTIAL_SHAPE = (160, 176, 480, 32)  # the eval decode tail's slab at S = 2
# px: the ranks' merged partial statistics against the whole-map kernel on
# the gathered activations, and the spatial pass's best_traj (its
# coordinates are the merged statistics') against the world of 1's. Both
# sides sum the same f32 terms in other orders, and take each pixel's
# weight as ex2(l - m) against another running max m: l - m rounds to
# 2^-24 of its size, which moves a weight by ln 2 x that (2^-22 for
# ex2.approx itself), so peaked maps (large l) differ most. A weight's
# relative error shifts the coordinate by at most the map's extent
# (480 px, where an f32 ulp is 2^-15 px) times it: a few ulps at the
# extent. merge_spread read at most 8 ulps (2.44e-4 px) over seeds, slab
# counts and flat and peaked maps; the bar is 4x that, and a wrong merge
# lands 4.6e4 bars off
F32_ULP_AT_EXTENT = 2.0 ** -15
P14_MERGE_ULPS = 32
P14_MERGE_TOL = P14_MERGE_ULPS * F32_ULP_AT_EXTENT  # 9.77e-4 px
MERGE_SEEDS = 4
MERGE_SCALES = (0.3, 3.0)  # the predictor's weight scale: flat, peaked maps
MERGE_WRONG = 100          # a wrong merge lands at least this many bars off
P14_MEM_RATIO = 0.75     # a rank's eval-pass peak over the world of 1's;
# predicted 0.5-0.6 (the K = 20 decode's maps halve; the goal logits'
# waypoint channel, the samplers and the coarse levels stay whole)


# a spatial train step's trajectory maps on a rank at S = 2: B = 8 x P = 12
# rows of 176 x 480
STEP_SLAB = (96, 176, 480)


def rows_partial_bound(R, HW, elem_bytes=4):
    """The rows kernel's partial variant reads the logits once and writes
    (R, 4) statistics; 8 operations a logit, as the whole-map kernel's."""
    return bound(R * HW * elem_bytes + R * 4 * 4, R * HW * 8)


def check_rows_partial_kernel(torch):
    """The partial-statistics variant of the rows kernel against its plain
    version in f32 and bf16 (each row's own soft-argmax, the fold of its
    statistics, px, and its max statistic m), on edge cases at a row
    offset (a train step's rows, a view off 16-byte alignment, H*W % 4 !=
    0, rows shorter than the cluster, a peaked map); two and three slabs
    of maps cut at uneven rows, merged in order (online_stats.fold,
    merge_ranks' arithmetic), against the whole-map kernel within
    P14_MERGE_TOL; f16 refused; timed at a spatial train step's slab of
    its trajectory maps (STEP_SLAB, row0 176) beside its bound -> its
    record for the JSON line."""
    from mst_tpu_torch.ops.kernels.online_stats import fold
    from mst_tpu_torch.ops.kernels.softargmax_rows import (
        softargmax2d_rows, softargmax2d_rows_partial,
        softargmax2d_rows_partial_plain)

    partial, plain = (softargmax2d_rows_partial,
                      softargmax2d_rows_partial_plain)
    g = torch.Generator(device="cuda").manual_seed(19)

    def maps(shape, dtype=torch.float32, offset=0):
        buf = torch.randn(math.prod(shape) + offset, generator=g,
                          device="cuda") * 3
        return buf.to(dtype)[offset:].view(shape)

    err = 0.0
    for dtype, tol in ((torch.float32, ROWS_TOL),
                       (torch.bfloat16, ROWS_BF16_TOL)):
        peaked = torch.full((1, 32, 64), -30.0, device="cuda", dtype=dtype)
        peaked[0, 17, 42] = 30.0
        cases = [("a train step's rows", maps((12, 44, 60), dtype), 44),
                 ("unaligned view", maps((3, 37, 53), dtype, 1), 37),
                 ("H*W % 4 != 0", maps((3, 37, 53), dtype), 74),
                 ("rows shorter than the cluster", maps((5, 3, 5), dtype),
                  9),
                 ("peaked", peaked, 100)]
        check(cases[1][1].data_ptr() % 16 != 0,
              "the unaligned view is aligned")
        label = f"rows partial statistics {str(dtype).split('.')[-1]}"
        err = max(err, check_cases(
            torch, label, lambda x, r: fold([partial(x, r)]),
            lambda x, r: fold([plain(x, r)]),
            [(n, (x, r)) for n, x, r in cases], tol))
        m_err = max(float((partial(x, r)[..., 0] - plain(x, r)[..., 0])
                          .abs().max()) for _, x, r in cases)
        check(m_err <= 1e-3, f"{label}: the max statistic m is {m_err} "
              "off its plain version")
        x = maps((6, 40, 56), dtype)
        whole = softargmax2d_rows(x)
        for cuts in ((0, 17, 40), (0, 8, 21, 40)):
            merged = fold([partial(x[:, lo:hi].contiguous(), lo)
                           for lo, hi in zip(cuts[:-1], cuts[1:])])
            e = float((merged - whole).abs().max())
            print(f"{label}: slabs {cuts} merged against the whole-map "
                  f"kernel: {e:.3e} px (tol {P14_MERGE_TOL})")
            check(e <= P14_MERGE_TOL, f"{label}: merged slabs {cuts} off")
            err = max(err, e)
    try:
        partial(maps((2, 8, 8)).half(), 0)
        check(False, "the rows partial kernel took f16")
    except ValueError:
        pass
    R, H, W = STEP_SLAB
    x = maps(STEP_SLAB)
    err = max(err, check_cases(
        torch, "rows partial statistics", lambda *a: fold([partial(*a)]),
        lambda *a: fold([plain(*a)]),
        [("a spatial step's trajectory slab", (x, H))], ROWS_TOL))
    rec = time_kernel(torch, f"softargmax_rows_partial {STEP_SLAB}",
                      lambda: partial(x, H), lambda: plain(x, H), 200, 20,
                      rows_partial_bound(R, H * W))
    del x
    torch.cuda.empty_cache()
    return {"name": "softargmax_rows_partial", "route": "cuda",
            "source": "mst_tpu_torch/csrc/softargmax_rows.cu",
            "replaces": "mst_tpu/ops/pallas/softargmax.py:63",
            "max_abs_err": err, "library_ms": None,
            **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by")}}


def partial_bound(R, H, W, C, P, elem_bytes=4):
    """The partial variant reads x once and writes (R, P, 4) statistics;
    the 2C operations a logit and its 8 of statistics, as fused_bound."""
    return bound(R * H * W * C * elem_bytes + (C * P + P) * 4
                 + R * P * 4 * 4, R * H * W * P * (2 * C + 8))


def merge_spread(torch):
    """The merge bar's readings: the spatial eval decode tail's whole map
    (PARTIAL_SHAPE's rows x 2 = 352, f32, P = 12) for MERGE_SEEDS seeds at
    each weight scale of MERGE_SCALES, cut into 2 and into 4 slabs, each
    slab's partial statistics folded in slab order (online_stats.fold,
    merge_ranks' arithmetic) against the whole-map kernel: the largest
    difference in px and in f32 ulps of the coordinate itself. Two wrong
    merges (the last slab's statistics dropped; every slab's y counted
    from row 0) must land MERGE_WRONG bars off -> (largest px, largest
    ulps, the nearest wrong merge's px)."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_partial)
    from mst_tpu_torch.ops.kernels.online_stats import fold

    R, rows, W, C = PARTIAL_SHAPE
    H = 2 * rows
    g = torch.Generator(device="cuda").manual_seed(23)
    by_scale = dict.fromkeys(MERGE_SCALES, 0.0)
    worst_ulps = 0.0
    wrong = math.inf
    for _ in range(MERGE_SEEDS):
        for scale in MERGE_SCALES:
            x = torch.randn((R, H, W, C), generator=g,
                            device="cuda").relu_()
            w = torch.randn((C, 12), generator=g, device="cuda") * scale
            b = torch.randn((12,), generator=g, device="cuda")
            whole = fused_predictor_softargmax(x, w, b)
            ulp = torch.exp2(torch.floor(torch.log2(
                whole.abs().clamp_min(1.0))) - 23)
            for n in (2, 4):
                parts, from0 = [], []
                for lo in range(0, H, H // n):
                    sl = x[:, lo:lo + H // n].contiguous()
                    parts.append(fused_predictor_softargmax_partial(
                        sl, w, b, lo))
                    from0.append(fused_predictor_softargmax_partial(
                        sl, w, b, 0))
                d = (fold(parts) - whole).abs()
                by_scale[scale] = max(by_scale[scale], float(d.max()))
                worst_ulps = max(worst_ulps, float((d / ulp).max()))
                for bad in (parts[:-1], from0):
                    wrong = min(wrong, float((fold(bad) - whole).abs()
                                             .max()))
            del x
    torch.cuda.empty_cache()
    worst_px = max(by_scale.values())
    print(f"merge spread ({MERGE_SEEDS} seeds x weight scales "
          f"{MERGE_SCALES}, 2 and 4 slabs of {(R, H, W, C)}, P = 12): the "
          f"merged statistics at most "
          f"{ {k: f'{v:.3e}' for k, v in by_scale.items()} } px by weight "
          f"scale, {worst_px:.3e} px = "
          f"{worst_px / F32_ULP_AT_EXTENT:.2f} ulps at the map's extent "
          f"({worst_ulps:.2f} ulps of the coordinate itself) off the "
          f"whole-map kernel (bar {P14_MERGE_TOL:.3e} px = "
          f"{P14_MERGE_ULPS} ulps); the nearest wrong merge {wrong:.3e} px "
          f"off")
    check(worst_px <= P14_MERGE_TOL,
          f"merge spread: {worst_px:.3e} px over the bar")
    check(wrong >= MERGE_WRONG * P14_MERGE_TOL,
          f"merge spread: a wrong merge is only {wrong:.3e} px off")
    return worst_px, worst_ulps, wrong


def check_partial_kernel(torch):
    """The partial-statistics variant of the fused kernel against its
    plain version in f32 and bf16, each slab's own soft-argmax (fold of
    its statistics, px) and its max statistic m (log2 units), on edge
    cases at a row offset (ragged, an image smaller than a stage, odd
    channels, a view off 16-byte alignment, P = 30); two and three slabs
    of a map cut at uneven rows, merged in order (online_stats.fold),
    against the whole-map kernel, and their spread (merge_spread); f16
    refused; timed at the spatial eval decode tail's slab (PARTIAL_SHAPE,
    P = 12, row0 176) beside its bound -> its record for the JSON
    line."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_partial,
        fused_predictor_softargmax_partial_plain)
    from mst_tpu_torch.ops.kernels.online_stats import fold
    from mst_tpu_torch.probes.serving_kernels import fused_inputs

    partial, plain = (fused_predictor_softargmax_partial,
                      fused_predictor_softargmax_partial_plain)
    g = torch.Generator(device="cuda").manual_seed(17)

    def case(R, H, W, C, P, dtype=torch.float32, offset=0):
        buf = torch.randn(R * H * W * C + offset, generator=g, device="cuda")
        x = buf.to(dtype)[offset:].view(R, H, W, C).relu_()
        w = (torch.randn((C, P), generator=g, device="cuda") * 0.3).to(dtype)
        return x, w, torch.randn((P,), generator=g, device="cuda")

    err = 0.0
    for dtype, tol in ((torch.float32, FUSED_TOL),
                       (torch.bfloat16, FUSED_BF16_TOL)):
        cases = [("ragged", case(3, 40, 56, 32, 12, dtype) + (96,)),
                 ("one image smaller than a stage",
                  case(1, 10, 20, 32, 12, dtype) + (7,)),
                 ("odd channels", case(2, 24, 40, 6, 5, dtype) + (13,)),
                 ("unaligned view", case(2, 40, 56, 32, 12, dtype, 1)
                  + (40,)),
                 ("P 30", case(2, 44, 60, 32, 30, dtype) + (22,))]
        check(cases[3][1][0].data_ptr() % 16 != 0,
              "the unaligned view is aligned")
        label = f"partial statistics {str(dtype).split('.')[-1]}"
        err = max(err, check_cases(
            torch, label, lambda *a: fold([partial(*a)]),
            lambda *a: fold([plain(*a)]), cases, tol))
        m_err = max(float((partial(*a)[..., 0] - plain(*a)[..., 0]).abs()
                          .max()) for _, a in cases)
        check(m_err <= 1e-3, f"{label}: the max statistic m is {m_err} "
              "off its plain version")
        x, w, b = case(4, 40, 56, 32, 12, dtype)
        whole = fused_predictor_softargmax(x, w, b)
        for cuts in ((0, 17, 40), (0, 8, 21, 40)):
            merged = fold([partial(x[:, lo:hi].contiguous(), w, b, lo)
                           for lo, hi in zip(cuts[:-1], cuts[1:])])
            e = float((merged - whole).abs().max())
            print(f"{label}: slabs {cuts} merged against the whole-map "
                  f"kernel: {e:.3e} px (tol {P14_MERGE_TOL})")
            check(e <= P14_MERGE_TOL, f"{label}: merged slabs {cuts} off")
            err = max(err, e)
    err = max(err, merge_spread(torch)[0])
    try:
        partial(*(t.half() for t in case(2, 8, 8, 32, 12)), 0)
        check(False, "the partial kernel took f16")
    except ValueError:
        pass
    R, H, W, C = PARTIAL_SHAPE
    x, w, b = fused_inputs(12, shape=PARTIAL_SHAPE)
    err = max(err, check_cases(
        torch, "partial statistics", lambda *a: fold([partial(*a)]),
        lambda *a: fold([plain(*a)]),
        [("the spatial decode tail's slab", (x, w, b, H))], FUSED_TOL))
    rec = time_kernel(
        torch, f"fused_predict_partial {PARTIAL_SHAPE} x ({C}, 12)",
        lambda: partial(x, w, b, H), lambda: plain(x, w, b, H), 20, 3,
        partial_bound(R, H, W, C, 12))
    del x, w, b
    torch.cuda.empty_cache()
    return {"name": "fused_predict_partial", "route": "cuda",
            "source": "mst_tpu_torch/csrc/fused_predict.cu",
            "replaces": "mst_tpu/ops/pallas/fused_predict.py:109",
            "max_abs_err": err, "library_ms": None,
            **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by")}}


def p14_spatial(torch, wrappers, out_path, shape=P14_SPATIAL):
    """(e) on this rank of phase 14's world of 2: 14b's K = 20 TTST pass
    (the model as p14_model makes it, phase 6b's batch, the world of 1's
    draws) on a `shape` ('data', 'space') mesh of the world, the rank
    holding its slab of the scene map's rows, twice; the second pass
    timed, its peak device memory above its start, and its kernel
    launches counted (the counts of the job are restored after, with
    them). Then, on the pass's decode
    inputs: the ranks' merged partial statistics against the whole-map
    kernel on the gathered activations, and the partial kernel against
    its plain version in f32 and bf16 -> report; the outputs and the
    waypoint samples to out_path."""
    import numpy as np

    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_partial,
        fused_predictor_softargmax_partial_plain)
    from mst_tpu_torch.ops.kernels.online_stats import fold, merge_ranks
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.train.steps import make_eval_step

    H, W, B = 352, 480, 8
    mesh = mesh_lib.mesh_from_shape(list(shape), ["data", "space"], "cuda")
    slab = mesh_lib.space_slab(mesh, H)
    params, weights, state, _, _ = p14_model(torch, "mosa_2")
    batch = fine_tune_batch(torch, params, H, W, B)
    batch["semantic"] = slab.take(batch["semantic"]).contiguous()
    scfg = step_config(params)
    eval_step = make_eval_step(ynet_config(params), scfg, mesh)
    held = {k: w.launches for k, w in wrappers.items()}
    report = {}
    for i in range(2):
        gen = torch.Generator("cuda").manual_seed(eval_seed_p14())
        torch.cuda.synchronize()
        if i:
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        feats, wps = eval_step.forward(weights, state, batch, gen)
        out = eval_step.global_outputs(eval_step.decode_and_score(
            weights, feats, wps, batch["traj"], batch["mask"]))
        torch.cuda.synchronize()
        report["ms"] = 1e3 * (time.perf_counter() - t0)
    report["peak"] = torch.cuda.max_memory_allocated() - base
    report["launches"] = {k: w.launches for k, w in wrappers.items()}
    K = wps.shape[0]
    report["chunks"] = K // (scfg.eval_k_chunk or K)
    report["rows"] = [f.shape[1] for f in feats]
    np.savez(out_path, wps=wps.cpu().numpy(),
             **{k: v.cpu().numpy() for k, v in out.items()})
    x, w, b = eval_step.prepredictor(weights, feats)(wps)
    report["partial_shape"] = list(x.shape)
    stats = fused_predictor_softargmax_partial(x, w, b, slab.lo)
    merged = merge_ranks(stats, slab)
    whole = fused_predictor_softargmax(slab.gather(x), w, b)
    report["merge_err"] = float((merged - whole).abs().max())
    for dtype, key in ((torch.float32, "plain_err"),
                       (torch.bfloat16, "plain_err_bf16")):
        xd, wd = x.to(dtype), w.to(dtype)
        report[key] = float((fold([fused_predictor_softargmax_partial(
            xd, wd, b, slab.lo)]) - fold([
                fused_predictor_softargmax_partial_plain(
                    xd, wd, b, slab.lo)])).abs().max())
    for k, w in wrappers.items():  # the comparisons' launches do not count
        w.launches = held[k] + report["launches"][k]
    return report


def hold_spatial(tmp, one, rep1, reps, card, shape=P14_SPATIAL,
                 label="14e"):
    """Phase 14e's checks of the spatial pass on each rank of the world of
    2 (its report and spatial_rank<r>.npz in tmp) against the world of 1's
    TTST pass of 14b (one, rep1): the waypoint samples bit-equal, ade and
    fde within P14_VAL_RTOL, best_traj within P14_MERGE_TOL model px; the
    ranks' merged partial statistics within P14_MERGE_TOL of the
    whole-map kernel; the partial kernel against its plain version; its
    launches one a decode chunk on each rank, the whole-map fused kernel
    none, the rows kernel (TTST's goal point) some; each rank's peak below
    P14_MEM_RATIO of the world of 1's. `shape`: the ranks' ('data',
    'space') mesh, one 'data' row. Prints them -> the partial variant's
    {launches by rank, max error}."""
    import numpy as np

    from mst_tpu_torch.config import get_params

    rf = get_params("sdd_shortterm_train.yaml")["resize_factor"]
    valid = one["eval/mask"] > 0
    val_err = px = 0.0
    for r, rep in enumerate(reps):
        sp = rep["spatial"]
        out = p14_read(os.path.join(tmp, f"spatial_rank{r}.npz"))
        check(np.array_equal(out["wps"], one["eval/wps"]),
              f"{label}: rank {r}'s waypoint samples differ from the world "
              f"of 1's ({int((out['wps'] != one['eval/wps']).sum())} "
              "values)")
        val_err = max(val_err, max(float(np.max(
            np.abs(out[k][valid] - one[f"eval/{k}"][valid])
            / one[f"eval/{k}"][valid])) for k in ("ade", "fde")))
        px = max(px, float(np.abs(out["best_traj"] - one["eval/best_traj"])
                           .max()) * rf)
        launches = sp["launches"]
        check(launches["fused_predict_partial"] == sp["chunks"] > 0
              and launches["fused_predict"] == 0
              and launches["softargmax_rows"] > 0,
              f"{label}: rank {r}'s launches {launches}, {sp['chunks']} "
              "decode chunk(s)")
        check(sp["rows"][0] == 352 // shape[1],
              f"{label}: rank {r}'s finest features hold {sp['rows'][0]} "
              "rows")
        check(sp["merge_err"] <= P14_MERGE_TOL
              and sp["plain_err"] <= FUSED_TOL
              and sp["plain_err_bf16"] <= FUSED_BF16_TOL,
              f"{label}: rank {r}: merged {sp['merge_err']:.3e} px off the "
              f"whole-map kernel, the kernel {sp['plain_err']:.3e} (f32) "
              f"and {sp['plain_err_bf16']:.3e} (bf16) off its plain one")
    check(val_err <= P14_VAL_RTOL and px <= P14_MERGE_TOL,
          f"{label}: ADE/FDE {val_err:.3e} relative, best_traj {px:.3e} "
          "model px off the world of 1's")
    ratio = [rep["spatial"]["peak"] / rep1["val_peak"] for rep in reps]
    check(max(ratio) < P14_MEM_RATIO,
          f"{label}: a rank's eval-pass peak is {max(ratio):.3f} of the "
          f"world of 1's (bar {P14_MEM_RATIO})")
    sps = [rep["spatial"] for rep in reps]
    print(f"{label}: the spatial eval on a {shape[0]} x {shape[1]} "
          f"('data', 'space') mesh ({card}): rows a rank "
          f"holds by level {sps[0]['rows']}; waypoint samples bit-equal to "
          f"the world of 1's on every rank, ADE/FDE {val_err:.3e} relative, "
          f"best_traj {px:.3e} model px; the partial variant on "
          f"{sps[0]['partial_shape']}: launches by rank "
          f"{[sp['launches']['fused_predict_partial'] for sp in sps]} "
          f"({sps[0]['chunks']} decode chunk(s)), merged "
          f"{max(sp['merge_err'] for sp in sps):.3e} px off the whole-map "
          f"kernel, {max(sp['plain_err'] for sp in sps):.3e} (f32) and "
          f"{max(sp['plain_err_bf16'] for sp in sps):.3e} px (bf16) off its "
          f"plain version; eval-pass peak memory by rank "
          f"{[round(sp['peak'] / 2**30, 3) for sp in sps]} GiB against the "
          f"world of 1's {rep1['val_peak'] / 2**30:.3f} GiB, ratios "
          f"{[round(x, 3) for x in ratio]} (bar {P14_MEM_RATIO}); the "
          f"pass's ms by rank {[round(sp['ms'], 1) for sp in sps]} against "
          f"the world of 1's {rep1['val_ms']:.1f} (its second pass each)")
    return {"launches": [sp["launches"]["fused_predict_partial"]
                         for sp in sps],
            "max_abs_err": max(max(sp["merge_err"], sp["plain_err"],
                                   sp["plain_err_bf16"]) for sp in sps)}


def p14_spatial_cli(torch, wrappers, args, shape=P14_SPATIAL):
    """(e) on this rank: the test CLI's main(), `python -m
    mst_tpu_torch.test args --mesh_shape D S --mesh_axes data space`, on
    a `shape` spatial mesh of the world, every kernel's count set to 0
    just before it and read just after (the job's counts then add them)
    -> {its stdout, its launches, host s}."""
    from mst_tpu_torch import test as test_cli
    from mst_tpu_torch.config import get_parser

    held = {k: w.launches for k, w in wrappers.items()}
    parsed = get_parser(False).parse_args(args + [
        "--mesh_shape", *map(str, shape), "--mesh_axes", "data", "space"])
    buf = io_text.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, launches = count_launches(wrappers,
                                     lambda: test_cli.main(parsed))
    torch.cuda.synchronize()
    for k, w in wrappers.items():
        w.launches = held[k] + launches[k]
    return {"text": buf.getvalue(), "launches": launches,
            "s": time.perf_counter() - t0}


def test_metrics(text):
    """The Test ADE / FDE values a test CLI printed, in order."""
    return [float(v) for v in re.findall(r"Test [AF]DE: ([\d.eE+-]+)",
                                         text)]


def hold_spatial_cli(text1, launches1, secs1, reps, card, label="14e"):
    """Phase 14e through the entry point: each rank's test CLI on the
    spatial mesh (p14_spatial_cli) against the same CLI without a mesh in
    this process (its stdout, launches and host s): every Test ADE / FDE
    it prints (each round's and the average) within P14_VAL_RTOL; its
    launches the world of 1's with the partial variant in the fused
    kernel's place (one a decode chunk) and the rows kernel's (TTST's
    goal point) unchanged -> the partial variant's launches by rank."""
    want = test_metrics(text1)
    check(want and all(map(math.isfinite, want)),
          f"{label}: the world of 1's test CLI printed {want}")
    expect = dict(launches1, fused_predict=0,
                  fused_predict_partial=launches1["fused_predict"])
    check(expect["fused_predict_partial"] > 0,
          f"{label}: the world of 1's test CLI launched {launches1}")
    err = 0.0
    for r, rep in enumerate(reps):
        cli = rep["spatial_cli"]
        got = test_metrics(cli["text"])
        check(len(got) == len(want), f"{label}: rank {r}'s test CLI "
              f"printed {got}, the world of 1's {want}")
        err = max(err, *(abs(g - w) / abs(w) for g, w in zip(got, want)))
        check(cli["launches"] == expect,
              f"{label}: rank {r}'s test CLI launched {cli['launches']}, "
              f"expected {expect}")
    check(err <= P14_VAL_RTOL, f"{label}: the test CLI's ADE/FDE "
          f"{err:.3e} relative off the world of 1's")
    ran = [{k: v for k, v in rep["spatial_cli"]["launches"].items() if v}
           for rep in reps]
    print(f"{label}: `python -m mst_tpu_torch.test --mesh_shape "
          f"{' '.join(map(str, P14_SPATIAL))} --mesh_axes data space` "
          f"(main() on each rank; {card}): Test ADE/FDE {got} on every "
          f"rank, {err:.3e} relative off the same CLI without a mesh "
          f"{want}; launches by rank {ran}, without a mesh "
          f"{ {k: v for k, v in launches1.items() if v} }; host s by rank "
          f"{[round(rep['spatial_cli']['s'], 1) for rep in reps]}, without "
          f"a mesh {secs1:.1f}")
    return [rep["spatial_cli"]["launches"]["fused_predict_partial"]
            for rep in reps]


# ---- phase 14f: training on the spatial ('data', 'space') mesh
P14F_EPOCHS = 1  # the train CLI's epochs on the spatial mesh (14f)


def p14_spatial_steps(torch, wrappers, out_path, shape=P14_SPATIAL):
    """(f) on this rank: 14b's P14_STEPS mosa_2 steps and a serial-adapter
    step (the models as p14_model makes them, phase 6b's batch) on a
    `shape` ('data', 'space') mesh of the world, the rank holding its
    'data' block of the rows and its slab of the scene map's rows; every
    kernel's count set to 0 just before the steps and read just after
    (the job's counts add them); each step's ms and the last mosa_2
    step's peak device memory above its start. Then, on the last state's
    maps (outside the counts): the rows kernel's partial variant against
    its plain version in f32 and bf16, and the ranks' merged statistics
    against the whole-map rows kernel on the gathered maps -> report; the
    leaves after the mosa_2 steps, their gradients and the serial state
    to out_path."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.ops.kernels.online_stats import fold, merge_ranks
    from mst_tpu_torch.ops.kernels.softargmax_rows import (
        softargmax2d_rows, softargmax2d_rows_partial,
        softargmax2d_rows_partial_plain)
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.train.steps import make_train_step

    H, W, B = 352, 480, 8
    mesh = mesh_lib.mesh_from_shape(list(shape), ["data", "space"], "cuda")
    slab = mesh_lib.space_slab(mesh, H)
    shards = mesh_lib.batch_shards(mesh)
    params, weights, state, opt, named = p14_model(torch, "mosa_2")
    batch = fine_tune_batch(torch, params, H, W, B)
    lo, hi = shards.rows(B // shards.count)
    batch = {k: slab.take(v).contiguous() if k == "semantic" else v[lo:hi]
             for k, v in batch.items()}
    step = make_train_step(ynet_config(params), step_config(params), mesh)
    sparams, sweights, sstate, sopt, _ = p14_model(torch, "serial")
    sstep = make_train_step(ynet_config(sparams), step_config(sparams),
                            mesh)
    held = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    arrays, report = {}, {"losses": [], "step_ms": []}
    for i in range(P14_STEPS):
        torch.cuda.synchronize()
        if i == P14_STEPS - 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = step(weights, state, opt, batch)
        torch.cuda.synchronize()
        report["step_ms"].append(1e3 * (time.perf_counter() - t0))
        report["losses"].append(float(m["loss"]))
        progress(f"spatial step {i}: {report['step_ms'][-1]:.1f} ms")
        arrays.update({f"grad{i}/{k}": v.grad.cpu().numpy()
                       for k, v in named.items()})
    report["step_peak"] = torch.cuda.max_memory_allocated() - base
    report["n"] = float(m["n"])
    arrays.update({f"leaf/{k}": v.detach().cpu().numpy()
                   for k, v in named.items()})
    sstate, sm = sstep(sweights, sstate, sopt, batch)
    report["serial_loss"] = float(sm["loss"])
    progress("spatial serial step")
    arrays.update({f"state/{k}": v.cpu().numpy()
                   for k, v in io.flatten(sstate).items()})
    torch.cuda.synchronize()
    report["launches"] = {k: w.launches for k, w in wrappers.items()}
    report["rows"] = list(batch["semantic"].shape[1:3])
    np.savez(out_path, **arrays)
    with torch.no_grad():
        _, _, goal_map, traj_map, _ = step.forward(weights, state, batch)
    maps = traj_map.permute(0, 3, 1, 2).contiguous()  # (B, P, rows, W)
    report["maps_shape"] = list(maps.shape)
    merged = merge_ranks(softargmax2d_rows_partial(maps, slab.lo), slab)
    whole = softargmax2d_rows(slab.gather(maps, 2))  # (B, P, H, W)
    report["merge_err"] = float((merged - whole).abs().max())
    for dtype, key in ((torch.float32, "plain_err"),
                       (torch.bfloat16, "plain_err_bf16")):
        md = maps.to(dtype)
        report[key] = float((fold([softargmax2d_rows_partial(
            md, slab.lo)]) - fold([softargmax2d_rows_partial_plain(
                md, slab.lo)])).abs().max())
    for k, w in wrappers.items():  # the comparisons' launches do not count
        w.launches = held[k] + report["launches"][k]
    return report


def hold_spatial_steps(tmp, one, rep1, reps, card, shape=P14_SPATIAL,
                       label="14f"):
    """Phase 14f's checks of the spatial train steps on each rank (its
    report's 'spatial_train' and spatial_train_rank<r>.npz in tmp) against
    the world of 1's 14b steps (one, rep1), 14b's bars: the losses within
    P14_LOSS_RTOL, the leaves the same on every rank and within
    P14_LEAF_TOL of their max where every step's |g| is above P14_SIG of
    its max, the serial step's loss and BN statistics; the rows kernel's
    partial variant twice a step on each rank, the whole-map rows kernel
    and every other kernel never; the partial kernel against its plain
    version (ROWS_TOL, ROWS_BF16_TOL) and the ranks' merged statistics
    against the whole-map kernel (P14_MERGE_TOL). Prints them, with each
    rank's step ms and peak against the world of 1's -> {launches by
    rank, max error}."""
    import numpy as np

    sts = [rep["spatial_train"] for rep in reps]
    n_steps = P14_STEPS + 1  # and the serial step
    for r, st in enumerate(sts):
        want = dict.fromkeys(st["launches"], 0)
        want["softargmax_rows_partial"] = 2 * n_steps
        check(st["launches"] == want, f"{label}: rank {r}'s steps launched "
              f"{ {k: v for k, v in st['launches'].items() if v} }, the "
              f"code gives {2 * n_steps} rows partial and nothing else")
        check(st["rows"][0] == 352 // shape[1],
              f"{label}: rank {r}'s scene slab holds {st['rows']}")
        check(st["merge_err"] <= P14_MERGE_TOL
              and st["plain_err"] <= ROWS_TOL
              and st["plain_err_bf16"] <= ROWS_BF16_TOL,
              f"{label}: rank {r}: merged {st['merge_err']:.3e} px off the "
              f"whole-map kernel, the kernel {st['plain_err']:.3e} (f32) and "
              f"{st['plain_err_bf16']:.3e} (bf16) off its plain one")
    loss_err = max(abs(a - b) / abs(b) for st in sts
                   for a, b in zip(st["losses"], rep1["losses"]))
    check(loss_err <= P14_LOSS_RTOL and all(
        st["n"] == rep1["n"] for st in sts),
          f"{label}: losses {loss_err:.3e} off the world of 1's")
    outs = [p14_read(os.path.join(tmp, f"spatial_train_rank{r}.npz"))
            for r in range(len(reps))]
    leaf_err, flipped, n_el = 0.0, 0, 0
    for k in (k for k in one if k.startswith("leaf/")):
        name = k[len("leaf/"):]
        sig = np.ones(one[k].shape, bool)
        for i in range(P14_STEPS):
            g = np.abs(one[f"grad{i}/{name}"])
            sig &= g > P14_SIG * g.max()
        for out in outs:
            check(np.array_equal(out[k], outs[0][k]),
                  f"{label}: the ranks' {name} differ")
        d = np.abs(outs[0][k] - one[k]) / max(np.abs(one[k]).max(), 1e-12)
        leaf_err = max(leaf_err, float(d[sig].max(initial=0.0)))
        flipped += int((d[~sig] > P14_LEAF_TOL).sum())
        n_el += d.size
    check(leaf_err <= P14_LEAF_TOL,
          f"{label}: leaves {leaf_err:.3e} of their max off the world of 1")
    stat_err = max(float(np.abs(out[k].astype(np.float64) - one[k]).max())
                   for out in outs for k in one if k.startswith("state/"))
    check(stat_err <= P14_STAT_TOL,
          f"{label}: serial BN statistics {stat_err:.3e} off")
    serial_err = max(abs(st["serial_loss"] - rep1["serial_loss"])
                     / abs(rep1["serial_loss"]) for st in sts)
    check(serial_err <= P14_LOSS_RTOL, f"{label}: serial loss {serial_err}")
    ratio = [st["step_peak"] / rep1["step_peak"] for st in sts]
    print(f"{label}: {P14_STEPS} mosa_2 steps and a serial step on a "
          f"{shape[0]} x {shape[1]} ('data', 'space') mesh ({card}), each "
          f"rank holding {sts[0]['rows'][0]} of 352 rows: losses "
          f"{loss_err:.3e} relative off the world of 1's, leaves "
          f"{leaf_err:.3e} of their max where |g| > {P14_SIG} max|g| "
          f"({flipped} of {n_el} other elements off by more), the same on "
          f"every rank; serial BN statistics {stat_err:.3e}, its loss "
          f"{serial_err:.3e}; the rows kernel's partial variant on "
          f"{sts[0]['maps_shape']}: launches by rank "
          f"{[st['launches']['softargmax_rows_partial'] for st in sts]}, "
          f"merged {max(st['merge_err'] for st in sts):.3e} px off the "
          f"whole-map kernel, {max(st['plain_err'] for st in sts):.3e} (f32)"
          f" and {max(st['plain_err_bf16'] for st in sts):.3e} px (bf16) off "
          f"its plain version; step ms by rank "
          f"{[[round(x, 1) for x in st['step_ms']] for st in sts]} against "
          f"the world of 1's {[round(x, 1) for x in rep1['step_ms']]}; a "
          f"step's peak by rank "
          f"{[round(st['step_peak'] / 2**30, 3) for st in sts]} GiB against "
          f"the world of 1's {rep1['step_peak'] / 2**30:.3f} GiB, ratios "
          f"{[round(x, 3) for x in ratio]}")
    return {"launches": [st["launches"]["softargmax_rows_partial"]
                         for st in sts],
            "max_abs_err": max(max(st["merge_err"], st["plain_err"],
                                   st["plain_err_bf16"]) for st in sts)}


def p14_spatial_train_cli(torch, wrappers, flows, shape=P14_SPATIAL):
    """(f) on this rank: the train CLI's main() on a `shape` spatial mesh
    of the world, once for each of flows ({tag: its arguments}), every
    kernel's count set to 0 just before each and read just after (the
    job's counts then add them) -> {tag: {its stdout, launches, whether
    --fused captured, host s, peak device memory}}."""
    held = {k: w.launches for k, w in wrappers.items()}
    out = {}
    mesh_args = ["--mesh_shape", *map(str, shape), "--mesh_axes", "data",
                 "space"]
    for tag, args in flows.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (text, seen), launches = count_launches(
            wrappers, lambda: p14_train_cli(torch, args + mesh_args))
        torch.cuda.synchronize()
        out[tag] = {"text": text, "launches": launches,
                    "captured": seen.get("captured", False),
                    "capture_s": seen.get("capture_s", 0.0),
                    "s": time.perf_counter() - t0,
                    "peak": torch.cuda.max_memory_allocated()}
        for k in held:
            held[k] += launches[k]
    for k, w in wrappers.items():
        w.launches = held[k]
    return out


def delta_leaves(ckpt):
    """The delta a train CLI saved under ckpt (its *__original.npz)."""
    import glob

    (path,) = glob.glob(os.path.join(ckpt, "*__original.npz"))
    return p14_read(path)


def epoch_records(ckpt):
    """The metrics log a train CLI wrote under ckpt, one record an
    epoch."""
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# a train CLI's delta against the same run's without a mesh, on the
# elements whose |g| stays above P14_SIG of its leaf's max: within this
# many lr a step. Adam moves such an element by lr x m / sqrt(v), which a
# gradient off by d (of max |g|) turns by at most about lr x d / P14_SIG;
# the steps agree to d = 1e-5 (the CPU's bars), so 1e-2 lr a step. 14b's
# bar is in units of a leaf's max instead, which for a delta that starts
# at zero (lora_B) is a few lr after a few steps.
P14_SIG_LR = 1e-2


def hold_trained(label, ckpt, ckpt0, grads, lr):
    """A train CLI run's files under ckpt against the same run's under
    ckpt0 (without a mesh): bit-equal, or each epoch's val ADE/FDE within
    P14_VAL_RTOL and the saved delta's leaves by the P14_SIG rule, with
    the run without a mesh's gradients (grads, {path: [|g| a step]}):
    within P14_SIG_LR lr a step where every step's |g| is above P14_SIG
    of its max, within 2 lr a step elsewhere -> (which held, the largest
    val error, the largest error on the significant elements in lr a
    step)."""
    import numpy as np

    a, b = delta_leaves(ckpt), delta_leaves(ckpt0)
    check(a.keys() == b.keys() == grads.keys(),
          f"{label}: the deltas' leaves differ: {sorted(a)[:4]}")
    recs, recs0 = epoch_records(ckpt), epoch_records(ckpt0)
    check(len(recs) == len(recs0) > 0,
          f"{label}: {len(recs)} epochs logged, {len(recs0)} without a mesh")
    val_err = max(abs(r[k] - r0[k]) / abs(r0[k]) for r, r0 in zip(recs, recs0)
                  for k in ("val_ade", "val_fde"))
    if all(np.array_equal(a[k], b[k]) for k in b) and val_err == 0.0:
        return "bit-equal", 0.0, 0.0
    n_steps = len(next(iter(grads.values())))
    leaf_err, of_max, n_sig, n_el = 0.0, 0.0, 0, 0
    for k, gs in grads.items():
        sig = np.logical_and.reduce([g > P14_SIG * g.max() for g in gs])
        d = np.abs(a[k] - b[k])
        leaf_err = max(leaf_err, float(d[sig].max(initial=0.0))
                       / (lr * n_steps))
        of_max = max(of_max, float(d[sig].max(initial=0.0))
                     / max(float(np.abs(b[k]).max()), 1e-12))
        n_sig, n_el = n_sig + int(sig.sum()), n_el + d.size
        check(float(d.max()) <= 2 * lr * n_steps,
              f"{label}: {k} moved {float(d.max()):.3e}, over 2 lr a step")
    print(f"{label}: the delta's significant elements ({n_sig} of {n_el}) "
          f"{leaf_err:.3e} lr a step ({of_max:.3e} of their leaf's max) "
          f"off the run without a mesh over {n_steps} steps")
    check(val_err <= P14_VAL_RTOL and leaf_err <= P14_SIG_LR,
          f"{label}: val ADE/FDE {val_err:.3e} relative, leaves "
          f"{leaf_err:.3e} lr a step off the run without a mesh")
    return "the P14_SIG rule", val_err, leaf_err


def hold_spatial_train_cli(tmp, flows0, reps, card, label="14f",
                           key="spatial_train_cli"):
    """Phase 14f through the entry point: each flow of the train CLI on
    the spatial mesh (p14_spatial_train_cli, each rank's report[key];
    rank 0 wrote f2_<tag>) against the same flow without a mesh in this
    process (flows0, which wrote f0_<tag>; the gradients of the first
    that recorded them): hold_trained; the rows kernel's partial variant
    launched on each rank, the whole-map rows kernel only where TTST
    samples the test's goal maps; --fused eager on gloo."""
    lr = float(P14_CLI_LR)
    grads = next(f[1]["grads"] for f in flows0.values() if "grads" in f[1])
    for tag in flows0:
        how, val_err, leaf_err = hold_trained(
            f"{label} {tag}", os.path.join(tmp, f"f2_{tag}"),
            os.path.join(tmp, f"f0_{tag}"), grads, lr)
        for r, rep in enumerate(reps):
            cli = rep[key][tag]
            check(cli["launches"]["softargmax_rows_partial"] > 0
                  and cli["launches"]["fused_predict_partial"] > 0
                  and cli["launches"]["fused_predict"] == 0
                  and not cli["captured"],
                  f"{label} {tag}: rank {r} launched {cli['launches']}, "
                  f"captured {cli['captured']}")
        ran = [{k: v for k, v in rep[key][tag]["launches"].items() if v}
               for rep in reps]
        print(f"{label} {tag}: `python -m mst_tpu_torch.train --mesh_shape "
              f"{' '.join(map(str, P14_SPATIAL))} --mesh_axes data space"
              f"{' --fused' if tag == 'fused' else ''}` (main() on each "
              f"rank, {P14F_EPOCHS} epoch; {card}) against the same CLI "
              f"without a mesh: {how} (val ADE/FDE {val_err:.3e} relative, "
              f"the delta's significant leaves {leaf_err:.3e} lr a step); "
              f"launches by "
              f"rank {ran}; host s by rank "
              f"{[round(rep[key][tag]['s'], 1) for rep in reps]}"
              f", without a mesh {flows0[tag][2]:.1f}")


# ---- 14g: the segmentation backbone on H slabs of the spatial mesh
P14G_STEPS = 3          # segmentation_bn steps, the backbone in train mode
P14G_OUT_TOL = SEG_TOL  # (c): the gathered probabilities against the world
# of 1's (phase 9's bar for the card against the CPU), and each leaf's
# gradient summed over the ranks, of its max
# (b): the f32 steps' gradients of the backbone's batch-norm leaves move by
# up to ~12% of a leaf's max when the image moves by 2^-20 of itself (my
# chip run 2 of PR 20, train mode: at ResNet101 depth a change in the last
# bits flips ReLUs whose inputs lie that close to 0), and the slabs change
# the forward's last bits (cuDNN sums layer3's 11-row slabs otherwise,
# PR 17), so 14f's fixed leaf bar cannot hold the segmentation_bn steps:
# their first gradients, leaves and statistics are held within P14G_RATIO
# of the world of 1's own distance from its run on the nudged image
P14G_NUDGE = 2.0 ** -20
P14G_RATIO = 2.0


def saved_bytes(torch, fn, exclude):
    """fn() -> (its result, the bytes of the distinct storages that
    autograd saved for the backward in it, tensors of `exclude` (the
    parameters) not counted): the activations a train step holds."""
    skip = {t.untyped_storage().data_ptr() for t in exclude}
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in skip:
            seen[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def p14g_model(torch, train_net, backbone_fp):
    """sdd_shortterm_train.yaml's model (p14_model's draws) with the
    ResNet101 U-Net of backbone_fp (6 classes) -> (params, weights, state
    with the backbone's 'segmentation_bn' statistics, optimizer, named
    trainable leaves)."""
    from mst_tpu_torch import io
    from mst_tpu_torch.config import get_params, ynet_config
    from mst_tpu_torch.models import segmentation as seg_lib
    from mst_tpu_torch.models.unet import extract_bn_stats
    from mst_tpu_torch.models.ynet import init_ynet
    from mst_tpu_torch.train.trainer import setup_training

    params = get_params("sdd_shortterm_train.yaml", dict(
        train_net=train_net, lr=1e-3, use_TTST=True))
    weights, state = init_ynet(torch.Generator().manual_seed(0),
                               ynet_config(params), "cuda")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in io.flatten(weights).items():
            if v.is_floating_point() and not v.any():
                v.copy_(0.05 * torch.randn(v.shape, generator=gen))
    weights["segmentation"] = seg_lib.load_params(backbone_fp, "cuda")
    state = {**state, "segmentation_bn": extract_bn_stats(
        weights["segmentation"])}
    setup = setup_training(weights, params, steps_per_epoch=1)
    named = {k: v for k, v in io.flatten(weights).items() if v.requires_grad}
    return params, weights, state, setup["optimizer"], named


def p14_backbone(torch, wrappers, out_path, job, shape=None):
    """(g) on this rank of phase 14's world of 2, on a `shape` ('data',
    'space') mesh of it, or the world of 1 (shape None), the ResNet101
    U-Net of job['backbone'] in the step at full width, on the rank's
    slab of each image (job['images']: 'small', phase 6c's scene at 352 x
    480, 'big' the same scene at resize 1.0, 1408 x 1920):
    (a) 14b's K = 20 TTST pass with segment_in_step (the world of 1's
        draws), twice, the second timed, counted (every kernel's count set
        to 0 just before and read just after) and its peak read;
    (b) P14G_STEPS Adam steps of segmentation_bn with the backbone's
        batch norms in eval mode on their inline statistics (Adam's
        leaves, as in mst_tpu), then P14G_STEPS in train mode
        (segment_train_mode) on the state's, on phase 6b's rows,
        counted, the last one's peak;
    (c) the backbone alone in eval mode, forward and backward of the sum
        of its probabilities against a fixed target, on the big image:
        peak, the bytes autograd saved (saved_bytes), the output gathered
        and the head weight's gradient summed over the ranks.
    -> report; the arrays to out_path."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.models.unet import unet_apply
    from mst_tpu_torch.ops import sampling
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.train.steps import make_eval_step, make_train_step

    H, W, B = 352, 480, 8
    mesh = None if shape is None else mesh_lib.mesh_from_shape(
        list(shape), ["data", "space"], "cuda")
    images = p14_read(job["images"])
    slab = mesh_lib.space_slab(mesh, H)

    def cut(image, sl):
        t = torch.tensor(image, device="cuda")
        return t if sl is None else sl.take(t).contiguous()

    held = {k: w.launches for k, w in wrappers.items()}
    report, arrays = {}, {}

    # ---- (a) the TTST pass
    params, weights, state, _, _ = p14g_model(torch, "mosa_2",
                                              job["backbone"])
    batch = fine_tune_batch(torch, params, H, W, B)
    batch["semantic"] = cut(images["small"], slab)
    eval_step = make_eval_step(ynet_config(params), step_config(
        params, segment_in_step=True), mesh)
    scfg = step_config(params)
    for i in range(2):
        gen = torch.Generator("cuda").manual_seed(eval_seed_p14())
        source = gen if mesh is not None else sampling.Rows(gen, 0, B, B)
        torch.cuda.synchronize()
        if i:
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        feats, wps = eval_step.forward(weights, state, batch, source)
        out = eval_step.global_outputs(eval_step.decode_and_score(
            weights, feats, wps, batch["traj"], batch["mask"]))
        torch.cuda.synchronize()
        report["eval_ms"] = 1e3 * (time.perf_counter() - t0)
    report["eval_peak"] = torch.cuda.max_memory_allocated() - base
    report["eval_launches"] = {k: w.launches for k, w in wrappers.items()}
    report["chunks"] = wps.shape[0] // (scfg.eval_k_chunk or wps.shape[0])
    report["rows"] = int(batch["semantic"].shape[1])
    arrays.update({f"eval/{k}": v.cpu().numpy() for k, v in out.items()})
    arrays["eval/wps"] = wps.cpu().numpy()
    del params, weights, state, batch, eval_step, feats, wps, out
    release(torch)

    # ---- (b) segmentation_bn steps, the backbone's batch norms in eval
    # mode ('b'), then in train mode ('t'); the world of 1 also runs both
    # on the image scaled by 1 + P14G_NUDGE ('nb', 'nt'). In eval mode the
    # norms read their inline statistics, Adam's leaves (a fine-tune
    # before e_unfreeze, whose state has no 'segmentation_bn'), so the
    # steps move them
    def steps(tag, train_mode, scale=1.0):
        params, weights, state, opt, named = p14g_model(
            torch, "segmentation_bn", job["backbone"])
        if not train_mode:
            del state["segmentation_bn"]
        batch = fine_tune_batch(torch, params, H, W, B)
        batch["semantic"] = cut(images["small"] * np.float32(scale), slab)
        step = make_train_step(ynet_config(params), step_config(
            params, segment_in_step=True, segment_train_mode=train_mode),
            mesh)
        for w in wrappers.values():
            w.launches = 0
        rep = {"losses": [], "step_ms": []}
        for i in range(P14G_STEPS):
            torch.cuda.synchronize()
            if i == P14G_STEPS - 1:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state, m = step(weights, state, opt, batch)
            torch.cuda.synchronize()
            rep["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rep["losses"].append(float(m["loss"]))
            arrays.update({f"{tag}/grad{i}/{k}": (
                v.grad if v.grad is not None else torch.zeros_like(v))
                .cpu().numpy() for k, v in named.items()})
        rep["peak"] = torch.cuda.max_memory_allocated() - base
        rep["launches"] = {k: w.launches for k, w in wrappers.items()}
        rep["n"] = float(m["n"])
        arrays.update({f"{tag}/leaf/{k}": v.detach().cpu().numpy()
                       for k, v in named.items()})
        arrays.update({f"{tag}/state/{k}": v.cpu().numpy() for k, v in
                       io.flatten(state.get("segmentation_bn", {})).items()})
        del params, weights, state, opt, named, batch, step, m
        release(torch)
        return rep

    report["b"] = steps("b", False)
    report["t"] = steps("t", True)
    if mesh is None:
        steps("nb", False, 1.0 + P14G_NUDGE)
        steps("nt", True, 1.0 + P14G_NUDGE)

    # ---- (c) the backbone alone on the big image
    _, weights, _, _, _ = p14g_model(torch, "segmentation_head",
                                     job["backbone"])
    bb = weights.pop("segmentation")
    del weights
    leaves = {k: v.requires_grad_() for k, v in io.flatten(bb).items()
              if v.is_floating_point() and not k.endswith(
                  ("running_mean", "running_var"))}
    big = slab if mesh is None else mesh_lib.space_slab(
        mesh, images["big"].shape[1])
    image = cut(images["big"], big)
    target = cut(np.random.default_rng(5).uniform(
        size=images["big"].shape[:3] + (6,)).astype(np.float32), big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    probs, nbytes = saved_bytes(torch, lambda: unet_apply(
        bb, image, slab=big), list(io.flatten(bb).values()))
    (probs * target).sum().backward()
    torch.cuda.synchronize()
    report["big_ms"] = 1e3 * (time.perf_counter() - t0)
    report["big_peak"] = torch.cuda.max_memory_allocated() - base
    report["big_saved"] = nbytes
    grads = [v.grad for v in leaves.values()]
    if mesh is not None:
        mesh_lib.sum_(grads)
        probs = big.gather(probs.detach())
    arrays["big/probs"] = probs.detach().cpu().numpy()
    arrays.update({f"big/grad/{k}": g.cpu().numpy()
                   for k, g in zip(leaves, grads)})
    report["big_rows"] = int(image.shape[1])
    for k, w in wrappers.items():  # (c) launches no kernel
        w.launches = held[k] + report["eval_launches"][k] + \
            report["b"]["launches"][k] + report["t"]["launches"][k]
    np.savez(out_path, **arrays)
    return report


def leaves_off(one, outs, tag, n_steps):
    """14b's leaf rule on the '<tag>/leaf/' arrays of each rank (outs)
    against the world of 1's (one): -> (the largest distance, of its
    leaf's max, where every step's |g| is above P14_SIG of its max; the
    other elements off by more than P14_LEAF_TOL; their count); the
    ranks' leaves must be the same."""
    import numpy as np

    err, flipped, n_el = 0.0, 0, 0
    for k in (k for k in one if k.startswith(f"{tag}/leaf/")):
        name = k[len(f"{tag}/leaf/"):]
        sig = np.ones(one[k].shape, bool)
        for i in range(n_steps):
            g = np.abs(one[f"{tag}/grad{i}/{name}"])
            sig &= g > P14_SIG * g.max()
        for o in outs:
            check(np.array_equal(o[k], outs[0][k]),
                  f"the ranks' {tag} {name} differ")
        d = np.abs(outs[0][k] - one[k]) / max(np.abs(one[k]).max(), 1e-12)
        err = max(err, float(d[sig].max(initial=0.0)))
        flipped += int((d[~sig] > P14_LEAF_TOL).sum())
        n_el += d.size
    return err, flipped, n_el


def of_max_over(a, b, prefix):
    """The largest |a - b| of b's max over the arrays named prefix*."""
    import numpy as np

    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               / max(float(np.abs(b[k]).max()), 1e-12)
               for k in b if k.startswith(prefix))


def hold_backbone(tmp, one, rep1, reps, card, shape=P14_SPATIAL,
                  label="14g"):
    """Phase 14g's checks of each rank's p14_backbone (its report's
    'backbone' and backbone_rank<r>.npz in tmp) against the world of 1's
    (one, rep1): (a) 14e's: the waypoint samples bit-equal, or within
    P14_PX_TOL model px on every row but those whose samples moved at a
    CDF boundary (at most P14_MOVED_SHARE of the valid rows, 14b's rule),
    ADE/FDE within P14_VAL_RTOL and best_traj within P14_MERGE_TOL on the
    others, the partial fused kernel one launch a decode chunk, the
    whole-map fused kernel none, the rows kernel (TTST's goal point)
    some, each rank's peak under P14_MEM_RATIO of the world of 1's; (b)
    14f's: the losses within P14_LOSS_RTOL, the rows kernel's partial
    variant twice a step and nothing else, the ranks' leaves the same;
    with the backbone's batch norms in eval mode no state, every running
    statistic a leaf with a gradient, and the first step's gradients
    within P14_LEAF_TOL of each one's max (14f's leaf bar); in both modes
    the first step's gradients, the leaves (the running statistics among
    them in eval mode; in train mode the state's statistics too) within
    P14G_RATIO of the world of 1's distance
    from its own run on the nudged image (the comment at P14G_NUDGE;
    14f's leaf rule is printed beside); (c) the probabilities within P14G_OUT_TOL,
    every leaf's gradient within P14G_OUT_TOL of its max, each rank's
    peak under the world of 1's. Prints them, with each rank's peaks and
    ms against the world of 1's -> {kernel: [launches of (a) and (b) by
    rank]}."""
    import numpy as np

    from mst_tpu_torch.config import get_params

    rf = get_params("sdd_shortterm_train.yaml")["resize_factor"]
    outs = [p14_read(os.path.join(tmp, f"backbone_rank{r}.npz"))
            for r in range(len(reps))]
    bbs = [rep["backbone"] for rep in reps]
    valid = one["eval/mask"] > 0
    # (a)
    equal = all(np.array_equal(o["eval/wps"], one["eval/wps"]) for o in outs)
    moved = valid & np.logical_or.reduce([np.abs(
        o["eval/wps"] - one["eval/wps"]).max(axis=(0, 2, 3)) > P14_PX_TOL
        for o in outs])
    kept = valid & ~moved
    val_err = max(float(np.max(np.abs(o[f"eval/{k}"][kept]
                                      - one[f"eval/{k}"][kept])
                               / one[f"eval/{k}"][kept], initial=0.0))
                  for o in outs for k in ("ade", "fde"))
    px = max(float(np.abs(o["eval/best_traj"] - one["eval/best_traj"])
                   .max(axis=(1, 2))[kept].max(initial=0.0)) * rf
             for o in outs)
    check(moved.sum() <= P14_MOVED_SHARE * valid.sum()
          and val_err <= P14_VAL_RTOL and px <= P14_MERGE_TOL,
          f"{label} (a): {int(moved.sum())} of {int(valid.sum())} rows' "
          f"samples moved; the others' ADE/FDE {val_err:.3e} relative, "
          f"best_traj {px:.3e} model px off the world of 1's")
    for r, bb in enumerate(bbs):
        la = bb["eval_launches"]
        check(la["fused_predict_partial"] == bb["chunks"] > 0
              and la["fused_predict"] == 0 and la["softargmax_rows"] > 0
              and la["kmeans"] > 0,
              f"{label} (a): rank {r}'s launches {la}, {bb['chunks']} "
              "decode chunk(s)")
        check(bb["rows"] == 352 // shape[1],
              f"{label}: rank {r}'s image slab holds {bb['rows']} rows")
    eval_ratio = [bb["eval_peak"] / rep1["eval_peak"] for bb in bbs]
    check(max(eval_ratio) < P14_MEM_RATIO,
          f"{label} (a): a rank's pass peak is {max(eval_ratio):.3f} of "
          f"the world of 1's (bar {P14_MEM_RATIO})")
    # (b)
    for tag in ("b", "t"):
        for r, bb in enumerate(bbs):
            want = dict.fromkeys(bb[tag]["launches"], 0)
            want["softargmax_rows_partial"] = 2 * P14G_STEPS
            check(bb[tag]["launches"] == want,
                  f"{label} (b): rank {r}'s {tag} steps launched "
                  f"{ {k: v for k, v in bb[tag]['launches'].items() if v} }")
    loss_err = {tag: max(abs(a - b) / abs(b) for bb in bbs for a, b in zip(
        bb[tag]["losses"], rep1[tag]["losses"])) for tag in ("b", "t")}
    check(max(loss_err.values()) <= P14_LOSS_RTOL and all(
        bb[tag]["n"] == rep1[tag]["n"] for bb in bbs for tag in ("b", "t")),
          f"{label} (b): losses {loss_err} off the world of 1's")
    # the encoder's 100 norms (bn1, and bn1-bn3 of each of 33 blocks)
    stats = [k for k in one if k.startswith("b/grad0/")
             and k.endswith(("/running_mean", "/running_var"))]
    check(not any(k.startswith("b/state/") for o in outs + [one]
                  for k in o) and len(stats) == 2 * 100 and all(
                      np.any(o[k]) for o in outs + [one] for k in stats),
          f"{label} (b): the eval-mode steps' running statistics are "
          f"{len(stats)} leaves, a state or a zero gradient")
    grad0 = max(of_max_over(o, one, "b/grad0/") for o in outs)
    check(grad0 <= P14_LEAF_TOL,
          f"{label} (b): the eval-mode steps' first gradients {grad0:.3e} "
          "of their max off the world of 1's")
    leaf14f, moved_t, nudged = {}, {}, {}
    for tag in ("b", "t"):
        leaf14f[tag] = leaves_off(one, outs, tag, P14G_STEPS)  # same ranks
        run_n = {f"{tag}/" + k[len(tag) + 2:]: v for k, v in one.items()
                 if k.startswith(f"n{tag}/")}
        parts = ("grad0/", "leaf/") + (("state/",) if tag == "t" else ())
        nudged[tag] = {w: of_max_over(run_n, one, f"{tag}/{w}")
                       for w in parts}
        moved_t[tag] = {w: max(of_max_over(o, one, f"{tag}/{w}")
                               for o in outs) for w in parts}
        check(all(moved_t[tag][w] <= P14G_RATIO * nudged[tag][w]
                  for w in parts),
              f"{label} (b) {tag}: off the world of 1 by {moved_t[tag]} of "
              f"each max, its own run on the nudged image by {nudged[tag]}")
    # (c)
    prob_err = max(float(np.abs(o["big/probs"] - one["big/probs"]).max())
                   for o in outs)
    grad_err = max(of_max_over(o, one, "big/grad/") for o in outs)
    big_ratio = [bb["big_peak"] / rep1["big_peak"] for bb in bbs]
    check(prob_err <= P14G_OUT_TOL and grad_err <= P14G_OUT_TOL
          and max(big_ratio) < 1.0,
          f"{label} (c): probabilities {prob_err:.3e}, gradients "
          f"{grad_err:.3e} of their max off the world of 1's; peaks "
          f"{big_ratio} of its")
    gib = 2 ** 30
    how = ("two ranks share the card over gloo: no scaling figure"
           if reps[0]["backend"] == "gloo" else "NCCL, a card a rank")
    print(f"{label}: the ResNet101 U-Net in the step on a {shape[0]} x "
          f"{shape[1]} ('data', 'space') mesh ({card}; {how}), each rank "
          f"{bbs[0]['rows']} "
          f"of 352 rows. (a) K = 20 TTST with segment_in_step: waypoint "
          f"samples {'bit-equal to' if equal else 'off'} the world of 1's"
          f"{'' if equal else f' ({int(moved.sum())} rows moved)'}, "
          f"ADE/FDE {val_err:.3e} relative, best_traj {px:.3e} model px; "
          f"launches by rank "
          f"{[{k: v for k, v in bb['eval_launches'].items() if v} for bb in bbs]}"
          f"; pass ms by rank {[round(bb['eval_ms'], 1) for bb in bbs]} "
          f"against {rep1['eval_ms']:.1f}; peak by rank "
          f"{[round(bb['eval_peak'] / gib, 3) for bb in bbs]} GiB against "
          f"{rep1['eval_peak'] / gib:.3f}, ratios "
          f"{[round(x, 3) for x in eval_ratio]}")
    for tag, mode in (("b", "eval"), ("t", "train")):
        ratio = [bb[tag]["peak"] / rep1[tag]["peak"] for bb in bbs]
        print(f"{label} (b): {P14G_STEPS} segmentation_bn steps, the "
              f"backbone's batch norms in {mode} mode: losses "
              f"{loss_err[tag]:.3e} relative off the world of 1's; "
              + f"the first gradients, the leaves (and statistics) "
              f"{moved_t[tag]} of each max off, the world of 1's own run "
              f"on the image x (1 + 2^-20) {nudged[tag]}; 14f's leaf rule: "
              f"{leaf14f[tag][0]:.3e} of their max where |g| > {P14_SIG} "
              f"max|g| ({leaf14f[tag][1]} of {leaf14f[tag][2]} other "
              "elements off by more)"
              + f"; rows partial launches by rank "
              f"{[bb[tag]['launches']['softargmax_rows_partial'] for bb in bbs]}"
              f"; step ms by rank "
              f"{[[round(x, 1) for x in bb[tag]['step_ms']] for bb in bbs]} "
              f"against {[round(x, 1) for x in rep1[tag]['step_ms']]}; a "
              f"step's peak by rank "
              f"{[round(bb[tag]['peak'] / gib, 3) for bb in bbs]} GiB "
              f"against {rep1[tag]['peak'] / gib:.3f}, ratios "
              f"{[round(x, 3) for x in ratio]}")
    print(f"{label} (c): the backbone alone, forward and backward (every "
          f"leaf), on a 1408 x 1920 image (each rank "
          f"{bbs[0]['big_rows']} rows): probabilities {prob_err:.3e}, "
          f"gradients {grad_err:.3e} of their max off the world of 1's; "
          f"peak by rank {[round(bb['big_peak'] / gib, 3) for bb in bbs]} "
          f"GiB against {rep1['big_peak'] / gib:.3f}, ratios "
          f"{[round(x, 3) for x in big_ratio]}; the activations autograd "
          f"saved, reckoned from its hooks: "
          f"{[round(bb['big_saved'] / gib, 3) for bb in bbs]} GiB a rank, "
          f"{rep1['big_saved'] / gib:.3f} whole; ms by rank "
          f"{[round(bb['big_ms'], 1) for bb in bbs]} against "
          f"{rep1['big_ms']:.1f}")
    return {k: [bb["eval_launches"][k] + bb["b"]["launches"][k]
                + bb["t"]["launches"][k] for bb in bbs]
            for k in bbs[0]["eval_launches"]}


def write_backbone_world(torch, tmp, images, train, val, test):
    """14g's files: phase 6c's scenes preprocessed at 352 x 480 and at
    resize 1.0 (p14g_images.npz), the full ResNet101 U-Net (6 classes, its
    batch norms moved and calibrated on the other scene: moved_backbone)
    at <tmp>/segworld/data/sdd/sdd_segmentation.npz, and write_grid_world's
    files under segworld with its yaml at the backbone's 6 classes ->
    (the images' npz, the backbone's npz, the yaml)."""
    import numpy as np
    import yaml

    from mst_tpu_torch.data import images as images_lib

    small = images_lib.preprocess_scene_images(images, 0.25, 32)
    big = images_lib.preprocess_scene_images(
        {"synth_0": images["synth_0"]}, 1.0, 32)
    images_fp = os.path.join(tmp, "p14g_images.npz")
    np.savez(images_fp, small=small["synth_0"][None],
             big=big["synth_0"][None])
    root = os.path.join(tmp, "segworld")
    cfg = write_grid_world(root, images, train, val, test)
    with open(cfg) as f:
        params = yaml.safe_load(f)
    params["n_semantic_classes"] = 6
    cfg = os.path.join(root, "seg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(params, f)
    backbone_fp = os.path.join(root, "data", "sdd", "sdd_segmentation.npz")
    np.savez(backbone_fp, **moved_backbone(
        torch, (3, 4, 23, 3), 0, calibrate=small["synth_1"][None]))
    return images_fp, backbone_fp, cfg


def p14_read(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def mesh_path(torch, wrappers, card):
    """Phase 14: data parallelism over a mesh on phase 6c's scenes at
    sdd_shortterm_train.yaml's width, cuDNN deterministic -> {kernel:
    [launches on each rank of the world of 2]}.

    (a) a world of 1 on NCCL: the train CLI with --mesh_shape 1, and with
        --fused --mesh_shape 1 (its graph captures the NCCL all-reduces),
        each bit-equal to the same flow without a mesh in this process;
    (b) a world of 2 sharing the card (gloo on CUDA tensors): 3 mosa_2
        steps, a serial-adapter step and a K = 20 TTST validation pass on
        phase 6b's batch (B = 8, the last two rows padding), against this
        process's world of 1; both kernels launch on each rank; the
        serial step's cost of the port's batch norm (serial_bn_cost);
    (c) torch.distributed.checkpoint: saved by the world of 2, restored
        here;
    (d) the grid, 2 seeds x 1 lr, 1 epoch, one run a rank, against the
        same grid in this process;
    (e) the spatial eval in the same world of 2, on a (1, 2) ('data',
        'space') mesh: 14b's TTST pass with each rank holding half of
        every map's rows (p14_spatial), against the world of 1's
        (hold_spatial); then the test CLI's main() on that mesh over (a)'s
        fine-tuned model with TTST on (p14_spatial_cli), against the same
        CLI without a mesh here (hold_spatial_cli);
    (f) training on that mesh: 14b's steps (p14_spatial_steps) against
        the world of 1's (hold_spatial_steps), then the train CLI's main()
        on it, 1 epoch, plain and --fused (eager on gloo), against the
        same CLI without a mesh here (hold_spatial_train_cli). (a) also
        runs the spatial mesh (1, 1) with and without --fused in its
        world of 1, whose graph captures the halo collectives.
    (g) the ResNet101 U-Net in the step on that mesh, each rank running
        it on its slab of the image (p14_backbone against this process's
        world of 1, hold_backbone): a K = 20 TTST pass with
        segment_in_step, 3 segmentation_bn steps with the backbone in
        train mode, the backbone alone forward and backward on a 1408 x
        1920 image, each with its peak memory against the world of 1's;
        then the train CLI's main() with --train_net segmentation_head on
        it, 1 epoch (the backbone in the train steps, validation on the
        cached whole-scene maps), against the same CLI without a mesh here
        (hold_spatial_train_cli).
    -> ({kernel: [launches on each rank]}, the partial variants' record:
    the fused kernel's launches on each rank in (e)'s test CLI, and its
    errors; the rows kernel's launches on each rank in (f)'s steps, and
    its errors; (g)'s launches of (a) and (b) by rank, 'p14g')."""
    import glob

    import numpy as np
    import yaml

    from mst_tpu_torch import grid, io
    from mst_tpu_torch.config import get_params
    from mst_tpu_torch.data import splits
    from mst_tpu_torch.train import sharded_ckpt
    from mst_tpu_torch.train.trainer import Experiment

    images, train, val, test = loop_data()
    train_ft = splits.limit_samples(train, 2, LOOP_B)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp()
    t_phase = time.perf_counter()
    try:
        cfg = write_grid_world(os.path.join(tmp, "world"), images, train_ft,
                               val, test)
        base = os.path.join(tmp, "base.npz")
        Experiment(get_params(cfg, {"seed": 0}),
                   device="cuda").save_params(base)
        grid_args = ["--config_filename", cfg, "--batch_size", str(LOOP_B),
                     "--dataset_path", "synth", "--load_data", "predefined",
                     "--fine_tune", "--train_net", "mosa_2", "--position",
                     *POSITIONS, "--pretrained_ckpt", base, "--n_epoch", "1",
                     "--n_train_batch", "2", "--smooth_val", "--window_size",
                     "1", "--seeds", "1", "2", "--lrs", "3e-3", "--device",
                     "cuda"]

        # ---- (b) the world of 1 in this process
        for w in wrappers.values():
            w.launches = 0
        rep1, _, _ = p14_steps(torch, None, os.path.join(tmp, "w1.npz"),
                               n_evals=2)
        one = p14_read(os.path.join(tmp, "w1.npz"))
        p14_1 = {k: w.launches for k, w in wrappers.items()}

        # ---- (a) the CLI flows without a mesh here, then with
        # --mesh_shape 1 in a world of 1 on NCCL
        flows0 = {tag: p14_train_cli(torch, p14_cli_args(
            cfg, base, os.path.join(tmp, f"a0_{tag}"), flags),
            record_grads=tag == "loop")
            for tag, flags in A0_FLOWS.items()}
        release(torch)
        wait1 = start_ranks(1, {"kind": "cli", "cfg": cfg, "base": base,
                                "tmp": tmp}, 600)
        (cli,) = wait1()
        check(cli["backend"] == "nccl",
              f"14a: backend {cli['backend']}")
        for tag in ("loop", "fused"):
            d0, d1 = (os.path.join(tmp, f"{w}_{tag}") for w in ("a0", "a1"))
            names = sorted(os.listdir(d0))
            check(names == sorted(os.listdir(d1)),
                  f"14a {tag}: the files differ: {names}")
            for name in names:
                if name.endswith(".npz"):
                    a, b = p14_read(os.path.join(d1, name)), p14_read(
                        os.path.join(d0, name))
                    check(a.keys() == b.keys() and all(
                        np.array_equal(a[k], b[k]) for k in b),
                          f"14a {tag}: {name} differs")
            logs = [[{k: v for k, v in json.loads(ln).items()
                      if k != "time" and "second" not in k
                      and "per_sec" not in k}
                     for ln in open(os.path.join(d, "metrics.jsonl"))]
                    for d in (d0, d1)]
            check(logs[0] == logs[1] and len(logs[0]) == P14_EPOCHS,
                  f"14a {tag}: the metrics logs differ: {logs}")
            epochs = [[ln for ln in text.splitlines()
                       if ln.startswith(("Epoch ", "Test ADE", "Test FDE"))]
                      for text in (flows0[tag][0], cli[tag]["text"])]
            check(epochs[0] == epochs[1] and epochs[0],
                  f"14a {tag}: the printed results differ: {epochs}")
        check(cli["fused"]["captured"] and flows0["fused"][1]["captured"]
              and cli["spatial_fused"]["captured"],
              "14a: --fused did not capture a graph")
        print(f"14a: a world of 1 on NCCL (--mesh_shape 1): the train CLI "
              f"and --fused equal the runs without a mesh bit for bit "
              f"(weights, validation, metrics log, printed results); the "
              f"captured epoch's launches a replay "
              f"{cli['fused']['per_replay']}, without a mesh "
              f"{flows0['fused'][1]['per_replay']}; the world's launches "
              f"{ {k: v for k, v in cli['launches'].items() if v} }")
        # the spatial (1, 1) mesh: the graph captures the halo exchanges'
        # all_reduces, forward and backward
        for tag in ("spatial", "spatial_fused"):
            how, val_err, leaf_err = hold_trained(
                f"14a {tag}", os.path.join(tmp, f"a1_{tag}"),
                os.path.join(tmp, f"a0_{A1_BASE[tag]}"),
                flows0["loop"][1]["grads"], float(P14_CLI_LR))
            print(f"14a {tag}: `{' '.join(A1_FLOWS[tag])}` in the world of "
                  f"1 on NCCL against the same flow without a mesh: {how} "
                  f"(val ADE/FDE {val_err:.3e} relative, the delta's "
                  f"significant leaves {leaf_err:.3e} lr a step); captured "
                  f"{cli[tag]['captured']}, a replay's launches "
                  f"{cli[tag]['per_replay']}")
        check(cli["spatial_fused"]["per_replay"].get(
            "softargmax2d_rows_partial.launches", 0) > 0,
              "14a: the spatial --fused replay holds no rows partial launch")

        # ---- (e) the test CLI without a mesh, on the fine-tuned model of
        # (a) with TTST on, to hold the spatial mesh's run against
        with open(cfg) as f:
            test_cfg = yaml.safe_load(f)
        test_cfg["use_TTST"] = True
        with open(os.path.join(tmp, "spatial.yaml"), "w") as f:
            yaml.safe_dump(test_cfg, f)
        (delta,) = glob.glob(os.path.join(tmp, "a0_loop",
                                          "*__original.npz"))
        test_args = ["--config_filename", os.path.join(tmp, "spatial.yaml"),
                     "--batch_size", str(LOOP_B), "--dataset_path", "synth",
                     "--load_data", "predefined", "--train_net", "mosa_2",
                     "--position", *POSITIONS, "--pretrained_ckpt", base,
                     "--tuned_ckpt", delta, "--n_round", "1", "--device",
                     "cuda"]
        test1, test1_s, test1_launches, _ = run_main(
            "14e world of 1", "mst_tpu_torch.test", test_args, tmp,
            wrappers)

        # ---- (f) the train CLI without a mesh, 1 epoch, to hold the
        # spatial mesh's runs against (the loop's gradients recorded)
        train_flows = {tag: p14_cli_args(
            cfg, base, os.path.join(tmp, f"f2_{tag}"),
            ["--n_epoch", str(P14F_EPOCHS)] + flags)
            for tag, flags in A0_FLOWS.items()}
        flows_f0 = {}
        for tag, flags in A0_FLOWS.items():
            t0 = time.perf_counter()
            text, seen = p14_train_cli(torch, p14_cli_args(
                cfg, base, os.path.join(tmp, f"f0_{tag}"),
                ["--n_epoch", str(P14F_EPOCHS)] + flags),
                record_grads=tag == "loop")
            flows_f0[tag] = (text, seen, time.perf_counter() - t0)

        # ---- (g) the backbone in the step: the world of 1 here, and the
        # train CLI of segmentation_head without a mesh (its gradients
        # recorded), to hold the spatial mesh's against
        release(torch)
        t_g = time.perf_counter()
        images_fp, backbone_fp, seg_cfg = write_backbone_world(
            torch, tmp, images, train_ft, val, test)
        seg_base = os.path.join(tmp, "seg_base.npz")
        Experiment(get_params(seg_cfg, {"seed": 0}),
                   device="cuda").save_params(seg_base)
        bb_job = {"images": images_fp, "backbone": backbone_fp}
        rep_g1 = p14_backbone(torch, wrappers, os.path.join(
            tmp, "backbone_w1.npz"), bb_job)
        one_g = p14_read(os.path.join(tmp, "backbone_w1.npz"))
        release(torch)

        def seg_args(ckpt):
            return [("segmentation_head" if a == "mosa_2" else a)
                    for a in p14_cli_args(seg_cfg, seg_base, ckpt, [
                        "--n_epoch", str(P14F_EPOCHS)])]

        t0 = time.perf_counter()
        text, seen = p14_train_cli(torch, seg_args(os.path.join(
            tmp, "f0_seg")), record_grads=True)
        flows_g0 = {"seg": (text, seen, time.perf_counter() - t0)}
        bb_job["train"] = {"seg": seg_args(os.path.join(tmp, "f2_seg"))}
        print(f"14g: the world of 1's part in {time.perf_counter() - t_g:.1f}"
              " s")

        # ---- (b) the world of 2 on the one card, (c) its checkpoint and
        # (d) its grid; the world of 1's grid here meanwhile would share the
        # card, so it runs after
        release(torch)
        wait2 = start_ranks(2, {"kind": "mesh", "tmp": tmp, "test": test_args,
                                "train": train_flows, "backbone": bb_job,
                                "grid": grid_args + [
                                    "--ckpt_path", os.path.join(tmp, "g2"),
                                    "--log_dir", os.path.join(tmp, "g2l")]},
                            900)
        reps = wait2()
        hold_world(tmp, one, rep1, reps, "gloo", "14b")
        print(f"14b ms ({card}): a mosa_2 step, world of 1 "
              f"{[round(x, 1) for x in rep1['step_ms']]}, world of 2 by rank "
              f"{[[round(x, 1) for x in r['step_ms']] for r in reps]}; the "
              f"TTST pass, world of 1 {rep1['val_ms']:.1f}, world of 2 "
              f"{[round(r['val_ms'], 1) for r in reps]} (the two ranks share "
              f"one card and talk through the host: no scaling figure)")
        serial_bn_cost(torch, card)
        spatial = hold_spatial(tmp, one, rep1, reps, card)
        spatial["launches"] = hold_spatial_cli(test1, test1_launches,
                                               test1_s, reps, card)
        steps_f = hold_spatial_steps(tmp, one, rep1, reps, card)
        spatial["train_launches"] = steps_f["launches"]
        spatial["train_max_abs_err"] = steps_f["max_abs_err"]
        hold_spatial_train_cli(tmp, flows_f0, reps, card)
        spatial["p14g"] = hold_backbone(tmp, one_g, rep_g1, reps, card)
        hold_spatial_train_cli(tmp, flows_g0, reps, card,
                               "14g (d) segmentation_head", "backbone_cli")

        # ---- (c) the world of 2's checkpoint restored in a world of 1
        saved = p14_read(os.path.join(tmp, "dcp_saved.npz"))
        template = io.unflatten({k: torch.zeros(v.shape, dtype=getattr(
            torch, str(v.dtype)), device="cuda")
            for k, v in saved.items()})
        sharded_ckpt.restore_sharded(os.path.join(tmp, "dcp"), template)
        restored = {k: v.cpu().numpy()
                    for k, v in io.flatten(template).items()}
        check(restored.keys() == saved.keys() and all(
            np.array_equal(restored[k], saved[k]) for k in saved),
              "14c: the restored checkpoint differs from the saved one")
        print(f"14c: torch.distributed.checkpoint saved by the world of 2 "
              f"({len(saved)} leaves) restored in a world of 1 bit for bit")

        # ---- (d) the grid: each rank's run against the world of 1's
        buf = io_text.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            want = grid.run_grid(grid.get_parser().parse_args(grid_args + [
                "--ckpt_path", os.path.join(tmp, "g1")]))
        grid1_s = time.perf_counter() - t0
        got = reps[0]["grid"]
        check([s["name"] for s in got] == [s["name"] for s in want]
              and reps[1]["grid"] == got, "14d: the grids' runs differ")
        worst = 0.0
        for s, w in zip(got, want):
            a = p14_read(os.path.join(tmp, "g2", s["name"] + ".npz"))
            b = p14_read(os.path.join(tmp, "g1", w["name"] + ".npz"))
            werr = max(float(np.abs(a[k] - b[k]).max()) for k in b) / w["lr"]
            verr = max(abs(x - y) / abs(y) for x, y in zip(
                s["val_ADE"] + s["val_FDE"], w["val_ADE"] + w["val_FDE"]))
            worst = max(worst, werr, verr)
            check(s["best_epoch"] == w["best_epoch"]
                  and werr <= GRID_STEP_TOL and verr <= GRID_VAL_RTOL,
                  f"14d: run {s['name']}: weights {werr:.3e} lr, val "
                  f"{verr:.3e}")
        print(f"14d: the grid over the world of 2 (one run a rank, "
              f"{[round(r['grid_s'], 2) for r in reps]} s) against the same "
              f"grid in a world of 1 ({grid1_s:.2f} s): each run within "
              f"{worst:.2e} (weights in lr, val relative); {card}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    per_rank = {k: [r["launches"][k] for r in reps] for k in wrappers}
    print(f"phase 14 launches: world of 2 by rank {per_rank}; this "
          f"process's world of 1 {p14_1}; {time.perf_counter() - t_phase:.1f}"
          f" s")
    return per_rank, spatial


# ---------------------------------------------------------------------------
# phase 15: the eval payload, the evaluator tools and the experiment suites
# ---------------------------------------------------------------------------

P15_MAP_TOL = 1e-4  # goal maps and activations, card against CPU, of max
P15_SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
                 decoder_channels=[16, 16, 16, 8, 8])
P15_SUITES = ("scripts/sdd/ped_to_biker/generalize.sh",
              "scripts/sdd/ped_to_biker/tune_mosa.sh")
# appended to the harness's guard/sitecustomize.py: every suite process
# prints its kernel launches as it ends
P15_COUNT_HOOK = r'''

def _print_launches():
    if "mst_tpu_torch.ops.kernels.fused_predict" not in sys.modules:
        return
    import json
    from mst_tpu_torch.probes import kernel_wrappers
    print("KERNEL_LAUNCHES " + json.dumps(
        {k: fn.launches for k, fn in kernel_wrappers().items()}),
        flush=True)


import atexit

atexit.register(_print_launches)
'''


def p15_params(flags=None, **over):
    """sdd_shortterm_eval.yaml with TTST on and mosa_2 on 0-4, the
    identity backbone's 3 classes, B = 8, one round."""
    from mst_tpu_torch.config import get_params

    return get_params("sdd_shortterm_eval.yaml", {
        "use_TTST": True, "train_net": "mosa_2", "position": POSITIONS,
        "n_semantic_classes": 3, "batch_size": LOOP_B, "n_round": 1,
        "seed": 1, "segmentation_model_fp": None, **(flags or {}), **over})


def p15_checkpoints(torch, params, images, tmp, tag):
    """A base checkpoint (random weights, seed 1) and a mosa_2 delta over
    it (lora_B ~ N(0, 0.05) from seed 3) -> (base path, delta path)."""
    from mst_tpu_torch import io
    from mst_tpu_torch.train.trainer import Experiment

    base = Experiment(dict(params, train_net="train", position=[]),
                      images=images, device="cpu")
    base_path = os.path.join(tmp, f"{tag}_base.npz")
    base.save_params(base_path)
    ft = Experiment(params, images=images, device="cpu")
    ft.load_params(base_path)
    g = torch.Generator().manual_seed(3)
    flat = io.flatten(ft.model_params)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    delta_path = os.path.join(tmp, f"{tag}_delta.npz")
    ft.save_params(delta_path)
    return base_path, delta_path


def p15_small_reference(torch, tmp):
    """15a/15c at small width, card against CPU, on the same weights: the
    payload's goal maps of test(return_samples=True) and every map
    capture_activations returns -> (max map error, max activation error),
    each over its map's max |value|."""
    import numpy as np

    from mst_tpu_torch.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch.evaluator.activations import capture_activations
    from mst_tpu_torch.train.trainer import restore_model

    params = p15_params(P15_SMALL)
    tracks, images = make_synthetic_dataset(seed=2, n_scenes=2, n_traj=6,
                                            img_hw=(128, 192))
    base, delta = p15_checkpoints(torch, params, images, tmp, "small")
    exps = {dev: restore_model(dict(params, device=dev), True, base, delta,
                               images=images) for dev in ("cuda", "cpu")}
    out = {dev: e.test(tracks, None, return_samples=True)[3][0]
           for dev, e in exps.items()}
    map_err = 0.0
    for key in ("goal_map", "goal_sigmoid_map"):
        got = np.concatenate(out["cuda"][key])
        want = np.concatenate(out["cpu"][key])
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"payload {key}: shape or non-finite")
        map_err = max(map_err, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
    for key in ("metaId", "groundtruth"):
        check(np.array_equal(np.concatenate(out["cuda"][key]),
                             np.concatenate(out["cpu"][key])),
              f"payload {key}: rows differ between card and CPU")
    one = tracks.take(tracks.sceneId == tracks.sceneId[0])
    acts = {dev: capture_activations(e, one, None)
            for dev, e in exps.items()}
    act_err = 0.0
    for k, want in acts["cpu"].items():
        got = acts["cuda"][k]
        check(got.shape == want.shape, f"activation {k}: shape")
        scale = max(float(np.abs(want).max()), 1e-12)
        act_err = max(act_err, float(np.abs(got - want).max()) / scale)
    return map_err, act_err


def p15_tiny_kernels(torch, rows_rec, fused_rec):
    """Both kernels at the harness's miniature shapes (32 x 64 maps, the
    decoder's last 8 channels into the fused kernel, K = 20 x B = 4 rows)
    against their plain versions."""
    from mst_tpu_torch.ops.kernels.fused_predict import (
        fused_predictor_softargmax, fused_predictor_softargmax_plain)
    from mst_tpu_torch.ops.kernels.softargmax_rows import (plain,
                                                           softargmax2d_rows)

    g = torch.Generator(device="cuda").manual_seed(15)
    logits = torch.randn((4, 32, 64), generator=g, device="cuda") * 4
    e_rows = float((softargmax2d_rows(logits) - plain(logits)).abs().max())
    x = torch.randn((80, 32, 64, 8), generator=g, device="cuda")
    w = torch.randn((8, 12), generator=g, device="cuda") * 0.5
    b = torch.randn((12,), generator=g, device="cuda")
    e_fused = float((fused_predictor_softargmax(x, w, b)
                     - fused_predictor_softargmax_plain(x, w, b))
                    .abs().max())
    print(f"harness shapes: rows soft-argmax (4, 32, 64) max |kernel - "
          f"plain| {e_rows:.3e} px (tol {ROWS_TOL}); fused predictor "
          f"(80, 32, 64, 8) x (8, 12) {e_fused:.3e} px (tol {FUSED_TOL})")
    check(e_rows <= ROWS_TOL, "rows kernel disagrees at the harness shapes")
    check(e_fused <= FUSED_TOL,
          "fused kernel disagrees at the harness shapes (C = 8)")
    rows_rec["max_abs_err"] = max(rows_rec["max_abs_err"], e_rows)
    fused_rec["max_abs_err"] = max(fused_rec["max_abs_err"], e_fused)


def p15_suites(tmp):
    """15d: two suites of scripts/ through the harness, on the card, side
    by side, with jax and mst_tpu unimportable -> {kernel: launches}."""
    from mst_tpu_torch.utils import scripts_e2e

    sb = os.path.join(tmp, "sandbox")
    t0 = time.perf_counter()
    scripts_e2e.build_sandbox(sb, scripts=list(P15_SUITES), device="cuda")
    with open(os.path.join(sb, "guard", "sitecustomize.py"), "a") as f:
        f.write(P15_COUNT_HOOK)
    print(f"harness sandbox for {len(P15_SUITES)} suites: "
          f"{time.perf_counter() - t0:.1f} s host")
    from concurrent.futures import ThreadPoolExecutor

    def run(rel):
        t0 = time.perf_counter()
        rc, out = scripts_e2e.run_script(rel, sb, timeout=300)
        return rc, out, time.perf_counter() - t0

    # side by side: a suite is a CLI process or two, most of whose time
    # is the process's start
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(P15_SUITES)) as pool:
        done = list(pool.map(run, P15_SUITES))
    print(f"15d: {len(P15_SUITES)} suites side by side in "
          f"{time.perf_counter() - t0:.1f} s host")
    total = {}
    for rel, (rc, out, dt) in zip(P15_SUITES, done):
        n_avg = len(re.findall(r"Average performance \(by ", out))
        want = scripts_e2e.expected_runs(rel)
        counts = [json.loads(line.split(" ", 1)[1])
                  for line in out.splitlines()
                  if line.startswith("KERNEL_LAUNCHES ")]
        launches = {}
        for c in counts:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        ade = re.findall(r"Average performance \(by \d+\): \nTest ADE: "
                         r"([\d.]+) \nTest FDE: ([\d.]+)", out)
        print(f"suite {rel}: rc {rc}, {n_avg}/{want} 'Average performance' "
              f"blocks {ade}, {len(counts)} CLI process(es), {dt:.1f} s "
              f"host, launches {launches}")
        check(rc == 0 and n_avg >= want,
              f"suite {rel} failed (rc {rc}):\n{out[-3000:]}")
        check("may not be imported" not in out, f"{rel} imported jax or "
              "mst_tpu")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def analysis_path(torch, wrappers, card, rows_rec, fused_rec):
    """Phase 15: the eval step's sample payload, the evaluator tools and
    two experiment suites, on phase 6c's scenes at sdd_shortterm_eval.
    yaml's width (352 x 480, B = 8, TTST on, mosa_2 on 0-4, the identity
    backbone's 3 classes, random weights from a seed).

    (a) Experiment.test(return_samples=True): the payload's keys and
        shapes, its host bytes; at small width, card against CPU on the
        same weights, the goal maps within P15_MAP_TOL of their max;
    (b) compare_checkpoints of the base and base + a mosa_2 delta;
        lora_importance over the delta's 9 LoRA layers (11 test passes);
        the swap oracle (a single perturbed group's swap equals the
        pretrained eval, every other group's the tuned eval, bit for bit);
    (c) capture_activations on one scene (small width: card against CPU;
        full width: timed);
    (d) generalize.sh and tune_mosa.sh through the harness on the card.
    Every count is set to 0 before (a)-(c)'s full-width runs and before
    each suite, and read after; the rows and fused kernels launch once an
    eval batch of (a) and (b). -> {kernel: launches}."""
    import numpy as np

    from mst_tpu_torch import io
    from mst_tpu_torch.evaluator.activations import capture_activations
    from mst_tpu_torch.evaluator.importance import (lora_importance,
                                                    swap_importance)
    from mst_tpu_torch.evaluator.multickpts import compare_checkpoints
    from mst_tpu_torch.train.trainer import restore_model

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mst_p15_")
    try:
        # ---- small width: card against CPU (not counted: comparisons)
        t0 = time.perf_counter()
        map_err, act_err = p15_small_reference(torch, tmp)
        print(f"15a/15c small width, card against CPU: goal maps "
              f"{map_err:.3e}, activations {act_err:.3e} of max (tol "
              f"{P15_MAP_TOL}); {time.perf_counter() - t0:.1f} s host")
        check(map_err <= P15_MAP_TOL and act_err <= P15_MAP_TOL,
              "the payload or the activations on the card disagree with "
              "the CPU")
        p15_tiny_kernels(torch, rows_rec, fused_rec)

        images, _, _, test = loop_data()
        params = p15_params()
        base, delta = p15_checkpoints(torch, params, images, tmp, "full")
        one = test.take(test.sceneId == test.sceneId[0])
        total = dict.fromkeys(wrappers, 0)
        n_batches = 0

        def counted(fn):
            out, launches = count_launches(wrappers, fn)
            for k, v in launches.items():
                total[k] += v
            return out

        # ---- (a) the payload at full width
        model = restore_model(params, True, base, delta, images=images)
        tuned = io.params_to_numpy(model.model_params)
        n_test = len(model.prepare_data(test, None, "test"))
        n_one = len(model.prepare_data(one, None, "test"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = counted(lambda: model.test(test, None, return_samples=True))
        dt = time.perf_counter() - t0
        n_batches += n_test
        trajs = res[3][0]
        n = len(np.unique(test.metaId))
        shapes = {k: np.concatenate(v).shape for k, v in trajs.items()}
        nbytes = sum(np.concatenate(trajs[k]).nbytes for k in
                     ("goal_map", "goal_sigmoid_map", "waypoint_sample"))
        print(f"15a payload ({card}): {n} trajectories in {n_test} batches, "
              f"{dt:.2f} s host; shapes {shapes}; host bytes {nbytes} "
              f"({nbytes / 2**20:.1f} MiB); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(shapes["goal_map"] == (n, 352, 480, 12)
              and shapes["goal_sigmoid_map"] == (n, 352, 480, 12)
              and shapes["waypoint_sample"] == (n, 1, 20, 2)
              and shapes["prediction"] == (n, 12, 2),
              f"payload shapes {shapes}")
        check(all(np.isfinite(np.concatenate(v)).all()
                  for k, v in trajs.items() if k != "metaId"),
              "the payload is not finite")
        del trajs, res

        # ---- (b) compare_checkpoints, lora_importance, the swap oracle
        t0 = time.perf_counter()
        df, _ = counted(lambda: compare_checkpoints(
            params, test, None, [base, delta], ["OODG", "mosa_2"],
            [False, True], n_round=1, seed=1, images=images))
        n_batches += 2 * n_test
        moved = float(np.abs(df["ade_OODG"] - df["ade_mosa_2"]).max())
        print(f"15b compare_checkpoints: {len(df)} rows, columns "
              f"{list(df.columns)}; the delta moves a trajectory's ADE by "
              f"up to {moved:.3f} px; {time.perf_counter() - t0:.2f} s "
              f"(2 test passes of {n_test} batches)")
        check(len(df) == n and moved > 0, "compare_checkpoints")
        t0 = time.perf_counter()
        lora = counted(lambda: lora_importance(model, one, None))
        n_batches += len(lora) * n_one
        dt = time.perf_counter() - t0
        print(f"15b lora_importance: {len(lora)} test passes of {n_one} "
              f"batch(es), {dt / len(lora):.3f} s a pass; ADE "
              f"{dict(zip(lora.zeroed, lora.ade.round(4)))}")
        check(len(lora) == 11 and np.isfinite(lora.ade).all(),
              "lora_importance: not none + 9 layers + all")
        pretrained = dict(tuned)
        for k in tuned:
            if k.startswith("traj_decoder/"):
                pretrained[k] = tuned[k] + 0.01

        def direct(flat):
            model.model_params = io.params_from_numpy(flat, "cuda")
            return model.test(one, None)[:2]

        t0 = time.perf_counter()
        ade_t, fde_t = counted(lambda: direct(tuned))
        ade_p, fde_p = counted(lambda: direct(pretrained))
        model.model_params = io.params_from_numpy(tuned, "cuda")
        swap = counted(lambda: swap_importance(
            model, one, None, pretrained, tuned, depth=1, seed=1))
        n_batches += (2 + len(swap)) * n_one
        dt = time.perf_counter() - t0
        by = swap.set_index("group")
        others = [g for g in by.index
                  if g not in ("none", "all", "traj_decoder")]
        print(f"15b swap oracle: {len(swap) + 2} test passes, "
              f"{dt / (len(swap) + 2):.3f} s a pass; tuned ADE {ade_t}, "
              f"pretrained {ade_p}; groups {list(by.index)}")
        check(ade_p != ade_t, "the perturbation does not matter")
        check(by.loc["none", "ade"] == ade_t and by.loc["all", "ade"] == ade_p
              and by.loc["traj_decoder", "ade"] == ade_p
              and by.loc["traj_decoder", "fde"] == fde_p and others
              and all(by.loc[g, "ade"] == ade_t for g in others),
              "the swap oracle does not hold bit for bit")

        # ---- (c) activations at full width
        t0 = time.perf_counter()
        acts = counted(lambda: capture_activations(model, one, None))
        print(f"15c capture_activations: {len(acts)} maps, goal map "
              f"{acts['goal_decoder.predictor_output'].shape}, "
              f"{time.perf_counter() - t0:.2f} s host")
        check(all(np.isfinite(a).all() for a in acts.values()),
              "non-finite activations")
        del acts, model
        print(f"15a-c launches: {total} over {n_batches} eval batches")
        check(total["softargmax_rows"] == n_batches
              and total["fused_predict"] == n_batches
              and total["kmeans"] == n_batches
              and all(v == 0 for k, v in total.items()
                      if k not in ("softargmax_rows", "fused_predict",
                                   "kmeans")),
              f"15a-c launched {total}, the code gives rows = fused = "
              f"kmeans = {n_batches}, others 0")

        # ---- (d) two suites through the harness
        torch.cuda.empty_cache()
        suites = p15_suites(tmp)
        for k, v in suites.items():
            total[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 15 launches: {total}; {time.perf_counter() - t_phase:.1f}"
          f" s")
    for k in ("softargmax_rows", "fused_predict"):
        check(total[k] > 0, f"{k} never ran in phase 15")
        check(suites.get(k, 0) > 0, f"{k} never ran in phase 15's suites")
    return total


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
    from mst_tpu_torch.ops.kernels.kmeans import lloyd2d
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows
    from mst_tpu_torch.probes import kernel_wrappers
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
    sources = ["fused_predict", "softargmax_rows", "kmeans", "conv3x3",
               "decoder_chain"]
    print_ptxas(_build.build(sources))
    print(f"build: nvcc {', '.join(s + '.cu' for s in sources)} in "
          f"parallel, {time.perf_counter() - t0:.1f} s")
    print_smem()
    check_splits()

    # ---- 3. kernels against their plain versions (and phase 11's bf16
    # checks of the same two kernels, here where the profiler still sees
    # every launch: late in a long process it loses kernel records)
    records = [check_rows_kernel(torch), check_fused_kernel(torch),
               check_kmeans_kernel(torch)]
    bf16_records = check_bf16_kernels(torch)
    partial_rec = check_partial_kernel(torch)
    rows_partial_rec = check_rows_partial_kernel(torch)
    for r in records + bf16_records + [partial_rec, rows_partial_rec]:
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
    lloyd2d.launches = 0
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
                "fused_predict": fused_predictor_softargmax.launches,
                "kmeans": lloyd2d.launches}
    print(f"main-path launches: {launches}")
    check(launches["kmeans"] == len(outs), "the k-means kernel launched "
          f"{launches['kmeans']} times over {len(outs)} TTST requests")
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

    # ---- 9. the segmentation backbone: card against CPU at small width,
    # then the ResNet101 U-Net at SDD width on the shipped configs' paths
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_err, state_err, traj_err, map_err = \
        small_segmentation_reference(torch)
    print(f"small-width segmentation: max relative |card - cpu| loss = "
          f"{loss_err:.3e} (tol {TRAIN_TOL}), state {state_err:.3e} (tol "
          f"{STATE_TOL}), eval trajectories {traj_err:.3e} model px (tol "
          f"{FUSED_TOL}), features and logits {map_err:.3e} (tol "
          f"{SEG_MAP_TOL})")
    check(loss_err <= TRAIN_TOL and state_err <= STATE_TOL
          and traj_err <= FUSED_TOL and map_err <= SEG_MAP_TOL,
          "a segmentation path on the card disagrees with the CPU")
    seg_launches = segmentation_path(torch, kernel_wrappers(), card,
                                     rows_rec, fused_rec)
    print(f"segmentation phase: {time.perf_counter() - t0:.1f} s")

    # ---- 11. bf16, remat, cross-scene batching, forward_test (before
    # phase 10, whose CLI processes take minutes: its traces need a
    # profiler that still records every kernel)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    p11 = bf16_requests(torch, wrappers, card, semantic, observed)
    steps = bf16_and_remat_steps(torch, wrappers, card, bf16_records[0])
    p11 = {k: p11[k] + steps[k] for k in p11}
    cross = cross_scene_path(torch, wrappers, card)
    forward_test_path(torch, card)
    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s")
    for r in bf16_records:
        r["launches"] = p11[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never ran on the bf16 path")
    records += bf16_records

    # ---- 12. --fused as CUDA graphs and the grid under vmap (before phase
    # 10 too: its traces need a profiler that records every kernel)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p12 = fused_and_grid_path(torch, kernel_wrappers(), card, rows_rec,
                              fused_rec)
    print(f"fused and grid phase: {time.perf_counter() - t0:.1f} s")

    # ---- 13. the serialized program: model directories with forward.pt2
    # and decode.pt2, served by a process that cannot import the model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p13 = serialized_program_path(torch, kernel_wrappers(), card, semantic,
                                  observed, delta)
    print(f"serialized program phase: {time.perf_counter() - t0:.1f} s")

    # ---- 14. data parallelism over a mesh: a world of 1 on NCCL, a world
    # of 2 sharing the card on gloo, its checkpoint and its grid, and the
    # spatial mesh's eval (14e) and training (14f) in that world
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p14, spatial = mesh_path(torch, kernel_wrappers(), card)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    # the partial variant's main path is phase 14e's test CLI on the
    # spatial mesh
    partial_rec["launches"] = sum(spatial["launches"])
    partial_rec["max_abs_err"] = max(partial_rec["max_abs_err"],
                                     spatial["max_abs_err"])
    check(all(spatial["launches"]), "fused_predict_partial never ran on a "
          "rank of the spatial path")
    records.append(partial_rec)
    # the rows kernel's partial variant's main path is phase 14f's spatial
    # train steps
    rows_partial_rec["launches"] = sum(spatial["train_launches"])
    rows_partial_rec["max_abs_err"] = max(rows_partial_rec["max_abs_err"],
                                          spatial["train_max_abs_err"])
    check(all(spatial["train_launches"]), "softargmax_rows_partial never "
          "ran on a rank of the spatial train path")
    records.append(rows_partial_rec)

    # ---- 10. from raw annotations to a resumed run, and ETH
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res_launches = raw_to_resumed(torch, kernel_wrappers(), card, rows_rec,
                                  fused_rec)
    print(f"resume phase: {time.perf_counter() - t0:.1f} s")

    # ---- 15. the eval payload, the evaluator tools and two suites of
    # scripts/ through the harness
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p15 = analysis_path(torch, kernel_wrappers(), card, rows_rec, fused_rec)
    print(f"analysis phase: {time.perf_counter() - t0:.1f} s")

    for r in records:
        r["p11_launches"] = p11[r["name"]] + cross[r["name"]]
        r["p12_launches"] = p12[r["name"]]
        r["p13_launches"] = p13[r["name"]]
        r["p14_launches"] = p14[r["name"]]
        r["p14g_launches"] = spatial["p14g"][r["name"]]
        r["p15_launches"] = p15[r["name"]]
        r["train_launches"] = train_launches[r["name"]]
        r["loop_launches"] = loop_launches[r["name"]]
        r["ymod_launches"] = ymod_launches[r["name"]]
        r["serve_launches"] = serve_launches[r["name"]]
        r["seg_launches"] = seg_launches[r["name"]]
        r["res_launches"] = res_launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "train_launches", "loop_launches", "ymod_launches",
            "serve_launches", "seg_launches", "res_launches", "p11_launches",
            "p12_launches", "p13_launches", "p14_launches", "p14g_launches",
            "p15_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
