"""Hyperparameter-grid fine-tuning: a seeds x lrs (x n_trains) sweep as one
vmapped program per shape group (counterpart of mst_tpu/grid.py).

The reference runs its adaptation grids as bash loops of `python
train.py` (e.g. scripts/sdd/ped_to_biker/tune_mosa.sh:28-41), each
process building, loading and stepping its own model. Here every run's
few-shot data, trainable leaves, model state and optimizer state are
stacked on a run axis, and the fused epoch (train/fused.py
make_epoch_runner) runs under torch.func.vmap over that axis: the frozen
base is one copy shared by every run, the learning rate is each run's
own tensor, and each run's validation draws are drawn ahead from the
seeds its own loop run would use. On a CUDA card one epoch of the
vmapped program is captured as a CUDA graph and replayed once per epoch,
so one graph serves every lr of a group; the serving kernels run inside
it through their vmap rules. Each run's smooth-val / early-stop /
best-checkpoint selection (train/fused.Selection) follows the epochs as
they stream out of each chunk, its model is saved under the name `python
-m mst_tpu_torch.train` gives it, and its left-out test runs as the
train CLI runs it.

As in mst_tpu, and unlike looping the train CLI: runs advance in
lockstep, so an early stop ends a run's bookkeeping, not its device work;
no periodic checkpoints or --resume; a diverged run (a non-finite loss)
is reported and skipped. --runs_per_program caps the runs of one
program, and a group that runs out of device memory
(torch.cuda.OutOfMemoryError) is split in half and resumed from the
epoch it reached. Two environment hooks test that split:
MST_GRID_FORCE_OOM_ABOVE=n fakes the error in a group of more than n
runs after its first chunk, MST_GRID_CHUNK_CAP=c caps the chunk.

    python -m mst_tpu_torch.grid --config_filename sdd_shortterm_train.yaml \\
        --fine_tune --train_net mosa_2 --position 0 1 2 3 4 \\
        --pretrained_ckpt ckpts/base.npz --smooth_val \\
        --seeds 1 2 3 --lrs 0.0005 0.001 0.005 [--n_trains 1 2 3] \\
        [--log_dir logs/] [--runs_per_program 8] [--device cpu]

--n_trains values change the packed data's shapes, so each n_train sweeps
as its own shape group; seeds x lrs within one n_train share a program.

On a mesh (--mesh_shape N, or R D with --mesh_axes replica data, under
torchrun) the run axis splits over the ranks, as mst_tpu shards it over
the mesh: rank i of n takes block i of the runs, padded to a multiple of
n with duplicates of the last run, whose results are discarded, and
sweeps its runs on its own card without collectives; every run's
results are gathered to rank 0, which writes every run's files as a
world of one would. The spatial mesh (--mesh_axes data space) exits
with mst_tpu's SystemExit (mst_tpu/grid.py:321-324).

    torchrun --nproc_per_node 2 -m mst_tpu_torch.grid --mesh_shape 2 ...
"""

import contextlib
import copy
import gc
import io as text_io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mst_tpu_torch import config as config_lib
from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.data.splits import prepare_dataset
from mst_tpu_torch.ops.kernels import launches
from mst_tpu_torch.ops.sampling import Draws
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.train import fused as fused_lib
from mst_tpu_torch.train.trainer import (Experiment, eval_seed, masked_means,
                                         write_checkpoint)
from mst_tpu_torch.utils.seeding import set_random_seeds

# bytes of per-epoch snapshots a chunk may bring to the host at once: the
# chunk shrinks to keep R x chunk x |trainable| under it (LoRA grids are
# ~100 KB a run and never reach it; full fine-tunes do)
SNAPSHOT_BUDGET = 2 << 30


def stack_trees(trees):
    """Nested dicts of tensors with the same paths -> one of stacked
    tensors (a leading run axis)."""
    return {k: stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def row_of(tree, i):
    """Run i's slice of a stacked tree, copied."""
    return {k: row_of(v, i) if isinstance(v, dict) else v[i].clone()
            for k, v in tree.items()}


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in io.flatten(tree).values())


class GroupProgram:
    """One epoch of the vmapped runner for a group of G runs, with the
    group's carry (stacked trainable leaves, state and optimizer state),
    data, learning rates and batch orders resident: epoch(e) -> (stats
    (G, n_train, 4), val (G, n_val, 3, B)), advancing the carry. Each
    run's validation draws of epoch e come from generators seeded as its
    loop run seeds them (eval_seed(seed, e, i)).

    On a CUDA device the epoch is captured once as a CUDA graph (after one
    eager warm-up call of the same function on the capture stream, which
    leaves the carry as it was) and replayed: the epoch's batch orders and
    validation draws fill static buffers first. On the CPU it runs
    eagerly."""

    def __init__(self, vrun, frozen, carry, lr, train, val, perms, seeds,
                 noise_shapes, device):
        self.vrun, self.frozen, self.carry = vrun, frozen, carry
        self.lr, self.train, self.val = lr, train, val
        self.perms, self.seeds = perms, seeds  # (G, n_epoch, n_train)
        self.gens = [torch.Generator(device) for _ in seeds]
        self.device = device
        self.perm = torch.zeros(perms[:, 0].shape, dtype=torch.long,
                                device=device)
        self.noise = [[torch.empty((len(seeds), *s), device=device)
                       for s in noise_shapes]
                      for _ in range(val["traj"].shape[1])]
        self.graph = None
        self.capture_seconds = 0.0

    def _call(self):
        tr, st, op, stats, val = self.vrun(
            self.carry["trainable"], self.frozen, self.carry["state"],
            self.carry["opt"], self.perm, self.noise, self.lr, self.train,
            self.val)
        return {"trainable": tr, "state": st, "opt": op}, stats, val

    def epoch(self, e):
        self.perm.copy_(self.perms[:, e])
        for i, draws in enumerate(self.noise):
            for row, seed in enumerate(self.seeds):
                gen = self.gens[row].manual_seed(eval_seed(seed, e, i))
                for buf in draws:
                    buf[row].exponential_(generator=gen)
        if self.device.type == "cpu":
            self.carry, stats, val = self._call()
            return stats, val
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.out

    def _capture(self):
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._call()  # warm-up: functional, the carry is unchanged
        torch.cuda.current_stream(self.device).wait_stream(stream)

        def epoch():
            carry, stats, val = self._call()
            fused_lib.copy_tree(self.carry, carry)
            return stats, val

        self.graph = launches.Graph()
        self.out = self.graph.capture(epoch, stream)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0


def _sweep_shape_group(*, gmap, carries, program, n_epoch, snap_bytes, G0,
                       sels, hist, snaps, last_state, diverged, done,
                       force_oom_above, chunk_cap, stats_out):
    """Advance one shape group (global run indices `gmap`, one packed-data
    shape) from epoch 0 to the end, in sub-groups of at most G0 runs, each
    a GroupProgram run chunk by chunk with one host read a chunk; a
    sub-group that runs out of device memory is split in half and resumed
    from the epoch it reached. Results stream into the per-run
    bookkeeping lists (indexed globally); carries[r] holds run r's carry
    between sub-groups."""

    def consume(idx, e, got):
        """Each run's epochs e, e + 1, ... of a chunk's records (host
        copies of each epoch's stats, val rows, trainable leaves and
        state) into its bookkeeping, pruning its snapshots."""
        for row, li in enumerate(idx):
            r = gmap[li]
            if done[r]:
                continue
            for j, g in enumerate(got):
                ep = e + j
                st = g["stats"][row].numpy()
                if not np.isfinite(st[:, 0]).all():
                    # the train CLI raises here; the grid marks the run
                    # failed and goes on (epochs past a run's early stop
                    # never reach this check, as the CLI never ran them)
                    bi = int(np.flatnonzero(~np.isfinite(st[:, 0]))[0])
                    diverged[r] = (ep, bi)
                    done[r] = True
                    break
                n = max(float(sum(st[:, 3])), 1)
                va, vf = masked_means(g["val"][row].numpy())
                hist[r].append((float(sum(st[:, 1])) / n,
                                float(sum(st[:, 2])) / n, va, vf))
                snaps[r][ep] = {k: v[row] for k, v in g["trainable"].items()}
                last_state[r] = row_of(io.unflatten(g["state"]), row)
                stop = sels[r].step(ep, va)
                live = sels[r].live_snapshots()
                for k in [k for k in snaps[r] if k not in live]:
                    del snaps[r][k]
                if stop:
                    done[r] = True
                    break

    def sweep(idx, e0):
        G = len(idx)
        chunk = max(1, min(fused_lib.MAX_CHUNK, n_epoch,
                           SNAPSHOT_BUDGET // (G * snap_bytes)))
        if chunk_cap:
            chunk = min(chunk, chunk_cap)
        rs = [gmap[li] for li in idx]
        e = e0
        prog = None
        exhausted = False
        try:
            prog = program(rs, stack_trees([carries[r] for r in rs]))
            while e < n_epoch and not all(done[r] for r in rs):
                if force_oom_above and G > force_oom_above and e > e0:
                    raise torch.cuda.OutOfMemoryError(
                        "out of memory (forced for the test of the split)")
                c = min(chunk, n_epoch - e)
                got = []
                for j in range(c):
                    stats, val = prog.epoch(e + j)
                    got.append({"stats": stats.clone(), "val": val.clone(),
                                "trainable": {k: v.detach().clone() for k, v
                                              in prog.carry["trainable"]
                                              .items()},
                                "state": io.flatten(fused_lib.clone_tree(
                                    prog.carry["state"]))})
                # the chunk's one device-to-host read
                tensors = [t for g in got for v in g.values()
                           for t in (v.values() if isinstance(v, dict)
                                     else [v])]
                it = iter(fused_lib.to_host(tensors))
                got = [{part: ({k: next(it) for k in v}
                               if isinstance(v, dict) else next(it))
                        for part, v in g.items()} for g in got]
                consume(idx, e, got)
                stats_out["replays"] += c
                stats_out["capture_seconds"] += prog.capture_seconds
                prog.capture_seconds = 0.0
                e += c
                for row, r in enumerate(rs):
                    carries[r] = row_of(prog.carry, row)
        except torch.cuda.OutOfMemoryError:
            if G == 1:
                raise
            exhausted = True
        if not exhausted:
            return
        print(f"[grid] {G}-run program exhausted device memory at epoch "
              f"{e}; splitting the group")
        # the failed program's buffers and graph pool go before the halves
        # allocate theirs; carries[r] holds the last completed chunk's
        # carry, so the halves resume from epoch e
        prog = got = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        mid = (G + 1) // 2
        sweep(idx[:mid], e)
        sweep(idx[mid:], e)

    for lo in range(0, len(gmap), G0):
        sweep(list(range(lo, min(lo + G0, len(gmap)))), 0)


def run_grid(args):
    """The sweep of `args` (the train CLI's flags plus --seeds, --lrs,
    --n_trains, --log_dir, --runs_per_program) -> one dict a run, in run
    order: seed, lr, n_train, name, the test's ade and fde (NaN for a
    diverged run), val_ADE and val_FDE (the epochs' histories) and
    best_epoch; on every rank of a mesh. run_grid.stats holds the sweep's
    seconds, its epochs of programs (replays on a card) and their capture
    seconds, on this rank."""
    t0 = time.time()
    if "space" in (args.mesh_axes or ()):
        # mst_tpu's refusal (mst_tpu/grid.py:321-324)
        raise SystemExit("the grid shards RUNS over the mesh; use a 1D "
                         "--mesh_shape (no 'space' axis)")
    config_lib.check_loop_ported(vars(args))
    device = resolve_device(args.device)
    mesh = mesh_lib.mesh_from_shape(args.mesh_shape, args.mesh_axes, device)
    seeds = list(args.seeds or [args.seed])
    lrs = [float(x) for x in (args.lrs or [args.lr])]
    n_trains = ([int(x) for x in args.n_trains] if args.n_trains
                else [args.n_train_batch])
    # lr-major like the reference's grids; an n_train's runs stay together
    all_runs = [(s, lr, nt) for nt in n_trains for lr in lrs for s in seeds]
    owned, keep = rank_runs(len(all_runs), mesh_lib.batch_shards(mesh))
    runs = [all_runs[i] for i in owned]
    R = len(runs)

    # ---- each run's setup: what the train CLI does up to its epoch loop
    exps, setups, names, tests, packs, rngs = [], [], [], [], [], []
    for seed, lr, nt in runs:
        set_random_seeds(seed)
        args_r = copy.deepcopy(args)
        args_r.seed, args_r.lr, args_r.n_train_batch = seed, lr, nt
        # each run trains on its whole batch on this rank
        args_r.mesh_shape = args_r.mesh_axes = None
        params = config_lib.get_params(args=args_r)
        image_path, data_path = config_lib.get_image_and_data_path(params)
        train, val, test = prepare_dataset(
            data_path, args.load_data, args.batch_size,
            args_r.n_train_batch, args.train_files, args.val_files,
            args.val_split, args.test_splits, args.shuffle,
            args.share_val_test, "train", args.show_details)
        name = config_lib.get_experiment_name(args_r,
                                              train.meta_ids().shape[0])
        print(f"[grid] run seed={seed} lr={lr} n_train={nt}: {name}")
        exp = Experiment(params)
        if args.pretrained_ckpt is not None:
            exp.load_params(args.pretrained_ckpt)
        rng = np.random.default_rng(seed)
        setup = exp._setup_training(train, val, image_path, image_path, rng)
        tr, va, why = exp._fused_pack(setup["train_items"],
                                      setup["val_items"])
        if tr is None:
            raise SystemExit(f"grid runs must be fused-eligible: {why}")
        exps.append(exp)
        setups.append(setup)
        names.append(name)
        tests.append((test, image_path))
        packs.append((fused_lib.stage_data(*tr, device),
                      fused_lib.stage_data(*va, device)))
        rngs.append(rng)

    # ---- shape groups: the runs of one program share their data shapes;
    # within one n_train the seeds must not change them
    def sig(r):
        return tuple((k, tuple(v.shape)) for part in packs[r]
                     for k, v in sorted(part.items()))

    for nt in n_trains:
        if len({sig(r) for r in range(R) if runs[r][2] == nt}) > 1:
            raise SystemExit(
                "grid runs produced differently-shaped data (seeds changed "
                "the split sizes or scene buckets); use predefined splits "
                "so every run of one --n_train_batch shares one shape")
    shape_groups = {}
    for r in range(R):
        shape_groups.setdefault(sig(r), []).append(r)

    opts = [s["optimizer"] for s in setups]
    if len({(type(o), o.milestones, o.gamma) for o in opts}) != 1:
        raise SystemExit("grid runs disagree on the lr schedule")
    opt0 = opts[0]

    def opt_factory(lr):
        return type(opt0).functional(lr, opt0.milestones, opt0.gamma)

    # the frozen base is shared: every run must hold the same one (a full
    # pretrained checkpoint over the frozen leaves; without one, or with a
    # delta-only one, each seed's random init stays in the base)
    def frozen_of(exp):
        return {k: v for k, v in io.flatten(exp.model_params).items()
                if not v.requires_grad}

    frozen = frozen_of(exps[0])
    for r in range(1, R):
        other = frozen_of(exps[r])
        if other.keys() != frozen.keys() or not all(
                torch.equal(frozen[k], other[k]) for k in frozen):
            raise SystemExit(
                "grid runs disagree on their frozen parameters (runs share "
                "one frozen base); pass --pretrained_ckpt with a FULL "
                "checkpoint that covers the frozen partition (delta-only or "
                "absent checkpoints leave seed-specific random init in the "
                "base)")

    exp0 = exps[0]
    p = exp0.params
    runner = fused_lib.make_epoch_runner(
        exp0.mcfg, config_lib.step_config(p),
        config_lib.step_config(p, for_validation=True), opt_factory)
    vrun = torch.func.vmap(runner, in_dims=(0, None, 0, 0, 0, 0, 0, 0, 0))

    # the validation draws' shapes: one validation batch of run 0, drawing
    # from a throwaway generator
    rec = Draws(generator=torch.Generator(device).manual_seed(0))
    val0 = packs[0][1]
    exp0._eval_step(for_validation=True)(
        exp0.model_params, exp0.model_state,
        fused_lib.index_batch(val0, torch.zeros(1, dtype=torch.long,
                                                device=device)), rec)
    noise_shapes = [tuple(t.shape) for t in rec.drawn]

    carries = [{"trainable": {k: v.detach().clone() for k, v in
                              s["trainable"].items()},
                "state": fused_lib.clone_tree(e.model_state),
                "opt": s["optimizer"].functional_state(s["trainable"])}
               for s, e in zip(setups, exps)]
    n_epoch = int(p["n_epoch"])
    # every epoch's batch order ahead: the loop's per-epoch shuffle stream
    n_batches = packs[0][0]["traj"].shape[0]
    perms = np.empty((R, n_epoch, n_batches), np.int64)
    for r in range(R):
        order = np.arange(n_batches)
        for j in range(n_epoch):
            rngs[r].shuffle(order)
            perms[r, j] = order

    def program(rs, carry):
        """The GroupProgram of runs rs from their carry."""
        return GroupProgram(
            vrun, frozen, carry,
            torch.tensor([runs[r][1] for r in rs], dtype=torch.float32,
                         device=device),
            stack_trees([packs[r][0] for r in rs]),
            stack_trees([packs[r][1] for r in rs]),
            torch.as_tensor(perms[rs], device=device),
            [runs[r][0] for r in rs], noise_shapes, device)

    snap_bytes = max(_tree_bytes(carries[0]["trainable"]), 1)
    G0 = max(1, min(int(args.runs_per_program or R), R))
    print(f"[grid] {len(all_runs)} runs ({len(seeds)} seeds x {len(lrs)} "
          f"lrs x {len(n_trains)} n_trains), {n_epoch} epochs, "
          f"{len(shape_groups)} shape group(s)"
          + (f", <={G0} runs/program" if G0 < R else "")
          + (f", {R} on each of {mesh.mesh.numel()} ranks" if mesh else "")
          + f", on {device}")

    sels = [fused_lib.Selection(
        smooth_val=bool(p.get("smooth_val", False)),
        window_size=int(p.get("window_size", 9)),
        fine_tune=bool(p.get("fine_tune", False)),
        n_early_stop=int(p.get("n_early_stop", 300))) for _ in runs]
    hist = [[] for _ in runs]       # (ade, fde, val_ade, val_fde) an epoch
    snaps = [{} for _ in runs]      # epoch -> trainable copy (pruned)
    last_state = [None] * R
    diverged = [None] * R           # (epoch, batch) of a non-finite loss
    done = [False] * R
    run_stats = {"replays": 0, "capture_seconds": 0.0}
    for gmap in shape_groups.values():
        _sweep_shape_group(
            gmap=gmap, carries=carries, program=program, n_epoch=n_epoch,
            snap_bytes=snap_bytes, G0=G0, sels=sels, hist=hist,
            snaps=snaps, last_state=last_state, diverged=diverged,
            done=done,
            force_oom_above=int(os.environ.get("MST_GRID_FORCE_OOM_ABOVE",
                                               "0")),
            chunk_cap=int(os.environ.get("MST_GRID_CHUNK_CAP", "0")),
            stats_out=run_stats)
    t_sweep = time.time() - t0

    # ---- each run's output, checkpoint and left-out test, in the train
    # CLI's order; on a mesh gathered to rank 0, which writes them all
    results = []
    for r, (seed, lr, nt) in enumerate(runs):
        if not keep[r]:
            continue
        buf = text_io.StringIO()
        with contextlib.redirect_stdout(buf):
            ckpt = _emit_run(exps[r], names[r], sels[r], hist[r], snaps[r],
                             last_state[r], diverged[r], setups[r])
            ade = fde = float("nan")
            if ckpt is not None:
                print("############ Test leftout data ##############")
                set_random_seeds(seed)
                test, image_path = tests[r]
                ade, fde, _, _ = exps[r].test(test, image_path)
        results.append((owned[r], dict(
            seed=seed, lr=lr, n_train=nt, name=names[r], ade=ade, fde=fde,
            val_ADE=[h[2] for h in hist[r]],
            val_FDE=[h[3] for h in hist[r]],
            best_epoch=sels[r].best_epoch), buf.getvalue(), ckpt))
    if mesh is not None:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, results)
        results = sorted(x for part in gathered for x in part)
    writer = mesh is None or dist.get_rank() == 0
    summary = []
    for _, s, text, ckpt in results:
        summary.append(s)
        if not writer:
            continue
        if ckpt is not None:
            write_checkpoint(*ckpt)
        print(f"===== run seed={s['seed']} lr={s['lr']} "
              f"n_train={s['n_train']} =====")
        print(text, end="")
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"{s['name']}.out"),
                      "w") as f:
                f.write(text)
    if mesh is not None:
        dist.barrier()

    print("\n[grid] summary (test minADE / minFDE):")
    for s in summary:
        print(f"  seed={s['seed']} lr={s['lr']} n_train={s['n_train']}: "
              f"ADE {s['ade']:.4f} FDE {s['fde']:.4f}  ({s['name']})")
    print(f"[grid] {len(summary)} runs in {time.time() - t0:.1f}s (sweep "
          f"{t_sweep:.1f}s, {run_stats['replays']} epochs of programs, "
          f"capture {run_stats['capture_seconds']:.1f}s)")
    run_grid.stats = dict(run_stats, sweep_seconds=t_sweep)
    return summary


def rank_runs(n_runs, shards):
    """This rank's runs of n_runs -> (their indices, whether each is kept):
    block `shards.index` of the runs padded to a multiple of the ranks with
    duplicates of the last run, which are not kept (every run, all kept,
    without shards)."""
    if shards is None:
        return list(range(n_runs)), [True] * n_runs
    per = -(-n_runs // shards.count)
    block = range(shards.index * per, (shards.index + 1) * per)
    return [min(i, n_runs - 1) for i in block], [i < n_runs for i in block]


def _emit_run(exp, name, sel, hist, snaps, state, diverged, setup):
    """One run's epoch lines and selection from its streamed bookkeeping,
    its leaves and state restored -> (path, arrays, metadata) of its
    checkpoint (trainer.write_checkpoint's arguments), or None for a
    diverged run."""
    p = exp.params
    if diverged is not None:
        ep, bi = diverged
        print(f"[grid] run diverged: non-finite loss at epoch {ep}, "
              f"scene-batch {bi} (lr={p['lr']}); skipping")
        return None
    for e, (ta, tf, va, vf) in enumerate(hist):
        print(f"Epoch {e}: \tTrain (Top-1) ADE: {ta:.2f} "
              f"FDE: {tf:.2f} \t\tVal (Top-k) ADE: {va:.2f} "
              f"FDE: {vf:.2f}")
    stop_e = len(hist) - 1
    if sel.stopped:
        print(f"Early stop at epoch {stop_e}")
    print(f"Best epoch at {sel.best_epoch}")
    exp.best_epoch = sel.best_epoch
    exp.val_ADE = [h[2] for h in hist]
    exp.val_FDE = [h[3] for h in hist]
    pick = (sel.best_snap if sel.best_epoch != 0 and sel.best_snap is not None
            else stop_e)
    with torch.no_grad():
        for k, v in snaps[pick].items():
            setup["trainable"][k].copy_(v)
    exp.model_state = io.unflatten({
        k: v.to(exp.device) for k, v in io.flatten(state).items()})
    return (f'{p["ckpt_path"]}/{name}.npz', *exp.checkpoint())


def get_parser():
    parser = config_lib.get_parser(True)
    parser.add_argument("--seeds", type=int, nargs="+", default=None,
                        help="grid seed axis (default: just --seed)")
    parser.add_argument("--lrs", type=float, nargs="+", default=None,
                        help="grid learning-rate axis (default: just --lr)")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="write per-run <experiment>.out logs in the "
                             "train CLI's line format")
    parser.add_argument("--n_trains", type=int, nargs="+", default=None,
                        help="grid n_train_batch axis (default: just "
                             "--n_train_batch); each value sweeps as its "
                             "own shape group")
    parser.add_argument("--runs_per_program", type=int, default=0,
                        help="cap how many runs one program holds (0 = "
                             "all); a group that exhausts device memory is "
                             "also split")
    return parser


if __name__ == "__main__":
    with mesh_lib.rank_zero_prints():
        run_grid(get_parser().parse_args())
