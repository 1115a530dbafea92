"""Fused multi-epoch training: chunks of the fine-tune loop with one host
read a chunk (counterpart of mst_tpu/train/fused.py; reference
utils/train_epoch.py:8-136 driven by models/trainer.py:222-281).

The few-shot fine-tune runs a few small train steps and a validation
pass, a hundred times over. Run eagerly, every kernel is a host launch
and every epoch pays its metric reads: on an H100, a bf16 mosa_2 step
at SDD width holds 17.5 ms of kernels in 21-27 ms of host time, and the
rows kernel takes 7 us on the card for 20-45 us of host. Here the train
and validation data are
staged on the device once, and one epoch (the epoch's permuted train
steps, then the validation batches with TTST off) is captured as a
torch.cuda.CUDAGraph and replayed once per epoch of a chunk: the batch
order is a static device tensor filled before each replay, the
validation draws are static noise buffers filled from the loop's seeds
before each replay, and the chunk's per-step losses, train sums and
validation rows come back in one device-to-host read after its last
replay. The host then runs the loop's own bookkeeping (Experiment.train's
finish_epoch) epoch by epoch, on the same numbers: on the CPU, where the
same epochs run eagerly, a fused run equals the loop bit for bit.

Both serving kernels run inside the graph (the rows kernel in each train
step's metrics, the fused kernel in each validation batch); their
wrappers count a captured launch once each replay
(ops/kernels/launches.py).

make_epoch_runner is the same epoch with parameters in and out and the
data, the validation draws and the learning rate as arguments, which the
grid (mst_tpu_torch.grid) runs under torch.func.vmap over a run axis.

On a data-parallel mesh each rank stages its rows of every batch and
runs the mesh's steps (train/steps.py), whose collectives an NCCL
world's graph captures; validation draws each rank's rows of the global
batch's noise. On the spatial mesh the staged scenes are the rank's
slabs of them (Experiment cuts each scene, whose height it first checks
against the 'space' ranks, mesh.check_spatial_scene, as mst_tpu checks
its staged stack), and the graph captures the halo exchanges of the
forward and the backward too. gloo's collectives cannot be captured, so
a gloo world on the card runs its epochs eagerly, as the CPU does, and
says so.
"""

import collections
import time

import numpy as np
import torch
import torch.distributed as dist

from mst_tpu_torch import io
from mst_tpu_torch.ops.kernels import launches
from mst_tpu_torch.ops.sampling import Draws
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.train.steps import make_eval_step, make_train_step

# chunks are capped so the per-chunk snapshots (chunk x trainable) and the
# early stop's overshoot (at most chunk - 1 epochs) stay small
MAX_CHUNK = 32
# torch.cuda.set_sync_debug_mode for a chunk's replays (chip_smoke sets
# "error" to show that a chunk syncs only where it reads its results)
REPLAY_SYNC_DEBUG = 0


def chunk_size(save_every_n, cap=MAX_CHUNK):
    """Largest chunk <= cap that divides save_every_n, so the periodic
    train-state saves (which need the optimizer state, current only at
    chunk ends) land on a chunk boundary."""
    save_every_n = max(int(save_every_n), 1)
    if save_every_n <= cap:
        return save_every_n
    for c in range(cap, 0, -1):
        if save_every_n % c == 0:
            return c
    return 1


def pack_batches(batches, semantic_for, homography_for=None):
    """A list of same-shape scene batches as one stageable struct (numpy):
    per-batch arrays stacked on a leading axis, and the scenes' semantic
    maps deduplicated into one (S, H, W, C) stack that each row indexes by
    'scene_idx'. semantic_for(batch) -> (1, H, W, C) array;
    homography_for(scene_id) -> (3, 3) adds 'homography'.

    -> (per_batch dict of (N, ...) arrays, scenes) or None when the
    batches cannot be fused: none, several (H, W) shapes, or cross-scene
    bucketed batches (they carry their own scene stacks)."""
    if not batches:
        return None
    if any(hasattr(b, "scene_idx") for b in batches):
        return None
    if len({(b.trajectories.shape, b.mask.shape) for b in batches}) != 1:
        return None
    scene_order, scene_of = [], {}
    for b in batches:
        if b.scene_id not in scene_of:
            scene_of[b.scene_id] = len(scene_order)
            scene_order.append(b)
    scenes = [np.asarray(semantic_for(b)) for b in scene_order]
    if len({s.shape for s in scenes}) != 1:
        return None
    scenes = np.stack([s[0] for s in scenes])  # (S, H, W, C)
    B = batches[0].mask.shape[0]
    per_batch = {
        "traj": np.stack([np.asarray(b.trajectories) for b in batches]),
        "mask": np.stack([np.asarray(b.mask) for b in batches]),
        "scene_idx": np.stack([np.full((B,), scene_of[b.scene_id], np.int32)
                               for b in batches]),
    }
    if homography_for is not None:
        per_batch["homography"] = np.stack(
            [np.asarray(homography_for(b.scene_id), np.float32)
             for b in batches])
    return per_batch, scenes


def stage_data(per_batch, scenes, device, shards=None):
    """A pack on the device, once for the run: its arrays as tensors
    ('scene_idx' as int64, for index_select) and 'scenes'. With shards
    (a parallel.mesh.Shards), each batch's rows are this rank's (axis 1;
    'homography' is a batch's, and whole)."""
    out = {}
    for k, v in per_batch.items():
        v = np.asarray(v)
        if shards is not None and k != "homography":
            v = v[:, slice(*shards.rows(v.shape[1] // shards.count))]
        out[k] = torch.as_tensor(v, device=device)
    out["scene_idx"] = out["scene_idx"].long()
    out["scenes"] = torch.as_tensor(np.asarray(scenes), device=device)
    return out


def index_batch(data, idx):
    """Batch idx (a 1-element int64 tensor on the data's device) of a
    staged pack as the loop's step batch: 'semantic' the batch's scene map
    (1, H, W, C), 'traj', 'mask' and, where packed, 'homography'."""
    b = {k: data[k].index_select(0, idx)[0]
         for k in ("traj", "mask", "homography") if k in data}
    b["semantic"] = data["scenes"].index_select(
        0, data["scene_idx"].index_select(0, idx)[0, :1])
    return b


def _stats(m):
    return torch.stack([m["loss"], m["ade_sum"], m["fde_sum"], m["n"]])


def _val_rows(out):
    return torch.stack([out["mask"], out["ade"], out["fde"]])


def to_host(tensors):
    """Device tensors -> CPU copies, in one device-to-host read of their
    bytes."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu()
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


def make_epoch_runner(mcfg, scfg_train, scfg_val, opt_factory):
    """One epoch with parameters in and out and the data, the validation
    draws and the learning rate as arguments, so the grid
    (mst_tpu_torch.grid) can vmap it over a run axis (mst_tpu's
    make_epoch_runner):

      run(trainable, frozen, state, opt_state, perm, noise, lr,
          train_data, val_data) -> (trainable, state, opt_state, stats, val)

    trainable and frozen are {path: tensor}; opt_factory(lr) ->
    optim.Functional (lr a 0-d tensor, so one runner serves every learning
    rate); perm (n_train,) int64 the epoch's batch order; noise, for each
    validation batch, the list of its draws (ops/sampling.Draws); stats
    (n_train, 4): each step's loss, ade_sum, fde_sum and n; val (n_val, 3,
    B): each validation batch's mask, ADE and FDE rows. The train steps
    are make_train_step's functional form; validation runs with the
    epoch's trainable leaves and state."""
    train_step = make_train_step(mcfg, scfg_train)
    eval_step = make_eval_step(mcfg, scfg_val)

    def run(trainable, frozen, state, opt_state, perm, noise, lr,
            train_data, val_data):
        update = opt_factory(lr).update
        stats = []
        for i in range(perm.shape[0]):
            trainable, state, opt_state, m = train_step.functional(
                trainable, frozen, state, opt_state, update,
                index_batch(train_data, perm[i:i + 1]))
            stats.append(_stats(m))
        params = io.unflatten({**frozen, **trainable})
        idx = torch.arange(len(noise), device=perm.device)
        val = [_val_rows(eval_step(params, state,
                                   index_batch(val_data, idx[i:i + 1]),
                                   Draws(draws)))
               for i, draws in enumerate(noise)]
        return trainable, state, opt_state, torch.stack(stats), \
            torch.stack(val)

    return run


def clone_tree(tree):
    """A nested dict of tensors, each cloned."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def copy_tree(dst, src):
    """Copy src's leaves into dst's (the same paths), in place."""
    src = io.flatten(src)
    for k, v in io.flatten(dst).items():
        v.copy_(src[k])


class FusedEpochs:
    """The single-run chunk runner of Experiment.train(--fused)
    (mst_tpu's make_fused_epochs): the loop's own train step and
    optimizer, updating the run's parameters and Adam in place.

      run(params, state, perms, epochs) -> (state, ys)

    params is the Experiment's tree (its trainable leaves are the
    optimizer's); perms (C, n_train) the chunk's batch orders (the loop's
    per-epoch shuffles); epochs (C,) their indices, which seed the
    validation draws (val_seed(epoch, i), as the loop seeds them). ys:
    'stats' (C, n_train, 4) and 'val' (C, n_val, 3, B) numpy arrays from
    one device-to-host read, and the epochs' 'snapshot's (the trainable
    leaves, {path: tensor}) and 'state's, on the device.

    On a CUDA device the first chunk captures one epoch as a CUDA graph
    (after one warm-up train step and validation batch on the capture
    stream, whose effects are undone) and every epoch is a replay; a
    capture or launch failure raises. On the CPU the same epoch runs
    eagerly, drawing validation from the loop's generators, and so does
    a mesh whose collectives cannot be captured (gloo's) on the card.
    mesh: the run's data-parallel mesh; the data is this rank's rows
    (stage_data)."""

    def __init__(self, mcfg, scfg_train, scfg_val, optimizer, val_seed,
                 train_data, val_data, named, mesh=None):
        self.train_step = make_train_step(mcfg, scfg_train, mesh)
        self.eval_step = make_eval_step(mcfg, scfg_val, mesh)
        self.optimizer = optimizer
        self.val_seed = val_seed
        self.train_data = train_data
        self.named = named  # {path: trainable leaf}
        self.device = train_data["traj"].device
        self.n_train = train_data["traj"].shape[0]
        idx = torch.arange(val_data["traj"].shape[0], device=self.device)
        self.val_batches = [index_batch(val_data, idx[i:i + 1])
                            for i in range(len(idx))]
        self.graph = None
        self.capture_seconds = 0.0
        self.replays = 0
        self.captured = (self.device.type == "cuda"
                         and mesh_lib.capturable(mesh))
        if self.device.type == "cuda" and not self.captured:
            print(f"--fused: the {dist.get_backend()} backend's collectives "
                  f"cannot be captured in a CUDA graph; the epochs run "
                  f"eagerly")

    def epoch(self, params, state, perm, gens):
        """One epoch, eagerly or under capture -> (state, stats, val)."""
        stats = []
        for i in range(self.n_train):
            state, m = self.train_step(params, state, self.optimizer,
                                       index_batch(self.train_data,
                                                   perm[i:i + 1]))
            stats.append(_stats(m))
        val = [_val_rows(self.eval_step(params, state, vb, g))
               for vb, g in zip(self.val_batches, gens)]
        return state, torch.stack(stats), torch.stack(val)

    def __call__(self, params, state, perms, epochs):
        perms = torch.as_tensor(np.asarray(perms, np.int64),
                                device=self.device)
        captured = self.captured
        if captured:
            if self.graph is None:
                self._capture(params, state)
            copy_tree(self.state, state)
            sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(REPLAY_SYNC_DEBUG)
        stats, val, snaps, states = [], [], [], []
        try:
            for j, e in enumerate(epochs):
                if captured:
                    state, s, v = self._replay(perms[j], int(e))
                else:
                    state, s, v = self.epoch(params, state, perms[j], [
                        torch.Generator(self.device).manual_seed(
                            self.val_seed(int(e), i))
                        for i in range(len(self.val_batches))])
                stats.append(s.clone())
                val.append(v.clone())
                snaps.append({k: v.detach().clone()
                              for k, v in self.named.items()})
                states.append(state)
        finally:
            if captured:
                torch.cuda.set_sync_debug_mode(sync_mode)
        stats, val = to_host([torch.stack(stats), torch.stack(val)])
        return state, {"stats": stats.numpy(), "val": val.numpy(),
                       "snapshot": snaps, "state": states}

    def _replay(self, perm, e):
        """Epoch e as a replay: its batch order and validation draws into
        the static buffers first -> (state, stats, val), the state a copy
        of the graph's."""
        self.perm.copy_(perm)
        for i, bufs in enumerate(self.noise):
            gen = self.gens[i].manual_seed(self.val_seed(e, i))
            for buf in bufs:
                buf.exponential_(generator=gen)
        self.graph.replay()
        self.replays += 1
        return (clone_tree(self.state),) + self.out

    def _capture(self, params, state):
        """Warm up on the capture stream (one train step and one
        validation batch: the kernels' libraries, the fused kernel's
        arrival counters on this stream, the gradients' buffers, the
        validation draws' shapes), undo the step, then capture one epoch:
        its inputs are the static perm, state and noise buffers, its
        outputs self.out (stats, val)."""
        t0 = time.perf_counter()
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        opt = self.optimizer
        with torch.cuda.stream(stream):
            self.perm = torch.zeros(self.n_train, dtype=torch.long,
                                    device=dev)
            self.state = clone_tree(state)
            live = {"p": dict(self.named), "count": {"c": opt.count},
                    "m": {f"{i}/{k}": t for i, s in enumerate(
                        opt.state.values()) for k, t in s.items()}}
            saved = clone_tree(live)
            st, _ = self.train_step(params, clone_tree(state), opt,
                                    index_batch(self.train_data,
                                                self.perm[:1]))
            rec = Draws(generator=torch.Generator(dev).manual_seed(0))
            self.eval_step(params, st, self.val_batches[0], rec)
            with torch.no_grad():
                copy_tree(live, saved)
            self.noise = [[torch.empty_like(t) for t in rec.drawn]
                          for _ in self.val_batches]
            self.gens = [torch.Generator(dev) for _ in self.val_batches]
        torch.cuda.current_stream(dev).wait_stream(stream)

        def epoch():
            st, stats, val = self.epoch(params, self.state, self.perm,
                                        [Draws(n) for n in self.noise])
            copy_tree(self.state, st)
            return stats, val

        graph = launches.Graph()
        self.out = graph.capture(epoch, stream)
        self.graph = graph
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0


class Selection:
    """Incremental replica of the loop's smooth-val / early-stop /
    best-checkpoint bookkeeping (Experiment.train's finish_epoch), fed one
    (epoch, val_ade) at a time; the grid trains its runs in lockstep and
    applies each run's selection as epochs stream out (a copy of
    mst_tpu/train/fused.py:Selection).

    After step(e, v) returns True (early stop) or the series ends:
    `best_epoch` is the reported label, `best_snap` the epoch whose
    post-update snapshot was selected (None: keep the final parameters),
    `stopped` whether the early stop fired. live_snapshots() lists every
    epoch a later selection could still pick."""

    def __init__(self, *, smooth_val, window_size, fine_tune,
                 n_early_stop):
        self.smooth_val = bool(smooth_val)
        self.window_size = int(window_size)
        self.half_window = self.window_size // 2 + 1
        self.fine_tune = bool(fine_tune)
        self.n_early_stop = int(n_early_stop)
        self.vals = []
        self.best = float("inf")
        self.best_epoch = 0
        self.best_snap = None
        self.snaps = collections.deque()
        self.stopped = False

    def step(self, e, val_ade):
        self.vals.append(float(val_ade))
        if self.smooth_val:
            current = (self.snaps.popleft()
                       if len(self.snaps) == self.half_window else None)
            self.snaps.append(e)
            if e < self.window_size:
                sel = self.best + 1
            else:
                sel = (sum(self.vals[-self.window_size:])
                       / self.window_size)
        else:
            current = e
            sel = val_ade
        if sel < self.best and current is not None:
            self.best = sel
            self.best_epoch = (e - self.half_window + 1 if self.smooth_val
                               else e)
            self.best_snap = current
        if self.fine_tune and self.vals and \
                self.best < min(self.vals[-self.n_early_stop:]):
            self.stopped = True
        return self.stopped

    def live_snapshots(self):
        live = set(self.snaps)
        if self.best_snap is not None:
            live.add(self.best_snap)
        if self.vals:
            live.add(len(self.vals) - 1)
        return live


def replay_selection(val_ades, *, smooth_val, window_size, fine_tune,
                     n_early_stop):
    """Selection over a completed val-ADE series -> (stop_epoch,
    best_epoch, best_snapshot_epoch): the last epoch that ran, the
    reported best label, and the epoch whose snapshot was selected (None
    when none was)."""
    sel = Selection(smooth_val=smooth_val, window_size=window_size,
                    fine_tune=fine_tune, n_early_stop=n_early_stop)
    for e, v in enumerate(val_ades):
        if sel.step(e, v):
            return e, sel.best_epoch, sel.best_snap
    return len(val_ades) - 1, sel.best_epoch, sel.best_snap
