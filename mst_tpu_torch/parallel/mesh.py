"""Device mesh and the data-parallel reductions (counterpart of
mst_tpu/parallel/mesh.py).

mst_tpu runs one program over a jax.sharding.Mesh: the batch axis shards
over every non-spatial mesh axis, parameters and optimizer state
replicate, and XLA emits the collectives, so a step computes on a mesh
exactly what it computes on one device. PyTorch's idiom is one process
per device, launched by torchrun: every rank holds the whole model and
computes on its block of the global batch, and the steps reduce over the
ranks whatever jit's global semantics would have computed (Shards: the
masked BCE's count, the gradients, the metric sums, the per-row outputs,
and the serial adapters' train-mode batch statistics).

A mesh is a torch.distributed DeviceMesh with mst_tpu's axis names,
('data',), ('replica', 'data') or ('data', 'space'), whose ranks are the
whole world: the product of --mesh_shape must equal the world size. The
hybrid mesh is node-aware, as mst_tpu's is slice-aware: each 'replica'
row takes its ranks from one host. The spatial mesh splits the batch over
'data' and the scene maps' H over 'space' (Slab: a rank's rows of every
map, and the collectives of the 'space' ranks, parallel/halo.py); each
'data' row takes its 'space' ranks from one host, as mst_tpu's takes its
chips from one slice. The backend follows from the devices: NCCL when
each rank has a card of its own, gloo on the CPU, and gloo on CUDA
tensors when two ranks hold one card (NCCL refuses two ranks on one
device), which the ranks find by comparing their cards' uuids. A
failed init raises; nothing falls back.

On the spatial mesh the port evaluates (Experiment.test, the test CLI)
and trains (Experiment.train, the train CLI, --fused): each rank computes
its share of the global loss, its 'data' block of the rows on its slab
of the maps, and the gradients are summed over every rank of the world
(sum_), while the BCE's row count and the metric sums reduce over the
'data' ranks (Shards) and a train-mode batch norm over whichever ranks
hold its level's batch (Shards.spanning).
"""

import contextlib
import math
import os
import socket
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mst_tpu_torch.parallel import halo

# scene-level batch keys: every rank holds them whole; every other key is
# per row and splits over the ranks (hostdata.take_local,
# pad_batch_to_multiple)
REPLICATED_KEYS = ("semantic", "image", "homography")

def world_size():
    """The world's size: the process group's, else torchrun's WORLD_SIZE
    (1 without one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_world(shape):
    """Raise unless the mesh shape covers the world exactly."""
    n, world = math.prod(shape), world_size()
    if n != world:
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, shape))} spans {n} ranks but "
            f"the world has {world} process(es); launch "
            f"`torchrun --nproc_per_node {n}` (one process per device)")


def card_id(device) -> str:
    """This rank's card: its host and the CUDA device's uuid (a card
    shows the same uuid to every process that sees it, whatever
    CUDA_VISIBLE_DEVICES numbers it)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    uuid = torch.cuda.get_device_properties(index).uuid
    return f"{socket.gethostname()}/{uuid}"


def choose_backend(device, store, rank: int, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo: on the CPU,
    and when two ranks hold one card (NCCL refuses two ranks on one
    device). Each rank puts its card_id into the rendezvous store and
    reads every rank's, so every rank picks the same backend."""
    if torch.device(device).type != "cuda":
        return "gloo"
    store.set(f"mesh/card/{rank}", card_id(device))
    cards = [store.get(f"mesh/card/{r}").decode() for r in range(world)]
    return "nccl" if len(set(cards)) == world else "gloo"


def init_process_group(device="cuda", init_method=None) -> str:
    """Join the world torchrun describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; LOCAL_RANK picks this rank's card, cuda:LOCAL_RANK modulo
    the cards it sees, made current) -> the backend (choose_backend, over
    the rendezvous' store). A world of one without torchrun needs no
    address. Does nothing if the group exists."""
    if dist.is_initialized():
        return dist.get_backend()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    world, rank = world_size(), int(os.environ.get("RANK", "0"))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise RuntimeError(
                f"a world of {world} needs its rendezvous (MASTER_ADDR and "
                "MASTER_PORT, as torchrun sets them)")
        store = dist.HashStore()
    else:
        store, rank, world = next(dist.rendezvous(
            init_method or "env://", rank, world))
    backend = choose_backend(device, store, rank, world)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank, world_size=world)
    if rank == 0:
        print(f"[mesh] {world} process(es), backend {backend}, device "
              f"{device.type}", flush=True)
    return backend


def shutdown():
    """Leave the world: free every captured CUDA graph (launches.
    release_graphs), then destroy the process groups; nothing without a
    world. NCCL cannot destroy a communicator while a graph that captured
    its collectives lives: destroy_process_group then waited on every
    rank for ever after a --fused run on a spatial mesh of 4 cards."""
    if not dist.is_initialized():
        return
    from mst_tpu_torch.ops.kernels import launches

    launches.release_graphs()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()


@contextlib.contextmanager
def rank_zero_prints():
    """A context in which only rank 0 of a torchrun world (RANK) prints:
    the other ranks' stdout goes to os.devnull."""
    if int(os.environ.get("RANK", "0")) == 0:
        yield
        return
    with open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        yield


def make_mesh(mesh_shape=None, axis_names=("data",), device="cuda"):
    """A 1-D mesh over the world; default: every rank on one 'data'
    axis."""
    init_process_group(device)
    shape = (dist.get_world_size(),) if mesh_shape is None \
        else tuple(mesh_shape)
    check_world(shape)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def hybrid_layout(hosts, n_replicas, per_replica):
    """The ranks of a (replica, data) mesh, (n_replicas, per_replica),
    from each rank's host: each row takes its ranks from one host (rows
    may share a host), hosts in the order of their first rank. A shape
    that does not align with the hosts warns and falls back to row-major
    order, whose 'data' rows may cross hosts; one host takes row-major
    order silently."""
    by_host = {}
    for rank, host in enumerate(hosts):
        by_host.setdefault(host, []).append(rank)
    if len(by_host) > 1:
        if all(len(r) % per_replica == 0 for r in by_host.values()):
            return np.asarray([ranks[i:i + per_replica]
                               for ranks in by_host.values()
                               for i in range(0, len(ranks), per_replica)])
        warnings.warn(
            f"hybrid mesh {n_replicas}x{per_replica}: the ranks span "
            f"{len(by_host)} hosts but the shape does not align with them "
            f"(ranks a host: { {h: len(r) for h, r in by_host.items()} }); "
            f"falling back to row-major order, whose 'data' rows may cross "
            f"hosts", stacklevel=2)
    return np.arange(n_replicas * per_replica).reshape(n_replicas,
                                                       per_replica)


def hostnames():
    """Each rank's hostname, in rank order (a collective)."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts


def host_count():
    """How many hosts the world spans (a collective)."""
    return len(set(hostnames()))


def make_hybrid_mesh(n_replicas=None, per_replica=None,
                     axis_names=("replica", "data"), device="cuda"):
    """A (replica, data) mesh whose rows each lie on one host
    (hybrid_layout of the ranks' hostnames); default: a row a host."""
    init_process_group(device)
    hosts = hostnames()
    if n_replicas is None:
        n_replicas = len(set(hosts))
    if per_replica is None:
        per_replica = len(hosts) // n_replicas
    check_world((n_replicas, per_replica))
    layout = hybrid_layout(hosts, n_replicas, per_replica)
    return DeviceMesh(torch.device(device).type, torch.as_tensor(layout),
                      mesh_dim_names=tuple(axis_names))


def make_spatial_mesh(data, space, device="cuda"):
    """A ('data', 'space') mesh (mst_tpu/parallel/mesh.py:88-128): the
    batch splits over 'data', the scene maps' H over 'space'. A halo
    exchange crosses 'space' at every conv, the batch's reductions cross
    'data' once a step, so each 'data' row takes its 'space' ranks from
    one host (hybrid_layout of the ranks' hostnames; rows may share a
    host). A world that spans several hosts raises (hostdata.
    check_spatial_hosts, mst_tpu's refusal)."""
    from mst_tpu_torch.parallel.hostdata import check_spatial_hosts

    init_process_group(device)
    check_world((data, space))
    hosts = hostnames()
    check_spatial_hosts(hosts)
    layout = hybrid_layout(hosts, data, space)
    return DeviceMesh(torch.device(device).type, torch.as_tensor(layout),
                      mesh_dim_names=("data", "space"))


def mesh_from_shape(mesh_shape, axis_names=None, device="cuda"):
    """--mesh_shape (and --mesh_axes) to a mesh: one value -> a 1-D 'data'
    mesh, two -> the hybrid (replica, data) mesh, or the spatial
    ('data', 'space') mesh when --mesh_axes says so; None -> no mesh. A
    shape that is not the world raises ValueError before any process
    group starts."""
    if mesh_shape is None:
        return None
    shape = tuple(int(s) for s in mesh_shape)
    if axis_names is not None:
        names = tuple(axis_names)
        if len(names) != len(shape):
            raise ValueError(
                f"--mesh_axes {names} must match --mesh_shape {shape}")
        if names not in (("data",), ("replica", "data"), ("data", "space")):
            raise ValueError(
                f"unsupported --mesh_axes {names}: expected 'data', "
                "'replica data', or 'data space'")
    if len(shape) not in (1, 2):
        raise ValueError(f"--mesh_shape takes 1 or 2 values, got {shape}")
    check_world(shape)
    if len(shape) == 1:
        return make_mesh(shape, device=device)
    if axis_names is not None and tuple(axis_names) == ("data", "space"):
        return make_spatial_mesh(*shape, device=device)
    return make_hybrid_mesh(*shape, device=device)


def is_spatial(mesh):
    """Whether the mesh splits the scene maps' H (a 'space' axis)."""
    return mesh is not None and "space" in mesh.mesh_dim_names


def batch_axes(mesh):
    """The mesh axes the batch splits over: all but 'space'."""
    return tuple(a for a in mesh.mesh_dim_names if a != "space")


def axis_size(mesh, name):
    """The size of the mesh's axis `name`."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def batch_shard_count(mesh):
    """How many blocks the batch splits into."""
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))


class Shards:
    """This rank's block of the batch over a mesh, and the reductions a
    step makes over the ranks (batch_shards). The block is the rank's
    place in the mesh's batch axes, row-major (index of count); the
    reductions run over `group`: the whole world (None), which a
    non-spatial mesh covers, or a spatial mesh's 'data' ranks, so that
    the 'space' ranks of a row, which hold the same rows, count them
    once. Every rank holds the same number of rows."""

    def __init__(self, index, count, group=None):
        self.index, self.count = int(index), int(count)
        self.group = group

    def rows(self, n_local):
        """This rank's rows [lo, hi) of the global batch, given its own
        row count."""
        lo = self.index * n_local
        return lo, lo + n_local

    def all_reduce(self, t):
        """t summed over the ranks, in place -> t."""
        dist.all_reduce(t, group=self.group)
        return t

    def spanning(self, slab):
        """The Shards of a batch whose maps the 'space' ranks split as
        `slab` does: every rank of the world holds a block (its rows of
        the batch, its slab's rows of the maps), count the 'data' ranks x
        the 'space' ranks. A train-mode batch norm at a sliced level takes
        its statistics over it; at a level that runs whole, every 'space'
        rank holds the same map and the 'data' ranks' Shards serves."""
        return Shards(self.index, self.count * slab.count)

    def sum_differentiable(self, t):
        """t summed over the ranks, as an autograd op whose backward sums
        the gradient over the ranks."""
        return _SumOverRanks.apply(t, self.group)

    def gather_rows(self, t):
        """This rank's rows of t (axis 0) -> the global batch's rows in
        global order, on every rank: each rank places its rows in zeros
        and one sum joins them, which every backend can do on CUDA
        tensors (gloo gathers none)."""
        return halo.gather(t, self.index, self.count, self.group)


def sum_(tensors, group=None):
    """Each tensor (one dtype) summed over the ranks of `group` (None: the
    world) in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum of the ranks'
    gradients: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_shards(mesh):
    """The Shards of this rank on a mesh (None for None): on a spatial
    mesh its 'data' coordinate, over the 'data' ranks of its 'space'
    column."""
    if mesh is None:
        return None
    if is_spatial(mesh):
        return Shards(mesh.get_local_rank("data"), axis_size(mesh, "data"),
                      mesh.get_group("data"))
    ranks = mesh.mesh.flatten().tolist()
    return Shards(ranks.index(dist.get_rank()), len(ranks))


def check_spatial_scene(mesh, key, value):
    """Raise unless a scene map's H (axis 1) divides the mesh's 'space'
    count (mst_tpu/parallel/mesh.py:189-203, its message); nothing on a
    mesh without one."""
    if not is_spatial(mesh):
        return
    s = axis_size(mesh, "space")
    h = np.shape(value)[1]
    if h % s != 0:
        raise ValueError(
            f"scene map '{key}' height {h} does not divide the mesh's "
            f"'space' axis ({s}); pick a space count that divides the "
            f"/32-padded scene heights (powers of two <= 32 always do)")


class Slab:
    """This rank's rows [lo, hi) of a map of global height `height` on a
    spatial mesh: 'space' rank `index` of `count` holds block `index` of
    height // count rows, at the finest level and at each coarser one
    whose slab has even rows (levels, down). `group` is the 'space'
    ranks' process group, over which the exchanges of parallel/halo.py
    run."""

    def __init__(self, index, count, group, height):
        if height % count:
            raise ValueError(f"a map of height {height} does not split "
                             f"over {count} 'space' ranks")
        self.index, self.count, self.group = int(index), int(count), group
        self.height = int(height)
        self.rows = self.height // self.count
        self.lo, self.hi = self.index * self.rows, (self.index + 1) * \
            self.rows

    def half(self):
        """The slab of a 2x2 pool of this one (its rows must be even)."""
        return Slab(self.index, self.count, self.group, self.height // 2)

    def down(self):
        """The slab of the next coarser level, or None where that level
        runs whole on every 'space' rank (ops/pooling.pool_down): when
        this slab's rows are odd, a pool would straddle two ranks; when
        the pooled slab's rows would be odd, its own pool would. The
        levels coarser than the first whole one are whole too."""
        if self.rows % 4:
            return None
        return self.half()

    def levels(self, n):
        """[this slab, the next level's, ...]: n entries, None from the
        first level that runs whole."""
        out = [self]
        while len(out) < n:
            out.append(None if out[-1] is None else out[-1].down())
        return out

    def take(self, x, dim=1):
        """This slab's rows of a whole map (dim: H)."""
        return x.narrow(dim, self.lo, self.rows)

    def gather(self, x, dim=1):
        """Every 'space' rank's slab (dim: H) -> the whole map, on every
        one of them (halo.gather)."""
        return halo.gather(x, self.index, self.count, self.group, dim)

    def exchange(self, x, k, edge="zero"):
        """x with k rows of each H neighbour's slab above and below, or
        k = (above, below) (halo.exchange)."""
        return halo.exchange(x, self, k, edge)

    def sum_differentiable(self, t):
        """t summed over the 'space' ranks, as an autograd op whose
        backward sums the gradient over them (a train-mode batch norm of
        a map that the 'space' ranks alone split: the backbone's)."""
        return _SumOverRanks.apply(t, self.group)


def space_slab(mesh, height):
    """This rank's Slab of a map of global height `height` on a spatial
    mesh; None on any other mesh (or none)."""
    if not is_spatial(mesh):
        return None
    return Slab(mesh.get_local_rank("space"), axis_size(mesh, "space"),
                mesh.get_group("space"), height)


def capturable(mesh):
    """Whether a CUDA graph can capture the mesh's collectives: NCCL's can
    (after one collective outside the capture), gloo's cannot."""
    return mesh is None or dist.get_backend() == "nccl"


def replicate_tree(mesh, tree):
    """Rank 0's values in every rank's leaves of a nested dict of tensors
    (in place; one broadcast a leaf) -> tree. Raises first if the ranks'
    trees differ in their leaves' paths, shapes or dtypes."""
    if mesh is None:
        return tree
    from mst_tpu_torch import io

    flat = io.flatten(tree)
    sig = [(k, tuple(v.shape), str(v.dtype)) for k, v in flat.items()]
    sigs = [None] * dist.get_world_size()
    dist.all_gather_object(sigs, sig)
    for rank, other in enumerate(sigs):
        if other != sig:
            diff = sorted(set(other) ^ set(sig))[:4]
            raise ValueError(f"rank {rank} holds another tree than rank "
                             f"{dist.get_rank()}: {diff}")
    for v in flat.values():
        dist.broadcast(v.detach(), src=0)
    return tree


def pad_batch_to_multiple(batch: dict, multiple: int):
    """Pad the row axis so it divides `multiple` (the ranks); padded rows
    carry mask 0, so they count nothing. Pads every non-scene key, so the
    per-row arrays stay aligned. Batches the trainer prepares are already
    sized by its batch_size round-up (Experiment.prepare_data); this serves
    batches fed to the steps directly."""
    n = batch["traj"].shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if k in REPLICATED_KEYS:
            continue
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.zeros((rem,) + v.shape[1:], v.dtype)])
    return out
