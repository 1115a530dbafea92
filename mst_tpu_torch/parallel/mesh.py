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
('data',) or ('replica', 'data'), whose ranks are the whole world: the
product of --mesh_shape must equal the world size. The hybrid mesh is
node-aware, as mst_tpu's is slice-aware: each 'replica' row takes its
ranks from one host. The backend follows from the devices: NCCL when
each rank has a card of its own, gloo on the CPU, and gloo on CUDA
tensors when two ranks hold one card (NCCL refuses two ranks on one
device), which the ranks find by comparing their cards' uuids. A
failed init raises; nothing falls back.

The spatial ('data', 'space') mesh is not ported yet (SPATIAL_NOT_PORTED).
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

# scene-level batch keys: every rank holds them whole; every other key is
# per row and splits over the ranks (hostdata.take_local,
# pad_batch_to_multiple)
REPLICATED_KEYS = ("semantic", "image", "homography")

SPATIAL_NOT_PORTED = (
    "--mesh_axes data space (the spatial mesh) is not ported yet; it is "
    "the next slice of the port: the halo exchanges of the 3x3 convs, the "
    "bilinear x2 and the rasterizer, and an H-sharded soft-argmax that "
    "merges the kernels' online statistics across ranks. Use --mesh_shape "
    "N or --mesh_shape R D (--mesh_axes replica data)")


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


def mesh_from_shape(mesh_shape, axis_names=None, device="cuda"):
    """--mesh_shape (and --mesh_axes) to a mesh: one value -> a 1-D 'data'
    mesh, two -> the hybrid (replica, data) mesh; None -> no mesh. The
    spatial ('data', 'space') mesh raises NotImplementedError; a shape
    that is not the world raises ValueError before any process group
    starts."""
    if mesh_shape is None:
        return None
    shape = tuple(int(s) for s in mesh_shape)
    if axis_names is not None:
        names = tuple(axis_names)
        if len(names) != len(shape):
            raise ValueError(
                f"--mesh_axes {names} must match --mesh_shape {shape}")
        if names == ("data", "space"):
            raise NotImplementedError(SPATIAL_NOT_PORTED)
        if names not in (("data",), ("replica", "data")):
            raise ValueError(
                f"unsupported --mesh_axes {names}: expected 'data', "
                "'replica data', or 'data space'")
    if len(shape) not in (1, 2):
        raise ValueError(f"--mesh_shape takes 1 or 2 values, got {shape}")
    check_world(shape)
    if len(shape) == 1:
        return make_mesh(shape, device=device)
    return make_hybrid_mesh(*shape, device=device)


def batch_axes(mesh):
    """The mesh axes the batch splits over: all of a non-spatial mesh's."""
    return tuple(a for a in mesh.mesh_dim_names if a != "space")


def batch_shard_count(mesh):
    """How many blocks the batch splits into."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in batch_axes(mesh))


class Shards:
    """This rank's block of the batch over a mesh, and the reductions a
    step makes over the ranks (batch_shards). The block is the rank's
    place in the mesh, row-major over its axes (index of count); the
    reductions run over the whole world, which a non-spatial mesh covers.
    Every rank holds the same number of rows."""

    def __init__(self, index, count):
        self.index, self.count = int(index), int(count)

    def rows(self, n_local):
        """This rank's rows [lo, hi) of the global batch, given its own
        row count."""
        lo = self.index * n_local
        return lo, lo + n_local

    def all_reduce(self, t):
        """t summed over the ranks, in place -> t."""
        dist.all_reduce(t)
        return t

    def sum_(self, tensors):
        """Each tensor (one dtype) summed over the ranks in place, in one
        collective."""
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def sum_differentiable(self, t):
        """t summed over the ranks, as an autograd op whose backward sums
        the gradient over the ranks."""
        return _SumOverRanks.apply(t)

    def gather_rows(self, t):
        """This rank's rows of t (axis 0) -> the global batch's rows in
        global order, on every rank: each rank places its rows in zeros
        and one sum joins them, which every backend can do on CUDA
        tensors (gloo gathers none)."""
        lo, hi = self.rows(t.shape[0])
        out = t.new_zeros((t.shape[0] * self.count, *t.shape[1:]))
        out[lo:hi] = t
        return self.all_reduce(out)


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum of the ranks'
    gradients: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def batch_shards(mesh):
    """The Shards of this rank on a mesh (None for None)."""
    if mesh is None:
        return None
    ranks = mesh.mesh.flatten().tolist()
    return Shards(ranks.index(dist.get_rank()), len(ranks))


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
