"""Per-rank input (counterpart of mst_tpu/parallel/hostdata.py).

On a mesh every rank builds the same global batches from the same seed
and feeds only its block of rows:

- local_slice: the rows [lo, hi) of a global batch a rank owns (a
  contiguous block: rank index i of count owns block i, as
  mesh.Shards.rows places them);
- take_local: a global batch cut to a rank's rows, scene-level arrays
  kept whole (on a spatial mesh, Experiment cuts each scene map to the
  rank's H slab with mesh.Slab.take);
- shard_batch_global: a rank's rows as its tensors, after checking that
  they are a rank's share of the global batch;
- check_spatial_hosts: mst_tpu's refusal of a spatial mesh across
  hosts.

mst_tpu's prefetch_to_device has no counterpart: the port's loop uploads
every batch once a run, before its first epoch (Experiment's
_device_batches), so no stream of uploads runs beside the steps.
"""

import numpy as np
import torch
import torch.distributed as dist

from mst_tpu_torch.parallel.mesh import REPLICATED_KEYS, batch_shard_count


def _rank_and_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_slice(n_global: int, process_index=None, process_count=None):
    """Rows [lo, hi) of a length-n_global batch axis owned by block
    process_index of process_count (default: this rank of the world).
    n_global must divide by process_count (Experiment.prepare_data rounds
    batch_size up to it; mesh.pad_batch_to_multiple pads other
    batches)."""
    rank, world = _rank_and_world()
    pi = rank if process_index is None else int(process_index)
    pc = world if process_count is None else int(process_count)
    if n_global % pc != 0:
        raise ValueError(f"a batch of {n_global} rows does not split over "
                         f"{pc} ranks; pad it (mesh.pad_batch_to_multiple)")
    per = n_global // pc
    return pi * per, (pi + 1) * per


def take_local(batch: dict, process_index=None, process_count=None):
    """A global batch (a dict of arrays) cut to a rank's rows; scene-level
    arrays are kept whole."""
    lo, hi = local_slice(batch["traj"].shape[0], process_index,
                         process_count)
    return {k: v if k in REPLICATED_KEYS else v[lo:hi]
            for k, v in batch.items()}


def check_spatial_hosts(hosts):
    """Raise mst_tpu's refusal (mst_tpu/parallel/hostdata.py:84-100) when
    the ranks of a spatial mesh, given each rank's hostname, span several
    hosts: mst_tpu has no per-host scene loader for it, and the port adds
    no feature that mst_tpu lacks."""
    if len(set(hosts)) > 1:
        raise NotImplementedError(
            "multi-host spatial meshes are not supported by "
            "shard_batch_global: the 'space' axis would span "
            "processes and corrupt the scene-map assembly. "
            "Run the spatial axis within one host (e.g. "
            "'data' over hosts x 'space' over local chips is "
            "also unsupported until a per-host scene loader "
            "exists) or use a non-spatial mesh across hosts.")


def shard_batch_global(mesh, local_batch: dict, global_batch_size=None):
    """A rank's rows (arrays) -> its CPU tensors. global_batch_size, when
    given, pins the global row count, so that a batch which does not split
    over the ranks, or rows that are not one rank's share, fail here with
    mst_tpu's messages rather than as a shape error later. Scene-level
    keys are whole on every rank. The batch splits over the mesh's batch axes
    (the 'space' ranks of a row hold the same rows)."""
    n_proc = 1 if mesh is None else batch_shard_count(mesh)
    out = {}
    for k, v in local_batch.items():
        v = np.asarray(v)
        if k not in REPLICATED_KEYS and global_batch_size is not None:
            if global_batch_size % n_proc != 0:
                raise ValueError(
                    f"global_batch_size={global_batch_size} is not "
                    f"divisible by process_count={n_proc}; pad the global "
                    f"batch to a multiple of the process count first "
                    f"(pad_batch_to_multiple)")
            expect = global_batch_size // n_proc
            if v.shape[0] != expect:
                raise ValueError(
                    f"batch key '{k}': {v.shape[0]} local rows but "
                    f"global_batch_size={global_batch_size} over "
                    f"{n_proc} processes expects {expect}")
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out
