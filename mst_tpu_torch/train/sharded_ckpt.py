"""Checkpoints written by every rank of a mesh (counterpart of
mst_tpu/train/sharded_ckpt.py, which uses orbax).

The npz + JSON format (io.py, Experiment.save_params) is the parity
format: one file in the JAX package's layout, which rank 0 writes. This
one is torch.distributed.checkpoint with a filesystem writer: every rank
takes part in a save, a leaf that every rank holds (a replicated one) is
written once, and a restore reads into a template's tensors in place,
in any world: one that a world of 2 saved restores into a world of 1,
and the other way round. Without a process group it runs in one process.
"""

import torch.distributed.checkpoint as dcp

from mst_tpu_torch import io


def save_sharded(path, tree):
    """Write a nested dict of tensors to the directory `path` (made if
    missing); every rank of the world calls it with its own tree."""
    dcp.save(io.flatten(tree), storage_writer=dcp.FileSystemWriter(path))


def restore_sharded(path, template):
    """Read the checkpoint at `path` into the leaves of `template` (a
    nested dict of tensors of the saved paths and shapes, whose values are
    overwritten in place) -> template."""
    flat = io.flatten(template)
    dcp.load(flat, storage_reader=dcp.FileSystemReader(path))
    return template
