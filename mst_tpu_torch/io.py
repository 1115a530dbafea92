"""Weight bridge from the JAX package's checkpoints (counterpart of
mst_tpu/train/checkpoints.py:60-75, 111-148), and the Adam state of its
training-state file (adam_state_to_numpy / adam_state_from_numpy).

A checkpoint is a flat npz with '/'-joined keys ('encoder/stages/0/conv0/
weight'). Conv weights are HWIO there and OIHW here; LoRA factors
(loralib's shapes) and biases carry over unchanged. Floating leaves are
f32 here, integer leaves keep their dtype (the batch norms' int32
num_batches, which mst_tpu's serving refuses to see change).
"""

import os

import numpy as np
import torch


def flatten(tree, prefix=""):
    """Nested dict -> {'a/b/c': leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def unflatten(flat):
    """{'a/b/c': leaf} -> nested dict."""
    out = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def params_from_numpy(tree_or_flat, device="cpu"):
    """The JAX package's parameters (nested, or flat with '/' keys; numpy
    arrays) -> the port's nested dict of tensors (f32, integer leaves
    as they are), conv weights HWIO -> OIHW."""
    flat = flatten(tree_or_flat) if any(
        isinstance(v, dict) for v in tree_or_flat.values()) else tree_or_flat
    out = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32)
        if key.endswith("weight") and arr.ndim == 4:
            # contiguous OIHW, as init_ynet makes them (torch.tensor keeps
            # the strides of the transposed numpy view)
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        out[key] = torch.tensor(arr, device=device)
    return unflatten(out)


def params_to_numpy(params):
    """The inverse bridge: the port's tree -> the JAX package's flat
    {'a/b/c': np.ndarray}, conv weights OIHW -> HWIO, dtypes kept."""
    out = {}
    for key, val in flatten(params).items():
        arr = val.detach().cpu().numpy()
        if key.endswith("weight") and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        out[key] = arr
    return out


# The model state (the batch norms' running_mean, running_var and int32
# num_batches) has no 4-D 'weight' leaf, so the parameter bridge carries
# it unchanged: no transposes, num_batches int32 both ways.
state_from_numpy = params_from_numpy
state_to_numpy = params_to_numpy


def load_checkpoint(path):
    """-> flat {path: np.ndarray} (appends .npz if missing)."""
    p = str(path)
    if not p.endswith(".npz") and not os.path.exists(p):
        p += ".npz"
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def overlay(params, new, strict=False):
    """Copy-on-write overlay of `new` (a nested port tree, e.g. from
    params_from_numpy) onto `params`: the dicts along each overlaid path
    are copied, every other subtree is shared with `params`.

    Non-strict (load_state_dict(strict=False), reference
    trainer.py:588,606-614): keys unknown to `params` are skipped. strict
    raises on them. A shape mismatch always raises.
    """
    out = dict(params)
    for key, val in flatten(new).items():
        node, parts = out, key.split("/")
        for part in parts[:-1]:
            child = node.get(part)
            if not isinstance(child, dict):
                node = None
                break
            node[part] = node = dict(child)
        if node is None or parts[-1] not in node:
            if strict:
                raise KeyError(f"'{key}' does not exist in the parameters")
            continue
        old = node[parts[-1]]
        if tuple(old.shape) != tuple(val.shape):
            raise ValueError(f"'{key}': shape {tuple(val.shape)} does not "
                             f"match the parameters' {tuple(old.shape)}")
        node[parts[-1]] = val.to(device=old.device, dtype=old.dtype)
    return out


def load_separated(params, base_path, delta_path):
    """A base checkpoint, then an adapter delta over it, both non-strict
    (mst_tpu/train/checkpoints.py:143-148; reference trainer.py:606-614)."""
    for path in (base_path, delta_path):
        params = overlay(params, params_from_numpy(load_checkpoint(path)))
    return params


# ---------------------------------------------------------------------------
# the optimizer state of a training-state file (mst_tpu/train/trainer.py:
# 791-888): optax.adam(schedule)'s leaves in jax.tree_util order
# ---------------------------------------------------------------------------

def jax_leaf_order(keys):
    """The '/'-joined paths in the order jax.tree_util flattens their nested
    dict: each level's keys sorted. This sorts the paths' tuples of parts,
    not the joined strings, which differ where a key holds a character
    below '/'."""
    return sorted(keys, key=lambda k: tuple(k.split("/")))


def _to_jax_layout(key, arr):
    return arr.transpose(2, 3, 1, 0) if key.endswith("weight") and \
        arr.ndim == 4 else arr


def adam_state_to_numpy(named, optimizer):
    """The port's optimizer state (train/optim.Adam; SGD has no moments)
    over the trainable leaves `named` ({path: parameter}) -> optax.adam's
    leaves: the int32 count, the first moments (mu) and the second
    moments (nu), each in jax_leaf_order and the JAX layout (conv weights
    HWIO), then the schedule's int32 count when the LR has milestones
    (optax's piecewise_constant_schedule state). Both counts are the
    optimizer's `count`, the global step; a leaf without moments writes
    zeros, as optax has them for a leaf that never had a gradient."""
    count = np.asarray(int(optimizer.count), np.int32)
    moments = {"exp_avg": [], "exp_avg_sq": []}
    for key in jax_leaf_order(named):
        param = named[key]
        state = optimizer.state.get(param, {})
        for name, out in moments.items():
            m = state.get(name)
            arr = (np.zeros(tuple(param.shape), np.float32) if m is None
                   else m.detach().cpu().numpy())
            out.append(np.ascontiguousarray(_to_jax_layout(key, arr)))
    leaves = [count, *moments["exp_avg"], *moments["exp_avg_sq"]]
    if optimizer.milestones:
        leaves.append(count.copy())
    return leaves


def adam_state_from_numpy(leaves, named, optimizer):
    """The inverse: optax.adam's leaves (as adam_state_to_numpy gives them)
    copied into the optimizer's own buffers (the count, and exp_avg = mu,
    exp_avg_sq = nu of every leaf of `named` where it keeps moments), so
    the learning rate follows from the count."""
    keys = jax_leaf_order(named)
    n = len(keys)
    want = 1 + 2 * n + (1 if optimizer.milestones else 0)
    if len(leaves) != want:
        raise ValueError(f"an Adam state of {len(leaves)} leaves; "
                         f"{n} trainable leaves with"
                         f"{'' if optimizer.milestones else 'out'} a "
                         f"schedule need {want}")
    with torch.no_grad():
        optimizer.count.fill_(int(np.asarray(leaves[0])))
        for i, key in enumerate(keys):
            param = named[key]
            state = optimizer.state.get(param)
            for name, arr in (("exp_avg", leaves[1 + i]),
                              ("exp_avg_sq", leaves[1 + n + i])):
                arr = np.asarray(arr, np.float32)
                if key.endswith("weight") and arr.ndim == 4:
                    arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
                if tuple(arr.shape) != tuple(param.shape):
                    raise ValueError(f"'{key}': Adam moment of shape "
                                     f"{arr.shape}, the leaf is "
                                     f"{tuple(param.shape)}")
                if state is not None:
                    state[name].copy_(torch.from_numpy(arr))
