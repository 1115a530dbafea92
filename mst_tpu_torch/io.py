"""Weight bridge from the JAX package's checkpoints (counterpart of
mst_tpu/train/checkpoints.py:60-75, 111-148).

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
