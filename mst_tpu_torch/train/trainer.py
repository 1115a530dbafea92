"""Fine-tune set-up and the checkpoint save (counterpart of
mst_tpu/train/trainer.py:88-116, 452-472; the Experiment loop, its data
pipeline and the CLIs are not ported yet).

setup_training marks the strategy's leaves trainable and builds Adam with
the fine-tune schedule; save_params writes the JAX package's npz (flat
'/'-joined keys, conv weights HWIO) and its JSON metadata sidecar, so a
delta saved here loads in mst_tpu and in serve.Predictor.add_style.
"""

import json
import os

import numpy as np
import torch

from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.train import freeze

# the metadata sidecar's keys (trainer.py:107-110)
METADATA_KEYS = ("train_net", "position", "network", "n_fusion", "seed",
                 "lr", "n_train_batch", "ynet_bias")


def setup_training(model_params, params_dict, steps_per_epoch: int):
    """Freeze split, Adam and its schedule for model_params (in place:
    requires_grad is set on every leaf).

    The schedule follows trainer.py:457-467: with fine_tune and steps,
    the LR is multiplied by lr_decay_ratio (default 0.1) from optimizer
    step m * steps_per_epoch on, for each distinct milestone m (optax's
    piecewise_constant_schedule takes a dict, so a repeated milestone
    decays once; MultiStepLR would decay twice). Otherwise the LR is
    constant. Step the scheduler once an optimizer step. On a CUDA device
    the f32 path is pinned (resolve_device).

    -> dict of trainable (the leaves), n_trainable, optimizer, scheduler.
    """
    leaf = next(iter(io.flatten(model_params).values()))
    resolve_device(leaf.device)
    trainable = freeze.set_trainable(
        model_params, params_dict.get("train_net", "train"),
        params_dict.get("position", ()), params_dict.get("ynet_bias", False))
    optimizer = torch.optim.Adam(trainable, lr=float(params_dict["lr"]))
    milestones = []
    if params_dict.get("fine_tune") and params_dict.get("steps"):
        spe = max(int(steps_per_epoch), 1)
        milestones = sorted({int(m) * spe for m in params_dict["steps"]})
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=milestones,
        gamma=float(params_dict.get("lr_decay_ratio", 0.1)))
    return dict(trainable=trainable,
                n_trainable=sum(p.numel() for p in trainable),
                optimizer=optimizer, scheduler=scheduler)


def save_params(path, model_params, params_dict):
    """The whole model for 'train'/'all', else the strategy's trainable
    leaves only (a delta: the leaves setup_training marked requires_grad),
    as mst_tpu's Experiment.save_params writes it (trainer.py:88-101,
    checkpoints.py:78-101): np.savez of the flat JAX layout at path, and
    the metadata at path + '.json'."""
    train_net = params_dict.get("train_net", "train")
    flat = io.flatten(model_params)
    if train_net not in ("all", "train"):
        flat = {k: v for k, v in flat.items() if v.requires_grad}
        if not flat:
            raise ValueError(f"train_net={train_net!r}: no leaf requires "
                             "grad; call setup_training first")
    arrays = io.params_to_numpy(flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    with open(str(path) + ".json", "w") as f:
        json.dump({k: params_dict.get(k) for k in METADATA_KEYS}, f,
                  indent=1, default=str)
