"""The adaptation strategies' freeze matrix (counterpart of
mst_tpu/train/freeze.py:27-137; reference models/trainer.py:112-195).

A strategy is a predicate over the '/'-joined parameter paths, which are
the JAX package's names ('encoder/stages/0/conv0/lora_A'). The port keeps
one parameter tree: `set_trainable` marks the predicate's leaves
requires_grad and returns them for the optimizer; the other leaves are
frozen (requires_grad False), so autograd computes no gradient for them.

Ported strategies: 'train'/'all', 'encoder' (with or without position
levels), 'mosa_<r>', 'biasEncoder'/'biasGoal'/'biasTraj'/'bias', and the
additive ynet_bias flag. The adapter, semantic, fusion and segmentation
strategies train parameters the port does not have yet and raise
NotImplementedError.
"""

import re

from mst_tpu_torch import io

_BIAS_PREFIXES = {"biasEncoder": ("encoder/",),
                  "biasGoal": ("goal_decoder/",),
                  "biasTraj": ("traj_decoder/",),
                  "bias": ("encoder/", "goal_decoder/", "traj_decoder/")}


def _is_ynet_bias(p: str) -> bool:
    return p.endswith("/bias") and p.startswith(_BIAS_PREFIXES["bias"])


def make_trainable_predicate(train_net: str, position=(),
                             ynet_bias: bool = False):
    """-> fn(path) -> bool, whether the strategy trains that parameter.
    (mst_tpu's `network` argument selects the fusion strategies, which are
    not ported.)"""
    position = [str(p) for p in position]
    if "serial" in train_net or "parallel" in train_net:
        # mst_tpu tests these before 'mosa' (freeze.py:69-74)
        raise NotImplementedError(
            f"train_net={train_net!r}: adapters are not ported yet")
    if train_net in ("all", "train"):
        def base(p):
            return not p.startswith("segmentation")
    elif train_net == "encoder" and not position:
        def base(p):
            return p.startswith("encoder/")
    elif train_net == "encoder":
        def base(p):
            # the reference matches the stage index (trainer.py:124-127)
            m = re.match(r"encoder/stages/(\w+)/", p)
            return bool(m) and m.group(1) in position
    elif "mosa" in train_net:
        def base(p):
            return p.startswith("encoder/") and "lora" in p
    elif train_net in _BIAS_PREFIXES:
        def base(p):
            return (p.endswith("/bias")
                    and p.startswith(_BIAS_PREFIXES[train_net]))
    else:
        raise NotImplementedError(
            f"train_net={train_net!r} is not ported yet")

    def pred(p: str) -> bool:
        if p.startswith("segmentation"):
            return False  # the backbone is always frozen (trainer.py:113)
        return base(p) or (ynet_bias and _is_ynet_bias(p))

    return pred


def set_trainable(params, train_net, position=(), ynet_bias=False):
    """Mark the strategy's leaves of params requires_grad and freeze the
    others (in place) -> the trainable leaves, in path order: the
    optimizer's parameters. requires_grad is then the one record of which
    leaves train."""
    pred = make_trainable_predicate(train_net, position, ynet_bias)
    trainable = []
    for key, leaf in io.flatten(params).items():
        leaf.requires_grad_(pred(key))
        if leaf.requires_grad:
            trainable.append(leaf)
    return trainable
