"""The adaptation strategies' freeze matrix (counterpart of
mst_tpu/train/freeze.py:27-137; reference models/trainer.py:112-195).

A strategy is a predicate over the '/'-joined parameter paths, which are
the JAX package's names ('encoder/stages/0/conv0/lora_A'). The port keeps
one parameter tree: `set_trainable` marks the predicate's leaves
requires_grad and returns them for the optimizer; the other leaves are
frozen (requires_grad False), so autograd computes no gradient for them.

Every strategy of mst_tpu's: 'train'/'all', 'encoder' (with or without
position levels), 'serial*'/'parallel*' (the adapters), 'mosa_<r>',
'semantic_<k>x<k>', the Y-Net-Mod branch sets ('scene', ...,
'scene_motion_fusion', with network='fusion'),
'biasEncoder'/'biasGoal'/'biasTraj'/'bias', the backbone's
'segmentation_{head,bias,bn,<layer>}' (their weights and biases: the
running statistics stay out, as in the reference), and the additive
ynet_bias flag. The backbone ('segmentation/...') is frozen under every
other strategy.
"""

import re

from mst_tpu_torch import io

_BIAS_PREFIXES = {"biasEncoder": ("encoder/",),
                  "biasGoal": ("goal_decoder/",),
                  "biasTraj": ("traj_decoder/",),
                  "bias": ("encoder/", "goal_decoder/", "traj_decoder/")}

# the Y-Net-Mod branch sets and the encoder groups they train
# (trainer.py:145-171)
_FUSION_BRANCHES = {
    "scene": ("scene_stages",),
    "motion": ("motion_stages",),
    "fusion": ("fusion_stages",),
    "scene_fusion": ("scene_stages", "fusion_stages"),
    "motion_fusion": ("motion_stages", "fusion_stages"),
    "scene_motion": ("scene_stages", "motion_stages"),
}


def is_running_statistic(p: str) -> bool:
    """A batch norm's running statistic or counter: model state that no
    optimizer trains."""
    return p.endswith(("/running_mean", "/running_var", "/num_batches"))


def _is_ynet_bias(p: str) -> bool:
    return p.endswith("/bias") and p.startswith(_BIAS_PREFIXES["bias"])


def _base_predicate(train_net, position, network):
    """The strategy's own leaves, tested in mst_tpu's order
    (freeze.py:49-105)."""
    if train_net in ("all", "train"):
        return lambda p: not p.startswith("segmentation")
    if train_net == "encoder" and not position:
        return lambda p: p.startswith("encoder/")
    if train_net == "encoder":
        def stage_in_position(p):
            # the reference matches the stage index (trainer.py:124-127);
            # a fusion tree has no encoder/stages/, so nothing matches
            m = re.match(r"encoder/stages/(\w+)/", p)
            return bool(m) and m.group(1) in position
        return stage_in_position
    for word in ("serial", "parallel"):
        if word in train_net:
            return lambda p, w=word: p.startswith("encoder/") and w in p
    if "mosa" in train_net:
        return lambda p: p.startswith("encoder/") and "lora" in p
    if "semantic" in train_net:
        return lambda p: "semantic_adapter" in p
    if network == "fusion" and train_net in _FUSION_BRANCHES:
        groups = tuple(f"encoder/{g}/" for g in _FUSION_BRANCHES[train_net])
        return lambda p: p.startswith(groups)
    if network == "fusion" and train_net == "scene_motion_fusion":
        return lambda p: p.startswith("encoder/")
    if train_net in _BIAS_PREFIXES:
        prefixes = _BIAS_PREFIXES[train_net]
        return lambda p: p.endswith("/bias") and p.startswith(prefixes)
    if train_net.startswith("segmentation"):
        # mst_tpu's rule (freeze.py:90-96): head, bias and bn match by
        # substring, so 'bn' selects the encoder's bn1-bn3 and not the
        # decoder's; any other word is a decoder layer,
        # 'decoder/blocks/<i>/<word>'. The running statistics are left out:
        # the reference's are buffers its Adam never moves (trainer.py:
        # 182-190), where mst_tpu's mask selects them (ROADMAP Queue 3 #10)
        layer = train_net.split("_")[1]
        if layer in ("head", "bias", "bn"):
            def match(p):
                return layer in p
        else:
            pattern = re.compile(rf"decoder/blocks/\d+/{layer}")

            def match(p):
                return pattern.search(p) is not None
        return lambda p: (p.startswith("segmentation/") and match(p)
                          and not is_running_statistic(p))
    raise NotImplementedError(
        f"train_net={train_net!r} is not a strategy of "
        f"network={network!r}")


def make_trainable_predicate(train_net: str, position=(),
                             ynet_bias: bool = False, network=None):
    """-> fn(path) -> bool, whether the strategy trains that parameter.
    network='fusion' enables the Y-Net-Mod branch sets, as in mst_tpu."""
    base = _base_predicate(train_net, [str(p) for p in position], network)

    def pred(p: str) -> bool:
        if p.startswith("segmentation") and \
                not train_net.startswith("segmentation"):
            return False  # the backbone is frozen (trainer.py:113)
        return base(p) or (ynet_bias and _is_ynet_bias(p))

    return pred


def set_trainable(params, train_net, position=(), ynet_bias=False,
                  network=None):
    """Mark the strategy's leaves of params requires_grad and freeze the
    others (in place) -> the trainable leaves, in path order: the
    optimizer's parameters. requires_grad is then the one record of which
    leaves train."""
    pred = make_trainable_predicate(train_net, position, ynet_bias, network)
    trainable = []
    for key, leaf in io.flatten(params).items():
        leaf.requires_grad_(pred(key))
        if leaf.requires_grad:
            trainable.append(leaf)
    return trainable
