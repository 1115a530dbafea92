"""Losses (counterpart of mst_tpu/train/losses.py). The reference trains
the goal and trajectory heatmaps with nn.BCEWithLogitsLoss() * loss_scale
(models/trainer.py:206, utils/train_epoch.py:94-109)."""

import torch


def bce_with_logits(logits, targets, mask=None):
    """Mean binary cross-entropy with logits, in the stable form
    max(x, 0) - x z + log1p(exp(-|x|)).

    mask (broadcast over the batch axis) drops padded rows: the mean runs
    over the valid elements only, count = sum(mask) * numel / mask.numel,
    floored at 1 so an all-zero mask gives 0. torch.maximum splits the
    gradient at x = 0 evenly, as jnp.maximum does.
    """
    x, z = logits, targets
    per_elem = (torch.maximum(x, x.new_zeros(())) - x * z
                + torch.log1p(torch.exp(-x.abs())))
    if mask is None:
        return per_elem.mean()
    m = mask.to(per_elem.dtype).reshape(
        mask.shape + (1,) * (per_elem.dim() - mask.dim()))
    total = (per_elem * m).sum()
    count = m.sum() * (per_elem.numel() / max(mask.numel(), 1))
    return total / torch.clamp(count, min=1.0)
