"""Losses (counterpart of mst_tpu/train/losses.py). The reference trains
the goal and trajectory heatmaps with nn.BCEWithLogitsLoss() * loss_scale
(models/trainer.py:206, utils/train_epoch.py:94-109)."""

import torch


def bce_with_logits(logits, targets, mask=None, shards=None, space=1):
    """Mean binary cross-entropy with logits, in the stable form
    max(x, 0) - x z + log1p(exp(-|x|)).

    mask (broadcast over the batch axis) drops padded rows: the mean runs
    over the valid elements only, count = sum(mask) * numel / mask.numel,
    floored at 1 so an all-zero mask gives 0. The gradient at x = 0 is
    mst_tpu's, -z: torch.maximum splits it evenly there, as jnp.maximum
    does, and |x| is a where whose derivative at 0 is 1, as jnp.abs's is
    (torch.abs's is 0, which gives BCEWithLogits' 0.5 - z). shards (a
    parallel.mesh.Shards, with mask): this rank holds its rows of a
    global batch, and its masked sum is divided by the global count, so
    that the ranks' losses and gradients sum to the global batch's (not
    averaged, which would be wrong wherever the ranks' valid rows differ).
    space: the 'space' ranks of a spatial mesh, when logits and targets
    are this rank's H slab of maps split `space` ways: the count is then
    the whole maps' (rows x H x W x P), so that the ranks' shares sum to
    the whole batch's loss (mst_tpu/train/losses.py:8 on the whole map).
    """
    x, z = logits, targets
    per_elem = (torch.maximum(x, x.new_zeros(())) - x * z
                + torch.log1p(torch.exp(-torch.where(x >= 0, x, -x))))
    if mask is None:
        return per_elem.mean()
    m = mask.to(per_elem.dtype).reshape(
        mask.shape + (1,) * (per_elem.dim() - mask.dim()))
    total = (per_elem * m).sum()
    n_valid = m.sum()
    if shards is not None:
        n_valid = shards.all_reduce(n_valid)
    count = n_valid * (per_elem.numel() * space / max(mask.numel(), 1))
    return total / torch.clamp(count, min=1.0)
