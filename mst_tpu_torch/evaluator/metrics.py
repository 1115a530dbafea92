"""Min-over-K ADE/FDE (counterpart of mst_tpu/evaluator/metrics.py;
reference evaluate.py:276-291)."""

import torch


def ade_fde_per_sample(gt_future, trajs_samples, goal_samples,
                       resize_factor):
    """gt_future (B, T, 2), trajs_samples (K, B, T, 2), goal_samples
    (K, B, 2), all model-space pixels -> (ade_k, fde_k), each (K, B), in
    raw-image pixels."""
    diff = (gt_future[None] - trajs_samples) / resize_factor
    ade_k = torch.sqrt((diff ** 2).sum(-1)).mean(-1)
    gdiff = (gt_future[None, :, -1] - goal_samples) / resize_factor
    fde_k = torch.sqrt((gdiff ** 2).sum(-1))
    return ade_k, fde_k


def min_ade_fde(gt_future, trajs_samples, goal_samples, resize_factor):
    """-> (ade (B,), fde (B,)), the best of the K samples each."""
    ade_k, fde_k = ade_fde_per_sample(gt_future, trajs_samples,
                                      goal_samples, resize_factor)
    return ade_k.amin(0), fde_k.amin(0)
