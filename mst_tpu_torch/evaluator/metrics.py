"""Min-over-K ADE/FDE, in raw pixels or in ETH/UCY world coordinates
(counterpart of mst_tpu/evaluator/metrics.py and the world-coordinate
metrics of mst_tpu/train/steps.py:523-544; reference evaluate.py:271-291,
image_utils.py:138-162)."""

import numpy as np
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


def to_world(points, homography, resize_factor):
    """Model-space pixels (..., 2) -> world coordinates through a (3, 3)
    homography (the eth/hotel x/y swap already folded in): raw pixels,
    homogeneous, projected, divided by the third coordinate."""
    p = points / resize_factor
    h = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    w = torch.einsum("ij,...j->...i", homography.to(p.dtype), h)
    return w[..., :2] / w[..., 2:]


def ade_fde_per_sample_world(gt_future, trajs_samples, goal_samples,
                             resize_factor, homography):
    """ade_fde_per_sample with every point in world coordinates
    (to_world) -> (ade_k, fde_k), each (K, B), in world units. As in
    mst_tpu, the converted points are not divided by resize_factor again
    (the reference's double division, docs/parity.md)."""
    gt_w = to_world(gt_future, homography, resize_factor)
    trajs_w = to_world(trajs_samples, homography, resize_factor)
    goals_w = to_world(goal_samples, homography, resize_factor)
    ade_k = torch.sqrt(((gt_w[None] - trajs_w) ** 2).sum(-1)).mean(-1)
    fde_k = torch.sqrt(((gt_w[None, :, -1] - goals_w) ** 2).sum(-1))
    return ade_k, fde_k


def image2world(image_coords, scene, homo_mat, resize):
    """Pixel -> world coordinates by the scene's homography, the eth and
    hotel x/y swap applied (mst_tpu/evaluator/metrics.py:20-33; reference
    utils/image_utils.py:138-162). image_coords (..., T, 2) -> float64
    numpy of the same shape; homo_mat {scene: (3, 3)}."""
    coords = np.array(image_coords, dtype=np.float64)
    shape = coords.shape
    traj = coords.reshape(-1, shape[-2], 2)
    if scene in ("eth", "hotel"):
        traj = traj[..., ::-1]
    traj = traj / resize
    ones = np.ones((*traj.shape[:-1], 1))
    homog = np.concatenate([traj, ones], axis=-1).reshape(-1, 3)
    world = (np.asarray(homo_mat[scene]) @ homog.T).T
    world = world / world[:, 2:]
    return world[:, :2].reshape(shape)
