"""Batched k-means for TTST goal clustering (counterpart of
mst_tpu/ops/kmeans.py:39-112; reference utils/kmeans.py:22-108).

Each row of the batch is its own k-means run and stops on its own rule
(summed centre shift, squared, below tol, or iter_limit iterations): rows
that have converged stay frozen while the others go on, as under the JAX
package's vmap of lax.while_loop. One global stopping condition would give
other centres. Empty clusters re-seed from a random point of their row.
"""

import torch


def pairwise_sq_dist(a, b):
    """(B, N, D) x (B, k, D) -> (B, N, k) squared euclidean distances."""
    return ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)


def batched_kmeans(X, num_clusters: int, tol: float = 1e-3,
                   iter_limit: int = 1000, init_centers=None,
                   generator=None):
    """Cluster (B, N, D) point sets into num_clusters each.

    init_centers: optional (B, k, D); each is snapped to its nearest data
    point first (reference kmeans.py:62-68). Without it, k distinct points
    of each row are drawn from `generator`.

    Returns assignments (B, N) int64 and centres (B, k, D).
    """
    B, N, D = X.shape
    rows = torch.arange(B, device=X.device)[:, None]
    if init_centers is None:
        idx = torch.rand((B, N), generator=generator,
                         device=X.device).topk(num_clusters, dim=1).indices
    else:
        idx = pairwise_sq_dist(X, init_centers.to(X)).argmin(dim=1)
    centers = X[rows, idx]  # (B, k, D)

    active = torch.ones(B, dtype=torch.bool, device=X.device)
    iters = torch.zeros(B, dtype=torch.int64, device=X.device)
    while bool(active.any()):
        choice = pairwise_sq_dist(X, centers).argmin(dim=2)  # (B, N)
        onehot = torch.nn.functional.one_hot(
            choice, num_clusters).to(X.dtype)  # (B, N, k)
        counts = onehot.sum(dim=1)  # (B, k)
        means = (onehot.transpose(1, 2) @ X) / counts.clamp(min=1.0)[..., None]
        ridx = torch.randint(0, N, (B, num_clusters), generator=generator,
                             device=X.device)
        new_centers = torch.where((counts > 0)[..., None], means,
                                  X[rows, ridx])
        shift = torch.sqrt(((new_centers - centers) ** 2).sum(-1)).sum(-1)
        centers = torch.where(active[:, None, None], new_centers, centers)
        iters = iters + active.to(torch.int64)
        active = active & (shift ** 2 >= tol) & (iters < iter_limit)
    return pairwise_sq_dist(X, centers).argmin(dim=2), centers
