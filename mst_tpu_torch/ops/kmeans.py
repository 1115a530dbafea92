"""Batched k-means for TTST goal clustering (counterpart of
mst_tpu/ops/kmeans.py; reference utils/kmeans.py:22-180).

Each row of the batch is its own k-means run and stops on its own rule
(summed centre shift, squared, below tol, or iter_limit iterations): rows
that have converged stay frozen while the others go on, as under the JAX
package's vmap of lax.while_loop. One global stopping condition would give
other centres. Empty clusters re-seed from a random point of their row.

On a CUDA device the loop runs as one hand-written kernel
(ops/kernels/kmeans.py, csrc/kmeans.cu: mst_tpu_torch::kmeans2d), every
row to its own rule in one launch, with no host read; it takes the
euclidean distance on f32 2-D points (TTST's goal samples) with up to
24 clusters, and raises for anything else. On the CPU the loop is
`lloyd`: the iterations in torch._higher_order_ops.while_loop, which
torch.export records as one loop in the program; run eagerly, and in the
exported program, its condition reads one flag each iteration. Both are
the span 'sampling.kmeans' (utils/profiling.py), which notes the trip
count as 'iterations' (the kernel's as a device tensor, the most trips
of a row). The draws come from a sampling.Key, the reseed's with the
iteration as the counter, drawn before either runs, so neither holds a
torch.Generator. Both of the reference's distances (euclidean, cosine;
on the CPU) and its centres-only kmeans_predict are here.
"""

import torch
from torch._higher_order_ops.while_loop import while_loop

from mst_tpu_torch.ops.kernels import kmeans as kernel
from mst_tpu_torch.ops.sampling import Key, Rows, key_from_generator
from mst_tpu_torch.utils.profiling import note, span


def pairwise_sq_dist(a, b):
    """(B, N, D) x (B, k, D) -> (B, N, k) squared euclidean distances."""
    return ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)


def pairwise_cosine(a, b):
    """(B, N, D) x (B, k, D) -> (B, N, k) cosine distances 1 - cos_sim
    (reference kmeans.py:162-180; no eps guard, so a zero vector gives
    nan there as here)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return 1.0 - (a[:, :, None, :] * b[:, None, :, :]).sum(-1)


DISTANCES = {"euclidean": pairwise_sq_dist, "cosine": pairwise_cosine}


def batched_kmeans(X, num_clusters: int, tol: float = 1e-3,
                   iter_limit: int = 1000, init_centers=None,
                   generator=None, distance: str = "euclidean"):
    """Cluster (B, N, D) point sets into num_clusters each.

    init_centers: optional (B, k, D); each is snapped to its nearest data
    point under `distance` first (reference kmeans.py:62-68). Without it,
    k distinct points of each row are drawn. The draws come from
    `generator`: a sampling.Key, or a torch.Generator (None: the global
    one) from which a key is drawn, or a sampling.Rows of either (a
    rank's rows of a global batch).

    Returns assignments (B, N) int64 and centres (B, k, D).
    """
    pdist = DISTANCES[distance]
    if X.device.type == "cuda" and distance != "euclidean":
        raise ValueError(f"batched_kmeans: the {distance} distance on a "
                         "CUDA device; its kernel (ops/kernels/kmeans.py) "
                         "takes the euclidean distance")
    if isinstance(generator, Rows):
        generator = generator.keyed(X.device)
    elif not isinstance(generator, Key):
        generator = Key(key_from_generator(generator, X.device))
    B, N, D = X.shape
    k = num_clusters
    rows = torch.arange(B, device=X.device)[:, None]
    if init_centers is None:
        # the bits of one (stream, counter) are distinct within a row
        idx = generator.bits((B, N)).topk(k, dim=1).indices
    else:
        idx = pdist(X, init_centers.to(X)).argmin(dim=1)
    centers = X[rows, idx]  # (B, k, D)
    # the reseed draws of every iteration the loop may run, drawn once
    # with the iteration as the counter: inside the loop a draw is one
    # index, not a hash of a dozen small launches an iteration
    reseed = generator.randint(N, (B, k), counter=torch.arange(
        iter_limit, dtype=torch.int64, device=X.device))
    with span("sampling.kmeans"):
        if X.device.type == "cuda":
            assign, centers, iters = kernel.lloyd2d(
                X.contiguous(), centers.contiguous(), reseed.contiguous(),
                tol, iter_limit)
            trips = iters.max()
        else:
            assign, centers, _, trips = lloyd(X, centers, reseed, tol,
                                              iter_limit, pdist)
        note("iterations", trips)
        return assign, centers


def lloyd(X, centers, reseed, tol, iter_limit, pdist):
    """The loop of batched_kmeans as one torch while_loop: each row of X
    (B, N, D) from its centres (B, k, D) to its own stopping rule, an
    empty cluster at iteration `it` reseeded from X[row, reseed[it, row,
    j]] -> (assignments (B, N), centres (B, k, D), each row's iterations
    (B,), the loop's trips). The kernel's plain version."""
    B, N, _ = X.shape
    k = centers.shape[1]
    rows = torch.arange(B, device=X.device)[:, None]
    clusters = torch.arange(k, device=X.device)

    def cond(centers, active, iters, it):
        return active.any()

    def body(centers, active, iters, it):
        choice = pdist(X, centers).argmin(dim=2)  # (B, N)
        # one_hot as a comparison: one_hot reads its input's range
        onehot = (choice[..., None] == clusters).to(X.dtype)  # (B, N, k)
        counts = onehot.sum(dim=1)  # (B, k)
        means = (onehot.transpose(1, 2) @ X) / counts.clamp(min=1.0)[..., None]
        ridx = reseed.index_select(0, it.reshape(1))[0]
        new_centers = torch.where((counts > 0)[..., None], means,
                                  X[rows, ridx])
        shift = torch.sqrt(((new_centers - centers) ** 2).sum(-1)).sum(-1)
        centers = torch.where(active[:, None, None], new_centers, centers)
        iters = iters + active.to(torch.int64)
        active = active & (shift ** 2 >= tol) & (iters < iter_limit)
        return centers, active, iters, it + 1

    carry = (centers, torch.ones(B, dtype=torch.bool, device=X.device),
             torch.zeros(B, dtype=torch.int64, device=X.device),
             torch.zeros((), dtype=torch.int64, device=X.device))
    centers, _, iters, trips = while_loop(cond, body, carry)
    return pdist(X, centers).argmin(dim=2), centers, iters, trips


def kmeans_predict(X, cluster_centers, distance: str = "euclidean"):
    """Assign points to existing centres (reference kmeans.py:111-143):
    X (N, D) with centres (k, D), or (B, N, D) with (B, k, D) -> cluster
    ids (N,) or (B, N) int64."""
    pdist = DISTANCES[distance]
    if X.dim() == 2:
        return pdist(X[None], cluster_centers[None]).argmin(dim=2)[0]
    return pdist(X, cluster_centers).argmin(dim=2)
