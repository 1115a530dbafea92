"""TTST's k-means loop: a CUDA C++ kernel for Hopper (csrc/kmeans.cu),
and its plain version.

Replaces no TPU kernel (mst_tpu keeps its vmap of lax.while_loop on the
TPU through XLA). The port's torch while_loop (ops/kmeans.py) reads one
flag on the host and launches about fifteen small kernels every trip;
this kernel runs every row's whole Lloyd loop on the card in one launch,
a cluster of 8 CTAs a row, each holding a slice of the row's
points in shared memory, and reads nothing back. Its algorithm,
precision (f32) and draws are the loop's: the same argmin (first
minimum, distances rounded as torch rounds them), means, reseeds from
the same table and stopping rule; only the order in which the means are
summed differs, fixed from call to call (no atomics).

ops/kmeans.batched_kmeans hands it every CUDA input; the kernel takes
f32 2-D points under the euclidean distance, 1 <= k <= min(24, N), and a
row whose slices fit the CTAs' shared memory, and refuses anything else
before any launch (TTST clusters f32 (B, 10,000, 2) samples to
n_goal - 1 = 19).
"""

import ctypes

import torch

from mst_tpu_torch.ops.kernels import _build, launches


def _library():
    lib = _build.load("kmeans")
    fn = lib.kmeans_launch
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [i32] * 3 + [
            ctypes.c_float, i32, ctypes.c_void_p]
        fn.restype = i32
    return lib


def lloyd2d(X, centers, reseed, tol: float, iter_limit: int):
    """Lloyd's loop of each row of X (B, N, 2) f32 from centers (B, k, 2)
    f32, each row to its own stopping rule (summed centre shift, squared,
    below tol, or iter_limit trips), an empty cluster reseeded at trip
    `it` from X[row, reseed[it, row, j]] (reseed (iter_limit, B, k)
    int64) -> (assignments (B, N) int64, centres (B, k, 2) f32, each
    row's trips (B,) int64).

    The custom op mst_tpu_torch::kmeans2d: a CPU tensor takes the plain
    version (ops/kmeans.lloyd, the torch while_loop). A CUDA tensor
    launches the kernel, which needs the three operands contiguous, of
    these dtypes and shapes, on one device, with B >= 1, 1 <= k <=
    min(24, N), iter_limit >= 1 and N within its CTAs' shared memory, and
    raises otherwise, before any launch. `launches` counts the
    kernel's launches (a launch under CUDA-graph capture once each
    replay)."""
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lloyd2d: unsupported device {X.device}")
    return _kmeans_op(X, centers, reseed, float(tol), int(iter_limit))


@torch.library.custom_op("mst_tpu_torch::kmeans2d", mutates_args=(),
                         device_types="cpu")
def _kmeans_op(X: torch.Tensor, centers: torch.Tensor, reseed: torch.Tensor,
               tol: float, iter_limit: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # ops/kmeans imports this module
    from mst_tpu_torch.ops.kmeans import lloyd, pairwise_sq_dist

    assign, centers, iters, _ = lloyd(X, centers, reseed, tol, iter_limit,
                                      pairwise_sq_dist)
    return assign, centers, iters


def _check(X, centers, reseed, iter_limit):
    B, N = X.shape[:2] if X.dim() == 3 else (-1, -1)
    k = centers.shape[1] if centers.dim() == 3 else -1
    for arg, t, shape, dtype in (
            ("X", X, (B, N, 2), torch.float32),
            ("centers", centers, (B, k, 2), torch.float32),
            ("reseed", reseed, (iter_limit, B, k), torch.int64)):
        if (t.device != X.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lloyd2d: {arg} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {X.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


@_kmeans_op.register_kernel("cuda")
def _kmeans_cuda(X, centers, reseed, tol, iter_limit):
    _check(X, centers, reseed, iter_limit)
    B, N, _ = X.shape
    k = centers.shape[1]
    assign = torch.empty((B, N), dtype=torch.int64, device=X.device)
    out = torch.empty_like(centers)
    iters = torch.empty(B, dtype=torch.int64, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().kmeans_launch(
            X.data_ptr(), centers.data_ptr(), reseed.data_ptr(),
            assign.data_ptr(), out.data_ptr(), iters.data_ptr(), B, N, k,
            tol, iter_limit, stream)
    if err == 1:  # cudaErrorInvalidValue, returned before any launch
        raise ValueError(
            f"lloyd2d: the kernel refused B={B}, N={N}, k={k}, iter_limit="
            f"{iter_limit}: it takes B >= 1, 1 <= k <= min(24, N), "
            "iter_limit >= 1 and N within its CTAs' shared memory")
    if err != 0:
        raise RuntimeError(f"kmeans kernel launch failed: cudaError_t {err}")
    launches.count(lloyd2d)
    return assign, out, iters


@_kmeans_op.register_fake
def _kmeans_fake(X, centers, reseed, tol, iter_limit):
    return (X.new_empty(X.shape[:2], dtype=torch.int64),
            torch.empty_like(centers),
            X.new_empty(X.shape[:1], dtype=torch.int64))


lloyd2d.launches = 0
