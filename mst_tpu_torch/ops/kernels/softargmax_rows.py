"""Rows soft-argmax: a CUDA C++ kernel for Hopper
(csrc/softargmax_rows.cu), and its plain version.

Replaces the TPU kernel mst_tpu/ops/pallas/softargmax.py
(`_softargmax_rows` -> `pl.pallas_call` of `_kernel`): the soft-argmax of
each row of (R, H*W) logits, (sx, sy) / (s + eps) with online-softmax
statistics m (max), s (mass), sx, sy (moments of x = flat mod W,
y = flat div W).

Bound on an H100: bytes. Each logit is read once (4 B) and each row writes
two floats; at TTST's shape (R = 8 rows of 352 x 480) that is 5.4 MB, about
1.6 us at 3.35 TB/s, less than a launch. The kernel is one launch with no
scratch: a cluster of CLUSTER CTAs a row, merged through distributed
shared memory; the design notes are in the source. Any H*W works (the TPU
kernel needed H*W % 1024 == 0). `row_split` mirrors the kernel's split and
`rows_split_reference` runs it with the kernel's merge arithmetic on the
CPU.
"""

import ctypes

import torch

from mst_tpu_torch.ops.kernels import _build
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.ops.softargmax import softargmax2d as plain

CLUSTER = 16   # CTAs a row (softargmax_rows.cu kCluster)
THREADS = 256  # a CTA
LOADS = 8      # float4 loads a thread issues before it reduces them
WARP = 32


def row_split(HW, lead, cluster, rank):
    """Rank `rank`'s share of a row of HW logits whose first element sits
    `lead` floats past a 16-byte boundary -> (head, h0, h1, v0, v1): the
    scalar elements [h0, h1) (the unaligned head on rank 0, the ragged tail
    on the last rank) and the float4s [v0, v1) of the body, which starts at
    element head. cluster >= 2."""
    head = min((4 - lead) & 3, HW)
    nv = (HW - head) // 4
    v0, v1 = nv * rank // cluster, nv * (rank + 1) // cluster
    h0 = head + 4 * nv if rank == cluster - 1 else 0
    h1 = head if rank == 0 else HW if rank == cluster - 1 else 0
    return head, h0, h1, v0, v1


def _coords(f, W):
    return (f % W).float(), (f // W).float()


def rows_split_reference(x, lead0: int = 0, cluster: int = CLUSTER,
                         eps: float = 1e-6):
    """The kernel's reduction on the CPU: (..., H, W) logits whose first
    element sits lead0 floats past a 16-byte boundary, cut into the same
    ranks, threads and load rounds, pushed and merged in the kernel's order
    with its log2-unit arithmetic (online_stats) -> (..., 2)."""
    H, W = x.shape[-2], x.shape[-1]
    HW = H * W
    rows = x.reshape(-1, HW).float() * ost.LOG2E
    lanes = torch.arange(THREADS)
    out = []
    for r in range(rows.shape[0]):
        row = rows[r]
        ranks = []
        for rank in range(cluster):
            head, h0, h1, v0, v1 = row_split(HW, (lead0 + r * HW) % 4,
                                             cluster, rank)
            st = ost.empty((THREADS,))
            for base in range(v0, v1, THREADS * LOADS):
                for i in range(LOADS):
                    idx = base + i * THREADS + lanes
                    valid = idx < v1
                    f = head + 4 * idx.clamp(max=max(v1 - 1, 0))
                    f4 = f[:, None] + torch.arange(4)
                    fx, fy = _coords(f4, W)
                    st = ost.push_group(st, row[f4.clamp(max=HW - 1)], fx,
                                        fy, valid)
            n = h1 - h0
            if n:
                f = h0 + lanes.clamp(max=n - 1)
                fx, fy = _coords(f, W)
                st = ost.push_group(st, row[f][:, None], fx[:, None],
                                    fy[:, None], lanes < n)
            warps = ost.warp_merge2(
                tuple(t.reshape(THREADS // WARP, WARP) for t in st), 1)
            padded = tuple(torch.cat([t, e]) for t, e in zip(
                warps, ost.empty((WARP - THREADS // WARP,))))
            ranks.append(ost.warp_merge2(padded, 0))
        lanes_c = tuple(torch.stack([s[k] for s in ranks]) for k in range(4))
        padded = tuple(torch.cat([t, e]) for t, e in zip(
            lanes_c, ost.empty((WARP - cluster,))))
        out.append(ost.finish(ost.warp_merge2(padded, 0), eps))
    return torch.stack(out).reshape(*x.shape[:-2], 2)


def _library():
    lib = _build.load("softargmax_rows")
    fn = lib.softargmax_rows_launch
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [i32] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = i32
        lib.softargmax_rows_slice.argtypes = [i32] * 4 + [ctypes.c_void_p]
        lib.softargmax_rows_slice.restype = None
        lib.softargmax_rows_cluster.argtypes = []
        lib.softargmax_rows_cluster.restype = i32
    return lib


def library_split(HW, lead, cluster):
    """The library's own split (softargmax_rows_slice) of one row, for
    holding row_split against it on the card."""
    lib = _library()
    split = []
    for rank in range(cluster):
        buf = (ctypes.c_int * 5)()
        lib.softargmax_rows_slice(HW, lead, cluster, rank, buf)
        split.append(tuple(buf))
    return split


def softargmax2d_rows(logits_hw_last, eps: float = 1e-6):
    """(..., H, W) f32 logits -> (..., 2) expected (x, y).

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel, which needs f32 and a contiguous layout, and raises otherwise.
    """
    x = logits_hw_last
    if x.device.type == "cpu":
        return plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"softargmax2d_rows: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() < 2:
        raise ValueError("softargmax2d_rows needs a contiguous f32 tensor of "
                         f"(..., H, W); got {x.dtype}, shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    H, W = x.shape[-2], x.shape[-1]
    R = x.numel() // (H * W)
    out = torch.empty((R, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().softargmax_rows_launch(
            x.data_ptr(), out.data_ptr(), R, H * W, W, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"softargmax_rows kernel launch failed: "
                           f"cudaError_t {err}")
    softargmax2d_rows.launches += 1
    return out.reshape(*x.shape[:-2], 2)


softargmax2d_rows.launches = 0
