"""Rows soft-argmax: a CUDA C++ kernel for Hopper
(csrc/softargmax_rows.cu), and its plain version.

Replaces the TPU kernel mst_tpu/ops/pallas/softargmax.py
(`_softargmax_rows` -> `pl.pallas_call` of `_kernel`): the soft-argmax of
each row of (R, H*W) logits, (sx, sy) / (s + eps) with online-softmax
statistics m (max), s (mass), sx, sy (moments of x = flat mod W,
y = flat div W). The logits are f32 or bf16 (a bf16 train step's maps);
the kernel widens bf16 in registers and keeps every statistic in f32, as
the TPU wrapper widens its input (softargmax.py:100).

Bound on an H100: bytes. Each logit is read once (4 B, 2 B in bf16) and
each row writes two floats; at TTST's shape (R = 8 rows of 352 x 480) that
is 5.4 MB in f32, about 1.6 us at 3.35 TB/s, less than a launch. The
kernel is one launch with no scratch: a cluster of CLUSTER CTAs a row,
merged through distributed shared memory; the design notes are in the
source. Any H*W works (the TPU kernel needed H*W % 1024 == 0). `row_split`
mirrors the kernel's split and `rows_split_reference` runs it with the
kernel's merge arithmetic on the CPU.

The partial-statistics variant (softargmax2d_rows_partial) is the same
kernel on an H slab of a spatial mesh: a row holds rows [row0, row0 + H)
of its map, and the kernel returns each row's (m, s, sx, sy) in log2
units, y offset by row0, which the 'space' ranks merge
(online_stats.merge_ranks). The train step's top-1 metrics run it on the
rank's slab of the trajectory and goal maps.
"""

import ctypes

import torch

from mst_tpu_torch.ops.kernels import _build, launches
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.ops.softargmax import softargmax2d as plain

CLUSTER = 16   # CTAs a row (softargmax_rows.cu kCluster)
THREADS = 256  # a CTA
LOADS = 8      # 16-byte loads a thread issues before it reduces them
WARP = 32
DTYPES = (torch.float32, torch.bfloat16)  # the logits the kernel takes


def vec_width(dtype):
    """Logits a 16-byte load holds: 4 f32 or 8 bf16."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def row_split(HW, lead, cluster, rank, vec=4):
    """Rank `rank`'s share of a row of HW logits whose first element sits
    `lead` logits past a 16-byte boundary, at vec logits a 16-byte vector
    -> (head, h0, h1, v0, v1): the scalar elements [h0, h1) (the unaligned
    head on rank 0, the ragged tail on the last rank) and the vectors
    [v0, v1) of the body, which starts at element head. cluster >= 2."""
    head = min((vec - lead) & (vec - 1), HW)
    nv = (HW - head) // vec
    v0, v1 = nv * rank // cluster, nv * (rank + 1) // cluster
    h0 = head + vec * nv if rank == cluster - 1 else 0
    h1 = head if rank == 0 else HW if rank == cluster - 1 else 0
    return head, h0, h1, v0, v1


def _coords(f, W, row0=0):
    return (f % W).float(), (f // W + row0).float()


def rows_split_reference(x, lead0: int = 0, cluster: int = CLUSTER,
                         eps: float = 1e-6, row0: int = 0,
                         partial: bool = False):
    """The kernel's reduction on the CPU: (..., H, W) f32 or bf16 logits
    whose first element sits lead0 logits past a 16-byte boundary, cut
    into the same ranks, threads and load rounds, pushed and merged in the
    kernel's order with its log2-unit arithmetic (online_stats) ->
    (..., 2). row0: the logits are rows [row0, row0 + H) of their maps
    (y offset by it); partial: stop before the soft-argmax, as the
    partial variant does -> (..., 4) statistics (m, s, sx, sy)."""
    H, W = x.shape[-2], x.shape[-1]
    HW = H * W
    vec = vec_width(x.dtype)
    rows = x.reshape(-1, HW).float() * ost.LOG2E
    lanes = torch.arange(THREADS)
    out = []
    for r in range(rows.shape[0]):
        row = rows[r]
        ranks = []
        for rank in range(cluster):
            head, h0, h1, v0, v1 = row_split(HW, (lead0 + r * HW) % vec,
                                             cluster, rank, vec)
            st = ost.empty((THREADS,))
            for base in range(v0, v1, THREADS * LOADS):
                for i in range(LOADS):
                    idx = base + i * THREADS + lanes
                    valid = idx < v1
                    f = head + vec * idx.clamp(max=max(v1 - 1, 0))
                    f4 = f[:, None] + torch.arange(vec)
                    fx, fy = _coords(f4, W, row0)
                    st = ost.push_group(st, row[f4.clamp(max=HW - 1)], fx,
                                        fy, valid)
            n = h1 - h0
            if n:
                f = h0 + lanes.clamp(max=n - 1)
                fx, fy = _coords(f, W, row0)
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
        merged = ost.warp_merge2(padded, 0)
        out.append(torch.stack(merged, -1) if partial
                   else ost.finish(merged, eps))
    return torch.stack(out).reshape(*x.shape[:-2], 4 if partial else 2)


def _library():
    lib = _build.load("softargmax_rows")
    fn = lib.softargmax_rows_launch
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [i32] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = i32
        lib.softargmax_rows_slice.argtypes = [i32] * 5 + [ctypes.c_void_p]
        lib.softargmax_rows_slice.restype = None
        lib.softargmax_rows_cluster.argtypes = []
        lib.softargmax_rows_cluster.restype = i32
        lib.softargmax_rows_partial_launch.argtypes = [
            ctypes.c_void_p] * 2 + [i32] * 5 + [ctypes.c_void_p]
        lib.softargmax_rows_partial_launch.restype = i32
    return lib


def library_split(HW, lead, cluster, vec=4):
    """The library's own split (softargmax_rows_slice) of one row, for
    holding row_split against it on the card."""
    lib = _library()
    split = []
    for rank in range(cluster):
        buf = (ctypes.c_int * 5)()
        lib.softargmax_rows_slice(HW, lead, cluster, rank, vec, buf)
        split.append(tuple(buf))
    return split


def softargmax2d_rows(logits_hw_last, eps: float = 1e-6):
    """(..., H, W) f32 or bf16 logits -> (..., 2) f32 expected (x, y).

    The custom op mst_tpu_torch::softargmax2d_rows: a CPU tensor takes the
    plain version (bf16 widened first). A CUDA tensor launches the CUDA
    kernel, which needs f32 or bf16 in a contiguous layout, and raises
    otherwise. Under torch.func.vmap the runs fold into the rows (one
    launch); under CUDA-graph capture the launch is recorded and counts
    once each replay (ops/kernels/launches.py). `launches` counts the f32
    kernel's launches, `launches_bf16` the bf16 kernel's. A tensor of
    another device raises (the op's fake serves tracing, not callers).
    """
    if logits_hw_last.device.type not in ("cpu", "cuda"):
        raise ValueError("softargmax2d_rows: unsupported device "
                         f"{logits_hw_last.device}")
    return _rows_op(logits_hw_last, eps)


@torch.library.custom_op("mst_tpu_torch::softargmax2d_rows",
                         mutates_args=(), device_types="cpu")
def _rows_op(x: torch.Tensor, eps: float) -> torch.Tensor:
    return plain(x, eps)


def _check_logits(name, x):
    if x.dtype not in DTYPES or not x.is_contiguous() or x.dim() < 2:
        raise ValueError(f"{name} needs a contiguous f32 or bf16 tensor of "
                         f"(..., H, W); got {x.dtype}, shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")


@_rows_op.register_kernel("cuda")
def _rows_cuda(x, eps):
    _check_logits("softargmax2d_rows", x)
    H, W = x.shape[-2], x.shape[-1]
    R = x.numel() // (H * W)
    out = torch.empty((R, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().softargmax_rows_launch(
            x.data_ptr(), out.data_ptr(), R, H * W, W, x.element_size(),
            float(eps), stream)
    if err != 0:
        raise RuntimeError(f"softargmax_rows kernel launch failed: "
                           f"cudaError_t {err}")
    launches.count(softargmax2d_rows, "launches_bf16"
                   if x.dtype == torch.bfloat16 else "launches")
    return out.reshape(*x.shape[:-2], 2)


@_rows_op.register_fake
def _rows_fake(x, eps):
    return x.new_empty((*x.shape[:-2], 2), dtype=torch.float32)


@_rows_op.register_vmap
def _rows_vmap(info, in_dims, x, eps):
    """The runs are more rows: one call on the batched tensor, contiguous
    with the run axis first."""
    if in_dims[0] is None:
        return _rows_op(x, eps), None
    return _rows_op(x.movedim(in_dims[0], 0).contiguous(), eps), 0


softargmax2d_rows.launches = 0
softargmax2d_rows.launches_bf16 = 0


# ---- the partial-statistics variant (an H slab of a spatial mesh)

def softargmax2d_rows_partial_plain(logits_hw_last, row0: int):
    """The plain version: (..., H, W) f32 or bf16 logits of rows [row0,
    row0 + H) of their maps -> (..., 4) f32, each row's (m, s, sx, sy) in
    log2 units (online_stats), y offset by row0, from the widened
    logits."""
    x = logits_hw_last
    H, W = x.shape[-2], x.shape[-1]
    lg = x.float().reshape(-1, H * W) * ost.LOG2E
    m = lg.amax(-1)
    e = torch.exp2(lg - m[:, None])
    ys = torch.arange(row0, row0 + H, dtype=torch.float32,
                      device=x.device).repeat_interleave(W)
    xs = torch.arange(W, dtype=torch.float32, device=x.device).repeat(H)
    return torch.stack([m, e.sum(-1), (e * xs).sum(-1), (e * ys).sum(-1)],
                       -1).reshape(*x.shape[:-2], 4)


def softargmax2d_rows_partial(logits_hw_last, row0: int):
    """(..., H, W) f32 or bf16 logits of rows [row0, row0 + H) of their
    maps -> (..., 4) f32 statistics (m, s, sx, sy) in log2 units, y
    offset by row0 (online_stats.merge_ranks merges the 'space' ranks').

    The custom op mst_tpu_torch::softargmax2d_rows_partial: a CPU tensor
    takes the plain version; a CUDA tensor launches the partial variant
    of the rows kernel, which needs f32 or bf16 in a contiguous layout,
    and raises otherwise. Under torch.func.vmap the runs fold into the
    rows; a launch under CUDA-graph capture counts once each replay.
    `launches` counts the f32 kernel's launches, `launches_bf16` the bf16
    kernel's."""
    if logits_hw_last.device.type not in ("cpu", "cuda"):
        raise ValueError("softargmax2d_rows_partial: unsupported device "
                         f"{logits_hw_last.device}")
    return _partial_op(logits_hw_last, int(row0))


@torch.library.custom_op("mst_tpu_torch::softargmax2d_rows_partial",
                         mutates_args=(), device_types="cpu")
def _partial_op(x: torch.Tensor, row0: int) -> torch.Tensor:
    return softargmax2d_rows_partial_plain(x, row0)


@_partial_op.register_kernel("cuda")
def _partial_cuda(x, row0):
    _check_logits("softargmax2d_rows_partial", x)
    H, W = x.shape[-2], x.shape[-1]
    R = x.numel() // (H * W)
    out = torch.empty((R, 4), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().softargmax_rows_partial_launch(
            x.data_ptr(), out.data_ptr(), R, H * W, W, x.element_size(),
            int(row0), stream)
    if err != 0:
        raise RuntimeError(f"softargmax_rows partial kernel launch failed: "
                           f"cudaError_t {err}")
    launches.count(softargmax2d_rows_partial, "launches_bf16"
                   if x.dtype == torch.bfloat16 else "launches")
    return out.reshape(*x.shape[:-2], 4)


@_partial_op.register_fake
def _partial_fake(x, row0):
    return x.new_empty((*x.shape[:-2], 4), dtype=torch.float32)


@_partial_op.register_vmap
def _partial_vmap(info, in_dims, x, row0):
    """The runs are more rows, as the whole-map op's rule folds them."""
    if in_dims[0] is None:
        return _partial_op(x, row0), None
    return _partial_op(x.movedim(in_dims[0], 0).contiguous(), row0), 0


softargmax2d_rows_partial.launches = 0
softargmax2d_rows_partial.launches_bf16 = 0
