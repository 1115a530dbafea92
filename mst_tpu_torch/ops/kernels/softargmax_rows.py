"""Rows soft-argmax: a Triton kernel for Hopper, and its plain version.

Replaces the TPU kernel mst_tpu/ops/pallas/softargmax.py
(`_softargmax_rows` -> `pl.pallas_call` of `_kernel`): the soft-argmax of
each row of (R, H*W) logits, (sx, sy) / (s + eps) with online-softmax
statistics m (max), s (mass), sx, sy (moments of x = flat mod W,
y = flat div W).

Bound on an H100: bytes. Each logit is read once (4 B) and each row writes
two floats; at TTST's shape (R = 8 rows of 352 x 480) that is 5.4 MB, about
1.6 us at 3.35 TB/s, well under a kernel launch, so in practice the
launches bound it. The TPU walked the columns of a row tile in order on one
core; 8 rows as 8 programs would leave ~124 of the 132 SMs idle, so the
design splits every row into column chunks. Pass 1 (one program per
(row, chunk)) writes the chunk's partial (m, s, sx, sy); pass 2 (one
program per row) merges them with the max-rescaling of
unify_packed_stats. Ragged tails are masked, so any H*W works (the TPU
kernel needed H*W % 1024 == 0).
"""

import torch

from mst_tpu_torch.ops.softargmax import softargmax2d as plain

BLOCK = 1024           # columns per load
BLOCKS_PER_CHUNK = 8   # a pass-1 program reduces 8192 columns
MERGE_BLOCK = 64       # partials per load in pass 2

_KERNELS = {}


def _kernels():
    """JIT-compiled (partial, merge) Triton kernels, made on first use:
    triton is imported here, never at module import."""
    if _KERNELS:
        return _KERNELS["partial"], _KERNELS["merge"]
    import triton
    import triton.language as tl

    @triton.jit
    def partial_kernel(x_ptr, part_ptr, HW, W, n_chunks,
                       BLOCK: tl.constexpr, BLOCKS_PER_CHUNK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        base = x_ptr + row.to(tl.int64) * HW
        start = chunk * (BLOCK * BLOCKS_PER_CHUNK)
        cols = tl.arange(0, BLOCK)
        m = tl.full((1,), value=float("-inf"), dtype=tl.float32)
        s = tl.zeros((1,), dtype=tl.float32)
        sx = tl.zeros((1,), dtype=tl.float32)
        sy = tl.zeros((1,), dtype=tl.float32)
        for b in tl.static_range(BLOCKS_PER_CHUNK):
            flat = start + b * BLOCK + cols
            valid = flat < HW
            t = tl.load(base + flat, mask=valid, other=-float("inf"))
            # the chunk's first block always holds a valid column, so m is
            # finite after it and a fully masked block adds exp(-inf) = 0
            new_m = tl.maximum(m, tl.max(t, axis=0))
            alpha = tl.exp(m - new_m)
            e = tl.exp(t - new_m)
            xs = (flat % W).to(tl.float32)
            ys = (flat // W).to(tl.float32)
            s = s * alpha + tl.sum(e, axis=0)
            sx = sx * alpha + tl.sum(e * xs, axis=0)
            sy = sy * alpha + tl.sum(e * ys, axis=0)
            m = new_m
        # the (1,)-shaped accumulators reduce to scalars for the stores
        out = part_ptr + (row * n_chunks + chunk) * 4
        tl.store(out + 0, tl.max(m, axis=0))
        tl.store(out + 1, tl.sum(s, axis=0))
        tl.store(out + 2, tl.sum(sx, axis=0))
        tl.store(out + 3, tl.sum(sy, axis=0))

    @triton.jit
    def merge_kernel(part_ptr, out_ptr, n_chunks, eps,
                     MERGE_BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = part_ptr + row * n_chunks * 4
        idx = tl.arange(0, MERGE_BLOCK)
        M = tl.full((1,), value=float("-inf"), dtype=tl.float32)
        for c0 in range(0, n_chunks, MERGE_BLOCK):
            valid = c0 + idx < n_chunks
            mc = tl.load(base + (c0 + idx) * 4, mask=valid,
                         other=float("-inf"))
            M = tl.maximum(M, tl.max(mc, axis=0))
        S = tl.zeros((1,), dtype=tl.float32)
        X = tl.zeros((1,), dtype=tl.float32)
        Y = tl.zeros((1,), dtype=tl.float32)
        for c0 in range(0, n_chunks, MERGE_BLOCK):
            valid = c0 + idx < n_chunks
            off = base + (c0 + idx) * 4
            mc = tl.load(off, mask=valid, other=float("-inf"))
            scale = tl.exp(mc - M)  # masked partials: exp(-inf) = 0
            S += tl.sum(tl.load(off + 1, mask=valid, other=0.0) * scale,
                        axis=0)
            X += tl.sum(tl.load(off + 2, mask=valid, other=0.0) * scale,
                        axis=0)
            Y += tl.sum(tl.load(off + 3, mask=valid, other=0.0) * scale,
                        axis=0)
        inv = 1.0 / (S + eps)
        tl.store(out_ptr + row * 2, tl.sum(X * inv, axis=0))
        tl.store(out_ptr + row * 2 + 1, tl.sum(Y * inv, axis=0))

    _KERNELS["partial"] = partial_kernel
    _KERNELS["merge"] = merge_kernel
    return partial_kernel, merge_kernel


def softargmax2d_rows(logits_hw_last, eps: float = 1e-6):
    """(..., H, W) f32 logits -> (..., 2) expected (x, y).

    A CPU tensor takes the plain version; a CUDA tensor launches the Triton
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
    HW = H * W
    R = x.numel() // HW
    chunk = BLOCK * BLOCKS_PER_CHUNK
    n_chunks = (HW + chunk - 1) // chunk
    part = torch.empty((R, n_chunks, 4), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((R, 2), dtype=torch.float32, device=x.device)
    partial_kernel, merge_kernel = _kernels()
    with torch.cuda.device(x.device):
        partial_kernel[(R, n_chunks)](x, part, HW, W, n_chunks, BLOCK=BLOCK,
                                      BLOCKS_PER_CHUNK=BLOCKS_PER_CHUNK,
                                      num_warps=4)
        merge_kernel[(R,)](part, out, n_chunks, eps,
                           MERGE_BLOCK=MERGE_BLOCK, num_warps=2)
    softargmax2d_rows.launches += 1
    return out.reshape(*x.shape[:-2], 2)


softargmax2d_rows.launches = 0
