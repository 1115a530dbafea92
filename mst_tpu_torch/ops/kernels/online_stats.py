"""The log2-unit online soft-argmax statistics of csrc/online_softmax.cuh
(merge2, push_group, warp_merge2) in torch.

The CPU tests run the fused and rows kernels' work splits through these,
in the kernels' order, and hold the result against the TPU kernels. A
statistics tuple is (m, s, sx, sy), tensors of one shape: the running max
of the logits scaled by log2(e), the mass sum 2^(l - m) and the moments of
the x and y coordinates. merge_ranks merges the 'space' ranks' statistics
of a spatial mesh (the partial variant of the fused kernel, one H slab a
rank) into the whole map's soft-argmax.
"""

import math

import torch

from mst_tpu_torch.parallel import halo

LOG2E = 1.4426950408889634


def empty(shape, device=None):
    """Statistics of nothing, made on `device` (a CUDA graph captures no
    host-to-device copy)."""
    return (torch.full(shape, -math.inf, device=device),
            torch.zeros(shape, device=device),
            torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


def _where(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def merge2(a, b):
    """online_softmax::merge2: max-rescale two statistics into one."""
    M = torch.maximum(a[0], b[0])
    Ms = torch.where(M == -math.inf, 0.0, M)  # both empty: stay empty
    fa, fb = torch.exp2(a[0] - Ms), torch.exp2(b[0] - Ms)
    return (M, a[1] * fa + b[1] * fb, a[2] * fa + b[2] * fb,
            a[3] * fa + b[3] * fb)


def push_group(st, logits, fx, fy, valid=None):
    """online_softmax::push_group: add logits (..., N) at coordinates
    fx, fy (broadcast to logits): the group's max first, one rescale, N
    exponentials. Where `valid` is False the statistics stay as they were;
    a valid group needs one finite logit."""
    m = torch.maximum(st[0], logits.amax(-1))
    ms = torch.where(m == -math.inf, 0.0, m)  # only where valid is False
    r = torch.exp2(st[0] - ms)
    e = torch.exp2(logits - ms[..., None])
    new = (m, st[1] * r + e.sum(-1), st[2] * r + (e * fx).sum(-1),
           st[3] * r + (e * fy).sum(-1))
    return new if valid is None else _where(valid, new, st)


def warp_merge2(st, dim):
    """online_softmax::warp_merge2 over the 32 lanes along `dim`: the xor
    butterfly; returns lane 0's total (that dim removed)."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        other = tuple(t.index_select(dim, lanes ^ off) for t in st)
        st = merge2(st, other)
    return tuple(t.select(dim, 0) for t in st)


def finish(st, eps):
    """(sx, sy) / (s + eps) -> (..., 2)."""
    inv = 1.0 / (st[1] + eps)
    return torch.stack([st[2] * inv, st[3] * inv], -1)


def merge_ranks(stats, slab, eps: float = 1e-6):
    """stats (..., 4): this rank's (m, s, sx, sy) of its slab (mesh.Slab)
    -> the whole map's soft-argmax (..., 2), the same bits on every
    'space' rank: one all_reduce of a zero-filled (count, ..., 4) buffer
    in which each rank fills its own slot (about 30 KB at K * B = 160
    rows and P = 12), then merge2 folds the slots in rank order and
    finish ends the merged statistics."""
    buf = halo.gather(stats.unsqueeze(0), slab.index, slab.count,
                      slab.group)
    return fold(buf.unbind(0), eps)


def fold(parts, eps: float = 1e-6):
    """Statistics (..., 4) of a map's parts -> the map's soft-argmax
    (..., 2): merge2 over the parts in their order, then finish."""
    st = empty(parts[0].shape[:-1], parts[0].device)
    for part in parts:
        st = merge2(st, part.unbind(-1))
    return finish(st, eps)
