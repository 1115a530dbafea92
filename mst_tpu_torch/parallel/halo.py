"""The collectives of a mesh's ranks: the halo exchange of a map's edge
rows between a spatial mesh's H neighbours (mesh.Slab), and the gather of
equal blocks to the whole tensor (the slabs of a map, the rows of a
batch, the ranks' partial statistics). XLA's GSPMD adds these to mst_tpu's
program (collective-permutes for the halos, all-gathers where a level
runs whole); the port calls them where the model needs them
(models/layers.conv2d, ops/pooling.upsample_bilinear_2x, the odd-slab
levels of models/ynet.py, and the eval and train steps).

Each is one all_reduce over its ranks' group (the 'space' ranks for the
maps) of a zero-filled buffer in which every rank fills its own slot: a
sum of one value and zeros is exact, and it is what every backend does
on CUDA tensors (gloo gathers nothing on them, and its point-to-point
calls are not known to take them), so it serves the card's standard
run, two ranks sharing one card over gloo, and NCCL alike. An exchange
of k rows moves a buffer of count x 2 x N x k x W x C elements through
the all_reduce: at the finest level of the eval decode (K * B = 160, 480
columns, 32 channels, k = 1, two ranks, f32) 39.3 MB a conv.

Both are autograd functions, so a train step differentiates through
them (an in-place all_reduce on a buffer of the graph would hide the
collective from autograd, and each halo row's gradient would stay on the
rank that used it). The exchange's backward is the reverse exchange: the
gradients of the k rows taken from each neighbour go back to it, in the
same kind of zero-filled all_reduce, and are added onto its edge rows.
The gather's backward sums the whole gradient over the group and keeps
the rank's own block: where a level runs whole, every 'space' rank
computes the same map and uses it only for its own slab's loss, so the
map's true gradient is the sum of the ranks'. Every rank runs every
backward collective, in the same order, as it runs the forward's.
"""

import torch
import torch.distributed as dist


def exchange(x, slab, k, edge="zero"):
    """x (N, rows, W, C), this rank's slab -> its k rows above and below
    taken from the H neighbours' slabs: (N, rows + 2k, W, C); k may be a
    pair (above, below), either of them 0 (a stride-2 op reads more rows
    above its slab than below: models/unet.py). At the global top and
    bottom, edge 'zero' puts the rows as zeros (a SAME conv's padding)
    and 'none' nothing, so the map then starts or ends there
    (F.interpolate's own clamp at the map's edge). Differentiable: the
    backward sends each halo row's gradient back to its owner; a zero
    row's gradient is dropped."""
    top, bottom = (k, k) if isinstance(k, int) else (int(k[0]), int(k[1]))
    rows = x.shape[1]
    if not (0 <= top <= rows and 0 <= bottom <= rows and top + bottom):
        raise ValueError(f"a halo of {top} rows above and {bottom} below "
                         f"needs slabs of at least as many rows; this one "
                         f"has {rows}")
    return _Exchange.apply(x, slab, top, bottom, edge)


class _Exchange(torch.autograd.Function):

    # one buffer a rank, slot [j]: rank j's first `bottom` rows (which
    # rank j - 1 takes as its bottom halo), then its last `top` rows
    # (which rank j + 1 takes as its top halo)

    @staticmethod
    def forward(ctx, x, slab, top, bottom, edge):
        rows = x.shape[1]
        ctx.slab, ctx.top, ctx.bottom, ctx.edge, ctx.rows = \
            slab, top, bottom, edge, rows
        buf = x.new_zeros((slab.count, x.shape[0], bottom + top,
                           *x.shape[2:]))
        buf[slab.index, :, :bottom] = x[:, :bottom]
        buf[slab.index, :, bottom:] = x[:, rows - top:]
        dist.all_reduce(buf, group=slab.group)
        parts = []
        if top and slab.index > 0:
            parts.append(buf[slab.index - 1, :, bottom:])
        elif top and edge == "zero":
            parts.append(x.new_zeros((x.shape[0], top, *x.shape[2:])))
        parts.append(x)
        if bottom and slab.index < slab.count - 1:
            parts.append(buf[slab.index + 1, :, :bottom])
        elif bottom and edge == "zero":
            parts.append(x.new_zeros((x.shape[0], bottom, *x.shape[2:])))
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        slab, top, bottom, rows = ctx.slab, ctx.top, ctx.bottom, ctx.rows
        above = top if slab.index > 0 or ctx.edge == "zero" else 0
        buf = g.new_zeros((slab.count, g.shape[0], bottom + top,
                           *g.shape[2:]))
        if top and slab.index > 0:  # rank index - 1's last rows
            buf[slab.index - 1, :, bottom:] = g[:, :top]
        if bottom and slab.index < slab.count - 1:  # index + 1's first
            buf[slab.index + 1, :, :bottom] = g[:, above + rows:
                                                 above + rows + bottom]
        dist.all_reduce(buf, group=slab.group)
        grad = g.narrow(1, above, rows).clone(
            memory_format=torch.contiguous_format)
        grad[:, :bottom] += buf[slab.index, :, :bottom]
        grad[:, rows - top:] += buf[slab.index, :, bottom:]
        return grad, None, None, None, None


def gather(x, index, count, group, dim=0):
    """Each rank's block of a tensor along dim (block `index` of `count`
    equal blocks, over the ranks of `group`) -> the whole tensor, the same
    bits on every rank: the 'space' ranks' slabs of a map (mesh.Slab), a
    'data' row's batch rows (mesh.Shards.gather_rows), a rank's partial
    statistics (online_stats.merge_ranks). Differentiable: the backward
    sums the whole gradient over the group and keeps this rank's
    block."""
    return _Gather.apply(x, index, count, group, dim)


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, index, count, group, dim):
        n = x.shape[dim]
        ctx.index, ctx.group, ctx.dim, ctx.n = index, group, dim, n
        shape = list(x.shape)
        shape[dim] = n * count
        out = x.new_zeros(shape)
        out.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, \
            None, None
