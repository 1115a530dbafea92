"""Pooling and resizing on NHWC tensors (counterpart of
mst_tpu/ops/pooling.py): nn.MaxPool2d(2, 2), the AvgPool2d(2**i) waypoint
pyramid and F.interpolate(scale_factor=2, bilinear, align_corners=False),
run on the channels_last view.

On a spatial mesh (a mesh.Slab of the input) the pools are exact on a
slab whose first row and length are even, and the bilinear x2 reads one
halo row of each neighbour's slab."""

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def max_pool_2x2(x):
    """(N, H, W, C) -> (N, H//2, W//2, C)."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def avg_pool_2x2(x):
    return _nhwc(F.avg_pool2d(_nchw(x), 2, 2))


def pool_down(x, pool, slab, next_slab):
    """pool(x) from a level whose slab (None: whole) is `slab` to the
    next, whose slab is `next_slab` (mesh.Slab.down). Where the next
    level runs whole (next_slab None), the 'space' ranks gather: this
    level before the pool when its slab's rows are odd, else the pooled
    slabs."""
    if slab is None or next_slab is not None:
        return pool(x)
    if slab.rows % 2:
        return pool(slab.gather(x))
    return slab.half().gather(pool(x))


def avg_pool_pyramid(x, n_levels: int, slabs=None):
    """[x, avg2(x), avg4(x), ...] with n_levels entries (each level pools
    the previous one by 2x2, exact for maps padded to 2**(n_levels-1)).
    slabs: each level's mesh.Slab (mesh.Slab.levels), x the first's
    rows; each entry is then its level's slab, or the whole level where
    the slab is None (pool_down)."""
    slabs = slabs or [None] * n_levels
    out = [x]
    for i in range(n_levels - 1):
        x = pool_down(x, avg_pool_2x2, slabs[i], slabs[i + 1])
        out.append(x)
    return out


def upsample_bilinear_2x(x, slab=None, out_slab=None):
    """(N, H, W, C) -> (N, 2H, 2W, C), half-pixel centres. slab: x is
    this slab's rows (its neighbours give a halo row each side; at the
    map's global edges F.interpolate clamps, as on the whole map), and
    the output is the slab twice as high; out_slab (x whole): the
    output's rows of that slab."""
    if slab is None:
        y = _Upsample2x.apply(x)
        return y if out_slab is None else out_slab.take(y)
    xe = slab.exchange(x, 1, edge="none")
    top = int(slab.index > 0)
    return _Upsample2x.apply(xe).narrow(1, 2 * top, 2 * x.shape[1])


class _Upsample2x(torch.autograd.Function):
    """F.interpolate's x2 bilinear forward with a backward that sums in a
    fixed order: F.interpolate's own backward scatters with atomicAdd on
    CUDA, so two identical train steps there differ in their last bits,
    as XLA's do not. It keeps nothing for its backward, and torch.func
    transforms (the grid's grad under vmap) run it through
    setup_context and a generated vmap rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _nhwc(F.interpolate(_nchw(x), scale_factor=2,
                                   mode="bilinear", align_corners=False))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _adjoint_2x(_adjoint_2x(g, 1), 2)


def _adjoint_2x(g, dim):
    """The adjoint along dim of the x2 half-pixel stencil out[2i] =
    0.75 x[i] + 0.25 x[max(i-1, 0)], out[2i+1] = 0.75 x[i] +
    0.25 x[min(i+1, n-1)]: (.., 2n, ..) -> (.., n, ..)."""
    n = g.shape[dim] // 2
    pairs = g.unflatten(dim, (n, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    zero = torch.zeros_like(even.narrow(dim, 0, 1))
    gx = 0.75 * (even + odd) + 0.25 * (
        torch.cat([even.narrow(dim, 1, n - 1), zero], dim)
        + torch.cat([zero, odd.narrow(dim, 0, n - 1)], dim))
    gx.narrow(dim, 0, 1).add_(even.narrow(dim, 0, 1), alpha=0.25)
    gx.narrow(dim, n - 1, 1).add_(odd.narrow(dim, n - 1, 1), alpha=0.25)
    return gx
