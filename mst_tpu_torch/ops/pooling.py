"""Pooling and resizing on NHWC tensors (counterpart of
mst_tpu/ops/pooling.py): nn.MaxPool2d(2, 2), the AvgPool2d(2**i) waypoint
pyramid and F.interpolate(scale_factor=2, bilinear, align_corners=False),
run on the channels_last view."""

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


def avg_pool_pyramid(x, n_levels: int):
    """[x, avg2(x), avg4(x), ...] with n_levels entries (each level pools
    the previous one by 2x2, exact for maps padded to 2**(n_levels-1))."""
    out = [x]
    for _ in range(n_levels - 1):
        x = avg_pool_2x2(x)
        out.append(x)
    return out


def upsample_bilinear_2x(x):
    """(N, H, W, C) -> (N, 2H, 2W, C), half-pixel centres."""
    return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="bilinear",
                               align_corners=False))
