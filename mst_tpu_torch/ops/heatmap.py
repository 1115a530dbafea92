"""Heatmap rasterizers: the distance-transform input maps and the Gaussian
ground-truth maps (counterpart of mst_tpu/ops/heatmap.py:39-59, 126-165).

The reference slices windows out of a (4200 * resize)^2 distance template
around each rounded point; evaluated analytically, the window value at a
pixel is 2 * hypot(i - y, j - x) / hypot(S//2, S//2). Points round half to
even, as np.round and jnp.round do (torch.round does the same). The
Gaussian template is separable, so a map is the outer product of two
windowed 1-D Gaussians divided by the template's sum. Each takes a first
row (row0): the map is then rows [row0, row0 + H) of the whole map, a
spatial mesh's H slab. The
space-to-depth packed rasterizers of the JAX package exist for the TPU's
128 lanes and have no counterpart here.
"""

import math

import numpy as np
import torch


def gaussian_template_normalizer(kernlen: int = 31,
                                 nsig: float = 4.0) -> float:
    """Sum of the un-normalised gkern grid (reference
    utils/image_utils.py:7-12), computed separably:
    (sum_d exp(-0.5 d^2 / nsig^2))^2 over d = linspace(-(k-1)/2, (k-1)/2,
    k)."""
    ax = np.linspace(-(kernlen - 1) / 2.0, (kernlen - 1) / 2.0, kernlen)
    one_d = np.exp(-0.5 * np.square(ax) / (nsig ** 2))
    return float(one_d.sum() ** 2)


def dist_template_scale(template_size: int) -> float:
    """Max of the size-S distance template: hypot(S//2, S//2)."""
    m = template_size // 2
    return math.hypot(m, m)


def rasterize_dist_nhwc(points, H: int, W: int, template_size: int,
                        row0: int = 0):
    """(B, T, 2) (x, y) points -> (B, H, W, T) f32 distance maps of rows
    [row0, row0 + H)."""
    pts = points.to(torch.float32)
    x = torch.round(pts[..., 0])  # (B, T)
    y = torch.round(pts[..., 1])
    scale = 2.0 / dist_template_scale(template_size)
    rows = torch.arange(row0, row0 + H, dtype=torch.float32,
                        device=pts.device)
    cols = torch.arange(W, dtype=torch.float32, device=pts.device)
    # T innermost in both terms, so the map comes out contiguous NHWC:
    # laid out (B, T, H, W), it would make every conv that reads it (and
    # every conv after) run NCHW, and the fused decode tail refuse it
    dy2 = (rows[None, :, None] - y[:, None, :]) ** 2  # (B, H, T)
    dx2 = (cols[None, :, None] - x[:, None, :]) ** 2  # (B, W, T)
    d2 = dy2[:, :, None, :] + dx2[:, None, :, :]  # (B, H, W, T)
    return torch.sqrt(d2) * scale


def rasterize_gaussian_nhwc(points, H: int, W: int, kernlen: int = 31,
                            nsig: float = 4.0, row0: int = 0):
    """(B, T, 2) (x, y) points -> (B, H, W, T) f32 Gaussian maps of rows
    [row0, row0 + H): the reference's gt template (kernlen window, sigma
    nsig, normalised by its sum) at each rounded point, built straight
    into NHWC."""
    pts = points.to(torch.float32)
    x = torch.round(pts[..., 0])  # (B, T)
    y = torch.round(pts[..., 1])
    half = (kernlen - 1) // 2
    inv_two_sig2 = 0.5 / (nsig ** 2)
    norm = gaussian_template_normalizer(kernlen, nsig)
    rows = torch.arange(row0, row0 + H, dtype=torch.float32,
                        device=pts.device)
    cols = torch.arange(W, dtype=torch.float32, device=pts.device)
    dy = rows[None, None, :] - y[..., None]  # (B, T, H)
    dx = cols[None, None, :] - x[..., None]  # (B, T, W)
    gy = torch.exp(-inv_two_sig2 * dy * dy) * (dy.abs() <= half)
    gx = torch.exp(-inv_two_sig2 * dx * dx) * (dx.abs() <= half)
    return (gy.transpose(1, 2)[:, :, None, :]
            * gx.transpose(1, 2)[:, None, :, :]) / norm
