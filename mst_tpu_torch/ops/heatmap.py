"""Distance-transform heatmap rasterizer (counterpart of
mst_tpu/ops/heatmap.py:52-59, 151-165).

The reference slices windows out of a (4200 * resize)^2 distance template
around each rounded point; evaluated analytically, the window value at a
pixel is 2 * hypot(i - y, j - x) / hypot(S//2, S//2). Points round half to
even, as np.round and jnp.round do (torch.round does the same). The
space-to-depth packed rasterizers of the JAX package exist for the TPU's
128 lanes and have no counterpart here.
"""

import math

import torch


def dist_template_scale(template_size: int) -> float:
    """Max of the size-S distance template: hypot(S//2, S//2)."""
    m = template_size // 2
    return math.hypot(m, m)


def rasterize_dist_nhwc(points, H: int, W: int, template_size: int):
    """(B, T, 2) (x, y) points -> (B, H, W, T) f32 distance maps."""
    pts = points.to(torch.float32)
    x = torch.round(pts[..., 0])  # (B, T)
    y = torch.round(pts[..., 1])
    scale = 2.0 / dist_template_scale(template_size)
    rows = torch.arange(H, dtype=torch.float32, device=pts.device)
    cols = torch.arange(W, dtype=torch.float32, device=pts.device)
    dy2 = (rows[None, None, :] - y[..., None]) ** 2  # (B, T, H)
    dx2 = (cols[None, None, :] - x[..., None]) ** 2  # (B, T, W)
    d2 = (dy2.transpose(1, 2)[:, :, None, :]
          + dx2.transpose(1, 2)[:, None, :, :])  # (B, H, W, T)
    return torch.sqrt(d2) * scale
