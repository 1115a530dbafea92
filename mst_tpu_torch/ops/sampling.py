"""Probability-map sampling (counterpart of mst_tpu/ops/sampling.py:48-105;
reference utils/image_utils.py:110-135).

With replacement: inverse-CDF sampling, one cumsum and
torch.searchsorted(right=True), which skips zero-weight bins even on exact
ties. Without replacement: Gumbel top-k, the exact sequential-multinomial
distribution. The noise comes from a torch.Generator, or is passed in
(`u=`, `gumbel=`) so a test can feed both packages the same draws.
"""

import torch


def sample_heatmap(prob_map, num_samples: int, rel_threshold=None,
                   replacement: bool = False, generator=None, u=None,
                   gumbel=None):
    """Sample (x, y) coordinates from (..., H, W) non-negative maps.

    rel_threshold excludes entries below rel_threshold * max(map).
    u: optional (rows, num_samples) uniforms in [0, 1) for the
    with-replacement draw; gumbel: optional (rows, H*W) Gumbel noise for
    the draw without replacement (rows = prod of the leading dims).

    Returns (..., num_samples, 2) f32 coordinates.
    """
    p = prob_map
    H, W = p.shape[-2], p.shape[-1]
    batch_shape = p.shape[:-2]
    flat = p.reshape(-1, H * W)
    below = None
    if rel_threshold is not None:
        below = flat < flat.amax(dim=1, keepdim=True) * rel_threshold

    if replacement:
        w = flat.to(torch.float32)
        if below is not None:
            w = torch.where(below, torch.zeros_like(w), w)
        cdf = torch.cumsum(w, dim=1)
        if u is None:
            u = torch.rand((flat.shape[0], num_samples), generator=generator,
                           device=flat.device)
        u = u.to(device=flat.device, dtype=torch.float32) * cdf[:, -1:]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=H * W - 1)
    else:
        logp = torch.log(torch.clamp(flat, min=1e-38))
        if below is not None:
            logp = torch.where(below, torch.full_like(logp, -torch.inf), logp)
        if gumbel is None:
            # -log(E) with E ~ Exp(1) is a standard Gumbel draw
            gumbel = -torch.empty_like(logp).exponential_(
                generator=generator).log()
        gumbel = gumbel.to(device=flat.device, dtype=logp.dtype)
        idx = torch.topk(logp + gumbel, num_samples, dim=1).indices

    coords = torch.stack([(idx % W).to(torch.float32),
                          torch.div(idx, W, rounding_mode="floor").to(
                              torch.float32)], dim=-1)
    return coords.reshape(*batch_shape, num_samples, 2)
