"""Spatial soft-argmax (counterpart of mst_tpu/ops/softargmax.py).

The plain PyTorch versions of the reference SoftArgmax2D
(utils/softargmax.py:26-81, eps 1e-6) and softargmax_on_softmax_map
(models/ynet.py:588-600). `softargmax2d_auto` launches the hand-written
rows kernel on a CUDA tensor and runs the plain version on a CPU tensor.
"""

import torch


def softargmax2d_auto(logits_hw_last, eps: float = 1e-6):
    """softargmax2d through ops/kernels/softargmax_rows.py: the Triton
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows

    return softargmax2d_rows(logits_hw_last, eps)


def softargmax2d(logits_hw_last, eps: float = 1e-6):
    """(..., H, W) logits -> (..., 2) expected (x, y) pixel coordinates."""
    x = logits_hw_last
    H, W = x.shape[-2], x.shape[-1]
    flat = x.reshape(*x.shape[:-2], H * W)
    exp_x = torch.exp(flat - flat.amax(dim=-1, keepdim=True))
    inv_sum = 1.0 / (exp_x.sum(dim=-1, keepdim=True) + eps)
    probs = (exp_x * inv_sum).reshape(x.shape)
    return softargmax_on_prob_map(probs)


def softargmax2d_nhwc(logits_nhwc, eps: float = 1e-6):
    """Channels-last soft-argmax: (B, H, W, C) -> (B, C, 2), in f32."""
    x = logits_nhwc.to(torch.float32)
    B, H, W, C = x.shape
    m = x.amax(dim=(1, 2))  # (B, C)
    e = torch.exp(x - m[:, None, None, :])
    s = e.sum(dim=(1, 2))
    xs = torch.arange(W, dtype=torch.float32, device=x.device)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    ex = torch.einsum("bhwc,w->bc", e, xs)
    ey = torch.einsum("bhwc,h->bc", e, ys)
    inv = 1.0 / (s + eps)
    return torch.stack([ex * inv, ey * inv], -1)


def softargmax_on_prob_map(probs_hw_last):
    """Expected coordinate of an already-normalised (..., H, W) map, with
    no re-normalisation; E[x] and E[y] come from the column and row
    marginals."""
    p = probs_hw_last
    H, W = p.shape[-2], p.shape[-1]
    xs = torch.arange(W, dtype=p.dtype, device=p.device)
    ys = torch.arange(H, dtype=p.dtype, device=p.device)
    ex = (p.sum(dim=-2) * xs).sum(dim=-1)
    ey = (p.sum(dim=-1) * ys).sum(dim=-1)
    return torch.stack([ex, ey], dim=-1)
