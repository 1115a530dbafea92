"""Spatial soft-argmax (counterpart of mst_tpu/ops/softargmax.py).

The plain PyTorch versions of the reference SoftArgmax2D
(utils/softargmax.py:26-81, eps 1e-6) and softargmax_on_softmax_map
(models/ynet.py:588-600). `softargmax2d_auto` launches the hand-written
rows kernel on a CUDA tensor and runs the plain version on a CPU tensor.
The serving path is unpacked; `softargmax2d_packed` and
`unify_packed_stats` carry the packed channel layout that the decoder-chain
kernels (ops/kernels/decoder_chain.py) compute in.
"""

import torch


def softargmax2d_auto(logits_hw_last, eps: float = 1e-6):
    """softargmax2d through ops/kernels/softargmax_rows.py: the CUDA
    kernel for a CUDA tensor (f32 or bf16 logits), the plain version for a
    CPU tensor."""
    from mst_tpu_torch.ops.kernels.softargmax_rows import softargmax2d_rows

    return softargmax2d_rows(logits_hw_last, eps)


def softargmax2d(logits_hw_last, eps: float = 1e-6):
    """(..., H, W) logits -> (..., 2) expected (x, y) pixel coordinates;
    bf16 logits are widened to f32 first, as mst_tpu's rows wrapper widens
    them (mst_tpu/ops/pallas/softargmax.py:100)."""
    x = logits_hw_last
    if x.dtype == torch.bfloat16:
        x = x.float()
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


def softargmax2d_packed(packed_nhwc, n_channels: int, eps: float = 1e-6):
    """Soft-argmax of a space-to-depth packed map: (B, H/2, W/2, 4C) with
    channel (si*2 + sj)*C + c -> (B, C, 2) coordinates on the
    full-resolution grid (x = 2j + sj, y = 2i + si), in f32."""
    B, Hp, Wp, C4 = packed_nhwc.shape
    C = n_channels
    if C4 != 4 * C:
        raise ValueError(f"softargmax2d_packed: {C4} channels, expected "
                         f"4 x {C}")
    x = packed_nhwc.to(torch.float32).reshape(B, Hp, Wp, 4, C)
    m = x.amax(dim=(1, 2, 3))  # (B, C)
    e = torch.exp(x - m[:, None, None, None, :])
    s4 = e.sum(dim=(1, 2))  # (B, 4, C) mass of each sub-position
    jw = torch.arange(Wp, dtype=torch.float32, device=x.device)
    ih = torch.arange(Hp, dtype=torch.float32, device=x.device)
    ex4 = torch.einsum("bhwkc,w->bkc", e, jw)
    ey4 = torch.einsum("bhwkc,h->bkc", e, ih)
    sj = torch.tensor([0.0, 1.0, 0.0, 1.0], device=x.device)[None, :, None]
    si = torch.tensor([0.0, 0.0, 1.0, 1.0], device=x.device)[None, :, None]
    S = s4.sum(1)
    X = (2.0 * ex4 + sj * s4).sum(1)
    Y = (2.0 * ey4 + si * s4).sum(1)
    inv = 1.0 / (S + eps)
    return torch.stack([X * inv, Y * inv], -1)


def unify_packed_stats(m, s, sx, sy, n_pred: int, eps: float):
    """Merge the four packed sub-position online-softmax statistics.

    m, s, sx, sy: (..., 4*n_pred) running max, mass, x- and y-moment (in
    packed column j and row i) of packed channel k*n_pred + p, k = si*2 + sj
    (the softargmax2d_packed layout). Returns the full-resolution expected
    (X, Y), each (..., n_pred).
    """
    P = n_pred
    mk = [m[..., k * P:(k + 1) * P] for k in range(4)]
    M = torch.maximum(torch.maximum(mk[0], mk[1]),
                      torch.maximum(mk[2], mk[3]))
    S = X = Y = 0.0
    for k in range(4):
        sj, si = float(k % 2), float(k // 2)
        scale = torch.exp(mk[k] - M)
        sk = s[..., k * P:(k + 1) * P] * scale
        S = S + sk
        X = X + 2.0 * sx[..., k * P:(k + 1) * P] * scale + sj * sk
        Y = Y + 2.0 * sy[..., k * P:(k + 1) * P] * scale + si * sk
    inv = 1.0 / (S + eps)
    return X * inv, Y * inv


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
