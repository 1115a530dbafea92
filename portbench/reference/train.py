"""The few-shot fine-tune step: Y-Net's loss (BCE on the goal and the
trajectory heatmaps against Gaussian ground-truth maps, times loss_scale;
the trajectory decoder fed the ground-truth waypoints' distance maps),
the top-1 soft-argmax ADE/FDE it reports, and Adam as optax computes it.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model

B1, B2, EPS = 0.9, 0.999, 1e-8


def gaussian_maps(points, H, W, kernlen, nsig):
    """(B, T, 2) (x, y) -> (B, T, H, W): the kernlen-wide Gaussian
    template (sigma nsig, normalised by its sum) at each rounded point."""
    half = (kernlen - 1) // 2
    ax = np.linspace(-(kernlen - 1) / 2.0, (kernlen - 1) / 2.0, kernlen)
    norm = float(np.exp(-0.5 * ax ** 2 / nsig ** 2).sum() ** 2)
    x = torch.round(points[..., 0].float())
    y = torch.round(points[..., 1].float())
    rows = torch.arange(H, dtype=torch.float32, device=points.device)
    cols = torch.arange(W, dtype=torch.float32, device=points.device)
    dy = rows - y[..., None]
    dx = cols - x[..., None]
    gy = torch.exp(-0.5 * dy * dy / nsig ** 2) * (dy.abs() <= half)
    gx = torch.exp(-0.5 * dx * dx / nsig ** 2) * (dx.abs() <= half)
    return gy[..., :, None] * gx[..., None, :] / norm


def masked_bce(logits, target, mask):
    per = F.binary_cross_entropy_with_logits(logits, target,
                                             reduction="none")
    m = mask.reshape(-1, *([1] * (per.dim() - 1)))
    count = mask.sum() * (per.numel() / mask.numel())
    return (per * m).sum() / torch.clamp(count, min=1.0)


def step_outputs(params, net, cfg, batch):
    """-> {'loss', 'goal_loss', 'traj_loss', 'ade_sum', 'fde_sum'} of one
    batch: 'semantic' (1, H, W, C), 'traj' (B, obs + pred, 2) model px,
    'mask' (B,)."""
    traj, mask = batch["traj"], batch["mask"]
    B = traj.shape[0]
    semantic = batch["semantic"].permute(0, 3, 1, 2).expand(B, -1, -1, -1)
    H, W = semantic.shape[-2:]
    ts = int(4200 * float(cfg["resize_factor"]))
    obs = int(cfg["obs_len"])
    future = traj[:, obs:]
    gt = gaussian_maps(future, H, W, int(cfg["kernlen"]), float(cfg["nsig"]))
    feats = model.features(params, net, semantic, traj, ts)
    goal = model.goal_logits(params, feats)
    traj_map = model.traj_logits(params, feats, future[:, list(net.waypoints)],
                                 ts)
    scale = float(cfg["loss_scale"])
    goal_loss = masked_bce(goal, gt, mask) * scale
    traj_loss = masked_bce(traj_map, gt, mask) * scale
    with torch.no_grad():
        rf = float(cfg["resize_factor"])
        pts = model.softargmax(traj_map.detach())
        goal_pt = model.softargmax(goal.detach()[:, -1:])
        ade = torch.sqrt((((future - pts) / rf) ** 2).sum(-1)).mean(-1)
        fde = torch.sqrt((((future[:, -1:] - goal_pt[:, -1:]) / rf) ** 2)
                         .sum(-1)).mean(-1)
    return {"loss": goal_loss + traj_loss, "goal_loss": goal_loss,
            "traj_loss": traj_loss, "ade_sum": (ade * mask).sum(),
            "fde_sum": (fde * mask).sum()}


def trainable(net, names):
    """The leaves MoSA trains: the encoder's LoRA factors."""
    if "mosa" not in net.train_net:
        raise ValueError(f"no MoSA leaves under train_net={net.train_net!r}")
    return [k for k in names if k.startswith("encoder/") and "lora" in k]


def follow(params, net, cfg, batches, lr, n_steps=3):
    """n_steps Adam steps from `params` ({path: tensor}, copied) on
    `batches` in order -> {'outputs': [step_outputs as floats, ...],
    'grads': [{leaf: gradient}, ...] (each step's), 'change': {leaf:
    params after the steps - before}}."""
    params = {k: v.detach().clone() for k, v in params.items()}
    names = trainable(net, params)
    for k in names:
        params[k].requires_grad_(True)
    mu = {k: torch.zeros_like(params[k]) for k in names}
    nu = {k: torch.zeros_like(params[k]) for k in names}
    start = {k: params[k].detach().clone() for k in names}
    outputs, grads = [], []
    for step in range(n_steps):
        out = step_outputs(params, net, cfg, batches[step])
        g = torch.autograd.grad(out["loss"], [params[k] for k in names])
        grads.append({k: gi.detach() for k, gi in zip(names, g)})
        outputs.append({k: float(v.detach()) for k, v in out.items()})
        with torch.no_grad():
            c = step + 1
            for k, gi in zip(names, g):
                mu[k] = (1 - B1) * gi + B1 * mu[k]
                nu[k] = (1 - B2) * (gi * gi) + B2 * nu[k]
                upd = (mu[k] / (1 - B1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                params[k] -= lr * upd
        del out, g
    return {"outputs": outputs, "grads": grads,
            "change": {k: (params[k] - start[k]).detach() for k in names}}


def norm(t):
    return math.sqrt(float((t.double() ** 2).sum()))
