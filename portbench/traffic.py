"""The one generator of every cell's inputs, from the workload file's
parameters and the run's seed: scene maps and weights on the card, tracks
on the host, and the order of the requests or batches.

Every seed gets the same work: the request sizes, styles and scenes are
fixed multisets (each a cycle over its range) that the seed only
permutes, block by block, so runs with different seeds differ in what
they draw and not in how much they do.
"""

import math

import numpy as np
import torch

from portbench.reference import model


def scene_maps(seed, n, H, W, C, device):
    """n semantic maps (1, H, W, C), softmax-normalised over the classes
    (the segmented map a request carries), made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((n, H, W, C), generator=g, device=device) * 2.0
    return [m[None].contiguous() for m in logits.softmax(-1)]


def tracks(rng, n, length, H, W, speed):
    """n straight-ish walks of `length` points (x, y) in model pixels,
    starting in the middle 60% of the map, `speed` = (lo, hi) pixels a
    step, with a little noise; every point stays inside the map."""
    start = rng.uniform([0.2 * W, 0.2 * H], [0.8 * W, 0.8 * H], size=(n, 2))
    angle = rng.uniform(0, 2 * math.pi, size=n)
    step = rng.uniform(*speed, size=n)
    vel = np.stack([np.cos(angle), np.sin(angle)], -1) * step[:, None]
    t = np.arange(length)[None, :, None]
    pts = start[:, None] + vel[:, None] * t + rng.normal(
        0, 0.3, size=(n, length, 2))
    return np.clip(pts, 1, [W - 2, H - 2]).astype(np.float32)


def cycle(rng, values, n):
    """n entries: `values` over and over, each pass in a new seeded
    order."""
    out = []
    while len(out) < n:
        out.extend(rng.permutation(values).tolist())
    return out[:n]


def requests(seed, cell, config):
    """The serve cells' request list: dicts with 'scene', 'style' (None
    for the base weights), 'observed' (B, obs_len, 2) and 'key' (two
    32-bit words: the seed's, and the request's index)."""
    rng = np.random.default_rng(seed)
    n = int(cell["requests"])
    lo, hi = cell["agents"]
    agents = cycle(rng, np.arange(lo, hi + 1), n)
    styles = cycle(rng, np.arange(cell["styles"] + 1), n)
    scenes = cycle(rng, np.arange(cell["scenes"]), n)
    obs = int(config["obs_len"])
    out = []
    for i in range(n):
        out.append({
            "scene": scenes[i],
            "style": None if styles[i] == 0 else f"style{styles[i]}",
            "observed": tracks(rng, agents[i], obs, cell["height"],
                               cell["width"], cell["speed"]),
            "key": np.array([seed % (1 << 32), i], dtype=np.int64)})
    return out


def few_shot(seed, cell, config, device):
    """The fine-tune cells' few-shot set: n_batches batches of batch_size
    rows, batch b on scene map b % scenes -> [{'semantic', 'traj',
    'mask'}] on the card, every row its own track."""
    rng = np.random.default_rng(seed)
    maps = scene_maps(seed, cell["scenes"], cell["height"], cell["width"],
                      int(config["n_semantic_classes"]), device)
    total = int(config["obs_len"]) + int(config["pred_len"])
    out = []
    for b in range(cell["n_batches"]):
        traj = tracks(rng, cell["batch_size"], total, cell["height"],
                      cell["width"], cell["speed"])
        out.append({"semantic": maps[b % len(maps)],
                    "traj": torch.tensor(traj, device=device),
                    "mask": torch.ones(cell["batch_size"], device=device)})
    return out


def batch_order(seed, n_batches, n_steps):
    """The batches' order: each epoch a new seeded permutation."""
    return cycle(np.random.default_rng(seed + 1), np.arange(n_batches),
                 n_steps)


def weights(net, seed, device):
    """The model's weights ({path: OIHW tensor}), made on the card from
    the seed in one draw: each leaf uniform within its init bound (a
    bias within 1/sqrt(fan_in) of its conv), every lora_B zero, as a
    MoSA base before its fine-tune."""
    shapes = model.param_shapes(net)
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for path, shape in shapes.items():
        n = math.prod(shape)
        leaf = u[at:at + n].view(shape)
        at += n
        if path.endswith("lora_B"):
            leaf = torch.zeros(shape, device=device)
        elif path.endswith("bias"):
            w = shapes[path[:-len("bias")] + "weight"]
            leaf = leaf / math.sqrt(w[1] * w[2] * w[3])
        else:
            leaf = leaf * model.init_bound(path, shape)
        out[path] = leaf.contiguous()
    return out


def style_deltas(net, seed, n, device):
    """n motion styles: every LoRA factor of the net drawn anew, lora_B
    at 0.3 / sqrt(rank k) so that a style moves each merged weight by
    about a third of its own scale -> [{path: tensor}]."""
    shapes = {k: s for k, s in model.param_shapes(net).items()
              if "lora" in k}
    g = torch.Generator(device=device).manual_seed(seed + 2)
    per = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(n * per, generator=g, device=device) * 2.0 - 1.0
    out, at = [], 0
    for _ in range(n):
        delta = {}
        for path, shape in shapes.items():
            size = math.prod(shape)
            bound = (model.init_bound(path, shape) if path.endswith("lora_A")
                     else 0.3 / math.sqrt(shape[1]))
            delta[path] = (u[at:at + size].view(shape) * bound).contiguous()
            at += size
        out.append(delta)
    return out


def write_npz(path, flat):
    """A checkpoint file in the published layout: conv weights HWIO."""
    arrays = {}
    for k, v in flat.items():
        a = v.detach().cpu().numpy()
        arrays[k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    np.savez(path, **arrays)
