"""The serving forward's draws: keyed noise, the heatmap sampler, TTST's
k-means and CWS (Y-Net's test-time sampling trick and conditional
waypoint sampling, the MST reference's utils/evaluate.py and
utils/kmeans.py).

The draws are a counter-based hash of (key, stream, counter, index):
a frozen copy of the arithmetic the program states for its keyed draws,
so that one key gives both sides the same uniforms and the same
exponentials. Each draw call takes the next stream number, in the order
the published forward draws: the goal samples, k-means' initial centres
and its reseeds, then one draw per CWS waypoint.
"""

import torch

from portbench.reference import model

_MASK32 = 0xFFFFFFFF
_MULTIPLIERS = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39)


def mix32(h):
    h = h ^ (h >> 16)
    for m, shift in zip(_MULTIPLIERS, (15, 13, 16)):
        h = (h * m) & _MASK32
        h = h ^ (h >> shift)
    return h


class Key:
    def __init__(self, key):
        self.key = key
        self.streams = 0

    def bits(self, shape, counter=0):
        stream = self.streams
        self.streams += 1
        k = self.key
        h = mix32(mix32(mix32(mix32(k[0]) ^ k[1]) ^ stream) ^ counter)
        n = 1
        for d in shape:
            n *= d
        idx = torch.arange(n, dtype=torch.int64, device=k.device)
        return mix32(h.reshape(*h.shape, 1) ^ idx).reshape(*h.shape, *shape)

    def uniform(self, shape):
        return (self.bits(shape) >> 8).to(torch.float32) * 2.0 ** -24

    def randint(self, high, shape, counter=0):
        return ((self.bits(shape, counter) >> 8) * high) >> 24

    def exponential(self, shape):
        u = ((self.bits(shape) >> 8) + 1).to(torch.float64) * 2.0 ** -24
        return (-torch.log(u)).to(torch.float32).clamp(min=2.0 ** -25)


def sample(maps, n, key, rel_threshold=None, replacement=False):
    """(..., H, W) non-negative maps -> (..., n, 2) pixel (x, y) draws:
    with replacement by the inverse CDF, without by Gumbel top-n; entries
    below rel_threshold of a map's max are never drawn."""
    H, W = maps.shape[-2:]
    lead = maps.shape[:-2]
    flat = maps.reshape(-1, H * W)
    below = None
    if rel_threshold is not None:
        below = flat < flat.amax(1, keepdim=True) * rel_threshold
    if replacement:
        w = flat.float() if below is None else torch.where(
            below, torch.zeros_like(flat), flat)
        cdf = torch.cumsum(w, 1)
        u = key.uniform((flat.shape[0], n)) * cdf[:, -1:]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=H * W - 1)
    else:
        logp = torch.log(torch.clamp(flat, min=1e-38))
        if below is not None:
            logp = torch.where(below, torch.full_like(logp, -torch.inf),
                               logp)
        gumbel = -key.exponential(tuple(logp.shape)).log()
        idx = torch.topk(logp + gumbel, n, dim=1).indices
    xy = torch.stack([(idx % W).float(),
                      torch.div(idx, W, rounding_mode="floor").float()], -1)
    return xy.reshape(*lead, n, 2)


def kmeans(X, k, key, tol=1e-3, iter_limit=1000):
    """Each row of (B, N, 2) its own k-means run from k distinct drawn
    points, stopping on its own when the squared sum of its centres'
    shifts falls below tol; an empty cluster takes a drawn point of its
    row. -> centres (B, k, 2)."""
    B, N, _ = X.shape
    rows = torch.arange(B, device=X.device)[:, None]
    centers = X[rows, key.bits((B, N)).topk(k, dim=1).indices]
    reseed = key.randint(N, (B, k), counter=torch.arange(
        iter_limit, dtype=torch.int64, device=X.device))
    clusters = torch.arange(k, device=X.device)
    active = torch.ones(B, dtype=torch.bool, device=X.device)
    iters = torch.zeros(B, dtype=torch.int64, device=X.device)
    it = 0
    while bool(active.any()):
        d = ((X[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
        onehot = (d.argmin(2)[..., None] == clusters).to(X.dtype)
        counts = onehot.sum(1)
        means = (onehot.transpose(1, 2) @ X) / counts.clamp(min=1.0)[..., None]
        new = torch.where((counts > 0)[..., None], means, X[rows, reseed[it]])
        shift = torch.sqrt(((new - centers) ** 2).sum(-1)).sum(-1)
        centers = torch.where(active[:, None, None], new, centers)
        iters = iters + active.to(torch.int64)
        active = active & (shift ** 2 >= tol) & (iters < iter_limit)
        it += 1
    return centers


def cws_prior(mean, dist, sigma_factor, ratio, rot, H, W):
    """The oriented Gaussian prior of CWS, normalised to sum 1 ->
    (..., H, W)."""
    dev = mean.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) * (H / (H - 1))
    xs = torch.arange(W, dtype=torch.float32, device=dev) * (W / (W - 1))
    ax = ys - mean[..., 1][..., None]
    ay = xs - mean[..., 0][..., None]
    rad = torch.atan2(dist[..., 0], dist[..., 1])
    c, s = torch.cos(rad), torch.sin(rad)
    R = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    if rot:
        R = torch.stack([-R[..., 1, :], R[..., 0, :]], -2)
    norm = torch.sqrt((dist ** 2).sum(-1)) + 5.0
    cov = torch.zeros(R.shape, device=dev)
    cov[..., 0, 0] = (norm / sigma_factor / ratio) ** 2
    cov[..., 1, 1] = (norm / sigma_factor) ** 2
    T = torch.einsum("...ij,...jl,...ml->...im", R, cov, R)
    Ti = torch.linalg.inv(T)
    gx = ay[..., None, :]
    gy = ax[..., :, None]
    q = (Ti[..., 0, 0][..., None, None] * gx * gx
         + (Ti[..., 0, 1] + Ti[..., 1, 0])[..., None, None] * gx * gy
         + Ti[..., 1, 1][..., None, None] * gy * gy)
    kern = torch.exp(-0.5 * q)
    return kern / kern.sum(dim=(-2, -1), keepdim=True)


def cws(goals, last_observed, wp_maps, key, n_goal, n_traj, cws_params):
    """Conditional waypoint sampling, back from the goal: goals (K, B, 2),
    wp_maps (B, n_wp, H, W) sigmoid maps -> (K * n_traj, B, n_wp, 2). The
    first goal group takes each map's soft-argmax, the others a draw
    above 5% of its max."""
    n_wp = wp_maps.shape[1]
    H, W = wp_maps.shape[-2:]
    goals = goals.repeat(n_traj, 1, 1)
    K = goals.shape[0]
    group = torch.div(torch.arange(K, device=goals.device), n_goal,
                      rounding_mode="floor").float()
    first = (group == 0)[:, None, None]
    sf = float(cws_params["sigma_factor"]) - group[:, None]
    out = [goals[:, :, None]]
    samples = goals
    for w in reversed(range(n_wp - 1)):
        dist = last_observed[None] - samples
        mean = samples + dist * (1.0 / (w + 2))
        prior = cws_prior(mean, dist, sf.expand(mean.shape[:2]),
                          float(cws_params["ratio"]), bool(cws_params["rot"]),
                          H, W)
        m = wp_maps[:, w][None] * prior
        m = m / m.sum(dim=(-2, -1), keepdim=True)
        drawn = sample(m, 1, key, rel_threshold=0.05)[:, :, 0]
        samples = torch.where(first, model.on_prob_map(m), drawn)
        out.append(samples[:, :, None])
    return torch.cat(out[::-1], 2)


def waypoint_samples(goal_logits, observed, key, cfg):
    """The serving forward's sampling from the goal decoder's (B,
    pred_len, H, W) logits -> (K, B, n_wp, 2) model px. cfg: the run's
    configuration (waypoints, temperature, n_goal, n_traj, use_TTST,
    rel_threshold, use_CWS, CWS_params)."""
    wp_logits = goal_logits.float()[:, list(cfg["waypoints"])]
    wp_maps = torch.sigmoid(wp_logits / float(cfg["temperature"]))
    n_goal, n_traj = int(cfg["n_goal"]), int(cfg["n_traj"])
    if cfg["use_TTST"]:
        drawn = sample(wp_maps[:, -1], 10000, key,
                       rel_threshold=float(cfg["rel_threshold"]),
                       replacement=True)
        centers = kmeans(drawn, n_goal - 1, key)
        sam = model.softargmax(wp_logits[:, -1])
        goals = torch.cat([sam[:, None], centers], 1).transpose(0, 1)
    else:
        goals = sample(wp_maps[:, -1:], n_goal, key)[:, 0].transpose(0, 1)
    n_wp = wp_maps.shape[1]
    if n_wp == 1:
        return goals[:, :, None]
    if cfg["use_CWS"]:
        return cws(goals, observed[:, int(cfg["obs_len"]) - 1], wp_maps, key,
                   n_goal, n_traj, cfg["CWS_params"])
    ws = sample(wp_maps[:, :-1], n_goal * n_traj, key).permute(2, 0, 1, 3)
    return torch.cat([ws, goals.repeat(n_traj, 1, 1)[:, :, None]], 2)
