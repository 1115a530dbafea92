"""Y-Net and Y-Net-Mod in plain PyTorch (NCHW, float32).

The parameter tree uses the published reference's names, '/'-joined:
encoder/stages/<i>/conv<j>/{weight,bias,lora_A,lora_B} (Y-Net), or
encoder/{scene,motion,fusion}_stages/... (Y-Net-Mod, `network` fusion),
goal_decoder/... and traj_decoder/... with center/<0,1>, upsample/<i>,
blocks/<i>/<0,1> and predictor. Conv weights are OIHW. A MoSA conv's
weight is W + (lora_B @ lora_A).view(W.shape) / rank (loralib's merge).

The trajectory decoder runs unshared: every one of the K samples
concatenates the encoder features with its own waypoint maps, as the
published forward does, and its 1x1 predictor's logits are formed in
full before the soft-argmax.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Net:
    """The sizes a configuration file states (configs/<name>.json)."""
    obs_len: int
    pred_len: int
    n_semantic_classes: int
    encoder_channels: tuple
    decoder_channels: tuple
    waypoints: tuple
    train_net: str
    position: tuple
    network: str = "original"
    n_fusion: int = 0

    @classmethod
    def of(cls, config):
        return cls(int(config["obs_len"]), int(config["pred_len"]),
                   int(config["n_semantic_classes"]),
                   tuple(config["encoder_channels"]),
                   tuple(config["decoder_channels"]),
                   tuple(config["waypoints"]), str(config["train_net"]),
                   tuple(str(p) for p in config["position"]),
                   config.get("network") or "original",
                   int(config.get("n_fusion") or 0))

    @property
    def rank(self):
        parts = self.train_net.split("_")
        return int(parts[1]) if len(parts) > 1 else 1

    def lora_at(self, level):
        return "mosa" in self.train_net and str(level) in self.position


def _conv(shapes, path, ci, co, k, lora=False, rank=1):
    shapes[f"{path}/weight"] = (co, ci, k, k)
    shapes[f"{path}/bias"] = (co,)
    if lora:
        shapes[f"{path}/lora_A"] = (rank * k, ci * k)
        shapes[f"{path}/lora_B"] = (co * k, rank * k)


def _stages(shapes, net, group, level_of, specs):
    for i, convs in enumerate(specs):
        for j, (ci, co) in enumerate(convs):
            _conv(shapes, f"encoder/{group}/{i}/conv{j}", ci, co, 3,
                  net.lora_at(level_of(i)), net.rank)


def _decoder(shapes, net, name, extra):
    enc = [c + extra for c in net.encoder_channels][::-1]
    dec = list(net.decoder_channels)
    up_in = [enc[0] * 2] + dec[:-1]
    up_out = [c // 2 for c in up_in]
    _conv(shapes, f"{name}/center/0", enc[0], enc[0] * 2, 3)
    _conv(shapes, f"{name}/center/1", enc[0] * 2, enc[0] * 2, 3)
    for i, (ci, co) in enumerate(zip(up_in, up_out)):
        _conv(shapes, f"{name}/upsample/{i}", ci, co, 3)
    for i, (e, u, co) in enumerate(zip(enc, up_out, dec)):
        _conv(shapes, f"{name}/blocks/{i}/0", e + u, co, 3)
        _conv(shapes, f"{name}/blocks/{i}/1", co, co, 3)
    _conv(shapes, f"{name}/predictor", dec[-1], net.pred_len, 1)


def param_shapes(net):
    """{path: shape} of every parameter, in a fixed order."""
    shapes = {}
    ch = net.encoder_channels
    if net.network == "fusion":
        n_sep = len(ch) - net.n_fusion - 1
        for branch, ci in (("scene", net.n_semantic_classes),
                           ("motion", net.obs_len)):
            specs = [[(ci, ch[0] // 2)]] + [
                [(ch[i] // 2, ch[i + 1] // 2),
                 (ch[i + 1] // 2, ch[i + 1] // 2)] for i in range(n_sep)]
            _stages(shapes, net, f"{branch}_stages", lambda i, b=branch: b,
                    specs)
        specs = [[(ch[i], ch[i + 1]), (ch[i + 1], ch[i + 1])]
                 for i in range(n_sep, len(ch) - 1)]
        _stages(shapes, net, "fusion_stages", lambda i: "fusion", specs)
    else:
        specs = [[(net.n_semantic_classes + net.obs_len, ch[0])]] + [
            [(ch[i], ch[i + 1]), (ch[i + 1], ch[i + 1])]
            for i in range(len(ch) - 1)]
        _stages(shapes, net, "stages", lambda i: i, specs)
    _decoder(shapes, net, "goal_decoder", 0)
    _decoder(shapes, net, "traj_decoder", len(net.waypoints))
    return shapes


def init_bound(path, shape):
    """The half-width of the uniform a leaf is drawn from: kaiming
    uniform (a = sqrt(5)) for a conv weight and lora_A, 1/sqrt(fan_in)
    for a bias (torch's Conv2d and loralib defaults)."""
    if path.endswith("bias"):
        return None
    if path.endswith("lora_A"):
        return math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / shape[1])
    fan_in = shape[1] * shape[2] * shape[3]
    return math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)


def conv_weight(params, path, rank):
    w = params[f"{path}/weight"]
    a = params.get(f"{path}/lora_A")
    if a is None:
        return w
    return w + (params[f"{path}/lora_B"] @ a).view(w.shape) * (1.0 / rank)


def conv(params, path, x, rank=1):
    w = conv_weight(params, path, rank)
    k = w.shape[-1]
    return F.conv2d(x, w, params[f"{path}/bias"], padding=k // 2)


def _encoder(params, net, semantic, observed):
    """-> the feature pyramid, finest first (NCHW)."""
    r = net.rank
    pool = lambda x: F.max_pool2d(x, 2, 2)  # noqa: E731

    def stages(group, x, first):
        outs = []
        i = 0
        while f"encoder/{group}/{i}/conv0/weight" in params:
            if first + i > 0:
                x = pool(x)
            for j in (0, 1):
                if f"encoder/{group}/{i}/conv{j}/weight" in params:
                    x = torch.relu(conv(params, f"encoder/{group}/{i}/conv{j}",
                                        x, r))
            outs.append(x)
            i += 1
        return outs

    if net.network == "fusion":
        feats = [torch.cat([s, m], 1) for s, m in
                 zip(stages("scene_stages", semantic, 0),
                     stages("motion_stages", observed, 0))]
        feats += stages("fusion_stages", feats[-1], len(feats))
    else:
        feats = stages("stages", torch.cat([semantic, observed], 1), 0)
    return feats + [pool(feats[-1])]


def _decoder_apply(params, name, feats):
    rev = feats[::-1]
    x = torch.relu(conv(params, f"{name}/center/0", rev[0]))
    x = torch.relu(conv(params, f"{name}/center/1", x))
    for i in range(len(rev) - 1):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = conv(params, f"{name}/upsample/{i}", x)
        x = torch.cat([x, rev[i + 1]], 1)
        x = torch.relu(conv(params, f"{name}/blocks/{i}/0", x))
        x = torch.relu(conv(params, f"{name}/blocks/{i}/1", x))
    return conv(params, f"{name}/predictor", x)


def dist_maps(points, H, W, template_size):
    """(B, T, 2) (x, y) -> (B, T, H, W): the distance template around
    each rounded point, 2 hypot(dy, dx) / hypot(S//2, S//2)."""
    m = template_size // 2
    scale = 2.0 / math.hypot(m, m)
    x = torch.round(points[..., 0].float())
    y = torch.round(points[..., 1].float())
    rows = torch.arange(H, dtype=torch.float32, device=points.device)
    cols = torch.arange(W, dtype=torch.float32, device=points.device)
    dy2 = (rows[None, None, :] - y[..., None]) ** 2
    dx2 = (cols[None, None, :] - x[..., None]) ** 2
    return torch.sqrt(dy2[..., :, None] + dx2[..., None, :]) * scale


def pyramid(x, n):
    out = [x]
    for _ in range(n - 1):
        out.append(F.avg_pool2d(out[-1], 2, 2))
    return out


def features(params, net, semantic, observed, template_size):
    """semantic (B, C, H, W), observed (B, obs_len, 2) model px -> the
    encoder's pyramid."""
    H, W = semantic.shape[-2:]
    obs = dist_maps(observed[:, :net.obs_len], H, W, template_size)
    return _encoder(params, net, semantic, obs)


def goal_logits(params, feats):
    """-> (B, pred_len, H, W)."""
    return _decoder_apply(params, "goal_decoder", feats)


def traj_logits(params, feats, waypoints, template_size):
    """feats of B rows, waypoints (B, n_wp, 2) model px -> (B, pred_len,
    H, W): the trajectory decoder on each feature map concatenated with
    its waypoint maps."""
    H, W = feats[0].shape[-2:]
    wp = pyramid(dist_maps(waypoints, H, W, template_size), len(feats))
    return _decoder_apply(params, "traj_decoder",
                          [torch.cat([f, w], 1) for f, w in zip(feats, wp)])


def softargmax(logits, eps=1e-6):
    """(..., H, W) logits -> (..., 2) expected (x, y)."""
    H, W = logits.shape[-2:]
    flat = logits.float().reshape(*logits.shape[:-2], H * W)
    e = torch.exp(flat - flat.amax(-1, keepdim=True))
    p = (e / (e.sum(-1, keepdim=True) + eps)).reshape(logits.shape)
    return on_prob_map(p)


def on_prob_map(p):
    """Expected (x, y) of normalised (..., H, W) maps."""
    H, W = p.shape[-2:]
    xs = torch.arange(W, dtype=p.dtype, device=p.device)
    ys = torch.arange(H, dtype=p.dtype, device=p.device)
    return torch.stack([(p.sum(-2) * xs).sum(-1), (p.sum(-1) * ys).sum(-1)],
                       -1)


def decode(params, feats, waypoints, template_size, chunk):
    """The K decodes of one request: feats of B rows, waypoints (K, B,
    n_wp, 2) model px -> (K, B, pred_len, 2) model px, `chunk` samples at
    a time."""
    K, B = waypoints.shape[:2]
    out = []
    for lo in range(0, K, chunk):
        wp = waypoints[lo:lo + chunk]
        kc = wp.shape[0]
        rep = [f.repeat(kc, 1, 1, 1) for f in feats]
        logits = traj_logits(params, rep, wp.reshape(kc * B, *wp.shape[2:]),
                             template_size)
        out.append(softargmax(logits).reshape(kc, B, -1, 2))
    return torch.cat(out)
