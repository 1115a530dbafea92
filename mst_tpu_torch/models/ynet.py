"""Y-Net on NHWC tensors (counterpart of mst_tpu/models/ynet.py, the
unpacked path).

The plain encoder and its MoSA (LoRA conv) variant, the goal and trajectory
decoders, and the K-sample trajectory decode with the encoder terms hoisted
out of the K axis. Parameters are a nested dict of tensors with the JAX
package's names (io.params_from_numpy converts its checkpoints); convs are
OIHW. Serial/parallel/semantic adapters, batch norm and the fusion/embed
networks are not ported yet, and a config asking for them raises.
"""

import dataclasses
from typing import Sequence

import torch

from mst_tpu_torch.models import layers
from mst_tpu_torch.ops.pooling import max_pool_2x2, upsample_bilinear_2x

_UNPORTED = ("serial", "parallel", "semantic", "Layer")


@dataclasses.dataclass(frozen=True)
class YNetConfig:
    obs_len: int
    pred_len: int
    n_semantic_classes: int = 6
    encoder_channels: Sequence[int] = (32, 32, 64, 64, 64)
    decoder_channels: Sequence[int] = (64, 64, 64, 32, 32)
    waypoints: Sequence[int] = (11,)
    train_net: str = "train"
    position: Sequence[str] = ()
    network: str = "original"

    def __post_init__(self):
        for name in ("encoder_channels", "decoder_channels", "waypoints"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        object.__setattr__(self, "position",
                           tuple(str(p) for p in self.position))
        if self.network != "original":
            raise NotImplementedError(
                f"network={self.network!r} is not ported yet")
        if any(s in self.train_net for s in _UNPORTED):
            raise NotImplementedError(
                f"train_net={self.train_net!r}: adapters are not ported yet")

    @property
    def n_waypoints(self):
        return len(self.waypoints)

    @property
    def feature_channels(self):
        return self.n_semantic_classes + self.obs_len

    @property
    def lora_rank(self):
        """rank parsed from 'mosa_<r>' (reference ynet.py:186-189)."""
        if "mosa" not in self.train_net:
            return None
        parts = self.train_net.split("_")
        return int(parts[1]) if len(parts) > 1 else 1

    def is_lora(self, level) -> bool:
        """Whether encoder level `level` holds a LoRA conv."""
        return "mosa" in self.train_net and str(level) in self.position


# ---------------------------------------------------------------------------
# init: the shapes and distributions of mst_tpu.models.ynet.init_ynet
# ---------------------------------------------------------------------------

def _conv_unit_init(generator, cfg, level, in_ch, out_ch):
    if cfg.is_lora(level):
        return layers.lora_conv_init(generator, in_ch, out_ch, 3,
                                     cfg.lora_rank)
    return layers.conv_init(generator, in_ch, out_ch, 3)


def _encoder_init(generator, cfg):
    chans = cfg.encoder_channels
    stages = {"0": {"conv0": _conv_unit_init(
        generator, cfg, 0, cfg.feature_channels, chans[0])}}
    for i in range(len(chans) - 1):
        stages[str(i + 1)] = {
            "conv0": _conv_unit_init(generator, cfg, i + 1, chans[i],
                                     chans[i + 1]),
            "conv1": _conv_unit_init(generator, cfg, i + 1, chans[i + 1],
                                     chans[i + 1]),
        }
    return {"stages": stages}


def _decoder_init(generator, cfg, traj: int = 0):
    enc = [c + traj for c in cfg.encoder_channels][::-1]
    center_ch = enc[0]
    dec = list(cfg.decoder_channels)
    up_in = [center_ch * 2] + dec[:-1]
    up_out = [c // 2 for c in up_in]
    return {
        "center": {
            "0": layers.conv_init(generator, center_ch, center_ch * 2, 3),
            "1": layers.conv_init(generator, center_ch * 2, center_ch * 2, 3),
        },
        "upsample": {str(i): layers.conv_init(generator, ci, co, 3)
                     for i, (ci, co) in enumerate(zip(up_in, up_out))},
        "blocks": {str(i): {"0": layers.conv_init(generator, e + u, co, 3),
                            "1": layers.conv_init(generator, co, co, 3)}
                   for i, (e, u, co) in enumerate(zip(enc, up_out, dec))},
        "predictor": layers.conv_init(generator, dec[-1], cfg.pred_len, 1),
    }


def init_ynet(generator: torch.Generator, cfg: YNetConfig, device="cpu"):
    """Random Y-Net parameters from a (CPU) generator, moved to device."""
    params = {
        "encoder": _encoder_init(generator, cfg),
        "goal_decoder": _decoder_init(generator, cfg),
        "traj_decoder": _decoder_init(generator, cfg, traj=cfg.n_waypoints),
    }
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _conv_unit(params, cfg, level, x):
    if cfg.is_lora(level):
        return layers.lora_conv_apply(params, x, cfg.lora_rank)
    return layers.conv_apply(params, x)


def pred_features(params, cfg: YNetConfig, scene_map, motion_map):
    """Encoder: scene (B, H, W, Cs) + motion (B, H, W, obs_len) -> the list
    of len(encoder_channels) + 1 NHWC feature maps, finest first
    (reference ynet.py:170-215, 570-575)."""
    x = torch.cat([scene_map, motion_map], dim=-1)
    features = []
    for i in range(len(cfg.encoder_channels)):
        stage = params["encoder"]["stages"][str(i)]
        if i > 0:
            x = max_pool_2x2(x)
        x = torch.relu(_conv_unit(stage["conv0"], cfg, i, x))
        if "conv1" in stage:
            x = torch.relu(_conv_unit(stage["conv1"], cfg, i, x))
        features.append(x)
    features.append(max_pool_2x2(x))
    return features


def _decoder_apply(d, features):
    """YNetDecoder.forward (reference ynet.py:453-471), coarsest last."""
    feats = features[::-1]
    x = torch.relu(layers.conv_apply(d["center"]["0"], feats[0]))
    x = torch.relu(layers.conv_apply(d["center"]["1"], x))
    for i in range(len(d["blocks"])):
        x = layers.conv_apply(d["upsample"][str(i)], upsample_bilinear_2x(x))
        x = torch.cat([x, feats[i + 1]], dim=-1)
        blk = d["blocks"][str(i)]
        x = torch.relu(layers.conv_apply(blk["0"], x))
        x = torch.relu(layers.conv_apply(blk["1"], x))
    return layers.conv_apply(d["predictor"], x)


def pred_goal(params, features):
    """(B, H, W, pred_len) goal/waypoint heatmap logits."""
    return _decoder_apply(params["goal_decoder"], features)


def make_shared_pred_traj(params, features, n_wp: int):
    """K-sample trajectory decoding with the encoder terms hoisted.

    Every first conv of the trajectory decoder sees
    concat([decoder path, encoder feature, waypoint map]); convolution is
    linear over input channels, so it splits into three convs, and the
    encoder term is the same for every one of the K samples: it is computed
    once per batch here instead of K times.

    Returns decode(wp_pyramid): wp_pyramid is a list of (K*B, h, w, n_wp)
    maps, finest first; decode returns the (K*B, H, W, C) input of the 1x1
    predictor with its (C, pred_len) weight and (pred_len,) bias, the
    operands of the fused predictor + soft-argmax kernel
    (ops/kernels/fused_predict.py); the (K*B, H, W, pred_len) logits are
    never formed.
    """
    d = params["traj_decoder"]
    L = len(features)
    feats_rev = features[::-1]
    enc_ch = [f.shape[-1] for f in feats_rev]
    up_out = [d["upsample"][str(i)]["weight"].shape[0]
              for i in range(L - 1)]

    def conv_slice(conv, x, lo, hi):
        return layers.conv2d(x, conv["weight"][:, lo:hi])

    center_enc = conv_slice(d["center"]["0"], feats_rev[0], 0, enc_ch[0])
    block_enc = [conv_slice(d["blocks"][str(i)]["0"], feats_rev[i + 1],
                            up_out[i], up_out[i] + enc_ch[i + 1])
                 for i in range(L - 1)]

    def plus_enc(y, enc):
        """y (K*B, ...) + the K-invariant enc (B, ...), broadcast over K
        without materialising K copies of enc."""
        return (y.reshape(-1, *enc.shape) + enc).reshape(y.shape)

    def decode(wp_pyramid):
        wp_rev = wp_pyramid[::-1]
        c0 = d["center"]["0"]
        x = (plus_enc(conv_slice(c0, wp_rev[0], enc_ch[0], enc_ch[0] + n_wp),
                      center_enc)
             + c0["bias"])
        x = torch.relu(x)
        x = torch.relu(layers.conv_apply(d["center"]["1"], x))
        for i in range(L - 1):
            x = layers.conv_apply(d["upsample"][str(i)],
                                  upsample_bilinear_2x(x))
            b0 = d["blocks"][str(i)]["0"]
            lo = up_out[i]
            hi = lo + enc_ch[i + 1]
            y = (plus_enc(conv_slice(b0, x, 0, lo), block_enc[i])
                 + conv_slice(b0, wp_rev[i + 1], hi, hi + n_wp)
                 + b0["bias"])
            x = torch.relu(y)
            x = torch.relu(layers.conv_apply(d["blocks"][str(i)]["1"], x))
        pred = d["predictor"]
        P = pred["weight"].shape[0]
        return x, pred["weight"].reshape(P, -1).t().contiguous(), pred["bias"]

    return decode
