"""Y-Net and Y-Net-Mod on NHWC tensors (counterpart of
mst_tpu/models/ynet.py, the unpacked path).

The plain encoder with its MoSA (LoRA conv), serial/parallel block and
in-layer adapters; the Y-Net-Mod fusion encoder (separate scene and motion
branches, then fused stages); the semantic adapter and the embed network's
scene/motion embeddings; the goal and trajectory decoders, and the
K-sample trajectory decode with the encoder terms hoisted out of the K
axis. Parameters are a nested dict of tensors with the JAX package's names
(io.params_from_numpy converts its checkpoints); convs are OIHW. The model
state is a second such tree: the serial adapters' batch-norm running
statistics. The segmentation backbone is models/unet.py; its output is
the semantic map (the steps run it, train/steps.py).
"""

import dataclasses
from typing import Optional, Sequence

import torch

from mst_tpu_torch.models import layers
from mst_tpu_torch.ops.pooling import max_pool_2x2, upsample_bilinear_2x


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
    network: str = "original"  # original | embed | fusion
    n_fusion: Optional[int] = None
    use_features_only: bool = False
    segmentation: Optional[str] = None  # None -> identity backbone

    def __post_init__(self):
        for name in ("encoder_channels", "decoder_channels", "waypoints"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        object.__setattr__(self, "position",
                           tuple(str(p) for p in self.position))
        if self.network == "fusion":
            assert self.n_fusion is not None, "fusion network needs n_fusion"
            assert not any(c % 2 for c in self.encoder_channels), \
                f"Odd value in channels={self.encoder_channels}"
            assert self.n_fusion <= len(self.encoder_channels) - 1

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

    def conv_kind(self, level) -> str:
        """Which conv get_conv2d builds at encoder level `level`: a stage
        index, or a fusion branch name (reference ynet.py:134-151)."""
        level = str(level)
        if "mosa" in self.train_net and level in self.position:
            return "lora"
        if "Layer" in self.train_net and level in self.position:
            return "adapter_layer"
        return "plain"

    def adapter_sizes(self):
        """The parallel adapters' kernel sizes from the train_net suffix
        ('parallel_1x1_3x3' -> [1, 3]; none -> [1]; reference
        ynet.py:21-38)."""
        sizes = self.train_net.split("_")[1:]
        if "serial" in self.train_net:
            return []
        if not sizes:
            return [1]
        return [int(s.split("x")[0]) for s in sizes]


def is_adapter_leaf(key: str) -> bool:
    """The leaves a pretrained base never has: LoRA factors and the serial,
    parallel, block and semantic adapters ('/'-joined paths of init_ynet's
    tree). Each is zero-initialised where it adds to the output (lora_B,
    the adapters' convs), so the init's leaves leave the base model's
    function unchanged."""
    return (key.endswith(("lora_A", "lora_B"))
            or any(s in key for s in ("serial_layer", "parallel_layer",
                                      "encoder/adapters/",
                                      "semantic_adapter")))


# ---------------------------------------------------------------------------
# init: the shapes and distributions of mst_tpu.models.ynet.init_ynet
# ---------------------------------------------------------------------------

def _serial_init(ch):
    """BN + a zero-init 1x1 conv without bias -> (params, state)."""
    bn, bn_state = layers.batchnorm_init(ch)
    conv = layers.conv_init(None, ch, ch, 1, bias=False, zero_init=True)
    return {"serial_layer": {"bn": bn, "conv": conv}}, \
        {"serial_layer": {"bn": bn_state}}


def _parallel_init(cfg, in_ch, out_ch):
    """Zero-init k x k convs without bias, one a size of adapter_sizes."""
    return {str(i): layers.conv_init(None, in_ch, out_ch, k, bias=False,
                                     zero_init=True)
            for i, k in enumerate(cfg.adapter_sizes())}


def _adapter_init(cfg, in_ch, out_ch=None):
    """A block adapter (AdapterBlock, reference ynet.py:41-67) ->
    (params, state)."""
    if "serial" in cfg.train_net:
        return _serial_init(in_ch)
    if "parallel" in cfg.train_net:
        return {"parallel_layer": _parallel_init(cfg, in_ch,
                                                 out_ch or in_ch)}, {}
    raise ValueError(f"Invalid adapter={cfg.train_net}")


def _conv_unit_init(generator, cfg, level, in_ch, out_ch):
    """One encoder conv: plain, LoRA or with an in-layer adapter
    (get_conv2d) -> (params, state)."""
    kind = cfg.conv_kind(level)
    if kind == "lora":
        return layers.lora_conv_init(generator, in_ch, out_ch, 3,
                                     cfg.lora_rank), {}
    params = layers.conv_init(generator, in_ch, out_ch, 3)
    if kind == "plain":
        return params, {}
    if "serial" in cfg.train_net:
        adapter, state = _serial_init(out_ch)
        return {**params, **adapter}, state
    params["parallel_layer"] = _parallel_init(cfg, in_ch, out_ch)
    return params, {}


def _stages_init(generator, cfg, specs):
    """specs: [(level, [(in, out), ...]), ...], one entry a stage ->
    ({'0': {'conv0': ...}, ...}, the same tree of the non-empty states)."""
    stages, state = {}, {}
    for i, (level, convs) in enumerate(specs):
        stage, st = {}, {}
        for j, (ci, co) in enumerate(convs):
            stage[f"conv{j}"], s = _conv_unit_init(generator, cfg, level,
                                                   ci, co)
            if s:
                st[f"conv{j}"] = s
        stages[str(i)] = stage
        if st:
            state[str(i)] = st
    return stages, state


def _encoder_init(generator, cfg):
    """The plain encoder (YNetEncoder/L/B, reference ynet.py:170-256) ->
    (params, state)."""
    chans = cfg.encoder_channels
    specs = [(0, [(cfg.feature_channels, chans[0])])] + [
        (i + 1, [(chans[i], chans[i + 1]), (chans[i + 1], chans[i + 1])])
        for i in range(len(chans) - 1)]
    stages, stage_state = _stages_init(generator, cfg, specs)
    params, state = {"stages": stages}, {}
    if stage_state:
        state["stages"] = stage_state
    block_adapter = (("serial" in cfg.train_net
                      or "parallel" in cfg.train_net)
                     and "Layer" not in cfg.train_net)
    if block_adapter and cfg.position:
        # the parallel adapter reads the stage's input, the serial one its
        # output (reference ynet.py:237-256)
        par_in = [cfg.feature_channels] + list(chans[:-1])
        adapters, ad_state = {}, {}
        for i in (int(p) for p in cfg.position):
            if "serial" in cfg.train_net:
                p, s = _adapter_init(cfg, chans[i])
            else:
                p, s = _adapter_init(cfg, par_in[i], chans[i])
            adapters[str(i)] = p
            if s:
                ad_state[str(i)] = s
        params["adapters"] = adapters
        if ad_state:
            state["adapters"] = ad_state
    return params, state


def _fusion_encoder_init(generator, cfg):
    """Y-Net-Mod's encoder (YNetEncoderFusion, reference ynet.py:286-367)
    -> (params, state). Each branch stage has half the channels; the conv
    kind is keyed on the branch name, so position 'scene' selects the
    scene branch's convs."""
    chans = cfg.encoder_channels
    n_sep = len(chans) - cfg.n_fusion - 1
    params, state = {}, {}
    for branch, in_ch in (("scene", cfg.n_semantic_classes),
                          ("motion", cfg.obs_len)):
        specs = [(branch, [(in_ch, chans[0] // 2)])] + [
            (branch, [(chans[i] // 2, chans[i + 1] // 2),
                      (chans[i + 1] // 2, chans[i + 1] // 2)])
            for i in range(n_sep)]
        params[f"{branch}_stages"], st = _stages_init(generator, cfg, specs)
        if st:
            state[f"{branch}_stages"] = st
    specs = [("fusion", [(chans[i], chans[i + 1]),
                         (chans[i + 1], chans[i + 1])])
             for i in range(n_sep, len(chans) - 1)]
    params["fusion_stages"], st = _stages_init(generator, cfg, specs)
    if st:
        state["fusion_stages"] = st
    return params, state


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


def _embedding_init(generator, ch):
    """3 x (conv3x3 + ReLU) at constant width (reference ynet.py:154-167)."""
    return {str(i): layers.conv_init(generator, ch, ch, 3) for i in range(3)}


def init_ynet(generator: torch.Generator, cfg: YNetConfig, device="cpu"):
    """Random Y-Net parameters from a (CPU) generator and the model state
    (batch-norm running statistics; {} without serial adapters), both moved
    to device -> (params, state)."""
    if cfg.network == "fusion":
        encoder, enc_state = _fusion_encoder_init(generator, cfg)
    else:
        encoder, enc_state = _encoder_init(generator, cfg)
    params = {
        "encoder": encoder,
        "goal_decoder": _decoder_init(generator, cfg),
        "traj_decoder": _decoder_init(generator, cfg, traj=cfg.n_waypoints),
    }
    if "semantic" in cfg.train_net:
        k = int(cfg.train_net.split("_")[-1].split("x")[0])
        params["semantic_adapter"] = layers.conv_init(
            generator, cfg.n_semantic_classes, cfg.n_semantic_classes, k,
            zero_init=True)
    if cfg.network == "embed":
        params["scene_embedding"] = _embedding_init(generator,
                                                    cfg.n_semantic_classes)
        params["motion_embedding"] = _embedding_init(generator, cfg.obs_len)
    state = {"encoder": enc_state} if enc_state else {}
    return (tree_map(lambda t: t.to(device), params),
            tree_map(lambda t: t.to(device), state))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _serial_apply(params, state, x, train):
    """x + conv1x1(BN(x)) -> (y, new state)."""
    sp = params["serial_layer"]
    y, bn_state = layers.batchnorm_apply(sp["bn"], state["serial_layer"]["bn"],
                                         x, train)
    return x + layers.conv_apply(sp["conv"], y), \
        {"serial_layer": {"bn": bn_state}}


def _parallel_apply(convs, x):
    """The sum of the parallel adapter's convs of x."""
    return sum(layers.conv_apply(convs[i], x)
               for i in sorted(convs, key=int))


def _conv_unit(params, state, cfg, level, x, train):
    """One encoder conv unit (reference ynet.py:134-151) -> (y, new
    state)."""
    kind = cfg.conv_kind(level)
    if kind == "lora":
        return layers.lora_conv_apply(params, x, cfg.lora_rank), state
    out = layers.conv_apply(params, x)
    if kind == "plain":
        return out, state
    if "serial" in cfg.train_net:
        return _serial_apply(params, state, out, train)
    return out + _parallel_apply(params["parallel_layer"], x), state


def _stage(params, state, cfg, level, x, train, pool):
    """[max-pool,] conv0 + ReLU [, conv1 + ReLU] -> (y, new state)."""
    if pool:
        x = max_pool_2x2(x)
    new_state = {}
    for name in ("conv0", "conv1"):
        if name in params:
            x, s = _conv_unit(params[name], state.get(name, {}), cfg, level,
                              x, train)
            x = torch.relu(x)
            if s:
                new_state[name] = s
    return x, new_state


def _encoder_apply(params, state, cfg, x, train):
    """The plain encoder with its block adapters (reference
    ynet.py:213-283) -> (features, new state)."""
    stage_state, adapter_state = {}, dict(state.get("adapters", {}))
    adapters = params.get("adapters", {})
    features = []
    for i in range(len(cfg.encoder_channels)):
        level = str(i)
        if i > 0:
            x = max_pool_2x2(x)
        y, s = _stage(params["stages"][level],
                      state.get("stages", {}).get(level, {}), cfg, i, x,
                      train, pool=False)
        if s:
            stage_state[level] = s
        if level in adapters:
            if "serial" in cfg.train_net:
                y, adapter_state[level] = _serial_apply(
                    adapters[level], adapter_state[level], y, train)
            else:
                # the parallel adapter reads the stage's post-pool input
                y = y + _parallel_apply(adapters[level]["parallel_layer"], x)
        features.append(y)
        x = y
    features.append(max_pool_2x2(x))
    new_state = {}
    if stage_state:
        new_state["stages"] = stage_state
    if adapter_state:
        new_state["adapters"] = adapter_state
    return features, new_state


def _fusion_encoder_apply(params, state, cfg, scene_map, motion_map, train):
    """YNetEncoderFusion.forward (reference ynet.py:369-395): the scene
    and motion branches, their outputs concatenated stage by stage, the
    fused stages on the last of them (each pooling first), then one
    max-pool -> (features, new state)."""
    new_state = {}

    def run(group, level, x, first_pools):
        outs, group_state = [], {}
        stages = params[group]
        for i in range(len(stages)):
            x, s = _stage(stages[str(i)],
                          state.get(group, {}).get(str(i), {}), cfg, level,
                          x, train, pool=i > 0 or first_pools)
            if s:
                group_state[str(i)] = s
            outs.append(x)
        if group_state:
            new_state[group] = group_state
        return outs

    scene = run("scene_stages", "scene", scene_map, False)
    motion = run("motion_stages", "motion", motion_map, False)
    features = [torch.cat([s, m], dim=-1) for s, m in zip(scene, motion)]
    features += run("fusion_stages", "fusion", features[-1], True)
    features.append(max_pool_2x2(features[-1]))
    return features, new_state


def adapt_semantic(params, cfg: YNetConfig, semantic):
    """The residual semantic adapter (reference ynet.py:554-559); identity
    without one."""
    if "semantic_adapter" not in params:
        return semantic
    return layers.conv_apply(params["semantic_adapter"], semantic) + semantic


def _embedding_apply(params, x):
    for i in range(3):
        x = torch.relu(layers.conv_apply(params[str(i)], x))
    return x


def scene_embedding(params, x):
    """The embed network's scene embedding (params holds it)."""
    return _embedding_apply(params["scene_embedding"], x)


def motion_embedding(params, x):
    """The embed network's motion embedding (params holds it)."""
    return _embedding_apply(params["motion_embedding"], x)


def pred_features(params, state, cfg: YNetConfig, scene_map, motion_map,
                  train=False):
    """Encoder: scene (B, H, W, Cs) + motion (B, H, W, obs_len) -> (the
    list of len(encoder_channels) + 1 NHWC feature maps, finest first; the
    new state) (reference ynet.py:570-575). train runs the batch norms on
    the batch's statistics and returns their moved running statistics:
    True for this process's rows, or a parallel.mesh.Shards for the
    global batch whose rows the mesh's ranks hold
    (layers.batchnorm_apply)."""
    enc_state = state.get("encoder", {})
    if cfg.network == "fusion":
        features, new_enc = _fusion_encoder_apply(
            params["encoder"], enc_state, cfg, scene_map, motion_map, train)
    else:
        features, new_enc = _encoder_apply(
            params["encoder"], enc_state, cfg,
            torch.cat([scene_map, motion_map], dim=-1), train)
    new_state = dict(state)
    if new_enc:
        new_state["encoder"] = new_enc
    return features, new_state


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


def pred_traj(params, features_with_waypoints):
    """(B, H, W, pred_len) trajectory logits of the trajectory decoder on
    each feature map concatenated with its waypoint map (the unshared
    form, which Experiment.forward_test runs)."""
    return _decoder_apply(params["traj_decoder"], features_with_waypoints)


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
