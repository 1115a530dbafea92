"""The segmentation backbone: a U-Net with a ResNet101 encoder on NHWC
tensors (counterpart of mst_tpu/models/unet.py).

The function is smp 0.1.0's Unet('resnet101') (reference
models/ynet.py:495-507), which the released weights were trained with:
torchvision's bottleneck ResNet (7x7/2 stem, 3x3/2 max-pool, stages of 3,
4, 23 and 3 blocks), the UnetDecoder (nearest 2x upsample, skip concat,
two Conv-BN-ReLU a block, 256/128/64/32/16 channels) and a 3x3 head with
an optional softmax. Every conv pads k // 2, so the three stride-2 3x3
convs (block 0's conv2 of layer2-4) pad (1, 1) as torchvision does;
mst_tpu's pad SAME, (0, 1) on an even size, and compute another function
there (ROADMAP Queue 3 #9).

Parameters are a nested dict with mst_tpu's paths ('encoder/layer1/0/
conv1/weight', 'decoder/blocks/0/conv1/0/weight',
'segmentation_head/0/bias', and the int leaf '_meta/activation': 1 for
softmax), so an npz of either package loads key for key through
io.params_from_numpy; convs are OIHW. The batch norms keep their running
statistics inline; bn_state overrides them once e_unfreeze adapts them.
Inside, activations are NCHW views of channels_last memory, and the convs
are cuDNN's (f32, TF32 off: mst_tpu_torch.resolve_device; bf16 on a bf16
step's compute copy, where the batch norms promote as models/layers.py
says).
"""

import math

import torch
import torch.nn.functional as F

from mst_tpu_torch import io
from mst_tpu_torch.models.layers import check_same_dtype

RESNET101_LAYERS = (3, 4, 23, 3)
DECODER_CHANNELS = (256, 128, 64, 32, 16)
ENCODER_CHANNELS = (3, 64, 256, 512, 1024, 2048)
_WIDTHS = (64, 128, 256, 512)


# ---------------------------------------------------------------------------
# init: mst_tpu's shapes (kaiming-normal convs, BN at identity)
# ---------------------------------------------------------------------------

def _conv_init(generator, cin, cout, k, bias=False):
    std = math.sqrt(2.0 / (cin * k * k))
    p = {"weight": torch.randn((cout, cin, k, k), generator=generator) * std}
    if bias:
        p["bias"] = torch.zeros(cout)
    return p


def _bn_init(ch):
    return {"weight": torch.ones(ch), "bias": torch.zeros(ch),
            "running_mean": torch.zeros(ch), "running_var": torch.ones(ch)}


def _bottleneck_init(generator, cin, width, cout, stride):
    p = {"conv1": _conv_init(generator, cin, width, 1), "bn1": _bn_init(width),
         "conv2": _conv_init(generator, width, width, 3),
         "bn2": _bn_init(width),
         "conv3": _conv_init(generator, width, cout, 1), "bn3": _bn_init(cout)}
    if stride != 1 or cin != cout:
        p["downsample"] = {"0": _conv_init(generator, cin, cout, 1),
                           "1": _bn_init(cout)}
    return p


def unet_init(generator, n_classes=6, layers=RESNET101_LAYERS,
              decoder_channels=DECODER_CHANNELS, activation="softmax"):
    """Random backbone parameters from a (CPU) generator."""
    encoder = {"conv1": _conv_init(generator, 3, 64, 7), "bn1": _bn_init(64)}
    cin = 64
    for li, (w, n) in enumerate(zip(_WIDTHS, layers), start=1):
        blocks = {}
        for b in range(n):
            stride = 2 if (li > 1 and b == 0) else 1
            blocks[str(b)] = _bottleneck_init(generator, cin, w, 4 * w, stride)
            cin = 4 * w
        encoder[f"layer{li}"] = blocks
    enc = ENCODER_CHANNELS[::-1]
    in_ch = [enc[0]] + list(decoder_channels[:-1])
    skip_ch = list(enc[1:len(decoder_channels)]) + [0]
    blocks = {}
    for i, (ci, cs, co) in enumerate(zip(in_ch, skip_ch, decoder_channels)):
        blocks[str(i)] = {
            "conv1": {"0": _conv_init(generator, ci + cs, co, 3),
                      "1": _bn_init(co)},
            "conv2": {"0": _conv_init(generator, co, co, 3),
                      "1": _bn_init(co)}}
    return {
        "encoder": encoder, "decoder": {"blocks": blocks},
        "segmentation_head": {"0": _conv_init(
            generator, decoder_channels[-1], n_classes, 3, bias=True)},
        # int32, as mst_tpu's device-resident tree holds it
        "_meta": {"activation": torch.tensor(
            1 if activation == "softmax" else 0, dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# pieces (NCHW views of channels_last memory inside)
# ---------------------------------------------------------------------------

def conv(p, x, stride=1):
    """A conv of the tree on NCHW x, padded k // 2 on every side (the
    torchvision/smp padding, also at stride 2)."""
    check_same_dtype(x, p["weight"])
    k = p["weight"].shape[-1]
    return F.conv2d(x, p["weight"], p.get("bias"), stride, k // 2)


def _get_path(tree, path):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def make_bn(bn_state=None, train=False, eps=1e-5, momentum=0.1):
    """-> (bn, updates): bn(path, params, x) normalises NCHW x with the
    statistics at bn_state[path] when present, else the inline ones
    (mst_tpu/models/unet.py:59-92). Eval mode normalises with them, as
    mst_tpu's formula does, so every leaf (the running statistics too)
    gets its gradient. train normalises with the batch's statistics and
    puts torch's running-statistic update (momentum 0.1, unbiased
    variance) into updates[path], on copies."""
    updates = {}

    def bn(path, p, x):
        src = _get_path(bn_state, path) if bn_state else None
        stats = src if src is not None else p
        if not train:
            scale = p["weight"] * torch.rsqrt(stats["running_var"] + eps)
            shift = p["bias"] - stats["running_mean"] * scale
            return torch.addcmul(shift[:, None, None], x,
                                 scale[:, None, None])
        mean = stats["running_mean"].detach().clone()
        var = stats["running_var"].detach().clone()
        y = F.batch_norm(x, mean, var, p["weight"].to(mean.dtype),
                         p["bias"].to(mean.dtype), True, momentum, eps)
        updates[path] = {"running_mean": mean, "running_var": var}
        return y

    return bn, updates


def _bottleneck(p, x, stride, bn, path):
    y = torch.relu(bn(f"{path}/bn1", p["bn1"], conv(p["conv1"], x)))
    y = torch.relu(bn(f"{path}/bn2", p["bn2"], conv(p["conv2"], y, stride)))
    y = bn(f"{path}/bn3", p["bn3"], conv(p["conv3"], y))
    identity = x
    if "downsample" in p:
        identity = bn(f"{path}/downsample/1", p["downsample"]["1"],
                      conv(p["downsample"]["0"], x, stride))
    return torch.relu(y + identity)


def _nchw(x_nhwc):
    return x_nhwc.permute(0, 3, 1, 2)


def _nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1).contiguous()


def encoder_apply(enc, image, layers=None, bn=None):
    """The ResNet encoder (mst_tpu _resnet_encoder_apply): NHWC image ->
    smp's feature list [image, stem, layer1, ..., layer4] as NCHW views of
    channels_last memory."""
    if layers is None:
        layers = tuple(len(enc[f"layer{li}"]) for li in range(1, 5))
    if bn is None:
        bn = make_bn()[0]
    x = _nchw(image)
    feats = [x]
    y = torch.relu(bn("encoder/bn1", enc["bn1"], conv(enc["conv1"], x, 2)))
    feats.append(y)
    y = F.max_pool2d(y, 3, 2, 1)
    for li, n in enumerate(layers, start=1):
        for b in range(n):
            stride = 2 if (li > 1 and b == 0) else 1
            y = _bottleneck(enc[f"layer{li}"][str(b)], y, stride, bn,
                            f"encoder/layer{li}/{b}")
        feats.append(y)
    return feats


def decoder_apply(dec, feats, decoder_channels=None, bn=None):
    """smp's UnetDecoder on encoder_apply's NCHW features -> NCHW."""
    if bn is None:
        bn = make_bn()[0]
    n_blocks = (len(dec["blocks"]) if decoder_channels is None
                else len(decoder_channels))
    feats = feats[::-1]
    x, skips = feats[0], feats[1:]
    for i in range(n_blocks):
        p = dec["blocks"][str(i)]
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i < len(skips) - 1:
            x = torch.cat([x, skips[i]], dim=1)
        path = f"decoder/blocks/{i}"
        x = torch.relu(bn(f"{path}/conv1/1", p["conv1"]["1"],
                          conv(p["conv1"]["0"], x)))
        x = torch.relu(bn(f"{path}/conv2/1", p["conv2"]["1"],
                          conv(p["conv2"]["0"], x)))
    return x


def head_apply(params, x):
    """The 3x3 head, then softmax over the classes where
    '_meta/activation' is 1 (chosen on the device, without a host read)
    -> NCHW."""
    x = conv(params["segmentation_head"]["0"], x)
    act = params.get("_meta", {}).get("activation")
    if act is None:
        return x
    return torch.where(act == 1, torch.softmax(x, dim=1), x)


def unet_apply(params, image, use_features_only=False, layers=None,
               decoder_channels=None, bn_state=None, train=False):
    """(B, H, W, 3) preprocessed image -> (B, H, W, n_classes) class map,
    or the decoder's (B, H, W, 16) features when use_features_only (the
    reference swaps the head for Identity, ynet.py:503-505); NHWC
    contiguous. Depth comes from the params unless given.

    bn_state: nested {path: {running_mean, running_var}} overriding the
    inline statistics. train normalises with the batch's statistics and
    returns (out, the nested running-statistic updates): the reference's
    model.train() backbone past e_unfreeze (train_epoch.py:27-48)."""
    bn, updates = make_bn(bn_state, train)
    feats = encoder_apply(params["encoder"], image, layers, bn)
    x = decoder_apply(params["decoder"], feats, decoder_channels, bn)
    out = _nhwc(x if use_features_only else head_apply(params, x))
    if train:
        return out, io.unflatten({f"{k}/{leaf}": v
                                  for k, d in updates.items()
                                  for leaf, v in d.items()})
    return out


def extract_bn_stats(params):
    """Nested {path: {running_mean, running_var}} copies of every batch
    norm's statistics in the backbone params: the seed of the e_unfreeze
    state (mst_tpu/models/unet.py:311-329)."""
    out = {}
    for key, val in io.flatten(params).items():
        if key.endswith(("/running_mean", "/running_var")):
            out[key] = val.detach().clone()
    return io.unflatten(out)
