"""The segmentation backbone: a U-Net with a ResNet101 encoder on NHWC
tensors (counterpart of mst_tpu/models/unet.py).

The function is smp 0.1.0's Unet('resnet101') (reference
models/ynet.py:495-507), which the released weights were trained with:
torchvision's bottleneck ResNet (7x7/2 stem, 3x3/2 max-pool, stages of 3,
4, 23 and 3 blocks), the UnetDecoder (nearest 2x upsample, skip concat,
two Conv-BN-ReLU a block, 256/128/64/32/16 channels) and a 3x3 head with
an optional softmax. The padding is mst_tpu's, which the port is held
against: the stem pads 3 on every side, the max-pool 1, and every other
conv pads as XLA's SAME (same_pads). That is k // 2 at stride 1 and (0,
0) for the 1x1/2 downsample, but (0, 1) for the three stride-2 3x3 convs
(block 0's conv2 of layer2-4) on an even size, where torchvision pads (1,
1): smp's function differs there (ROADMAP Queue 3 #9, an mst_tpu quirk
kept on purpose).

Parameters are a nested dict with mst_tpu's paths ('encoder/layer1/0/
conv1/weight', 'decoder/blocks/0/conv1/0/weight',
'segmentation_head/0/bias', and the int leaf '_meta/activation': 1 for
softmax), so an npz of either package loads key for key through
io.params_from_numpy; convs are OIHW. The batch norms keep their running
statistics inline; bn_state overrides them once e_unfreeze adapts them.
Inside, activations are NCHW views of channels_last memory, and the convs
are cuDNN's (f32, TF32 off: mst_tpu_torch.resolve_device; bf16 on a bf16
step's compute copy, where the batch norms promote as models/layers.py
says), oneDNN's on the CPU in f32 (ops/conv.py).

On a spatial ('data', 'space') mesh every piece takes this rank's H slab
of its input and a mesh.Slab of it (`slab`; None: the whole map), and
gives the whole map's output on the slab's rows (backbone_slabs: the
level rule). A k x k conv of stride s padded p above reads p rows above
its slab and k - p - s below it (parallel/halo.py, zeros at the global
top and bottom): the 7x7/2 stem 3 and 2, a stride-2 3x3 conv 0 and 1
(SAME on the whole map's even rows), the 3x3/2 max-pool 1 and 0, a
stride-1 3x3 conv 1 and 1; a 1x1 conv, the nearest upsample, the skip
concat and the head's softmax need none. A train-mode
batch norm of a sliced level takes its statistics over the 'space' ranks
(the 'data' ranks hold the same image, so the count is the image's
N x H x W).
"""

import math

import torch
import torch.nn.functional as F

from mst_tpu_torch import io
from mst_tpu_torch.models.layers import check_same_dtype
from mst_tpu_torch.ops.conv import conv2d

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

def backbone_slabs(slab, n=len(ENCODER_CHANNELS)):
    """The backbone's level rule: the mesh.Slab of each of its n levels
    (the image, the stem, layer1, ..., layer4; each half the rows of the
    one before), from the image's `slab`, and None from the first level
    that runs whole on every 'space' rank. A stride-2 op reads input rows
    2i - p.. for output row i, so it slices only when its input slab's
    rows are even (the slab then starts on an even row): the level after
    a slab of odd rows runs whole, and so does every coarser one. At 352
    rows over 2 ranks the slabs hold 176, 88, 44, 22 and 11 rows, and
    layer4 runs whole; at 1408 over 2 every level slices. (The Y-Net's
    rule, mesh.Slab.down, is its own.)"""
    out = [slab]
    while len(out) < n:
        prev = out[-1]
        out.append(prev.half() if prev is not None and prev.rows % 2 == 0
                   else None)
    return out


def _halo(x, slab, k):
    """NCHW x on a slab with the rows k = (above, below) of its H
    neighbours (halo.exchange on the NHWC view: channels_last memory in
    and out)."""
    return slab.exchange(x.permute(0, 2, 3, 1), k).permute(0, 3, 1, 2)


def _whole(x, slab_in, slab_out):
    """NCHW x of a level whose slab is slab_in, for an op whose output
    level's is slab_out: the whole map (every 'space' rank's slab
    gathered, differentiably) where the output runs whole and the input
    does not, else x -> (x, the input's slab for the op)."""
    if slab_in is not None and slab_out is None:
        x = slab_in.gather(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x, None
    return x, slab_in


def same_pads(n, k, stride):
    """XLA's SAME padding of a k-tap window of stride s on an axis of n
    -> (before, after): total = max((ceil(n / s) - 1) s + k - n, 0),
    before = total // 2. k // 2 on both sides at stride 1; a 3x3/2 conv
    pads (0, 1) on an even n and (1, 1) on an odd one."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=1, slab=None, pad=None):
    """A conv of the tree on NCHW x, padded SAME on each axis (same_pads;
    mst_tpu's _conv), or `pad` on every side (the stem's 3). The
    convolution itself pads symmetrically, so SAME's extra row and column
    at the bottom and right are zeros put there first (a copy, only where
    before and after differ: the stride-2 3x3 convs on even sizes).
    slab: x holds the slab's rows (starting on an even row at stride 2),
    the output the next level's slab's; H pads by the whole map's rows
    (slab.height), and its rows come from the H neighbours
    (parallel/halo.py), zeros at the global top and bottom."""
    check_same_dtype(x, p["weight"])
    k = p["weight"].shape[-1]
    n = x.shape[2] if slab is None else slab.height
    ph, pw = ((pad, pad), (pad, pad)) if pad is not None else (
        same_pads(n, k, stride), same_pads(x.shape[3], k, stride))
    halo = (ph[0], max(k - ph[0] - stride, 0))
    if slab is not None and any(halo):
        x = _halo(x, slab, halo)
        ph = (0, 0)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (0, pw[1] - pw[0], 0, ph[1] - ph[0]))
    return conv2d(x, p["weight"], p.get("bias"), stride, (ph[0], pw[0]))


def max_pool(x, slab=None):
    """The 3x3/2 max-pool padded 1 (F.max_pool2d pads -inf). On a slab the
    row above comes from the neighbour, and at the global top it is the
    exchange's zero row. That is exact: the input is a ReLU's output,
    >= 0, and every window holds a real row, so a 0 never exceeds the
    max; where it ties with a real 0, the gradient that takes the zero
    row instead is dropped, and the real 0's own would have been stopped
    by the ReLU's backward (its output is not > 0). No row below is read
    (the last output row reads the slab's last row)."""
    if slab is None:
        return F.max_pool2d(x, 3, 2, 1)
    return F.max_pool2d(_halo(x, slab, (1, 0)), 3, 2, (0, 1))


def _get_path(tree, path):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def make_bn(bn_state=None, train=False, eps=1e-5, momentum=0.1):
    """-> (bn, updates): bn(path, params, x, slab=None) normalises NCHW x
    with the statistics at bn_state[path] when present, else the inline
    ones (mst_tpu/models/unet.py:59-92). Eval mode normalises with them,
    as mst_tpu's formula does, so every leaf (the running statistics too)
    gets its gradient. train normalises with the batch's statistics and
    puts torch's running-statistic update (momentum 0.1, unbiased
    variance) into updates[path], on copies. With a slab, x holds the
    slab's rows of the map and train mode's statistics are the whole
    map's (_slab_batch_norm); eval mode is per pixel either way."""
    updates = {}

    def bn(path, p, x, slab=None):
        src = _get_path(bn_state, path) if bn_state else None
        stats = src if src is not None else p
        if not train:
            scale = p["weight"] * torch.rsqrt(stats["running_var"] + eps)
            shift = p["bias"] - stats["running_mean"] * scale
            return torch.addcmul(shift[:, None, None], x,
                                 scale[:, None, None])
        mean = stats["running_mean"].detach().clone()
        var = stats["running_var"].detach().clone()
        if slab is None:
            y = F.batch_norm(x, mean, var, p["weight"].to(mean.dtype),
                             p["bias"].to(mean.dtype), True, momentum, eps)
        else:
            y, mean, var = _slab_batch_norm(p, x, mean, var, slab, momentum,
                                            eps)
        updates[path] = {"running_mean": mean, "running_var": var}
        return y

    return bn, updates


def _slab_batch_norm(p, x, mean, var, slab, momentum, eps):
    """Train-mode batch norm of NCHW x, this rank's slab of a map that the
    'space' ranks split (every slab the same size): the map's mean, then
    its biased variance about it, each a sum over the 'space' ranks (an
    autograd op: the backward sums over them too), in the statistics'
    dtype, as layers.global_batch_norm computes the Y-Net's. The 'data'
    ranks hold the same image, so the count is the image's N x H x W and
    no sum crosses 'data'. -> (y in x's dtype, the moved running mean and
    variance, the variance unbiased by that count)."""
    xs = x.to(mean.dtype)
    n = xs.numel() // xs.shape[1] * slab.count
    m = slab.sum_differentiable(xs.sum(dim=(0, 2, 3))) / n
    d = xs - m[:, None, None]
    v = slab.sum_differentiable((d * d).sum(dim=(0, 2, 3))) / n
    y = d * (torch.rsqrt(v + eps) * p["weight"].to(mean.dtype))[
        :, None, None] + p["bias"].to(mean.dtype)[:, None, None]
    with torch.no_grad():
        mean = (1 - momentum) * mean + momentum * m
        var = (1 - momentum) * var + momentum * v * (n / max(n - 1, 1))
    return y.to(x.dtype), mean, var


def _bottleneck(p, x, stride, bn, path, slab_in=None, slab_out=None):
    """A bottleneck block on x, the slab_in level's; its output is the
    slab_out level's (the same at stride 1)."""
    y = torch.relu(bn(f"{path}/bn1", p["bn1"], conv(p["conv1"], x),
                      slab_in))
    y = torch.relu(bn(f"{path}/bn2", p["bn2"],
                      conv(p["conv2"], y, stride, slab_in), slab_out))
    y = bn(f"{path}/bn3", p["bn3"], conv(p["conv3"], y), slab_out)
    identity = x
    if "downsample" in p:
        identity = bn(f"{path}/downsample/1", p["downsample"]["1"],
                      conv(p["downsample"]["0"], x, stride), slab_out)
    return torch.relu(y + identity)


def _nchw(x_nhwc):
    return x_nhwc.permute(0, 3, 1, 2)


def _nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1).contiguous()


def encoder_apply(enc, image, layers=None, bn=None, slab=None):
    """The ResNet encoder (mst_tpu _resnet_encoder_apply): NHWC image ->
    smp's feature list [image, stem, layer1, ..., layer4] as NCHW views of
    channels_last memory. slab: image holds the slab's rows, and each
    feature its level's slab's (backbone_slabs), or the whole map where
    its level runs whole."""
    if layers is None:
        layers = tuple(len(enc[f"layer{li}"]) for li in range(1, 5))
    if bn is None:
        bn = make_bn()[0]
    s = backbone_slabs(slab)
    x = _nchw(image)
    feats = [x]
    x, sin = _whole(x, s[0], s[1])
    y = torch.relu(bn("encoder/bn1", enc["bn1"],
                      conv(enc["conv1"], x, 2, sin, pad=3), s[1]))
    feats.append(y)
    y, sin = _whole(y, s[1], s[2])
    y = max_pool(y, sin)
    for li, n in enumerate(layers, start=1):
        for b in range(n):
            stride = 2 if (li > 1 and b == 0) else 1
            if stride == 2:  # from level li to li + 1
                y, sin = _whole(y, s[li], s[li + 1])
            else:
                sin = s[li + 1]
            y = _bottleneck(enc[f"layer{li}"][str(b)], y, stride, bn,
                            f"encoder/layer{li}/{b}", sin, s[li + 1])
        feats.append(y)
    return feats


def decoder_apply(dec, feats, decoder_channels=None, bn=None, slabs=None):
    """smp's UnetDecoder on encoder_apply's NCHW features -> NCHW. slabs:
    each feature's level's slab (backbone_slabs, None where it runs
    whole); a whole map upsampled onto a sliced level is cut to its slab
    (mesh.Slab.take) before it meets the skip."""
    if bn is None:
        bn = make_bn()[0]
    n_blocks = (len(dec["blocks"]) if decoder_channels is None
                else len(decoder_channels))
    if slabs is None:
        slabs = [None] * len(feats)
    feats, slabs = feats[::-1], slabs[::-1]
    x, skips = feats[0], feats[1:]
    for i in range(n_blocks):
        p = dec["blocks"][str(i)]
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if slabs[i] is None and slabs[i + 1] is not None:
            x = slabs[i + 1].take(x, 2)
        if i < len(skips) - 1:
            x = torch.cat([x, skips[i]], dim=1)
        path = f"decoder/blocks/{i}"
        x = torch.relu(bn(f"{path}/conv1/1", p["conv1"]["1"],
                          conv(p["conv1"]["0"], x, slab=slabs[i + 1]),
                          slabs[i + 1]))
        x = torch.relu(bn(f"{path}/conv2/1", p["conv2"]["1"],
                          conv(p["conv2"]["0"], x, slab=slabs[i + 1]),
                          slabs[i + 1]))
    return x


def head_apply(params, x, slab=None):
    """The 3x3 head, then softmax over the classes where
    '_meta/activation' is 1 (chosen on the device, without a host read)
    -> NCHW (slab: the slab's rows in and out)."""
    x = conv(params["segmentation_head"]["0"], x, slab=slab)
    act = params.get("_meta", {}).get("activation")
    if act is None:
        return x
    return torch.where(act == 1, torch.softmax(x, dim=1), x)


def unet_apply(params, image, use_features_only=False, layers=None,
               decoder_channels=None, bn_state=None, train=False,
               slab=None):
    """(B, H, W, 3) preprocessed image -> (B, H, W, n_classes) class map,
    or the decoder's (B, H, W, 16) features when use_features_only (the
    reference swaps the head for Identity, ynet.py:503-505); NHWC
    contiguous. Depth comes from the params unless given.

    bn_state: nested {path: {running_mean, running_var}} overriding the
    inline statistics. train normalises with the batch's statistics and
    returns (out, the nested running-statistic updates): the reference's
    model.train() backbone past e_unfreeze (train_epoch.py:27-48).

    slab (a mesh.Slab of the image's H): image holds the slab's rows and
    so does the output; each level runs on its slab down to the first
    that runs whole (backbone_slabs)."""
    bn, updates = make_bn(bn_state, train)
    feats = encoder_apply(params["encoder"], image, layers, bn, slab)
    slabs = backbone_slabs(slab, len(feats))
    x = decoder_apply(params["decoder"], feats, decoder_channels, bn, slabs)
    out = _nhwc(x if use_features_only else head_apply(params, x, slabs[0]))
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
