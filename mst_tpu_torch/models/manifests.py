"""Key and shape manifests of the reference's released artifacts (a copy
of mst_tpu/models/manifests.py's tables, with its checks run against the
port's initialisers).

The released checkpoints are torch state dicts (and one pickled
segmentation_models_pytorch module) whose key names and tensor shapes
are the converters' contract (models/convert.py). The manifests are the
names, not the code:

- ``smp_unet_resnet101_manifest``: segmentation_models_pytorch 0.1.0
  ``Unet('resnet101', encoder_weights='imagenet', classes=6)``
  (reference requirements.txt:7, models/ynet.py:495-507): torchvision's
  bottleneck ResNet encoder without ``fc``, the UnetDecoder's
  DecoderBlock(conv1, conv2) of Conv2dReLU = Sequential(conv without
  bias, BN, ReLU), and SegmentationHead = Sequential(conv3x3).
- ``loralib_conv_entries``: loralib 0.1.1's ``lora.Conv2d`` leaves
  (requirements.txt:11; reference models/ynet.py:141-144): the class
  subclasses nn.Conv2d, so ``<conv>.weight/bias`` plus
  ``lora_A (r*k, cin*k)`` and ``lora_B (cout*k, r*k)``.
- ``ynet_manifest``: the reference YNet state dict (without the
  backbone, converted on its own) for every network and train_net
  variant (reference models/ynet.py:15-131, 170-283, 286-367, 398-451,
  474-545).

``check_*_manifest`` run the converters over zero state dicts shaped by
the manifests and demand exact two-way coverage of ``unet_init`` /
``init_ynet``'s trees in the npz layout (io.params_to_numpy): the dry run
the real artifacts will face. CLI: ``python -m
mst_tpu_torch.models.convert --check-manifest``.
"""

import numpy as np

# the one architecture every released checkpoint family shares
# (reference config/*.yaml: all eight configs pin these)
ENCODER_CHANNELS = (32, 32, 64, 64, 64)
DECODER_CHANNELS = (64, 64, 64, 32, 32)
N_SEMANTIC_CLASSES = 6

# the five experiment suites (reference README.md:89-107) -> model family
FAMILIES = {
    # Motion Style Transfer across Agents (scripts/sdd/ped_to_biker)
    "sdd_shortterm_ynet": dict(obs_len=8, pred_len=12, n_waypoints=1,
                               network="original"),
    # Motion Style Transfer across Scenes (scripts/inD/ped2ped.../ynet)
    "ind_longterm_ynet": dict(obs_len=5, pred_len=30, n_waypoints=2,
                              network="original"),
    # Modular Style Adapter, agent motion (scripts/inD/scene1_car_to_truck)
    "ind_longterm_ynetmod": dict(obs_len=5, pred_len=30, n_waypoints=2,
                                 network="fusion", n_fusion=2),
    # Modular Style Adapter, scene (scripts/inD/ped2ped.../ynetmod)
    "ind_shortterm_ynetmod": dict(obs_len=8, pred_len=12, n_waypoints=1,
                                  network="fusion", n_fusion=2),
    # Modular Style Adapter, agent motion (scripts/sdd/biker_low_to_high)
    "sdd_shortterm_ynetmod": dict(obs_len=8, pred_len=12, n_waypoints=1,
                                  network="fusion", n_fusion=2),
}

# adaptation strategies whose checkpoints the suites release / produce
VARIANTS_ORIGINAL = [
    ("train", ()),
    ("mosa_1", (0, 1, 2, 3, 4)),
    ("mosa_2", (0, 1, 2, 3, 4)),
    ("mosa_3", (0, 1, 2, 3, 4)),
    ("serialLayer", (0, 1, 2, 3, 4)),
    ("parallelLayer_3x3", (0, 1, 2, 3, 4)),
    ("serial", (1, 2)),
    ("parallel_1x1_3x3", (0, 1)),
    ("semantic_3x3", ()),
    ("bias", ()),
]
VARIANTS_FUSION = [
    ("train", ()),
    ("scene", ()),
    ("motion", ()),
    ("fusion", ()),
    ("mosa_2", ("scene",)),
    ("mosa_2", ("motion",)),
    ("mosa_2", ("fusion",)),
    ("mosa_2", ("scene", "motion", "fusion")),
    ("parallelLayer_3x3", ("scene", "fusion")),
    ("serialLayer", ("motion",)),
]


# ---------------------------------------------------------------------------
# segmentation backbone: smp 0.1.0 Unet(resnet101)
# ---------------------------------------------------------------------------

RESNET101_LAYERS = (3, 4, 23, 3)
SMP_DECODER_CHANNELS = (256, 128, 64, 32, 16)
SMP_ENCODER_OUT = (3, 64, 256, 512, 1024, 2048)


def _bn_entries(m, prefix, ch):
    m[f"{prefix}.weight"] = (ch,)
    m[f"{prefix}.bias"] = (ch,)
    m[f"{prefix}.running_mean"] = (ch,)
    m[f"{prefix}.running_var"] = (ch,)
    m[f"{prefix}.num_batches_tracked"] = ()


def smp_unet_resnet101_manifest(classes=N_SEMANTIC_CLASSES,
                                layers=RESNET101_LAYERS,
                                decoder_channels=SMP_DECODER_CHANNELS):
    """name -> torch shape (OIHW) of smp 0.1.0 Unet(resnet101)."""
    m = {}
    # torchvision bottleneck ResNet101 stem + stages (fc/avgpool deleted
    # by smp's ResNetEncoder, so absent from the state dict)
    m["encoder.conv1.weight"] = (64, 3, 7, 7)
    _bn_entries(m, "encoder.bn1", 64)
    cin = 64
    for li, (w, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
        cout = w * 4
        for b in range(n):
            p = f"encoder.layer{li}.{b}"
            m[f"{p}.conv1.weight"] = (w, cin, 1, 1)
            _bn_entries(m, f"{p}.bn1", w)
            m[f"{p}.conv2.weight"] = (w, w, 3, 3)
            _bn_entries(m, f"{p}.bn2", w)
            m[f"{p}.conv3.weight"] = (cout, w, 1, 1)
            _bn_entries(m, f"{p}.bn3", cout)
            if b == 0:  # every stage's first block projects the identity
                m[f"{p}.downsample.0.weight"] = (cout, cin, 1, 1)
                _bn_entries(m, f"{p}.downsample.1", cout)
            cin = cout
    # smp UnetDecoder: blocks of (conv1, conv2) Conv2dReLU; attention1/2
    # are Identity (attention_type=None) with no parameters
    enc = SMP_ENCODER_OUT[::-1]
    in_ch = [enc[0]] + list(decoder_channels[:-1])
    skip_ch = list(enc[1:len(decoder_channels)]) + [0]
    for i, (ci, cs, co) in enumerate(zip(in_ch, skip_ch, decoder_channels)):
        p = f"decoder.blocks.{i}"
        m[f"{p}.conv1.0.weight"] = (co, ci + cs, 3, 3)
        _bn_entries(m, f"{p}.conv1.1", co)
        m[f"{p}.conv2.0.weight"] = (co, co, 3, 3)
        _bn_entries(m, f"{p}.conv2.1", co)
    m["segmentation_head.0.weight"] = (classes, decoder_channels[-1], 3, 3)
    m["segmentation_head.0.bias"] = (classes,)
    return m


# ---------------------------------------------------------------------------
# loralib 0.1.1 / adapter conv leaves
# ---------------------------------------------------------------------------

def loralib_conv_entries(m, prefix, cin, cout, k, r):
    """loralib 0.1.1 lora.Conv2d leaves (subclass of nn.Conv2d)."""
    m[f"{prefix}.weight"] = (cout, cin, k, k)
    m[f"{prefix}.bias"] = (cout,)
    m[f"{prefix}.lora_A"] = (r * k, cin * k)
    m[f"{prefix}.lora_B"] = (cout * k, r * k)


def _adapter_entries(m, prefix, train_net, cin, cout):
    """AdapterLayer/AdapterBlock sub-layer leaves (ynet.py:15-131).

    serial: BatchNorm + zero-init 1x1 conv (bias=False);
    parallel: zero-init kxk conv(s) (bias=False), ModuleList when the
    name carries multiple sizes (e.g. parallel_1x1_3x3).
    """
    sizes = train_net.split("_")[1:]
    if "serial" in train_net:
        _bn_entries(m, f"{prefix}.serial_layer.0", cout)
        m[f"{prefix}.serial_layer.1.weight"] = (cout, cout, 1, 1)
    elif "parallel" in train_net:
        if len(sizes) >= 2:  # multiple kernel sizes -> ModuleList
            for j, s in enumerate(sizes):
                k = int(s.split("x")[0])
                m[f"{prefix}.parallel_layer.{j}.weight"] = (cout, cin, k, k)
        else:
            k = int(sizes[0].split("x")[0]) if sizes else 1
            m[f"{prefix}.parallel_layer.weight"] = (cout, cin, k, k)


def _get_conv2d_entries(m, prefix, train_net, l, position, cin, cout,
                        k=3, rank=None):
    """Mirror of reference get_conv2d (ynet.py:134-151) key emission."""
    position = [str(p) for p in position]
    if "mosa" in train_net and str(l) in position:
        # single source of the loralib shape contract
        loralib_conv_entries(m, prefix, cin, cout, k, rank)
        return
    m[f"{prefix}.weight"] = (cout, cin, k, k)
    m[f"{prefix}.bias"] = (cout,)
    if "Layer" in train_net and str(l) in position:
        _adapter_entries(m, prefix, train_net, cin, cout)


# ---------------------------------------------------------------------------
# YNet state-dict manifest (reference models/ynet.py:474-545)
# ---------------------------------------------------------------------------

def _mosa_rank(train_net):
    if "mosa" not in train_net:
        return None
    parts = train_net.split("_")
    return int(parts[1]) if len(parts) > 1 else 1


def _decoder_entries(m, name, encoder_channels, decoder_channels,
                     output_len, traj=False):
    """YNetDecoder (ynet.py:398-451)."""
    enc = [c + traj for c in encoder_channels] if traj \
        else list(encoder_channels)
    enc = enc[::-1]
    cc = enc[0]
    m[f"{name}.center.0.weight"] = (2 * cc, cc, 3, 3)
    m[f"{name}.center.0.bias"] = (2 * cc,)
    m[f"{name}.center.2.weight"] = (2 * cc, 2 * cc, 3, 3)
    m[f"{name}.center.2.bias"] = (2 * cc,)
    up_in = [2 * cc] + list(decoder_channels[:-1])
    up_out = [c // 2 for c in up_in]
    for i, (ci, co) in enumerate(zip(up_in, up_out)):
        m[f"{name}.upsample_conv.{i}.weight"] = (co, ci, 3, 3)
        m[f"{name}.upsample_conv.{i}.bias"] = (co,)
    dec_in = [e + u for e, u in zip(enc, up_out)]
    for i, (ci, co) in enumerate(zip(dec_in, decoder_channels)):
        m[f"{name}.decoder.{i}.0.weight"] = (co, ci, 3, 3)
        m[f"{name}.decoder.{i}.0.bias"] = (co,)
        m[f"{name}.decoder.{i}.2.weight"] = (co, co, 3, 3)
        m[f"{name}.decoder.{i}.2.bias"] = (co,)
    m[f"{name}.predictor.weight"] = (output_len, decoder_channels[-1], 1, 1)
    m[f"{name}.predictor.bias"] = (output_len,)


def ynet_manifest(obs_len, pred_len, n_waypoints,
                  n_semantic_classes=N_SEMANTIC_CLASSES,
                  encoder_channels=ENCODER_CHANNELS,
                  decoder_channels=DECODER_CHANNELS,
                  train_net="train", position=(), network="original",
                  n_fusion=None):
    """name -> torch shape of the reference YNet state dict, minus the
    ``semantic_segmentation.*`` subtree (converted separately)."""
    m = {}
    ch = list(encoder_channels)
    in_ch = n_semantic_classes + obs_len
    rank = _mosa_rank(train_net)

    if "semantic" in train_net:  # zero-init adapter conv (ynet.py:513-519)
        k = int(train_net.split("_")[-1].split("x")[0])
        m["semantic_adapter.weight"] = (n_semantic_classes,
                                        n_semantic_classes, k, k)
        m["semantic_adapter.bias"] = (n_semantic_classes,)

    if network == "embed":  # 3-conv embeddings (ynet.py:154-167,529-531)
        for name, c in (("scene_embedding", n_semantic_classes),
                        ("motion_embedding", obs_len)):
            for j in (0, 2, 4):
                m[f"{name}.conv.{j}.weight"] = (c, c, 3, 3)
                m[f"{name}.conv.{j}.bias"] = (c,)

    if network == "fusion":
        # YNetEncoderFusion (ynet.py:286-367): half-channel scene/motion
        # branches for n_sep stages, then full-channel fusion stages
        n_sep = len(ch) - n_fusion - 1
        for branch, c0 in (("scene", n_semantic_classes),
                           ("motion", obs_len)):
            _get_conv2d_entries(m, f"encoder.{branch}_stages.0.0",
                                train_net, branch, position, c0, ch[0] // 2,
                                rank=rank)
            for i in range(n_sep):
                _get_conv2d_entries(
                    m, f"encoder.{branch}_stages.{i + 1}.1", train_net,
                    branch, position, ch[i] // 2, ch[i + 1] // 2, rank=rank)
                _get_conv2d_entries(
                    m, f"encoder.{branch}_stages.{i + 1}.3", train_net,
                    branch, position, ch[i + 1] // 2, ch[i + 1] // 2,
                    rank=rank)
        for fi, i in enumerate(range(n_sep, len(ch) - 1)):
            _get_conv2d_entries(m, f"encoder.fusion_stages.{fi}.1",
                                train_net, "fusion", position, ch[i],
                                ch[i + 1], rank=rank)
            _get_conv2d_entries(m, f"encoder.fusion_stages.{fi}.3",
                                train_net, "fusion", position, ch[i + 1],
                                ch[i + 1], rank=rank)
    else:
        # YNetEncoder stages (ynet.py:170-215): stage l == position index
        _get_conv2d_entries(m, "encoder.stages.0.0", train_net, 0, position,
                            in_ch, ch[0], rank=rank)
        for i in range(1, len(ch)):
            _get_conv2d_entries(m, f"encoder.stages.{i}.1", train_net, i,
                                position, ch[i - 1], ch[i], rank=rank)
            _get_conv2d_entries(m, f"encoder.stages.{i}.3", train_net, i,
                                position, ch[i], ch[i], rank=rank)
        # block adapters (YNetEncoderB, ynet.py:237-256): ModuleList
        # indexed by the ORDER positions were given
        if "Layer" not in train_net and (
                "serial" in train_net or "parallel" in train_net):
            par_in = [in_ch] + ch[:-1]
            for j, p in enumerate(int(p) for p in position):
                cin = ch[p] if "serial" in train_net else par_in[p]
                _adapter_entries(m, f"encoder.adapters.{j}", train_net,
                                 cin, ch[p])

    _decoder_entries(m, "goal_decoder", ch, list(decoder_channels),
                     pred_len)
    _decoder_entries(m, "traj_decoder", ch, list(decoder_channels),
                     pred_len, traj=n_waypoints)
    return m


# ---------------------------------------------------------------------------
# strict converter-coverage checks (the --check-manifest dry run)
# ---------------------------------------------------------------------------

def _zeros_state_dict(manifest):
    return {k: (np.zeros(s, np.float32) if s != () else
                np.zeros((), np.int64))
            for k, s in manifest.items()}


def _npz_shapes(tree):
    """A port tree's {key: shape} in the npz layout (conv weights HWIO)."""
    from mst_tpu_torch import io

    return {k: tuple(v.shape) for k, v in io.params_to_numpy(tree).items()}


def _diff(name, got, want):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    msgs = []
    if missing:
        msgs.append(f"{name}: {len(missing)} target leaves never produced "
                    f"by the converter, e.g. {missing[:6]}")
    if extra:
        msgs.append(f"{name}: {len(extra)} converted keys with no target "
                    f"leaf, e.g. {extra[:6]}")
    if bad:
        msgs.append(f"{name}: {len(bad)} shape mismatches, e.g. " + ", ".join(
            f"{k}: {got[k]} != {want[k]}" for k in bad[:4]))
    return msgs


def check_segmentation_manifest(verbose=False):
    """Convert a zero state dict shaped like the pickled smp module and
    demand exact two-way coverage of ``unet_init``'s tree."""
    import torch

    from mst_tpu_torch.models.convert import convert_torch_segmentation
    from mst_tpu_torch.models.unet import unet_init

    manifest = smp_unet_resnet101_manifest()
    flat = convert_torch_segmentation(_zeros_state_dict(manifest))
    got = {k: tuple(np.shape(v)) for k, v in flat.items()}
    errors = _diff("segmentation", got,
                   _npz_shapes(unet_init(torch.Generator().manual_seed(0))))
    if verbose:
        print(f"segmentation: {len(manifest)} torch keys -> "
              f"{len(got)} converted leaves "
              f"({len(manifest) - len(got) + 1} num_batches_tracked "
              f"skipped, 1 _meta/activation added); "
              f"{'OK' if not errors else 'MISMATCH'}")
    return errors


def check_ynet_manifest(family, train_net, position, verbose=False):
    """Convert a zero state dict shaped like one released YNet family
    and demand exact two-way coverage of ``init_ynet``'s trees."""
    import torch

    from mst_tpu_torch.models.convert import convert_torch_ynet
    from mst_tpu_torch.models.ynet import YNetConfig, init_ynet

    fam = FAMILIES[family]
    manifest = ynet_manifest(
        fam["obs_len"], fam["pred_len"], fam["n_waypoints"],
        train_net=train_net, position=position, network=fam["network"],
        n_fusion=fam.get("n_fusion"))
    flat, flat_state = convert_torch_ynet(_zeros_state_dict(manifest),
                                          position=position)
    cfg = YNetConfig(
        obs_len=fam["obs_len"], pred_len=fam["pred_len"],
        n_semantic_classes=N_SEMANTIC_CLASSES,
        encoder_channels=ENCODER_CHANNELS,
        decoder_channels=DECODER_CHANNELS,
        waypoints=tuple(range(fam["n_waypoints"])),
        train_net=train_net, position=position, network=fam["network"],
        n_fusion=fam.get("n_fusion"))
    params, state = init_ynet(torch.Generator().manual_seed(0), cfg)
    got = {k: tuple(np.shape(v)) for k, v in flat.items()}
    got.update({f"state:{k}": tuple(np.shape(v))
                for k, v in flat_state.items()})
    want = _npz_shapes(params)
    want.update({f"state:{k}": s for k, s in _npz_shapes(state).items()})
    errors = _diff(f"{family}/{train_net}", got, want)
    if verbose:
        status = "OK" if not errors else "MISMATCH"
        print(f"{family}/{train_net} pos={list(position)}: "
              f"{len(manifest)} torch keys -> {len(flat)} params + "
              f"{len(flat_state)} state leaves; {status}")
    return errors


def check_all(verbose=True):
    """Every family x variant and the backbone -> a list of error strings
    (empty: full coverage)."""
    errors = list(check_segmentation_manifest(verbose=verbose))
    for family, fam in FAMILIES.items():
        variants = (VARIANTS_FUSION if fam["network"] == "fusion"
                    else VARIANTS_ORIGINAL)
        for train_net, position in variants:
            errors.extend(check_ynet_manifest(family, train_net, position,
                                              verbose=verbose))
    return errors
