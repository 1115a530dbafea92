"""Torch -> npz checkpoint conversion (counterpart of
mst_tpu/models/convert.py), writing mst_tpu's npz layout: flat
'/'-joined keys, conv weights HWIO, BN running statistics of the
adapters in a '_state.npz' sidecar. The same file then loads in both
packages (io.params_from_numpy here).

- Y-Net checkpoints: full `*_weights.pt` state dicts and adapter-only
  deltas (reference trainer.py:594-604), `convert_torch_ynet`;
- the segmentation backbone: the reference ships a pickled smp module
  (torch.load, ynet.py:495-502); its state dict, `convert_torch_segmentation`
  (BN running statistics inline: the backbone's batch norms carry them).

loralib's lora_A/lora_B are kept as they are (models/layers.py evaluates
the same (B @ A).view(...) / r merged weight).

CLI:
  python -m mst_tpu_torch.models.convert ynet in.pt out.npz [--position ...]
  python -m mst_tpu_torch.models.convert segmentation in.pth out.npz \
      [--activation softmax|none] [--no-strict]
  python -m mst_tpu_torch.models.convert --check-manifest
"""

import argparse
import re

import numpy as np


def _hwio(w):
    w = np.asarray(w)
    return np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else w


def _map_decoder_key(rest):
    """'center.0.weight' etc -> our decoder path, or None."""
    m = re.match(r"center\.(\d+)\.(\w+)$", rest)
    if m:
        idx = {0: "0", 2: "1"}[int(m.group(1))]
        return f"center/{idx}/{m.group(2)}"
    m = re.match(r"upsample_conv\.(\d+)\.(\w+)$", rest)
    if m:
        return f"upsample/{m.group(1)}/{m.group(2)}"
    m = re.match(r"decoder\.(\d+)\.(\d+)\.(\w+)$", rest)
    if m:
        idx = {0: "0", 2: "1"}[int(m.group(2))]
        return f"blocks/{m.group(1)}/{idx}/{m.group(3)}"
    m = re.match(r"predictor\.(\w+)$", rest)
    if m:
        return f"predictor/{m.group(1)}"
    return None


def _map_stage_conv(group: str, stage: str, j: int) -> str:
    """torch Sequential index -> conv slot.

    Stage 0 of `stages`/`scene_stages`/`motion_stages` is the stem
    [conv, relu] (ynet.py:192-197,306-319); every other stage — including
    ALL fusion_stages — is [pool, conv, relu, conv, relu]."""
    if stage == "0" and group != "fusion_stages":
        return "conv0"
    return {1: "conv0", 3: "conv1"}[j]


_BN_STATE_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def convert_torch_ynet(state_dict, position=()):
    """torch YNet state dict -> (flat params dict, flat state dict)."""
    params, state = {}, {}
    position = [str(p) for p in position]

    def put(path, key, val):
        leaf = "num_batches" if key == "num_batches_tracked" else key
        target = state if key in _BN_STATE_KEYS else params
        target[f"{path}/{leaf}"] = (
            _hwio(val) if leaf == "weight" and np.asarray(val).ndim == 4
            else np.asarray(val))

    for name, val in state_dict.items():
        # copy: torch .numpy()/np.asarray share the parameter storage, and
        # a converted tree must not silently track later in-place optimizer
        # updates of the source model
        val = np.array(getattr(val, "numpy", lambda: val)()
                       if hasattr(val, "numpy") else val, copy=True)
        if name.startswith("semantic_segmentation"):
            continue  # convert separately (convert_torch_segmentation)

        # ---- encoders (plain + fusion branches)
        m = re.match(
            r"encoder\.(stages|scene_stages|motion_stages|fusion_stages)"
            r"\.(\d+)\.(\d+)\.(.+)$", name)
        if m:
            group, stage, j, rest = m.groups()
            conv = _map_stage_conv(group, stage, int(j))
            base = f"encoder/{group}/{stage}/{conv}"
            # in-layer adapters: rest like 'serial_layer.0.weight' (BN),
            # 'serial_layer.1.weight' (conv), 'parallel_layer.k.weight'
            am = re.match(r"serial_layer\.(\d+)\.(\w+)$", rest)
            if am:
                sub = {0: "bn", 1: "conv"}[int(am.group(1))]
                put(f"{base}/serial_layer/{sub}", am.group(2), val)
                continue
            am = re.match(r"parallel_layer\.(\d+)\.(\w+)$", rest)
            if am:
                put(f"{base}/parallel_layer/{am.group(1)}", am.group(2), val)
                continue
            am = re.match(r"parallel_layer\.(\w+)$", rest)
            if am:
                put(f"{base}/parallel_layer/0", am.group(1), val)
                continue
            put(base, rest, val)  # weight / bias / lora_A / lora_B
            continue

        # ---- block adapters (YNetEncoderB, indexed by order -> position)
        m = re.match(r"encoder\.adapters\.(\d+)\.(.+)$", name)
        if m:
            j, rest = m.groups()
            pos = position[int(j)] if int(j) < len(position) else j
            base = f"encoder/adapters/{pos}"
            am = re.match(r"serial_layer\.(\d+)\.(\w+)$", rest)
            if am:
                sub = {0: "bn", 1: "conv"}[int(am.group(1))]
                put(f"{base}/serial_layer/{sub}", am.group(2), val)
                continue
            am = re.match(r"parallel_layer\.(\d+)\.(\w+)$", rest)
            if am:
                put(f"{base}/parallel_layer/{am.group(1)}", am.group(2), val)
                continue
            am = re.match(r"parallel_layer\.(\w+)$", rest)
            if am:
                put(f"{base}/parallel_layer/0", am.group(1), val)
                continue
            continue

        # ---- decoders
        m = re.match(r"(goal_decoder|traj_decoder)\.(.+)$", name)
        if m:
            mapped = _map_decoder_key(m.group(2))
            if mapped:
                params[f"{m.group(1)}/{mapped}"] = _hwio(val)
            continue

        # ---- semantic adapter + embeddings
        m = re.match(r"semantic_adapter\.(\w+)$", name)
        if m:
            params[f"semantic_adapter/{m.group(1)}"] = _hwio(val)
            continue
        m = re.match(r"(scene|motion)_embedding\.conv\.(\d+)\.(\w+)$", name)
        if m:
            idx = {0: "0", 2: "1", 4: "2"}[int(m.group(2))]
            params[f"{m.group(1)}_embedding/{idx}/{m.group(3)}"] = _hwio(val)
            continue
    return params, state


def convert_torch_segmentation(state_dict, activation="softmax",
                               strict=False):
    """smp Unet('resnet101') state dict -> flat params dict (BN running
    statistics inline; num_batches_tracked dropped; '_meta/activation' 1
    for softmax, else 0).

    strict=True holds the result against the smp 0.1.0 manifest
    (models/manifests.py): every expected leaf with its shape, and no
    other key; the check a released .pth must pass."""
    params = {}
    skipped = []
    for name, val in state_dict.items():
        val = np.array(getattr(val, "numpy", lambda: val)()
                       if hasattr(val, "numpy") else val, copy=True)
        name = re.sub(r"^(semantic_segmentation|model)\.", "", name)
        if name.endswith("num_batches_tracked"):
            continue
        if re.match(r"^encoder\.(fc|avgpool)\.", name):
            # torchvision's classifier head, which smp's ResNetEncoder
            # deletes; tolerated should a variant keep it
            skipped.append(name)
            continue
        if val.ndim == 4:
            val = _hwio(val)
        params[name.replace(".", "/")] = val
    params["_meta/activation"] = np.array(
        1 if activation == "softmax" else 0)
    if strict:
        from mst_tpu_torch.models.manifests import (
            _diff, smp_unet_resnet101_manifest)

        head_bias = params.get("segmentation_head/0/bias")
        # no head (an encoder-only dict): the released 6-class manifest,
        # so _diff reports it readably
        n_classes = head_bias.shape[0] if head_bias is not None else 6
        want = {}
        for k, s in smp_unet_resnet101_manifest(classes=n_classes).items():
            if k.endswith("num_batches_tracked"):
                continue
            s = (s[2], s[3], s[1], s[0]) if len(s) == 4 else s  # OIHW->HWIO
            want[k.replace(".", "/")] = s
        want["_meta/activation"] = ()
        got = {k: tuple(np.shape(v)) for k, v in params.items()}
        errors = _diff("segmentation", got, want)
        if skipped:
            print(f"[convert] skipped classifier-head keys: {skipped}")
        if errors:
            raise ValueError(
                "segmentation checkpoint does not match the smp 0.1.0 "
                "Unet(resnet101) manifest:\n  " + "\n  ".join(errors))
    return params


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert a torch checkpoint to the npz layout")
    parser.add_argument("kind", nargs="?", choices=["ynet", "segmentation"])
    parser.add_argument("src", nargs="?")
    parser.add_argument("dst", nargs="?")
    parser.add_argument("--position", nargs="+", default=[])
    parser.add_argument("--activation", default="softmax")
    parser.add_argument("--no-strict", action="store_true",
                        help="segmentation only: skip the manifest check")
    parser.add_argument("--check-manifest", action="store_true",
                        help="convert every manifest's zero state dict and "
                             "check its coverage of the initialisers")
    args = parser.parse_args(argv)
    if args.check_manifest:
        from mst_tpu_torch.models.manifests import check_all

        errors = check_all(verbose=True)
        if errors:
            print(f"\n{len(errors)} coverage error(s):")
            for e in errors:
                print(" -", e)
            raise SystemExit(1)
        print("\nall manifests fully covered")
        return
    if not (args.kind and args.src and args.dst):
        parser.error("kind, src and dst are required")

    import torch

    # weights_only=False: the released backbone is a pickled smp module,
    # which torch >= 2.6 refuses under weights_only=True. This loads a
    # file the user chose, as the reference's own torch.load does.
    sd = torch.load(args.src, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # np.savez appends .npz to a bare name; normalise first so the state
    # sidecar sits beside the params
    dst = args.dst if args.dst.endswith(".npz") else args.dst + ".npz"
    if args.kind == "ynet":
        params, state = convert_torch_ynet(sd, args.position)
        np.savez(dst, **params)
        if state:
            np.savez(dst[:-len(".npz")] + "_state.npz", **state)
    else:
        params = convert_torch_segmentation(sd, args.activation,
                                            strict=not args.no_strict)
        np.savez(dst, **params)
    print(f"converted {len(sd)} torch tensors -> {dst}")


if __name__ == "__main__":
    main()
