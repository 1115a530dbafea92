"""Config: the CLI flags, a YAML file of `mst_tpu_torch/configs` (or a path)
merged with them into one flat params dict, the experiment-name codec and
the dataset paths (counterpart of mst_tpu/config.py:26-306 and
mst_tpu/train/trainer.py:312-351), with the JAX package's key vocabulary
and flag surface, plus --device.

--mesh_shape N and --mesh_shape R D (--mesh_axes replica data) run
data-parallel over the ranks torchrun starts, and --mesh_shape D S
--mesh_axes data space trains and evaluates on the spatial mesh
(parallel/mesh.py; the grid refuses it as mst_tpu's does). An unknown
--compute_dtype raises ValueError (parse_compute_dtype,
check_loop_ported).
--seg_cache_device_mb sizes a TPU-side cache and is accepted and unused.
The segmentation backbone is used when its weight file exists
(has_backbone).
"""

import argparse
import json
import os
import pathlib

import numpy as np
import torch
import yaml

from mst_tpu_torch.models.ynet import YNetConfig
from mst_tpu_torch.train.steps import CWSParams, StepConfig

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


# ---------------------------------------------------------------------------
# arg parser — mst_tpu/config.py:26-137 (reference utils/parser.py:6-80)
# ---------------------------------------------------------------------------

def get_parser(is_train: bool) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    # data args (parser.py:6-21)
    parser.add_argument("--dataset_path", default=None, type=str)
    parser.add_argument("--ckpt_path", default="ckpts")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--load_data", default="sequential",
                        choices=["sequential", "predefined"])
    parser.add_argument("--show_details", action="store_true")
    parser.add_argument("--val_split", default=0.1, type=float)
    parser.add_argument("--test_splits", default=None, type=int, nargs="+")
    parser.add_argument("--val_files", default=None, type=str, nargs="+")
    parser.add_argument("--share_val_test", action="store_true")
    # model args (parser.py:24-41)
    parser.add_argument("--ckpts", default=None, type=str, nargs="+")
    parser.add_argument("--ckpts_name", default=None, type=str, nargs="+")
    parser.add_argument("--pretrained_ckpt", default=None, type=str)
    parser.add_argument("--tuned_ckpt", default=None, type=str)
    parser.add_argument("--tuned_ckpts", default=None, type=str, nargs="+")
    parser.add_argument("--network",
                        choices=["original", "embed", "fusion"],
                        default="original",
                        help="the Y-Net, the embed network or Y-Net-Mod"
                             " (fusion, with --n_fusion)")
    parser.add_argument("--n_fusion", default=None, type=int)
    parser.add_argument("--swap_semantic", action="store_true")
    parser.add_argument("--position", default=[], type=str, nargs="+")
    parser.add_argument("--ynet_bias", action="store_true")
    parser.add_argument("--train_net", default="train", type=str)
    # general args (parser.py:44-50)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--n_round", default=1, type=int)
    parser.add_argument("--config_filename", default=None, type=str)
    # mst_tpu's additions
    parser.add_argument("--mesh_shape", default=None, type=int, nargs="+",
                        help="device mesh shape: N (data) or R D (replica"
                             " data), one process a device under torchrun;"
                             " its product must be the world size")
    parser.add_argument("--mesh_axes", default=None, type=str, nargs="+",
                        help="mesh axis names: data, replica data, or"
                             " data space (the spatial mesh: the scene"
                             " maps' H over 'space')")
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="the convs' dtype; bfloat16 keeps f32 master "
                             "weights, losses, sampling and soft-argmax "
                             "statistics")
    parser.add_argument("--metrics_jsonl", default=None, type=str,
                        help="write structured per-epoch train/val metrics"
                             " as JSON lines to this path (alongside the"
                             " reference-compatible stdout)")
    parser.add_argument("--cross_scene_batching", action="store_true",
                        help="train and test batches across scenes sharing"
                             " a padded image shape (validation and eth stay"
                             " per scene)")
    parser.add_argument("--max_scenes_per_batch", default=8, type=int,
                        help="the most scenes a --cross_scene_batching"
                             " group stacks: its batches carry that many"
                             " scene maps, each row gathering its own")
    parser.add_argument("--eth_world_coords", action="store_true",
                        help="ETH/UCY metrics in world coordinates through"
                             " each scene's homography (dataset_name eth)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the encoder's and the map decoders'"
                             " activations in the train step's backward"
                             " instead of holding them")
    parser.add_argument("--seg_cache_device_mb", default=512, type=int,
                        help="mst_tpu's ceiling on device-resident semantic"
                             " maps; accepted and unused (the port keeps"
                             " every scene's map on the device)")
    # the port's addition
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (which must exist) or cpu (the plain"
                             " PyTorch path)")
    if is_train:
        # train args (parser.py:53-69)
        parser.add_argument("--fine_tune", action="store_true")
        parser.add_argument("--resume", action="store_true",
                            help="resume from <ckpt_path>/<experiment>"
                                 "__train_state.npz (written every"
                                 " save_every_n epochs) if it exists")
        parser.add_argument("--n_epoch", default=100, type=int)
        parser.add_argument("--n_early_stop", default=300, type=int)
        parser.add_argument("--n_train_batch", default=None, type=float)
        parser.add_argument("--lr", default=0.0001, type=float)
        parser.add_argument("--steps", default=[], type=int, nargs="+")
        parser.add_argument("--lr_decay_ratio", default=0.1, type=float)
        parser.add_argument("--init_check", action="store_true")
        parser.add_argument("--window_size", default=9, type=int)
        parser.add_argument("--smooth_val", action="store_true")
        parser.add_argument("--train_files", default=None, type=str,
                            nargs="+")
        parser.add_argument("--fused", action="store_true",
                            help="run the epoch loop in chunks of epochs,"
                                 " each epoch (train steps + validation)"
                                 " a CUDA-graph replay, one host read a"
                                 " chunk (eager on the CPU); falls back to"
                                 " the loop, saying why, when ineligible"
                                 " (several scene shapes, cross-scene"
                                 " batches, in-step segmentation,"
                                 " e_unfreeze, an empty split)")
    return parser


# ---------------------------------------------------------------------------
# params dict — mst_tpu/config.py:139-179 (reference utils/util.py:34-59)
# ---------------------------------------------------------------------------

_DEFAULTS = dict(
    save_every_n=10, use_raw_data=False, fine_tune=False, augment=False,
    ynet_bias=False, use_CWS=False, use_TTST=False, rel_threshold=0.002,
    CWS_params=None, n_early_stop=300, steps=[], lr_decay_ratio=0.1,
    network="original", swap_semantic=False, window_size=9, smooth_val=False,
    e_unfreeze=10000, n_round=1, position=[], train_net="train",
    n_fusion=None, use_features_only=False, compute_dtype="float32",
    mesh_shape=None, mesh_axes=None, remat=False, eth_world_coords=False,
    segmentation_model_fp=None, eval_k_chunk=0,
    cross_scene_batching=False, max_scenes_per_batch=8, fused=False,
    metrics_jsonl=None,
)


def get_params(config_filename=None, overrides=None, args=None) -> dict:
    """Defaults, then the YAML, then the CLI args, then the overrides.

    The YAML is config_filename (else args.config_filename): an existing
    path, else config/<name>, else a file of mst_tpu_torch/configs. For sdd
    and inD with a data_dir, segmentation_model_fp names the dataset's
    backbone weights (util.py:39-49); the backbone is used only if that
    file exists (see has_backbone). A whole-number --n_train_batch becomes
    an int, in args too (util.py:52-56).
    """
    params = dict(_DEFAULTS)
    fname = config_filename or (args.config_filename if args else None)
    if fname:
        if os.path.exists(fname):
            path = fname
        elif os.path.exists(os.path.join("config", fname)):
            path = os.path.join("config", fname)
        else:
            path = os.path.join(CONFIG_DIR, fname)
        with open(path) as f:
            params.update(yaml.safe_load(f))

    dataset_name = str(params.get("dataset_name", "")).lower()
    if params.get("data_dir") and dataset_name:
        if "sdd" in dataset_name:
            seg = "sdd_segmentation.npz"
        elif "ind" in dataset_name:
            seg = "inD_segmentation.npz"
        else:
            seg = None
        if seg:
            params["segmentation_model_fp"] = os.path.join(
                params["data_dir"], params["dataset_name"], seg)

    if args is not None:
        d = vars(args)
        ntb = d.get("n_train_batch")
        if ntb is not None and int(ntb) == ntb:
            d["n_train_batch"] = int(ntb)
        params.update(d)
    if overrides:
        params.update(overrides)
    if params.get("network") == "fusion" and params.get("n_fusion") is None:
        raise ValueError("network=fusion needs n_fusion")
    return params


def has_backbone(params: dict) -> bool:
    """A segmentation backbone is present only when its weight file exists
    (mst_tpu/config.py:185); otherwise the identity backbone is used: the
    scene image is the semantic map."""
    seg_fp = params.get("segmentation_model_fp")
    return bool(seg_fp and os.path.exists(seg_fp))


_COMPUTE_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                   "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def parse_compute_dtype(name) -> torch.dtype:
    """--compute_dtype -> torch.float32 or torch.bfloat16, as
    mst_tpu/train/trainer.py:48-59 parses it; anything else raises."""
    try:
        return _COMPUTE_DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(f"compute_dtype={name!r}: expected one of "
                         f"{sorted(_COMPUTE_DTYPES)}") from None


def check_loop_ported(params: dict):
    """Raise on what mst_tpu's Experiment loop takes and the port does not
    act on: an unknown compute dtype."""
    parse_compute_dtype(params.get("compute_dtype", "float32"))


def ynet_config(params: dict) -> YNetConfig:
    """The model config of a flat params dict (mst_tpu/config.py:182-204):
    segmentation 'unet' when the backbone's file exists, else None (the
    identity backbone); with the backbone, use_features_only feeds its 16
    decoder channels to the Y-Net in place of the classes."""
    backbone = has_backbone(params)
    features_only = bool(params.get("use_features_only", False))
    return YNetConfig(
        obs_len=params["obs_len"],
        pred_len=params["pred_len"],
        n_semantic_classes=(16 if features_only and backbone
                            else params["n_semantic_classes"]),
        encoder_channels=tuple(params["encoder_channels"]),
        decoder_channels=tuple(params["decoder_channels"]),
        waypoints=tuple(params["waypoints"]),
        train_net=params.get("train_net", "train"),
        position=tuple(params.get("position", ()) or ()),
        network=params.get("network") or "original",
        n_fusion=params.get("n_fusion"),
        use_features_only=features_only,
        segmentation="unet" if backbone else None,
    )


def step_config(params: dict, for_validation: bool = False,
                **overrides) -> StepConfig:
    """The step config of a flat params dict (as
    mst_tpu.train.trainer.Experiment._step_config builds it).
    for_validation turns TTST off and passes use_CWS through, as the
    reference's per-epoch validation does (trainer.py:314-317). The
    backbone's step fields (segment_in_step, segment_train_mode) come as
    overrides; use_features_only, compute_dtype and remat are the
    config's."""
    cws = params.get("CWS_params")
    scfg = StepConfig(
        obs_len=params["obs_len"], pred_len=params["pred_len"],
        waypoints=tuple(params["waypoints"]),
        template_size=int(4200 * params["resize_factor"]),
        resize_factor=float(params["resize_factor"]),
        temperature=float(params["temperature"]),
        n_goal=int(params["n_goal"]), n_traj=int(params["n_traj"]),
        use_ttst=bool(params["use_TTST"]) and not for_validation,
        rel_threshold=float(params["rel_threshold"]),
        use_cws=bool(params["use_CWS"]),
        cws_params=(CWSParams(sigma_factor=float(cws["sigma_factor"]),
                              ratio=float(cws["ratio"]),
                              rot=bool(cws["rot"])) if cws else None),
        eval_k_chunk=int(params["eval_k_chunk"]),
        kernlen=int(params["kernlen"]), nsig=float(params["nsig"]),
        loss_scale=float(params["loss_scale"]),
        swap_semantic=bool(params["swap_semantic"]),
        use_features_only=bool(params.get("use_features_only", False)),
        # ETH metrics are in pixels unless --eth_world_coords
        # (trainer.py:341-347)
        world_coords=(str(params.get("dataset_name", "")).lower() == "eth"
                      and bool(params.get("eth_world_coords", False))),
        compute_dtype=parse_compute_dtype(params.get("compute_dtype",
                                                     "float32")),
        remat=bool(params.get("remat", False)),
    )
    return scfg._replace(**overrides)


def get_image_and_data_path(params):
    """reference utils/util.py:62-75."""
    dataset_name = params["dataset_name"].lower()
    if "sdd" in dataset_name:
        image_path = os.path.join(params["data_dir"], params["dataset_name"],
                                  "raw", "annotations")
    elif "ind" in dataset_name or dataset_name == "eth":
        # eth: the port's layout, <data_dir>/eth/images/<scene>/oracle.png
        # beside <data_dir>/eth_ucy/<scene>_H.txt (the reference and
        # mst_tpu have no eth path here)
        image_path = os.path.join(params["data_dir"], params["dataset_name"],
                                  "images")
    else:
        raise ValueError(f"Invalid {dataset_name}")
    if not os.path.isdir(image_path):
        raise FileNotFoundError(f"image dir error: {image_path}")
    data_path = os.path.join(params["data_dir"], params["dataset_name"],
                             params["dataset_path"])
    if not os.path.isdir(data_path):
        raise FileNotFoundError(f"data dir error: {data_path}")
    return image_path, data_path


# ---------------------------------------------------------------------------
# experiment naming + ckpt-name codec — mst_tpu/config.py:230-306
# (reference utils/util.py:7-31, 78-135), byte for byte: the log tools
# parse these strings
# ---------------------------------------------------------------------------

def get_experiment_name(args, n_data) -> str:
    experiment = f"Seed_{args.seed}"
    if args.load_data == "sequential":
        files = "_".join(f.replace(".pkl", "") for f in args.train_files)
        experiment += f"__{args.dataset_path.replace('/', '_')}_{files}"
    else:
        experiment += f"__{args.dataset_path.replace('/', '_')}"
    experiment += f"__{args.train_net}"
    if args.position:
        experiment += f'__Pos_{"_".join(map(str, args.position))}'
    if args.n_train_batch is not None:
        experiment += f"__TrN_{n_data}"
        experiment += f'__lr_{np.format_float_positional(args.lr, trim="-")}'
        if args.smooth_val:
            experiment += "__smooth"
        if args.n_early_stop < args.n_epoch:
            experiment += f"__early_{args.n_early_stop}"
        if args.augment:
            experiment += "__AUG"
        if args.ynet_bias:
            experiment += "__bias"
    if args.network in ("original", "embed"):
        experiment += f"__{args.network}"
    else:
        experiment += f"__fusion_{args.n_fusion}"
    return experiment


def get_position(ckpt_path, return_list=True):
    """reference utils/util.py:78-90."""
    if ckpt_path is None or "Pos" not in ckpt_path:
        return None
    pos = ckpt_path.split("Pos_")[-1].split("__")[0]
    return pos.split("_") if return_list else pos


def get_ckpt_name(ckpt_path):
    """reference utils/util.py:93-103."""
    ckpt_path = ckpt_path.split("/")[-1]
    train_net = ckpt_path.split("__")[2]
    n_train = int(ckpt_path.split("TrN_")[-1].split("_")[0])
    if "Pos" in ckpt_path:
        position = get_position(ckpt_path, return_list=False)
        return f"{train_net}[{position}]({n_train})"
    return f"{train_net}({n_train})"


def update_params_from_ckpt(ckpt_path, params):
    """reference utils/util.py:106-122 (+ the JSON sidecar if there is
    one)."""
    meta_path = str(ckpt_path) + ".json"
    updated = dict(params)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            updated.update(json.load(f))
        return updated
    name = ckpt_path.split("/")[-1]
    updated["train_net"] = name.split("__")[2].split(".")[0]
    if params.get("pretrained_ckpt"):
        base_arch = params["pretrained_ckpt"].split("_")[-1].split(".")[0]
        if base_arch == "embed":
            updated["network"] = "embed"
    if "Pos" in name:
        updated["position"] = get_position(name)
    return updated


def get_ckpts_and_names(ckpts, ckpts_name, pretrained_ckpt, tuned_ckpts):
    """reference utils/util.py:125-135."""
    if ckpts is not None:
        return ckpts, ckpts_name, [False] * len(ckpts)
    if pretrained_ckpt is not None:
        tuned = [c for c in (tuned_ckpts or []) if c]
        names = ["OODG"] + [get_ckpt_name(c) for c in tuned]
        return [pretrained_ckpt] + tuned, names, [False] + [True] * len(tuned)
    raise ValueError("No checkpoint provided")


def ensure_dir(path):
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)
    return path
