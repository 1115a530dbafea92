"""Config: a YAML file of `mst_tpu_torch/configs` (or a path) merged with
overrides into one flat params dict, with the JAX package's key vocabulary
(counterpart of mst_tpu/config.py:125-204 and
mst_tpu/train/trainer.py:312-351).

Flags the port does not act on yet raise NotImplementedError at a
non-default value instead of being dropped (see _check_ported).
"""

import os

import yaml

from mst_tpu_torch.models.ynet import YNetConfig
from mst_tpu_torch.train.steps import CWSParams, StepConfig

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

_DEFAULTS = dict(
    use_CWS=False, use_TTST=False, rel_threshold=0.002, CWS_params=None,
    network="original", position=[], train_net="train", eval_k_chunk=0,
    swap_semantic=False,
)


def get_params(config_filename=None, overrides=None) -> dict:
    """Defaults, then the YAML (an existing path, else a file of
    mst_tpu_torch/configs), then the overrides."""
    params = dict(_DEFAULTS)
    if config_filename:
        path = (config_filename if os.path.exists(config_filename)
                else os.path.join(CONFIG_DIR, config_filename))
        with open(path) as f:
            params.update(yaml.safe_load(f))
    if overrides:
        params.update(overrides)
    return params


def _check_ported(params: dict):
    """Raise on a flag that mst_tpu acts on and the port does not yet: bf16
    compute (trainer.py:348-349), ETH world-coordinate metrics
    (trainer.py:346-347), the feature-only segmentation backbone
    (mst_tpu/config.py:187-190) and the fusion network's n_fusion."""
    dtype = params.get("compute_dtype")
    if dtype is not None and str(dtype).lower() not in ("float32", "f32"):
        raise NotImplementedError(
            f"compute_dtype={dtype!r}: only float32 is ported yet")
    if (str(params.get("dataset_name", "")).lower() == "eth"
            and params.get("eth_world_coords")):
        raise NotImplementedError(
            "eth_world_coords: ETH world-coordinate metrics are not ported "
            "yet")
    if params.get("use_features_only") and params.get(
            "segmentation_model_fp"):
        raise NotImplementedError(
            "use_features_only with a segmentation backbone "
            "(segmentation_model_fp): the backbone is not ported yet")
    if params.get("n_fusion") is not None:
        raise NotImplementedError(
            f"n_fusion={params['n_fusion']!r}: the fusion network is not "
            "ported yet")


def ynet_config(params: dict) -> YNetConfig:
    """The model config of a flat params dict (identity segmentation: the
    semantic input is the segmented map)."""
    _check_ported(params)
    return YNetConfig(
        obs_len=params["obs_len"],
        pred_len=params["pred_len"],
        n_semantic_classes=params["n_semantic_classes"],
        encoder_channels=tuple(params["encoder_channels"]),
        decoder_channels=tuple(params["decoder_channels"]),
        waypoints=tuple(params["waypoints"]),
        train_net=params.get("train_net", "train"),
        position=tuple(params.get("position", ()) or ()),
        network=params.get("network") or "original",
    )


def step_config(params: dict, for_validation: bool = False,
                **overrides) -> StepConfig:
    """The step config of a flat params dict (as
    mst_tpu.train.trainer.Experiment._step_config builds it).
    for_validation turns TTST off and passes use_CWS through, as the
    reference's per-epoch validation does (trainer.py:314-317)."""
    _check_ported(params)
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
    )
    return scfg._replace(**overrides)
