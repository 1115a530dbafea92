"""Config: a YAML file of `mst_tpu_torch/configs` (or a path) merged with
overrides into one flat params dict, with the JAX package's key vocabulary
(counterpart of mst_tpu/config.py:125-204)."""

import os

import yaml

from mst_tpu_torch.models.ynet import YNetConfig
from mst_tpu_torch.train.steps import CWSParams, StepConfig

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

_DEFAULTS = dict(
    use_CWS=False, use_TTST=False, rel_threshold=0.002, CWS_params=None,
    network="original", position=[], train_net="train", eval_k_chunk=0,
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


def ynet_config(params: dict) -> YNetConfig:
    """The model config of a flat params dict (identity segmentation: the
    semantic input is the segmented map)."""
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


def step_config(params: dict, **overrides) -> StepConfig:
    """The eval/predict step config of a flat params dict (as
    mst_tpu.train.trainer.Experiment._step_config builds it)."""
    cws = params.get("CWS_params")
    scfg = StepConfig(
        obs_len=params["obs_len"], pred_len=params["pred_len"],
        waypoints=tuple(params["waypoints"]),
        template_size=int(4200 * params["resize_factor"]),
        resize_factor=float(params["resize_factor"]),
        temperature=float(params["temperature"]),
        n_goal=int(params["n_goal"]), n_traj=int(params["n_traj"]),
        use_ttst=bool(params["use_TTST"]),
        rel_threshold=float(params["rel_threshold"]),
        use_cws=bool(params["use_CWS"]),
        cws_params=(CWSParams(sigma_factor=float(cws["sigma_factor"]),
                              ratio=float(cws["ratio"]),
                              rot=bool(cws["rot"])) if cws else None),
        eval_k_chunk=int(params["eval_k_chunk"]),
    )
    return scfg._replace(**overrides)
