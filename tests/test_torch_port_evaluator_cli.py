"""The port's evaluator tools with their real eval step and as CLIs, on
the CPU (the comparisons with mst_tpu are in
tests/test_torch_port_evaluator.py, whose world this file shares):

- the swap oracle: a single perturbed group's swap equals the pretrained
  model's eval, every other group's the tuned eval, bit for bit;
- python -m mst_tpu_torch.evaluator.{multickpts,importance} with
  --device cpu on an on-disk world; without it, on a machine with no
  card, every evaluator CLI raises before any work.
"""

import os
import shutil

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from mst_tpu_torch import io
from mst_tpu_torch.evaluator import activations, importance, multickpts
from mst_tpu_torch.train import trainer
from tests.test_torch_port_evaluator import world  # noqa: F401


def test_swap_oracle_with_the_real_eval_step(world):  # noqa: F811
    """Tuned differs from pretrained in traj_decoder only: swapping it
    gives the pretrained eval, swapping any other group the tuned eval,
    bit for bit (one generator seed a batch and round)."""
    w = world
    model = trainer.restore_model(dict(w["params"], n_round=1), True,
                                  w["base"], w["delta"], images=w["images"])
    one = w["tracks"].take(w["tracks"].sceneId == "synth_0")
    tuned = io.params_to_numpy(model.model_params)
    pretrained = {k: v + 0.01 if k.startswith("traj_decoder/") else v
                  for k, v in tuned.items()}

    def direct(flat):
        model.model_params = io.params_from_numpy(flat)
        return model.test(one, None)[:2]

    ade_t, fde_t = direct(tuned)
    ade_p, fde_p = direct(pretrained)
    assert ade_p != ade_t
    model.model_params = io.params_from_numpy(tuned)
    by = importance.swap_importance(model, one, None, pretrained, tuned,
                                    depth=1).set_index("group")
    assert by.loc["none", "ade"] == ade_t and by.loc["all", "ade"] == ade_p
    assert (by.loc["traj_decoder", "ade"], by.loc["traj_decoder", "fde"]) \
        == (ade_p, fde_p)
    others = [g for g in by.index if g not in ("none", "all",
                                               "traj_decoder")]
    assert others
    for g in others:
        assert (by.loc[g, "ade"], by.loc[g, "fde"]) == (ade_t, fde_t), g


def test_evaluator_clis(world, tmp_path, monkeypatch):  # noqa: F811
    """The three CLIs on an on-disk world with --device cpu; without it,
    on a machine with no card, each raises before any work."""
    w = world
    root = tmp_path
    ddir = root / "data" / "sdd" / "filter" / "synth"
    ddir.mkdir(parents=True)
    three = w["df"][w["df"].metaId.isin([0, 1, 7])]
    for split in ("train", "val", "test"):
        three.to_pickle(ddir / f"{split}.pkl")
    for scene, im in w["images"].items():
        name, idx = scene.split("_")
        d = root / "data/sdd/raw/annotations" / name / f"video{idx}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "reference.jpg"), (im * 255).astype(np.uint8))
    cfg = {k: w["params"][k] for k in (
        "resize_factor", "waypoints", "temperature", "loss_scale", "kernlen",
        "nsig", "obs_len", "pred_len", "encoder_channels",
        "decoder_channels", "n_semantic_classes", "n_goal", "n_traj")}
    cfg.update(dataset_name="sdd", data_dir=str(root / "data") + "/",
               use_raw_data=True)
    (root / "synth.yaml").write_text(yaml.safe_dump(cfg))
    # a delta named in the reference's codec, which the CLIs parse
    delta = root / ("Seed_1__synth__mosa_2__Pos_0_1_2_3_4__TrN_8__lr_0.001"
                    "__original.npz")
    for suffix in ("", ".json"):
        shutil.copy(w["delta"] + suffix, str(delta) + suffix)
    monkeypatch.chdir(root)
    common = ["--config_filename", "synth.yaml", "--dataset_path",
              "filter/synth", "--load_data", "predefined", "--batch_size",
              "4", "--n_round", "1", "--pretrained_ckpt", w["base"]]
    multickpts.main(common + ["--tuned_ckpts", str(delta),
                              "--given_meta_ids", "0", "1", "7",
                              "--device", "cpu"])
    (csv,) = (root / "csv" / "comparison").rglob("*.csv")
    assert csv.name == "OODG_mosa_2[0_1_2_3_4](8)__N3_R1.csv"
    assert len(pd.read_csv(csv)) == 3
    importance.main(common + ["--tuned_ckpt", str(delta), "--mode", "swap",
                              "--out_csv", "swap.csv", "--per_traj_dir",
                              "per_traj", "--device", "cpu"])
    assert list(pd.read_csv(root / "swap.csv").group) == [
        "none", "encoder", "goal_decoder", "traj_decoder", "all"]
    assert sorted(os.listdir(root / "per_traj")) == [
        "FT__N3.csv", "FT__N3__encoder.csv", "FT__N3__goal_decoder.csv",
        "FT__N3__traj_decoder.csv", "OODG__N3.csv"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (multickpts, importance, activations):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(common + ["--ckpts", w["base"], "--ckpts_name",
                               "OODG"])
