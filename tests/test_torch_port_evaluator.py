"""The port's evaluator tools (mst_tpu_torch/evaluator/{multickpts,
importance,activations}.py) against mst_tpu's on the CPU:

- under one deterministic stub eval step in both packages,
  compare_checkpoints, swap_importance (with its per-trajectory csv tree)
  and lora_importance give mst_tpu's tables and csv files exactly: the
  frames, the file names and the files' contents;
- capture_activations on the same weights within 1e-4 of each map's max.

The swap oracle with the real eval step and the CLIs are in
tests/test_torch_port_evaluator_cli.py.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from mst_tpu.evaluator import activations as jacts
from mst_tpu.evaluator import importance as jimportance
from mst_tpu.evaluator import multickpts as jmultickpts
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import io
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.evaluator import activations, importance, multickpts
from mst_tpu_torch.train import trainer
from tests.test_torch_port_experiment import loop_params

MAP_TOL = 1e-4  # of each activation's max


def stub_outputs(traj, mask):
    """A deterministic eval step, read off the batch."""
    return {"mask": mask, "ade": traj[:, -1, 0] * 0.5,
            "fde": traj[:, 0, 1] + 1.0, "best_traj": traj[:, 8:] * 4.0}


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(
        jsteps, "cached_eval_step",
        lambda *a, **k: lambda params, state, db, key: stub_outputs(
            db["traj"], db["mask"]))
    monkeypatch.setattr(
        trainer, "make_eval_step",
        lambda *a, **k: lambda params, state, batch, gen: stub_outputs(
            batch["traj"], batch["mask"]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """2 scenes of 6 tracks (128 x 192), a base checkpoint (the port's
    init, seed 1) and a mosa_2 delta over it with nonzero lora_B, written
    by the port in mst_tpu's layout."""
    from mst_tpu.data.synthetic import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("evaluator")
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=6,
                                        img_hw=(128, 192))
    params = loop_params(tmp, "mosa_2", n_round=2, batch_size=4)
    base = trainer.Experiment(dict(params, train_net="train", position=[]),
                              images=images)
    base.save_params(str(tmp / "base.npz"))
    ft = trainer.Experiment(params, images=images)
    ft.load_params(str(tmp / "base.npz"))
    g = torch.Generator().manual_seed(3)
    for k, v in io.flatten(ft.model_params).items():
        if k.endswith("lora_B"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    ft.save_params(str(tmp / "delta.npz"))
    return dict(tmp=tmp, df=df, tracks=Tracks.from_frame(df),
                images=images, params=params, base=str(tmp / "base.npz"),
                delta=str(tmp / "delta.npz"))


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_csv_tree(got, want):
    assert tree_files(got) == tree_files(want)
    assert tree_files(want)
    for rel in tree_files(want):
        pd.testing.assert_frame_equal(pd.read_csv(os.path.join(got, rel)),
                                      pd.read_csv(os.path.join(want, rel)))


def test_compare_checkpoints_matches_jax(world, stub):
    w = world
    args = ([w["base"], w["delta"]], ["OODG", "mosa_2[0_1](8)"],
            [False, True])
    got, gt = multickpts.compare_checkpoints(
        w["params"], w["tracks"], None, *args, n_round=2, seed=1,
        out_dir=str(w["tmp"] / "cmp_port"), images=w["images"])
    want, wt = jmultickpts.compare_checkpoints(
        w["params"], w["df"], None, *args, n_round=2, seed=1,
        out_dir=str(w["tmp"] / "cmp_jax"), images=w["images"])
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["metaId", "sceneId", "ade_OODG",
                                 "fde_OODG", "ade_mosa_2[0_1](8)",
                                 "fde_mosa_2[0_1](8)"]
    assert_same_csv_tree(w["tmp"] / "cmp_port", w["tmp"] / "cmp_jax")
    assert gt.keys() == wt.keys()
    for name in wt:
        for r, jr in zip(gt[name], wt[name]):
            for k in jr:
                np.testing.assert_array_equal(np.concatenate(r[k]),
                                              np.concatenate(jr[k]))


def restored(w):
    port = trainer.restore_model(w["params"], True, w["base"], w["delta"],
                                 images=w["images"])
    jexp = jtrainer.restore_model(w["params"], True, w["base"], w["delta"])
    jexp._images_override = w["images"]
    return port, jexp


def test_swap_importance_matches_jax(world, stub):
    w = world
    port, jexp = restored(w)
    pretrained = jckpt.load_checkpoint(w["base"])
    tuned, jtuned = (io.params_to_numpy(port.model_params),
                     jckpt.flatten_tree(jexp.model_params))
    assert tuned.keys() == jtuned.keys()
    got = importance.swap_importance(
        port, w["tracks"], None, io.load_checkpoint(w["base"]), tuned,
        depth=2, per_traj_dir=str(w["tmp"] / "swap_port"))
    want = jimportance.swap_importance(
        jexp, w["df"], None, pretrained,
        {k: np.asarray(v) for k, v in jtuned.items()}, depth=2,
        per_traj_dir=str(w["tmp"] / "swap_jax"))
    pd.testing.assert_frame_equal(got, want)
    assert {"none", "all", "encoder/stages"} <= set(got.group)
    assert_same_csv_tree(w["tmp"] / "swap_port", w["tmp"] / "swap_jax")


def test_lora_importance_matches_jax(world, stub):
    w = world
    port, jexp = restored(w)
    got = importance.lora_importance(port, w["tracks"], None, max_combo=2)
    want = jimportance.lora_importance(jexp, w["df"], None, max_combo=2)
    pd.testing.assert_frame_equal(got, want)
    # none, 9 layers, 36 pairs, all
    assert len(got) == 1 + 9 + 36 + 1


def test_capture_activations_matches_jax(world):
    w = world
    port, jexp = restored(w)
    one = w["df"][w["df"].sceneId == "synth_1"]
    got = activations.capture_activations(port, Tracks.from_frame(one),
                                          None)
    want = jacts.capture_activations(jexp, one, None)
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=MAP_TOL * max(np.abs(v).max(), 1e-12),
                                   err_msg=k)
    diff = activations.goal_sigmoid_diff(got, got, 1.3)
    assert diff.shape == got["goal_decoder.predictor_output"].shape
    assert not diff.any()
    with pytest.raises(ValueError, match="expects one scene"):
        activations.capture_activations(port, w["tracks"], None)


def test_get_meta_ids_focus_matches_jax(world, tmp_path):
    w = world
    assert list(multickpts.get_meta_ids_focus(w["tracks"])) == list(
        jmultickpts.get_meta_ids_focus(w["df"]))
    assert multickpts.get_meta_ids_focus(given_meta_ids=3) == [3]
    csv = tmp_path / "r.csv"
    pd.DataFrame({"metaId": [1, 2, 3], "a": [1.0, 5.0, 2.0],
                  "b": [2.0, 1.0, 9.0]}).to_csv(csv, index=False)
    for op in ("diff", "abs_diff"):
        given = {"path": str(csv), "name": f"a__b__{op}", "n_limited": 2}
        assert list(multickpts.get_meta_ids_focus(given_csv=given)) == \
            list(jmultickpts.get_meta_ids_focus(given_csv=given))

