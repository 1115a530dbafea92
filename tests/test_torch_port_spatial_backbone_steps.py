"""The eval and train steps, Experiment and the CLIs with the segmentation
backbone in the step (segment_in_step) on the spatial ('data', 'space')
mesh against the world of one: gloo worlds of 2 and 4 CPU processes on
(1, 2) and (2, 2) meshes (tests/torch_port_ranks.py, one thread a rank),
each rank holding its 'data' block of the B = 8 rows (the last 3
padding) and its H slab of the 64 x 64 image, on which a shallow backbone
(the U-Net's widths, one block a stage) runs (models/unet.py):

- the eval step under CWS (two waypoints) and TTST on a cross-scene
  batch of two images, with tests/test_torch_port_spatial_eval.py's
  bars: each 'data' row's waypoint samples bit-equal to its rows of the
  world of one's, ade and fde within 1e-5 relative, best_traj within
  1e-4 model px, the same outputs on every rank;
- Adam steps of segmentation_head and segmentation_bn with the backbone's
  batch norms (their weights, biases and running statistics off 1, 0, 0
  and 1) in eval mode (and one segmentation_bn step without a state, as
  before e_unfreeze: the norms' running statistics are Adam's leaves, as
  in mst_tpu, and each gets a gradient), segmentation_head in train mode
  (segment_train_mode: the image's statistics over the 'space' ranks),
  --remat, bf16 and a cross-scene batch, with tests/
  test_torch_port_spatial_train.py's bars: losses and metric sums within
  1e-5 relative, each trainable leaf within 1e-5 of its max where every
  step's |g| exceeds 1e-3 of its max and within 2 lr a step elsewhere,
  the backbone's running statistics within 1e-5, the same leaves on every
  rank; the remat step equals its plain step bit for bit; the bf16
  steps' first gradients and the running statistics after them within
  twice the world of one's own bf16-to-f32 distance;
- the train CLI (2 epochs of segmentation_head: the train steps run the
  backbone on the slab, validation segments the whole scene out of the
  step and keeps the slab of its map), the same with --fused for an
  epoch (which falls back to the loop with mst_tpu's reason), and the
  test CLI over
  its delta, on a 5-stage Y-Net's 64 x 96 scenes, against the same runs
  without a mesh: each epoch's val ADE/FDE, loss and train ADE/FDE
  within 1e-5 relative, the delta within 1e-4 of each leaf's max, the
  printed test lines equal; each rank uploads its slab of each image for
  the train steps ('raw_image', and nothing else) and the whole image
  for the cached path ('image').
"""

import os
import re

import numpy as np
import pytest
import torch

from mst_tpu_torch import config
from tests import torch_port_ranks as ranks

SHAPES = {"1x2": (1, 2), "2x2": (2, 2)}
EVALS = ("segment_cws", "segment_cross")
VAL_RTOL = 1e-5
PX_TOL = 1e-4     # model px
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5   # of each leaf's max, where the gradient is significant
SIG = 1e-3
BF16_RATIO = 2.0
STAT_TOL = 1e-5
PARAM_TOL = 1e-4  # the CLI's delta, of each leaf's max
METRICS = ("loss", "goal_loss", "traj_loss", "ade_sum", "fde_sum", "n")
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' steps and a (1, 2) world's CLIs (from the backbone
    world's directory) started together, the world of one run here
    meanwhile -> ({shape id: each rank's results}, the world of one's
    steps, its CLI flows)."""
    root = tmp_path_factory.mktemp("backbone_cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ranks.write_backbone_world(root)
        handles = {name: ranks.start(
            tmp_path_factory.mktemp(name), shape,
            ["spatial_backbone_steps"], ["data", "space"], THREADS)
            for name, shape in SHAPES.items()}
        cli = ranks.start(root / "ranks", SHAPES["1x2"],
                          ["spatial_backbone_cli"], ["data", "space"],
                          THREADS)
        one = ranks.case_spatial_backbone_steps(None)
        flows = ranks.backbone_flows("w1", [])
    finally:
        os.chdir(cwd)
    worlds = {name: ranks.finish(handle) for name, handle in handles.items()}
    worlds["1x2"].update(ranks.finish(cli))
    return worlds, one, flows


def rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def of_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", EVALS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_spatial_eval_with_the_backbone_matches_the_world_of_one(
        runs, shape, case):
    worlds, one, _ = runs
    data, space = SHAPES[shape]
    want = one[case]
    got = [out[case] for out in worlds[shape]["spatial_backbone_steps"]]
    rf = config.step_config(ranks.step_params()).resize_factor
    per = want["wps"].shape[1] // data
    for r, out in enumerate(got):
        d = r // space
        np.testing.assert_array_equal(out["wps"],
                                      want["wps"][:, d * per:(d + 1) * per])
        assert out["rows"] == ranks.H // space
    for out in got:
        for k in ("ade", "fde", "ade_sum", "fde_sum"):
            assert rel(out[k], want[k]) <= VAL_RTOL, k
        assert float(np.abs(out["best_traj"] - want["best_traj"]).max()) \
            * rf <= PX_TOL
        np.testing.assert_array_equal(out["mask"], want["mask"])
        assert float(out["n"]) == float(want["n"]) == 5.0
        for k in out:
            if k not in ("wps", "rows"):
                np.testing.assert_array_equal(out[k], got[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(ranks.BACKBONE_TRAINS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_spatial_train_step_with_the_backbone_matches_the_world_of_one(
        runs, shape, case):
    worlds, one, _ = runs
    want = one[case]
    n_steps = ranks.BACKBONE_TRAINS[case][2]
    assert len(want["steps"]) == n_steps
    lr_steps = 2 * ranks.ADAM_LR * n_steps
    outs = [out[case] for out in worlds[shape]["spatial_backbone_steps"]]
    for got in outs:
        for mine, ref in zip(got["steps"], want["steps"]):
            for k in METRICS:
                assert abs(mine["metrics"][k] - ref["metrics"][k]) <= \
                    LOSS_RTOL * abs(ref["metrics"][k]), k
            assert ref["metrics"]["n"] == 5.0
        assert got["leaves"].keys() == want["leaves"].keys()
        assert all(k.startswith("segmentation/") for k in want["leaves"])
        for k, leaf in want["leaves"].items():
            g = [np.abs(s["grads"][k]) for s in want["steps"]]
            sig = np.logical_and.reduce([x > SIG * x.max() for x in g])
            d = np.abs(got["leaves"][k] - leaf)
            if case == "seg_bf16":
                f32 = one["seg_train_mode"]["steps"][0]["grads"][k]
                bf16 = want["steps"][0]["grads"][k]
                assert of_max(got["steps"][0]["grads"][k], bf16) <= \
                    BF16_RATIO * of_max(bf16, f32), k
            else:
                assert float(d[sig].max(initial=0.0)) <= \
                    LEAF_TOL * np.abs(leaf).max(), k
            assert float(d.max()) <= lr_steps, k
            np.testing.assert_array_equal(got["leaves"][k],
                                          outs[0]["leaves"][k])
        for k, v in want["state"].items():
            if case == "seg_bf16":  # statistics of bf16 activations
                assert of_max(got["state"][k], v) <= BF16_RATIO * of_max(
                    v, one["seg_train_mode"]["state"][k]), k
            else:
                np.testing.assert_allclose(got["state"][k], v, rtol=0,
                                           atol=STAT_TOL, err_msg=k)
        moved = [k for k in want["state"] if k.startswith(
            "segmentation_bn/") and not np.array_equal(
                want["state"][k], one["seg_head"]["state"][k])]
        assert bool(moved) == ranks.BACKBONE_TRAINS[case][3], case
    stats = [k for k in want["leaves"]
             if k.endswith(("/running_mean", "/running_var"))]
    assert len(stats) == (2 * 13 if case.startswith("seg_bn") else 0)
    if case == "seg_bn":  # the state's statistics are read
        stats = []
    assert not (stats and any(k.startswith("segmentation_bn/")
                              for k in want["state"]))
    for k in stats:
        for got in outs:
            assert np.any(got["steps"][0]["grads"][k]), k


@pytest.mark.parametrize("shape", list(SHAPES))
def test_remat_equals_the_step_without(runs, shape):
    for out in runs[0][shape]["spatial_backbone_steps"]:
        remat, plain = out["seg_remat"], out["seg_train_mode"]
        assert remat["steps"][0]["metrics"] == plain["steps"][0]["metrics"]
        for k, g in plain["steps"][0]["grads"].items():
            np.testing.assert_array_equal(remat["steps"][0]["grads"][k], g)


def printed(text):
    """The printed test lines, numbers to 4 places."""
    keep = [ln for ln in text.splitlines()
            if re.search(r"(Test ADE|Test FDE|Round|Average)", ln)]
    return [re.sub(r"\d+\.\d+", lambda m: f"{float(m.group()):.4f}", ln)
            for ln in keep]


@pytest.mark.parametrize("flow", ["train", "fused"])
def test_the_train_cli_with_the_backbone_in_the_step(runs, flow):
    worlds, _, flows = runs
    text1, records1, delta1 = flows[flow]
    assert len(records1) == (2 if flow == "train" else 1)
    for out in worlds["1x2"]["spatial_backbone_cli"]:
        text, records, delta = out[flow]
        if flow == "fused":
            assert "--fused unavailable (segmentation runs inside the " \
                "train step); using the epoch loop" in text
        assert len(records) == len(records1)
        for rec, rec1 in zip(records, records1):
            for k in ("val_ade", "val_fde", "loss", "train_ade",
                      "train_fde"):
                assert abs(rec[k] - rec1[k]) <= VAL_RTOL * abs(rec1[k]), k
        assert delta.keys() == delta1.keys() and delta1
        assert all(k.startswith("segmentation/") for k in delta1)
        for k, v in delta1.items():
            assert float(np.abs(delta[k] - v).max()) <= \
                PARAM_TOL * float(np.abs(v).max()), k


def test_the_test_cli_with_the_backbone(runs):
    worlds, _, flows = runs
    want = printed(flows["test"])
    assert sum("Test ADE" in ln for ln in want) == 3  # 2 rounds + average
    for out in worlds["1x2"]["spatial_backbone_cli"]:
        assert printed(out["test"]) == want


def test_each_rank_uploads_what_its_path_needs(runs):
    """The train CLI's train batches (the backbone in the step): the
    rank's slab of each image as 'raw_image', no whole image; its
    validation and the test CLI (the cached path): the whole image as
    'image', as the run without a mesh holds it."""
    worlds, _, flows = runs
    whole = {}
    for in_step, _, scenes in flows["uploads"]:
        for scene, held in scenes.items():
            whole[scene] = held["image"]
    # a train CLI: its train batches, validation, the left-out test; twice,
    # then the test CLI
    calls = [(True, False)] + [(False, True)] * 2
    for rank, out in enumerate(worlds["1x2"]["spatial_backbone_cli"]):
        uploads = out["uploads"]
        assert [(a, b) for a, b, _ in uploads] == calls * 2 + [(False, True)]
        for in_step, cached, scenes in uploads:
            assert scenes
            for scene, held in scenes.items():
                image = whole[scene]
                rows = image.shape[1] // 2
                if in_step:
                    assert set(held) == {"raw_image"}
                    np.testing.assert_array_equal(
                        held["raw_image"],
                        image[:, rank * rows:(rank + 1) * rows])
                else:
                    assert set(held) == {"image"}
                    np.testing.assert_array_equal(held["image"], image)
