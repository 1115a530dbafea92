"""The eval step's sample payload (collect_samples; mst_tpu/train/
steps.py:341-356, 595-603) and Experiment.test(return_samples=True)
(mst_tpu/train/trainer.py:892-1049) against mst_tpu on the CPU:

- the goal logits and their tempered sigmoid against mst_tpu's
  collect_samples eval step (run unpacked) on the same weights, within
  1e-4, and the waypoint samples equal when the port's samplers are given
  the draws mst_tpu's forward made;
- test()'s payload keys, shapes and row order against mst_tpu's under one
  deterministic stub eval step in both;
- the flag off: the step's outputs and forward are what they were;
- a gloo world of 2 (tests/torch_port_ranks.py) gives its ranks the world
  of 1's payload, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import io
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.train import steps, trainer
from tests import torch_port_ranks as ranks
from tests.test_torch_port_experiment import loop_params, pair

MAP_TOL = 1e-4
H, W, B = 64, 96, 4
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3)
PAYLOAD = ("goal_map", "goal_sigmoid_map", "waypoint_sample")


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def test_payload_matches_jax(rng, monkeypatch):
    """Same weights, same batch: goal_map and goal_sigmoid_map within
    MAP_TOL of mst_tpu's; with mst_tpu's draws injected into the port's
    samplers, waypoint_samples (B, n_wp, K, 2) equal mst_tpu's."""
    params = get_params("sdd_shortterm_eval.yaml", dict(
        SMALL, waypoints=[5, 11], n_goal=3, n_traj=1, temperature=1.3))
    mcfg, scfg = ynet_config(params), step_config(params)
    weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=(8, 8, 16, 16, 16),
        decoder_channels=(16, 16, 16, 8, 8), waypoints=(5, 11))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=(5, 11),
        template_size=scfg.template_size, kernlen=31, nsig=4.0,
        loss_scale=1000.0, resize_factor=scfg.resize_factor,
        temperature=1.3, n_goal=3, n_traj=1, packed_decode=False)
    jweights = io.unflatten(io.params_to_numpy(weights))
    b = {"semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
         "traj": rng.uniform(10, 50, size=(B, 20, 2)).astype(np.float32),
         "mask": np.ones(B, np.float32)}
    key = jax.random.PRNGKey(5)
    jes = jsteps.make_eval_step(jmcfg, jscfg, collect_samples=True)
    _, jwps, _ = jes.forward(jweights, {}, b, key)
    want = {k: np.asarray(v) for k, v in jes(jweights, {}, b, key).items()}

    # the port's two draws, in its order: the goals (B, 1, K, 2), then
    # the other waypoints (B, n_wp - 1, K, 2)
    wps = t(jwps)
    draws = [wps[:, :, -1:].permute(1, 2, 0, 3),
             wps[:, :, :-1].permute(1, 2, 0, 3)]
    monkeypatch.setattr(steps, "sample_heatmap",
                        lambda *a, **k: draws.pop(0))
    step = steps.make_eval_step(mcfg, scfg, collect_samples=True)
    got = step(weights, state, {k: t(v) for k, v in b.items()},
               torch.Generator().manual_seed(0))
    assert not draws
    for k in ("goal_map", "goal_sigmoid_map"):
        assert got[k].shape == want[k].shape == (B, H, W, 12)
        np.testing.assert_allclose(
            got[k].numpy(), want[k], rtol=0,
            atol=MAP_TOL * np.abs(want[k]).max(), err_msg=k)
    assert want["waypoint_samples"].shape == (B, 2, 3, 2)
    np.testing.assert_array_equal(got["waypoint_samples"].numpy(),
                                  want["waypoint_samples"])


def stub_outputs(traj, mask):
    """A deterministic eval step with the payload, read off the batch."""
    return {"mask": mask, "ade": traj[:, -1, 0], "fde": traj[:, 0, 1],
            "best_traj": traj[:, 8:] * 4.0,
            "goal_map": traj[:, :3, :, None] * 1.0,
            "goal_sigmoid_map": traj[:, 2:5, :, None] * 0.5,
            "waypoint_samples": traj[:, None, 3:8, :] + 1.0}


@pytest.fixture(scope="module")
def data():
    from mst_tpu.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch.data.tracks import Tracks

    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=7,
                                        img_hw=(128, 192))
    return df, Tracks.from_frame(df), images


def test_test_payload_rows_match_jax(tmp_path, monkeypatch, data):
    """Under one stub eval step in both packages, test(return_samples=
    True) returns mst_tpu's keys, shapes and rows, in mst_tpu's order
    (the padded rows of each batch dropped), for every round."""
    df, tracks, images = data
    monkeypatch.setattr(
        jsteps, "cached_eval_step",
        lambda *a, **k: lambda params, state, db, key: stub_outputs(
            db["traj"], db["mask"]))
    monkeypatch.setattr(
        trainer, "make_eval_step",
        lambda *a, **k: lambda params, state, batch, gen: stub_outputs(
            batch["traj"], batch["mask"]))
    port, jexp = pair(loop_params(tmp_path, n_round=2, batch_size=4),
                      images)
    got = port.test(tracks, None, return_samples=True)
    want = jexp.test(df, None, return_samples=True)
    assert got[:2] == want[:2]
    assert len(got[3]) == len(want[3]) == 2
    for trajs, jtrajs in zip(got[3], want[3]):
        assert list(trajs) == list(jtrajs)
        assert set(PAYLOAD) <= set(trajs)
        for k in jtrajs:
            assert len(trajs[k]) == len(jtrajs[k]), k
            a, b = np.concatenate(trajs[k]), np.concatenate(jtrajs[k])
            assert a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    # return_samples implies return_preds; without either, no trajs
    assert port.test(tracks, None)[3] == [None, None]


def test_flag_off_leaves_the_step_as_it_was(rng):
    """collect_samples only adds keys: the step's other outputs are bit
    for bit the flag-off step's, its forward returns the goal logits
    third, and the flag-off forward returns (features, samples)."""
    params = get_params("sdd_shortterm_eval.yaml", dict(
        SMALL, waypoints=[5, 11], n_goal=4))
    mcfg, scfg = ynet_config(params), step_config(params)
    weights, state = init_ynet(torch.Generator().manual_seed(1), mcfg)
    b = {"semantic": t(rng.normal(size=(1, 32, 64, 3))),
         "traj": t(rng.uniform(6, 26, size=(3, 20, 2))),
         "mask": t(np.ones(3))}
    off = steps.make_eval_step(mcfg, scfg)
    on = steps.make_eval_step(mcfg, scfg, collect_samples=True)
    want = off(weights, state, b, torch.Generator().manual_seed(2))
    got = on(weights, state, b, torch.Generator().manual_seed(2))
    assert set(got) == set(want) | {"goal_map", "goal_sigmoid_map",
                                    "waypoint_samples"}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    f_off = off.forward(weights, state, b, torch.Generator().manual_seed(2))
    f_on = on.forward(weights, state, b, torch.Generator().manual_seed(2))
    assert len(f_off) == 2 and len(f_on) == 3
    assert torch.equal(f_on[1], f_off[1])
    assert torch.equal(got["waypoint_samples"], f_on[1].permute(1, 2, 0, 3))
    assert torch.equal(got["goal_sigmoid_map"],
                       torch.sigmoid(got["goal_map"] / scfg.temperature))


def test_world_of_two_gives_the_world_of_one_payload(tmp_path):
    """The payload of a gloo world of 2 (B = 8, the last 3 rows padding)
    on each rank, gathered in global row order, equals one process's."""
    res = ranks.launch(tmp_path, [2], ["samples"])
    one = ranks.case_samples(None)
    for k in ("goal_map", "goal_sigmoid_map", "waypoint_samples", "ade",
              "best_traj"):
        assert one[k].shape[0] == len(ranks.MASK), k
        for r in range(2):
            np.testing.assert_array_equal(res["samples"][r][k], one[k],
                                          err_msg=k)
