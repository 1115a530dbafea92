"""The plain reference against the port at a small width on the CPU:
the same parameter tree, the same features and goal maps, the same keyed
draws through TTST and CWS, the same decodes. (The test imports both; the
reference imports neither the port nor jax.)"""

import numpy as np
import pytest
import torch

from portbench import core, traffic
from portbench.reference import model, sampling
from portbench.tests.small import small

SERVE = ("ynet_sdd.serve_ttst", "ynetmod_ind.serve_ttst_cws")


def port(cfg):
    from mst_tpu_torch.config import step_config, ynet_config

    params = core.program_params(cfg)
    return ynet_config(params), step_config(params)


def styled(net, seed):
    """Base weights with a style's LoRA factors: every factor nonzero."""
    return {**traffic.weights(net, seed, "cpu"),
            **traffic.style_deltas(net, seed, 1, "cpu")[0]}


@pytest.mark.parametrize("name", SERVE)
def test_parameter_tree_is_the_ports(name):
    from mst_tpu_torch import io
    from mst_tpu_torch.models.ynet import init_ynet

    cell, cfg = small(name)
    mcfg, _ = port(core.run_config(cfg, cell))
    tree, _ = init_ynet(torch.Generator().manual_seed(0), mcfg)
    ours = model.param_shapes(model.Net.of(cfg))
    theirs = {k: tuple(v.shape) for k, v in io.flatten(tree).items()}
    assert ours == theirs


@pytest.mark.parametrize("name", SERVE)
def test_predict_matches_the_port(name):
    from mst_tpu_torch import io
    from mst_tpu_torch.train.steps import make_predict_step

    cell, cfg = small(name)
    cfg = core.run_config(cfg, cell)
    mcfg, scfg = port(cfg)
    net = model.Net.of(cfg)
    flat = styled(net, 7)
    H, W = cell["height"], cell["width"]
    scene = traffic.scene_maps(7, 1, H, W, net.n_semantic_classes, "cpu")[0]
    obs = torch.tensor(traffic.tracks(np.random.default_rng(7), 3,
                                      net.obs_len, H, W, cell["speed"]))
    key = torch.tensor([7, 11], dtype=torch.int64)
    step = make_predict_step(mcfg, scfg)
    with torch.no_grad():
        out = step(io.unflatten(flat), {}, scene, obs, key)
        ts = int(4200 * cfg["resize_factor"])
        sem = scene.permute(0, 3, 1, 2).expand(3, -1, -1, -1)
        feats = model.features(flat, net, sem, obs, ts)
        wps = sampling.waypoint_samples(model.goal_logits(flat, feats), obs,
                                        sampling.Key(key), cfg)
        trajs = model.decode(flat, feats, wps, ts, 5)
    rf = cfg["resize_factor"]
    np.testing.assert_allclose(out["waypoints"], wps / rf, atol=1e-3)
    np.testing.assert_allclose(out["trajectories"], trajs / rf, atol=1e-3)
    # the draws and the decode are not vacuous: samples spread, styles move
    assert float(out["waypoints"].std(0).max()) > 1.0


def test_key_draws_are_the_ports():
    from mst_tpu_torch.ops.sampling import Key

    key = torch.tensor([2 ** 32 - 5, 123456], dtype=torch.int64)
    a, b = Key(key), sampling.Key(key)
    assert torch.equal(a.bits((3, 50)), b.bits((3, 50)))
    assert torch.equal(a.uniform((4, 7)), b.uniform((4, 7)))
    assert torch.equal(a.randint(1000, (2, 3), counter=torch.arange(5)),
                       b.randint(1000, (2, 3), counter=torch.arange(5)))
    assert torch.equal(a.exponential(torch.empty(6, 9)),
                       b.exponential((6, 9)))


def test_kmeans_is_the_ports():
    from mst_tpu_torch.ops.kmeans import batched_kmeans
    from mst_tpu_torch.ops.sampling import Key

    X = torch.rand(3, 500, 2, generator=torch.Generator().manual_seed(0))
    key = torch.tensor([5, 6], dtype=torch.int64)
    _, theirs = batched_kmeans(X * 100, 19, tol=1e-3, generator=Key(key))
    ours = sampling.kmeans(X * 100, 19, sampling.Key(key))
    assert torch.equal(theirs, ours)


@pytest.mark.parametrize("rf", [0.25, 0.33])
def test_waypoints_back_in_model_pixels(rf):
    """The raw-pixel round trip the judge undoes errs by far less than
    its ambiguity margin, and every unambiguous coordinate rounds to the
    program's pixel."""
    serve = core.load_module("loops", "serve")
    w = torch.rand(200000, generator=torch.Generator().manual_seed(1)) * 600
    w = torch.cat([w, torch.arange(0, 600, dtype=torch.float32) + 0.5])
    back, near = serve.model_space((w / rf).numpy(), rf)
    assert np.abs(back - w.numpy()).max() <= 2 ** -14  # 2 ulps at 600
    same = np.round(back) == torch.round(w).numpy()
    assert same[~near].all()
    assert near[-600:].all()
