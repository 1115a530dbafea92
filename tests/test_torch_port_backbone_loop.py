"""The segmentation backbone's paths against mst_tpu on the CPU in f32:
two epochs across e_unfreeze (the backbone's batch norms adapting in the
state), a TTST test through Experiment on segmented maps, the model
directory exported with segment_in_step and its LoadedModel and daemon on
raw RGB scenes, use_features_only's 16 channels, and the stride-2 padding
difference bounded end to end.

The backbone file, the scenes and the configs are
test_torch_port_segmentation.py's (`world`): a shallow backbone (layers
(1, 1, 1, 1), the real widths) with its batch norms moved and its three
stride-2 convs zero, so the two packages' paddings compute the same
function there; test_padding_difference_bound keeps those convs as they
are (ROADMAP Queue 3 #9).
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from mst_tpu import serve as jserve
from mst_tpu.models import ynet as jynet
from mst_tpu.ops import softargmax as jsoftargmax
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import config, io, serve
from mst_tpu_torch.models import unet
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.ops.softargmax import softargmax2d_nhwc
from mst_tpu_torch.serve_http import run_server
from mst_tpu_torch.train import optim, steps, trainer
from tests.test_torch_port_http import _request
from tests.test_torch_port_segmentation import (  # noqa: F401 (world)
    backbone_flat, hwio, jax_configs, jax_tree, params_for, scene, t, world)

H, W, B = 64, 96, 4
MAP_TOL = 1e-4  # maps and logits, relative to each one's max
PARAM_TOL = 1e-4  # weights after training, relative to each leaf's max
MODEL_PX_TOL = 1e-4  # trajectories, model pixels


def jax_experiment(params, images, port):
    """mst_tpu's Experiment on the port Experiment's Y-Net weights and
    state (its init_ynet replaced: JAX's eager init is slow on the CPU);
    it loads the backbone from the same file itself."""
    flat = {k: v for k, v in hwio(port.model_params).items()
            if not k.startswith("segmentation")}
    trees = (jax_tree(flat), jax_tree(io.state_to_numpy(port.model_state)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jynet, "init_ynet", lambda key, cfg: trees)
        return jtrainer.Experiment(params, images=images)


def close_px(got, want, resize_factor, what=""):
    """Raw-pixel arrays within MODEL_PX_TOL model pixels."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=MODEL_PX_TOL / resize_factor,
                               err_msg=what)


def close(got, want, tol=MAP_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)

# ---------------------------------------------------------------------------
# the Experiment: e_unfreeze, a TTST test, the export
# ---------------------------------------------------------------------------

def scripted(script):
    calls = iter(script)

    def evaluate(*args, **kwargs):
        ade = next(calls)
        return ade, ade * 1.1, {}, None

    return evaluate


@pytest.fixture(scope="module")
def unfrozen(world):
    """Both packages' train() of 2 epochs with e_unfreeze 1 (train_net
    train) from the same weights, with SGD and a scripted validation, as
    tests/test_torch_port_experiment.py runs the loop: epoch 0 trains on
    the cached segmented maps, epoch 1 runs the backbone in the step in
    train mode. -> (port Experiment, mst_tpu Experiment, {side: epoch
    records})."""
    over = dict(n_epoch=2, e_unfreeze=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optim, "Adam", optim.SGD)
        mp.setattr(optax, "adam", optax.sgd)
        step_config = jtrainer.Experiment._step_config
        mp.setattr(jtrainer.Experiment, "_step_config",
                   lambda self, *a, **k: step_config(self, *a, **k)._replace(
                       packed_decode=False))
        port = trainer.Experiment(params_for(world, **over),
                                  images=world["images"])
        jexp = jax_experiment(params_for(world, "jax", **over),
                              world["images"], port)
        records = {}
        for side, exp, split in (("port", port, world["tables"]),
                                 ("jax", jexp, world["frames"])):
            exp._evaluate = scripted([50.0, 45.0])
            exp.train(split["train"], split["val"], None, None, "exp")
            with open(world["tmp"] / side / "metrics.jsonl") as f:
                records[side] = [json.loads(line) for line in f]
    return port, jexp, records


def test_e_unfreeze_epochs_match_jax(world, unfrozen):
    """Across the boundary: the same epoch losses (1e-5), the
    'segmentation_bn' state after epoch 1 (every batch norm's running
    statistics adapted from the inline ones; 1e-4 of each leaf's max, the
    maps' tolerance: batch means of features that agree to ~1e-6), the
    Y-Net's weights (1e-4), the backbone's parameters untouched in both,
    and the full checkpoint without the backbone."""
    port, jexp, records = unfrozen
    assert len(records["port"]) == len(records["jax"]) == 2
    for g, w in zip(records["port"], records["jax"]):
        for k in ("loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    got = io.state_to_numpy(port.model_state["segmentation_bn"])
    want = {k: np.asarray(v) for k, v in io.flatten(
        jexp.model_state["segmentation_bn"]).items()}
    assert got.keys() == want.keys() and len(got) == 2 * 27
    inline = io.state_to_numpy(unet.extract_bn_stats(
        port.model_params["segmentation"]))
    for k, v in want.items():
        close(got[k], v, MAP_TOL, k)
        assert not np.array_equal(got[k], inline[k]), k
    ported = hwio(port.model_params)
    jflat = {k: np.asarray(v)
             for k, v in jckpt.flatten_tree(jexp.model_params).items()}
    for k, v in jflat.items():
        if k.startswith("segmentation/"):
            np.testing.assert_array_equal(
                ported[k], world["flat"][k[len("segmentation/"):]])
            np.testing.assert_array_equal(v, ported[k])
        else:
            close(ported[k], v, PARAM_TOL, k)
    with np.load(world["tmp"] / "port" / "ckpts" / "exp.npz") as z:
        keys = set(z.files)
    assert keys == {k for k in jflat if not k.startswith("segmentation")}
    # the train maps once; the validation maps each epoch (the backbone's
    # statistics change at the boundary)
    n_scenes = {k: len(world["tables"][k].scene_ids())
                for k in ("train", "val")}
    assert port.n_segmented == n_scenes["train"] + 2 * n_scenes["val"]


def goal_trajectories(params, state, batch, mcfg, scfg, lib):
    """The deterministic part of a TTST test batch in either package: the
    goal decoder's maps and their soft-argmax points (TTST's first goal),
    -> eval-step outputs (ade, fde, best_traj in raw px)."""
    sem, obs = lib["prepare"](mcfg, scfg, params, batch["semantic"],
                              batch["traj"])[:2]
    feats, _ = lib["features"](params, state, mcfg, sem, obs)
    pts = lib["softargmax"](lib["goal"](params, feats))  # (B, pred, 2)
    gt = batch["traj"][:, scfg.obs_len:]
    dist = ((pts - gt) ** 2).sum(-1) ** 0.5 / scfg.resize_factor
    return {"mask": batch["mask"], "ade": dist.mean(-1), "fde": dist[:, -1],
            "best_traj": pts / scfg.resize_factor}


PORT_LIB = dict(prepare=steps._prepare_inputs,
                features=ynet_lib.pred_features, goal=ynet_lib.pred_goal,
                softargmax=softargmax2d_nhwc)
JAX_LIB = dict(
    prepare=lambda m, s, p, sem, traj: jsteps._prepare_inputs(
        m, s, p, sem, traj, False),
    features=jynet.pred_features, goal=jynet.pred_goal,
    softargmax=jsoftargmax.softargmax2d_nhwc)


def test_ttst_test_through_experiment_matches_jax(world, monkeypatch):
    """Experiment.test with TTST on and 2 rounds on the backbone's maps:
    each scene is segmented once for both rounds, and an eval step that
    keeps the deterministic part of the TTST batch (the goal maps' soft-
    argmax trajectories; the draws of the two packages' generators
    cannot be matched) scores the same rounds, metrics rows and
    trajectories (1e-4 model px) in both."""
    params = params_for(world, use_TTST=True, n_round=2)
    mcfg = config.ynet_config(params)
    scfg = config.step_config(params)
    jmcfg, jscfg = jax_configs(params)
    jstep = jax.jit(lambda p, s, db: goal_trajectories(
        p, s, db, jmcfg, jscfg, JAX_LIB))
    monkeypatch.setattr(jsteps, "cached_eval_step",
                        lambda *a, **k: lambda p, s, db, key: jstep(p, s,
                                                                    db))
    monkeypatch.setattr(trainer, "make_eval_step",
                        lambda *a: lambda p, s, db, gen: goal_trajectories(
                            p, s, db, mcfg, scfg, PORT_LIB))
    port = trainer.Experiment(params, images=world["images"])
    jexp = jax_experiment(params_for(world, "jax", use_TTST=True, n_round=2),
                          world["images"], port)
    got = port.test(world["tables"]["test"], None, return_preds=True)
    want = jexp.test(world["frames"]["test"], None, return_preds=True)
    assert port.n_segmented == 2  # 2 scenes, 2 rounds
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    for trajs, jtrajs in zip(got[3], want[3]):
        for k in ("prediction", "groundtruth"):
            close_px(np.concatenate(trajs[k]), np.concatenate(jtrajs[k]),
                     params["resize_factor"], k)
        np.testing.assert_array_equal(np.concatenate(trajs["metaId"]),
                                      np.concatenate(jtrajs["metaId"]))


def test_export_segment_in_step_matches_jax(world, unfrozen, tmp_path):
    """export_model(segment_in_step=True) after the e_unfreeze run:
    params.npz (the backbone in it) and state.npz (its adapted
    'segmentation_bn') equal to mst_tpu's export of the same weights and
    state key for key, in dtype and value; a 3-channel semantic_shape and
    segment_in_step in the manifest, whose shared fields agree."""
    port, jexp, _ = unfrozen
    jexp.model_params = jckpt.overlay_checkpoint(
        jexp.model_params, hwio(port.model_params), strict=True)
    jexp.model_state = jax_tree(io.state_to_numpy(port.model_state))
    serve.export_model(port, tmp_path / "port", H, W, B,
                       segment_in_step=True)
    jserve.export_model(jexp, tmp_path / "jax", H, W, B, platforms=("cpu",),
                        segment_in_step=True)
    for f in ("params.npz", "state.npz"):
        with np.load(tmp_path / "port" / f) as a, \
                np.load(tmp_path / "jax" / f) as b:
            assert set(a.files) == set(b.files), f
            for k in b.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert any(k.startswith(("segmentation/", "segmentation_bn/"))
                       for k in a.files), f
    got = json.loads((tmp_path / "port" / "manifest.json").read_text())
    want = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert got["semantic_shape"] == want["semantic_shape"] == [1, H, W, 3]
    assert got["segment_in_step"] is want["segment_in_step"] is True
    for k in want.keys() - {"format", "files"}:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def directory(world, unfrozen, tmp_path_factory):
    """A model directory exported with segment_in_step from the
    e_unfreeze run (its state holds the adapted statistics)."""
    d = tmp_path_factory.mktemp("seg_dir") / "m"
    port = unfrozen[0]
    serve.export_model(port, d, H, W, B, segment_in_step=True)
    # a first predict before any compared one (see
    # test_torch_port_deploy.warm_up)
    serve.load_model(d, device="cpu").predict(scene(), np.full((B, 8, 2),
                                                               30.0))
    return d


def test_loaded_model_segments_in_step(world, directory):
    """LoadedModel on the raw 3-channel scene answers what a Predictor of
    the same weights and state answers on the segmented map (the
    backbone with the adapted statistics): 1e-4 model px."""
    model = serve.LoadedModel(directory, device="cpu")
    assert model.manifest["segment_in_step"] and \
        "segmentation" in model.params
    pred = serve.Predictor(params_for(world, n_goal=4), directory /
                           "params.npz", device="cpu",
                           state=directory / "state.npz")
    assert not pred.scfg.segment_in_step
    raw = scene(5)
    observed = np.random.default_rng(5).uniform(10, 50, size=(B, 8, 2))
    with torch.no_grad():
        sem = unet.unet_apply(pred.params["segmentation"], t(raw),
                              bn_state=pred.state["segmentation_bn"])
    got = model.predict(raw, observed, seed=3)
    want = pred.predict(sem, observed, seed=3)
    for k in ("trajectories", "waypoints"):
        close_px(got[k], want[k], model.manifest["resize_factor"], k)


def test_daemon_serves_a_segment_in_step_directory(world, directory,
                                                   tmp_path):
    """The daemon takes the directory's raw 3-channel scenes (the
    manifest's semantic_shape) and answers what LoadedModel answers."""
    raw = scene(6)
    np.save(tmp_path / "raw.npy", raw)
    import threading

    ready = threading.Event()
    thread = threading.Thread(target=run_server, kwargs=dict(
        model_dir=str(directory), port=0,
        scenes=[f"plaza={tmp_path / 'raw.npy'}"], ready_event=ready,
        device="cpu", max_wait_ms=50.0), daemon=True)
    thread.start()
    assert ready.wait(timeout=120)
    try:
        port = ready.server.server_address[1]
        rows = np.random.default_rng(6).uniform(10, 50, size=(B, 8, 2))
        code, out = _request(port, "/predict", {
            "scene": "plaza", "observed": rows.tolist(), "seed": 4})
        assert code == 200, out
        direct = serve.LoadedModel(directory, device="cpu").predict(
            raw, rows, seed=4)
        np.testing.assert_allclose(np.asarray(out["trajectories"]),
                                   np.moveaxis(direct["trajectories"], 1, 0),
                                   rtol=1e-5, atol=1e-5)
    finally:
        ready.server.shutdown()
        ready.batcher.stop()
        thread.join(timeout=30)


# ---------------------------------------------------------------------------
# use_features_only, and the padding difference end to end
# ---------------------------------------------------------------------------

def forward_both(params, flat, raw, traj):
    """The backbone in the step and the Y-Net's goal logits, in both
    packages on the same weights -> (port semantic, port logits, mst_tpu
    semantic, mst_tpu logits)."""
    mcfg = config.ynet_config(params)
    weights, _ = ynet_lib.init_ynet(torch.Generator().manual_seed(0), mcfg)
    weights["segmentation"] = io.params_from_numpy(flat)
    scfg = config.step_config(params, segment_in_step=True)
    with torch.no_grad():
        sem, obs, _ = steps._prepare_inputs(mcfg, scfg, weights, t(raw),
                                            t(traj))
        feats, _ = ynet_lib.pred_features(weights, {}, mcfg, sem, obs)
        logits = ynet_lib.pred_goal(weights, feats)
    jmcfg, jscfg = jax_configs(params, segment_in_step=True)

    @jax.jit
    def jforward(p, raw, traj):
        s, o, _ = jsteps._prepare_inputs(jmcfg, jscfg, p, raw, traj, False)
        f, _ = jynet.pred_features(p, {}, jmcfg, s, o)
        return s, jynet.pred_goal(p, f)

    jp = jax_tree(hwio(weights))
    jsem, jlogits = jforward(jp, raw, traj)
    return sem, logits, jsem, jlogits


def test_features_only_matches_jax(world):
    """use_features_only: the backbone's 16 decoder channels are the
    Y-Net's semantic input (feature_channels 16 + obs_len) in both; the
    features and the goal logits at 1e-4."""
    params = params_for(world, use_features_only=True)
    assert config.ynet_config(params).n_semantic_classes == 16
    traj = np.random.default_rng(7).uniform(5, 60, size=(B, 20, 2))
    sem, logits, jsem, jlogits = forward_both(params, world["flat"],
                                              scene(7), traj)
    assert sem.shape == (B, H, W, 16)
    close(sem, jsem, what="features")
    close(logits, jlogits, what="goal logits")


# the unmodified weights' difference between the two packages, measured
# by the test below on the CPU (shallow backbone with kaiming-normal convs
# and moved batch norms, 64 x 96): the class probabilities 0.7414 and the
# goal logits 0.02077 of their max, the argmax class at 0.1872 of the
# pixels; bounded with a margin
PADDING_BOUND = {"class map": 0.8, "goal logits": 0.03, "argmax": 0.25}


def test_padding_difference_bound(world):
    """With the backbone's weights as they are (the stride-2 convs not
    zeroed), the two packages' paths differ only through the stride-2
    padding: the class maps and the goal logits downstream differ by more
    than 1e-3 of their max (the difference is real) and by no more than
    PADDING_BOUND, nor do more pixels change their argmax class (ROADMAP
    Queue 3 #9)."""
    params = params_for(world)
    traj = np.random.default_rng(8).uniform(5, 60, size=(B, 20, 2))
    out = forward_both(params, backbone_flat(zero_stride2=False), scene(8),
                       traj)
    for name, got, want in (("class map", out[0], out[2]),
                            ("goal logits", out[1], out[3])):
        want = np.asarray(want)
        rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        print(f"{name}: max |port - mst_tpu| / max = {rel:.4g}")
        assert 1e-3 < rel <= PADDING_BOUND[name], (name, rel)
    flip = float(np.mean(out[0].numpy().argmax(-1)
                         != np.asarray(out[2]).argmax(-1)))
    print(f"argmax class changed at {flip:.4g} of the pixels")
    assert flip <= PADDING_BOUND["argmax"]
