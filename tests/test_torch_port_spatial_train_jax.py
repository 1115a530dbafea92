"""The port's train step on the spatial ('data', 'space') mesh against
mst_tpu's: gloo worlds of 2 and 4 CPU processes on (1, 2) and (2, 2)
meshes (tests/torch_port_ranks.py, one thread a rank) beside mst_tpu's
make_train_step on make_spatial_mesh(1, 2) and (2, 2) of
tests/conftest.py's virtual devices, whose GSPMD program shards the scene
maps' H over 'space'; the same weights (io.params_to_numpy), the same
batch (B = 8, the last 3 rows padding, a 64 x 64 scene), Adam at lr 1e-3,
every leaf training. mst_tpu's own bars for its spatial step against one
device (tests/test_spatial_sharding.py:127-139): the loss after 2 steps
within 1e-4 relative, every leaf within rtol 1e-3, atol 3 lr (Adam's
first steps turn a near-zero gradient's sign into a whole lr step); and
a cross-scene bucketed step's loss (two scene maps, each row's
scene_idx) within 1e-4 relative, on the (2, 2) mesh.
"""

import numpy as np
import optax
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.parallel import mesh as jmesh_lib
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import config, io
from tests import torch_port_ranks as ranks

LOSS_RTOL = 1e-4
LEAF_RTOL, LEAF_ATOL = 1e-3, 3 * ranks.ADAM_LR
SHAPES = {"1x2": (1, 2), "2x2": (2, 2)}
# the bucketed step on the larger mesh alone: each mst_tpu mesh and batch
# shape is a compile of its own
CROSS_SHAPE = "2x2"
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def jax_step():
    """mst_tpu's train step of the port's 'train' case (Adam) and its
    trainable and frozen trees."""
    train_net = ranks.SPATIAL_TRAINS["train"][0]
    params = ranks.step_params(train_net)
    weights, _ = ranks.model(params)
    scfg = config.step_config(params)
    s = ranks.SMALL
    jmcfg = jynet.YNetConfig(
        obs_len=s["obs_len"], pred_len=s["pred_len"],
        n_semantic_classes=s["n_semantic_classes"],
        encoder_channels=tuple(s["encoder_channels"]),
        decoder_channels=tuple(s["decoder_channels"]),
        waypoints=tuple(s["waypoints"]), train_net=train_net)
    jscfg = jsteps.StepConfig(
        obs_len=s["obs_len"], pred_len=s["pred_len"],
        waypoints=tuple(s["waypoints"]), template_size=scfg.template_size,
        kernlen=scfg.kernlen, nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False)
    jw = io.unflatten(io.params_to_numpy(weights))
    trainable, frozen = jfreeze.split_params(
        jw, jfreeze.trainable_mask(jw, train_net, ()))
    opt = optax.adam(ranks.ADAM_LR)
    return jsteps.make_train_step(jmcfg, jscfg, opt), opt, trainable, frozen


def jax_run(shape, cross):
    """mst_tpu's steps on the spatial mesh: the 'train' case's steps ->
    {'train': (each step's loss, the leaves after)}, and with cross the
    cross-scene batch's first step too."""
    step, opt, trainable, frozen = jax_step()
    mesh = jmesh_lib.make_spatial_mesh(*shape)
    trainable = jmesh_lib.replicate_tree(mesh, trainable)
    frozen = jmesh_lib.replicate_tree(mesh, frozen)
    out = {}
    batches = [("train", ranks.spatial_batch(ranks.H))]
    if cross:
        batches.append(("cross", ranks.cross_batch()))
    for name, b in batches:
        batch = jmesh_lib.shard_batch(mesh, {k: v for k, v in b.items()})
        t, state = trainable, opt.init(trainable)
        losses = []
        for _ in range(ranks.SPATIAL_TRAINS[name][2]):
            t, _, state, m = step(t, frozen, {}, state, batch)
            losses.append(float(m["loss"]))
        out[name] = (losses, {k: np.asarray(v)
                              for k, v in io.flatten(t).items()})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds (started first) and mst_tpu's runs on the same
    mesh shapes -> {shape id: (the port's results, mst_tpu's)}."""
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 ["spatial_train_jax"], ["data", "space"],
                                 THREADS)
               for name, shape in SHAPES.items()}
    wants = {name: jax_run(shape, name == CROSS_SHAPE)
             for name, shape in SHAPES.items()}
    return {name: (ranks.finish(handles[name])["spatial_train_jax"],
                   wants[name]) for name in SHAPES}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_spatial_train_steps_match_mst_tpu_mesh(worlds, shape):
    got, want = worlds[shape]
    losses, leaves = want["train"]
    assert len(losses) == 2
    for out in got:
        mine = out["train"]
        for step, loss in zip(mine["steps"], losses):
            assert abs(step["metrics"]["loss"] - loss) <= \
                LOSS_RTOL * abs(loss)
        ported = io.params_to_numpy({k: torch.from_numpy(v)
                                     for k, v in mine["leaves"].items()})
        assert ported.keys() == leaves.keys()
        for k, v in leaves.items():
            np.testing.assert_allclose(ported[k], v, rtol=LEAF_RTOL,
                                       atol=LEAF_ATOL, err_msg=k)


def test_spatial_bucketed_step_matches_mst_tpu_mesh(worlds):
    got, want = worlds[CROSS_SHAPE]
    (loss,), _ = want["cross"]
    for out in got:
        mine = out["cross"]["steps"][0]["metrics"]["loss"]
        assert abs(mine - loss) <= LOSS_RTOL * abs(loss)
