"""The port's data-parallel steps on gloo worlds of 2 and 4 CPU processes
(the 4 as the hybrid 2 x 2 mesh) against mst_tpu's steps on a 2-device
make_mesh and a 2 x 2 make_hybrid_mesh of tests/conftest.py's virtual
devices, on the same weights (io.params_to_numpy) and the same batch,
whose last 3 of 8 rows are padding (tests/torch_port_ranks.py):

- the train step ('train', every leaf): 2 SGD steps, the losses within
  1e-5 relative and the gradients within 1e-4 of each leaf's max (the
  bars of tests/test_torch_port_train.py);
- the eval step with the waypoint samples mst_tpu's mesh forward drew
  injected into the port's decode and score on each rank's rows: ade and
  fde within 1e-5 relative, best_traj within 1e-4 model px, gathered in
  global row order.
"""

import jax
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
from tests.test_torch_port_train import capture_grads, numpy_leaves

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4   # of each leaf's max
PX_TOL = 1e-4     # model px


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_configs(params):
    scfg = config.step_config(params)
    s = ranks.SMALL
    jmcfg = jynet.YNetConfig(
        obs_len=s["obs_len"], pred_len=s["pred_len"],
        n_semantic_classes=s["n_semantic_classes"],
        encoder_channels=tuple(s["encoder_channels"]),
        decoder_channels=tuple(s["decoder_channels"]),
        waypoints=tuple(s["waypoints"]), train_net=params["train_net"],
        position=tuple(params["position"]))
    jscfg = jsteps.StepConfig(
        obs_len=s["obs_len"], pred_len=s["pred_len"],
        waypoints=tuple(s["waypoints"]), template_size=scfg.template_size,
        kernlen=scfg.kernlen, nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False)
    return jmcfg, jscfg


def jax_mesh(shape):
    return (jmesh_lib.make_mesh(tuple(shape)) if len(shape) == 1
            else jmesh_lib.make_hybrid_mesh(*shape))


def jax_weights():
    params = ranks.step_params()
    weights, _ = ranks.model(params)
    return params, io.unflatten(io.params_to_numpy(weights))


def jax_train(shape):
    """mst_tpu's train step on the mesh -> [(metrics, gradients)]."""
    params, jw = jax_weights()
    jmcfg, jscfg = jax_configs(params)
    mesh = jax_mesh(shape)
    trainable, frozen = jfreeze.split_params(
        jw, jfreeze.trainable_mask(jw, "train", ()))
    trainable = jmesh_lib.replicate_tree(mesh, trainable)
    frozen = jmesh_lib.replicate_tree(mesh, frozen)
    opt = optax.chain(capture_grads(), optax.sgd(ranks.SGD_LR))
    state = opt.init(trainable)
    step = jsteps.make_train_step(jmcfg, jscfg, opt)
    batch = jmesh_lib.shard_batch(mesh, ranks.batch())
    out = []
    for _ in range(ranks.N_STEPS):
        trainable, _, state, m = step(trainable, frozen, {}, state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    numpy_leaves(state[0])))
    return out


SHAPES = {"data2": [2], "hybrid2x2": [2, 2]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of both shapes, started first, running the train
    step and then the eval step on the waypoint samples that mst_tpu's
    mesh forward draws meanwhile; mst_tpu's eval and train on its meshes.
    -> {shape id: (shape, the port's results, mst_tpu's eval, mst_tpu's
    train)}."""
    params, jw = jax_weights()
    jmcfg, jscfg = jax_configs(params)
    dirs = {name: tmp_path_factory.mktemp(name) for name in SHAPES}
    handles = {name: ranks.start(dirs[name], shape,
                                 ["train", "injected_eval"])
               for name, shape in SHAPES.items()}
    wants = {}
    for name, shape in SHAPES.items():
        mesh = jax_mesh(shape)
        es = jsteps.make_eval_step(jmcfg, jscfg, mesh=mesh)
        batch = jmesh_lib.shard_batch(mesh, ranks.batch())
        rep = jmesh_lib.replicate_tree(mesh, jw)
        key = jax.random.PRNGKey(5)
        _, wps = es.forward(rep, {}, batch, key)
        tmp = dirs[name] / "samples.tmp.npy"
        np.save(tmp, np.asarray(wps))
        tmp.rename(dirs[name] / "waypoint_samples.npy")
        wants[name] = {k: np.asarray(v)
                       for k, v in es(rep, {}, batch, key).items()}
    return {name: (shape, ranks.finish(handles[name]), wants[name],
                   jax_train(shape)) for name, shape in SHAPES.items()}


@pytest.fixture(params=list(SHAPES))
def world(request, worlds):
    return worlds[request.param]


def test_train_step_matches_mst_tpu_mesh(world):
    _, got, _, jax_steps = world
    for (metrics, grads), step in zip(jax_steps, got["train"][0]["steps"]):
        for k in ("loss", "goal_loss", "traj_loss"):
            assert abs(step["metrics"][k] - metrics[k]) <= \
                LOSS_RTOL * abs(metrics[k]), k
        mine = io.params_to_numpy({k: torch.from_numpy(v)
                                   for k, v in step["grads"].items()})
        assert mine.keys() == grads.keys()
        for k, g in grads.items():
            np.testing.assert_allclose(
                mine[k], g, rtol=0, atol=GRAD_TOL * np.abs(g).max(),
                err_msg=k)


def test_eval_step_on_mst_tpu_draws_matches_its_mesh(world):
    _, got, want, _ = world
    rf = config.step_config(ranks.step_params()).resize_factor
    for rank_out in got["injected_eval"]:
        np.testing.assert_allclose(rank_out["ade"], want["ade"], rtol=1e-5)
        np.testing.assert_allclose(rank_out["fde"], want["fde"], rtol=1e-5)
        np.testing.assert_allclose(rank_out["best_traj"] * rf,
                                   want["best_traj"] * rf, rtol=0,
                                   atol=PX_TOL)
        np.testing.assert_allclose(rank_out["ade_sum"], want["ade_sum"],
                                   rtol=1e-5)
        assert float(rank_out["n"]) == float(want["n"]) == 5.0
