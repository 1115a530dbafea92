"""The port's spatial eval step against mst_tpu's on the same mesh
shapes: gloo worlds of 2 and 4 CPU processes on (1, 2) and (2, 2)
('data', 'space') meshes (tests/torch_port_ranks.py) beside mst_tpu's
make_spatial_mesh(1, 2) and (2, 2) of tests/conftest.py's virtual
devices, whose GSPMD program shards the scene maps' H over 'space'; the
same weights (io.params_to_numpy) and batch (B = 8, the last 3 rows
padding, a 64 x 64 scene). mst_tpu's mesh forward draws the waypoint
samples (one waypoint, and two for a longterm setting); injected into
the port's spatial decode and score on each rank's rows and slab, they
give ade and fde within 1e-5 relative and best_traj within 1e-4 model
px, in global row order on every rank.
"""

import jax
import numpy as np
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.parallel import mesh as jmesh_lib
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import config, io
from tests import torch_port_ranks as ranks

VAL_RTOL = 1e-5
PX_TOL = 1e-4     # model px
SHAPES = {"1x2": (1, 2), "2x2": (2, 2)}
EVALS = ("ttst", "cws")


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_step(name, mesh):
    """mst_tpu's eval step of SPATIAL_EVALS[name]'s setting on `mesh`,
    with plain samplers (the draws are what the port is given), and its
    weights -> (step, replicated weights)."""
    over, _ = ranks.SPATIAL_EVALS[name]
    params = ranks.step_params(**over)
    weights, _ = ranks.model(params)
    scfg = config.step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=params["obs_len"], pred_len=params["pred_len"],
        n_semantic_classes=params["n_semantic_classes"],
        encoder_channels=tuple(params["encoder_channels"]),
        decoder_channels=tuple(params["decoder_channels"]),
        waypoints=tuple(params["waypoints"]), train_net="train")
    jscfg = jsteps.StepConfig(
        obs_len=params["obs_len"], pred_len=params["pred_len"],
        waypoints=tuple(params["waypoints"]),
        template_size=scfg.template_size, kernlen=scfg.kernlen,
        nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False)
    rep = jmesh_lib.replicate_tree(mesh, io.unflatten(
        io.params_to_numpy(weights)))
    return jsteps.make_eval_step(jmcfg, jscfg, mesh=mesh), rep


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds, started first, decoding the samples that
    mst_tpu's spatial forward draws meanwhile; mst_tpu's outputs ->
    {shape id: (the port's results, {eval: mst_tpu's outputs})}."""
    dirs = {name: tmp_path_factory.mktemp(name) for name in SHAPES}
    handles = {name: ranks.start(dirs[name], shape,
                                 [f"spatial_injected_{e}" for e in EVALS],
                                 ["data", "space"])
               for name, shape in SHAPES.items()}
    wants = {}
    for name, shape in SHAPES.items():
        mesh = jmesh_lib.make_spatial_mesh(*shape)
        wants[name] = {}
        for e in EVALS:
            es, rep = jax_step(e, mesh)
            batch = jmesh_lib.shard_batch(mesh, ranks.spatial_batch(
                ranks.SPATIAL_EVALS[e][1]))
            assert batch["semantic"].sharding.spec == \
                jax.sharding.PartitionSpec(None, "space")
            key = jax.random.PRNGKey(5)
            _, wps = es.forward(rep, {}, batch, key)
            tmp = dirs[name] / f"samples_{e}.tmp.npy"
            np.save(tmp, np.asarray(wps))
            tmp.rename(dirs[name] / f"waypoint_samples_{e}.npy")
            wants[name][e] = {k: np.asarray(v)
                              for k, v in es(rep, {}, batch, key).items()}
    return {name: (ranks.finish(handles[name]), wants[name])
            for name in SHAPES}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", EVALS)
def test_spatial_eval_on_mst_tpu_draws_matches_its_mesh(worlds, shape,
                                                         name):
    got, wants = worlds[shape]
    want = wants[name]
    rf = config.step_config(ranks.step_params()).resize_factor
    for out in got[f"spatial_injected_{name}"]:
        np.testing.assert_allclose(out["ade"], want["ade"], rtol=VAL_RTOL)
        np.testing.assert_allclose(out["fde"], want["fde"], rtol=VAL_RTOL)
        np.testing.assert_allclose(out["best_traj"] * rf,
                                   want["best_traj"] * rf, rtol=0,
                                   atol=PX_TOL)
        np.testing.assert_allclose(out["ade_sum"], want["ade_sum"],
                                   rtol=VAL_RTOL)
        assert float(out["n"]) == float(want["n"]) == 5.0
