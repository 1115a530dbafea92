"""The port's train step with the segmentation backbone in the step
(segment_in_step) on the spatial ('data', 'space') mesh against mst_tpu's:
a gloo world of 2 CPU processes on a (1, 2) mesh (tests/
torch_port_ranks.py, one thread a rank; each rank runs the backbone on
its slab of the image, models/unet.py) beside mst_tpu's make_train_step
on make_spatial_mesh(1, 2) of tests/conftest.py's virtual devices, whose
GSPMD program partitions the backbone's convs over 'space' with the rest
of the step. The same weights (io.params_to_numpy): the small Y-Net and a
shallow backbone (the U-Net's widths, one block a stage, batch norms off
identity) with its three stride-2 3x3 convs live, padded SAME in both
(their halos on the slabs: 0 rows above, 1 below); the same batch
(B = 8, the last 3 rows padding, a 64 x 64 image), 2 Adam steps at lr
1e-3 of segmentation_head with the backbone's batch norms in train mode
(segment_train_mode: on the image's statistics, over the 'space' ranks in
the port). The bars are tests/test_torch_port_spatial_train_jax.py's,
mst_tpu's own for its spatial step: each step's loss within 1e-4
relative, every trainable leaf within rtol 1e-3, atol 3 lr; and the
backbone's moved running statistics within 1e-4 of each one's max. (Each
mst_tpu step config is a compile of ~13 s on the CPU, so the eval-mode
backbone is held here by the slabs' bit-equality with the world of one,
tests/test_torch_port_spatial_backbone*.py, and by the whole map's
parity with mst_tpu, tests/test_torch_port_segmentation.py.)
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
STAT_TOL = 1e-4  # of each running statistic's max
SHAPE = (1, 2)
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def jax_run(name, mesh):
    """mst_tpu's steps of BACKBONE_JAX[name] on the spatial mesh -> (each
    step's loss, the trainable leaves after, the state after)."""
    params, weights, state, train_net, n_steps, _, train_mode = \
        ranks.train_setup(name)
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
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False,
        segment_in_step=True, segment_train_mode=train_mode)
    jw = io.unflatten(io.params_to_numpy(weights))
    trainable, frozen = jfreeze.split_params(
        jw, jfreeze.trainable_mask(jw, train_net, ()))
    opt = optax.adam(ranks.ADAM_LR)
    step = jsteps.make_train_step(jmcfg, jscfg, opt)
    trainable = jmesh_lib.replicate_tree(mesh, trainable)
    frozen = jmesh_lib.replicate_tree(mesh, frozen)
    jstate = jmesh_lib.replicate_tree(mesh, io.unflatten(
        io.state_to_numpy(state)))
    batch = jmesh_lib.shard_batch(mesh, ranks.spatial_batch(ranks.H))
    opt_state, losses = opt.init(trainable), []
    for _ in range(n_steps):
        trainable, jstate, opt_state, m = step(trainable, frozen, jstate,
                                               opt_state, batch)
        losses.append(float(m["loss"]))
    return (losses, {k: np.asarray(v) for k, v in
                     io.flatten(trainable).items() if v is not None},
            {k: np.asarray(v) for k, v in io.flatten(jstate).items()})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's world of 2 (started first) and mst_tpu's runs on the
    same mesh shape -> (the port's results on each rank, mst_tpu's)."""
    handle = ranks.start(tmp_path_factory.mktemp("w2"), SHAPE,
                         ["spatial_backbone_jax"], ["data", "space"],
                         THREADS)
    mesh = jmesh_lib.make_spatial_mesh(*SHAPE)
    wants = {name: jax_run(name, mesh) for name in ranks.BACKBONE_JAX}
    return ranks.finish(handle)["spatial_backbone_jax"], wants


@pytest.mark.parametrize("name", list(ranks.BACKBONE_JAX))
def test_spatial_backbone_steps_match_mst_tpu_mesh(worlds, name):
    got, wants = worlds
    losses, leaves, state = wants[name]
    train_mode = ranks.BACKBONE_JAX[name][3]
    assert len(losses) == ranks.BACKBONE_JAX[name][2]
    for out in got:
        mine = out[name]
        for step, loss in zip(mine["steps"], losses):
            assert abs(step["metrics"]["loss"] - loss) <= \
                LOSS_RTOL * abs(loss)
        ported = io.params_to_numpy({k: torch.from_numpy(v)
                                     for k, v in mine["leaves"].items()})
        assert ported.keys() == leaves.keys() and leaves
        for k, v in leaves.items():
            np.testing.assert_allclose(ported[k], v, rtol=LEAF_RTOL,
                                       atol=LEAF_ATOL, err_msg=k)
        stats = {k: v for k, v in io.state_to_numpy(
            io.unflatten({k: torch.from_numpy(v) for k, v in
                          mine["state"].items()})).items()
                 if k.startswith("segmentation_bn/")}
        assert stats.keys() == {k for k in state
                                if k.startswith("segmentation_bn/")}
        for k, v in stats.items():
            assert train_mode
            np.testing.assert_allclose(
                v, state[k], rtol=0,
                atol=STAT_TOL * max(np.abs(state[k]).max(), 1e-12),
                err_msg=k)
