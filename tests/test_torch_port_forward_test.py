"""Experiment.forward_test (the single-scene probe forward) against
mst_tpu's on the CPU, with the identity backbone and with a shallow
segmentation backbone (test_torch_port_segmentation.py's `world`: the
real widths, batch norms moved, the stride-2 convs live, padded SAME in
both packages) in front of a 2-stage Y-Net.

The reference is mst_tpu's probe run in float64 (`jax.enable_x64`, its
weights, state and scene widened; the rasterizers stay f32 in both
packages): mst_tpu's own f32 CPU sums land up to 1.3e-4 relative from its
float64 losses (ROADMAP Queue 3 #3 and #11), above the losses' bar. The
port's f32 probe is held to it at fixed bars: the losses within 1e-5
relative, the goal and trajectory maps and the semantic map within 1e-4
of their max.

The input gradients ('scene', 'semantic', 'traj') are held within 1e-4 of
each one's max with both packages in float64. A gradient jumps where a
ReLU's input crosses zero or a max-pool's runner-up overtakes it, and in
the probe with the backbone one first-stage ReLU input sits 1e-8 of its
tensor's max from zero: the port's f32 run takes the other side there,
and its gradients move by up to 11.5% of their max (Queue 3 #11). In
float64 that kink lies far above the rounding, so the two packages take
the same side. The noisy probe runs on mst_tpu's own float64 draws,
injected. Per-scene batches only, one scene only.

This file runs the identity backbone's probe, and
test_torch_port_forward_test_backbone.py the shallow backbone's and the
noisy one, through the helpers below: mst_tpu's eager float64 probe
compiles each op it meets, ~15 s a file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import io
from mst_tpu_torch.train import trainer
from tests.test_torch_port_segmentation import (  # noqa: F401 (world)
    hwio, jax_tree, params_for, world)

LOSS_RTOL = 1e-5  # losses, relative
MAP_TOL = 1e-4  # maps and the semantic map, relative to each one's max
GRAD_TOL = 1e-4  # input gradients, relative to each gradient's max
INPUTS = ("scene", "semantic", "traj")

torch.set_num_threads(2)


def one_scene(world, side):
    """The train split's tracks of the first scene: mst_tpu's DataFrame
    or the port's table."""
    frame = world["frames"]["train"]
    scene = frame.sceneId.unique()[0]
    if side == "jax":
        return frame[frame.sceneId == scene]
    table = world["tables"]["train"]
    return table.take(table.sceneId == scene)


@pytest.fixture(scope="module")
def pairs(world):
    """backbone ('identity' or 'backbone') -> the port's Experiment and
    mst_tpu's on the same weights: a 2-stage Y-Net (mst_tpu's forward_test
    runs eagerly, and its first call compiles every op it meets), mosa_2
    on both stages with every lora_B moved off zero, so the adapters take
    part."""
    cache = {}

    def get(backbone):
        if backbone not in cache:
            over = dict(train_net="mosa_2", position=["0", "1"],
                        encoder_channels=[8, 16], decoder_channels=[16, 8])
            if backbone == "identity":
                over.update(segmentation_model_fp=None,
                            n_semantic_classes=3)
            port = trainer.Experiment(params_for(world, **over),
                                      images=world["images"])
            g = torch.Generator().manual_seed(3)
            for k, v in io.flatten(port.model_params).items():
                if k.endswith("lora_B"):
                    v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            flat = {k: v for k, v in hwio(port.model_params).items()
                    if not k.startswith("segmentation")}
            trees = (jax_tree(flat), jax_tree(io.state_to_numpy(
                port.model_state)))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jynet, "init_ynet", lambda key, cfg: trees)
                jexp = jtrainer.Experiment(params_for(world, "jax", **over),
                                           images=world["images"])
            cache[backbone] = port, jexp
        return cache[backbone]

    return get


def close(got, want, tol, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def widened(batches):
    """Scene batches with the image and tracks in float64."""
    for b in batches:
        b.image = b.image.astype(np.float64)
        b.trajectories = b.trajectories.astype(np.float64)
    return batches


def in_float64(port, fn):
    """fn() with the port's weights, state, data and default dtype in
    float64 (the rasterizers stay f32, as they always are)."""
    saved = port.model_params, port.model_state, port.prepare_data

    def wide(tree):
        return io.unflatten({k: v.double() if v.is_floating_point() else v
                             for k, v in io.flatten(tree).items()})

    port.model_params, port.model_state = wide(saved[0]), wide(saved[1])
    port.prepare_data = lambda *a, **kw: widened(saved[2](*a, **kw))
    torch.set_default_dtype(torch.float64)
    try:
        return fn()
    finally:
        torch.set_default_dtype(torch.float32)
        port.model_params, port.model_state, port.prepare_data = saved


def jax_float64(jexp, fn):
    """fn() under jax.enable_x64 with mst_tpu's weights, state and data in
    float64 (its rasterizers stay f32); the arrays out as numpy."""
    saved = jexp.model_params, jexp.model_state, jexp.prepare_data

    def wide(tree):  # through numpy: no convert op to compile a leaf
        return jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64))
            if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    with jax.enable_x64(True):
        jexp.model_params, jexp.model_state = wide(saved[0]), wide(saved[1])
        jexp.prepare_data = lambda *a, **kw: widened(saved[2](*a, **kw))
        try:
            return jax.tree.map(np.asarray, fn())
        finally:
            jexp.model_params, jexp.model_state, jexp.prepare_data = saved


def assert_loss(got, want, what):
    """A loss (the port's) within 1e-5 relative of mst_tpu's float64."""
    got, want = float(got), float(want)
    print(f"{what} loss, relative: {(got - want) / want:.2e}")
    assert abs(got - want) <= LOSS_RTOL * abs(want), (what, got, want)


def assert_grad(got, want, what):
    """A gradient (the port's) within 1e-4 of its max of mst_tpu's
    float64 gradient."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    print(f"{what} gradient, of its max: {err:.2e}")
    assert err <= GRAD_TOL, (what, err)


def jax_noise(jexp, port, world, set_input):
    """mst_tpu's float64 forward_test draws (trainer.py:1104-1140), for
    injecting into the port: standard normals of the observed maps' and
    the semantic map's shapes from its key folds, under jax.enable_x64."""
    key = jax.random.fold_in(jexp._key, 777)
    batches = port.prepare_data(one_scene(world, "port"), None, "test")
    n = int(sum(b.mask.sum() for b in batches))
    H, W, _ = batches[0].image.shape
    noise = {}
    with jax.enable_x64(True):
        if "traj" in set_input:
            noise["traj"] = np.asarray(jax.random.normal(
                jax.random.fold_in(key, 1), (n, H, W, port.mcfg.obs_len)))
        if "semantic" in set_input:
            noise["semantic"] = np.asarray(jax.random.normal(
                jax.random.fold_in(key, 2),
                (1, H, W, port.mcfg.n_semantic_classes)))
    assert all(z.dtype == np.float64 for z in noise.values())
    return noise


@pytest.fixture(scope="module")
def probes(world, pairs):
    """backbone -> the port's f32 probe's losses ('port') and maps
    ('port_maps'), its float64 probe with the three input gradients
    ('port64'), and mst_tpu's float64 probes with the gradients ('jax64')
    and of the maps ('jax64_maps'), each run once (mst_tpu's
    forward_test is eager)."""
    cache = {}

    def get(backbone):
        if backbone not in cache:
            port, jexp = pairs(backbone)
            data, frame = one_scene(world, "port"), one_scene(world, "jax")
            kw = dict(set_input=INPUTS, input_grads=True)
            cache[backbone] = {
                "port": port.forward_test(data, None),
                "port_maps": port.forward_test(data, None, decision="map"),
                "port64": in_float64(port, lambda: port.forward_test(
                    data, None, **kw)),
                "jax64": jax_float64(jexp, lambda: jexp.forward_test(
                    frame, None, **kw)),
                "jax64_maps": jax_float64(jexp, lambda: jexp.forward_test(
                    frame, None, decision="map"))}
        return cache[backbone]

    return get


def check_losses(r):
    """The goal and trajectory losses of the port's f32 and float64
    probes within 1e-5 relative of mst_tpu's float64 probe, and the
    post-adapter semantic map within 1e-4 of its max."""
    want = r["jax64"]
    assert len(r["port"]) == 3 and len(want) == 4
    for got in (r["port"], r["port64"]):
        for g, w, name in zip(got[:2], want[:2], ("goal", "traj")):
            assert_loss(g, w, name)
        close(got[2], want[2], MAP_TOL, "semantic")


def check_maps(r):
    """decision 'map': the goal and trajectory logits (the trajectory
    decoder on the predicted goal map's waypoint pyramid) and the
    semantic map of the port's f32 probe, each within 1e-4 of its max of
    mst_tpu's float64 probe."""
    got, want = r["port_maps"], r["jax64_maps"]
    assert len(got) == len(want) == 3
    for g, w, name in zip(got, want, ("goal", "traj", "semantic")):
        close(g, w, MAP_TOL, name)


def check_input_grads(r):
    """d(goal_loss + traj_loss)/d(input) for the scene image (through the
    backbone and the semantic adapter), the semantic map and the observed
    maps, through one torch.autograd.grad, against mst_tpu's three
    jax.grad calls, both in float64: each within 1e-4 of its max."""
    got, want = r["port64"], r["jax64"]
    assert got[3].keys() == want[3].keys() == set(INPUTS)
    for name in INPUTS:
        assert_grad(got[3][name], want[3][name], name)


@pytest.mark.parametrize("backbone", ["identity"])
def test_forward_test_losses_match_mst_tpu(probes, backbone):
    check_losses(probes(backbone))


@pytest.mark.parametrize("backbone", ["identity"])
def test_forward_test_maps_match_mst_tpu(probes, backbone):
    check_maps(probes(backbone))


@pytest.mark.parametrize("backbone", ["identity"])
def test_forward_test_input_grads_match_mst_tpu(probes, backbone):
    check_input_grads(probes(backbone))


def test_forward_test_one_scene_and_its_generator(world, pairs, tmp_path):
    """More than one scene raises, and cross-scene batching does not
    reach the probe; without injected noise the draws come from the
    generator given (the same seed, the same losses; another, others), or
    from the experiment's seed; an unknown decision raises."""
    port, _ = pairs("backbone")
    with pytest.raises(ValueError, match="2 scenes"):
        port.forward_test(world["tables"]["train"], None)
    with pytest.raises(ValueError, match="decision"):
        port.forward_test(one_scene(world, "port"), None, decision="maps")
    data = one_scene(world, "port")

    def noisy(seed=None):
        gen = (None if seed is None
               else torch.Generator().manual_seed(seed))
        return float(port.forward_test(data, None, set_input=("traj",),
                                       noisy_std_frac=0.2,
                                       generator=gen)[0])

    assert noisy(1) == noisy(1) != noisy(2)
    assert noisy() == noisy()
    cross = trainer.Experiment(dict(port.params, cross_scene_batching=True),
                               images=world["images"])
    cross.model_params = port.model_params
    assert float(cross.forward_test(data, None)[0]) == \
        float(port.forward_test(data, None)[0])
