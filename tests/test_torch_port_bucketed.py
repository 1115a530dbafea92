"""Cross-scene batching (--cross_scene_batching) against mst_tpu on the CPU.

The batches of data/scenes.make_bucketed_batches equal mst_tpu's field by
field for the same seed; a bucketed train step's loss and gradients are
the mean of the per-scene steps' at the same weights (as
tests/test_bucketed_batching.py checks mst_tpu) and equal mst_tpu's
bucketed step; one --cross_scene_batching epoch of the Experiment equals
mst_tpu's within tests/test_torch_port_experiment.py's bars (losses 1e-5,
weights 1e-4 of each leaf's max); validation and eth stay per scene; a
test's rows carry their own scene names, and each scene group's stack
goes through the backbone once.
"""

import numpy as np
import optax
import pytest
import torch

from mst_tpu.data import scenes as jscenes
from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.models import ynet as jynet
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import config, io
from mst_tpu_torch.data import scenes
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.models import unet
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.train import steps, trainer
from tests.test_torch_port_experiment import (  # noqa: F401 (data)
    assert_params_close, assert_same_policy, data, loop_params, run_policy)
from tests.test_torch_port_train import capture_grads, numpy_leaves

TOTAL_LEN = 12
LOSS_RTOL = 1e-5  # losses, relative
GRAD_TOL = 1e-4  # gradients, relative to each leaf's max |g|

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    """3 scenes of 5 tracks of 12 frames (mst_tpu's synthetic world of
    tests/test_bucketed_batching.py) as its DataFrame and the port's
    table."""
    df, images = make_synthetic_dataset(seed=5, n_scenes=3, n_traj=5,
                                        total_len=TOTAL_LEN,
                                        img_hw=(96, 128))
    images = {k: np.asarray(v) for k, v in images.items()}
    return df, Tracks.from_frame(df), images


@pytest.mark.parametrize("shuffle,max_scenes,reshape", [
    (False, 8, False), (True, 8, False), (True, 2, False), (True, 8, True)],
    ids=["ordered", "shuffled", "groups_of_2", "two_shape_buckets"])
def test_bucketed_batches_equal_mst_tpus(world, shuffle, max_scenes,
                                         reshape):
    """The same batches as mst_tpu's for the same seed, field by field:
    scene ids, the stacks, each row's slot, trajectories, mask and
    metaIds; the generator's draws in mst_tpu's order (bucket keys,
    scenes, rows), so both leave it in the same state."""
    df, tracks, images = world
    if reshape:  # one scene in a bucket of its own
        images = dict(images, synth_2=np.zeros((128, 160, 3), np.float32))
    rngs = [np.random.default_rng(7) for _ in range(2)]
    want = jscenes.make_bucketed_batches(df, images, TOTAL_LEN, 4, 0.25,
                                         shuffle=shuffle, rng=rngs[0],
                                         max_scenes_per_batch=max_scenes)
    got = scenes.make_bucketed_batches(tracks, images, TOTAL_LEN, 4, 0.25,
                                       shuffle=shuffle, rng=rngs[1],
                                       max_scenes_per_batch=max_scenes)
    assert len(got) == len(want) and len(got) >= 4
    for g, w in zip(got, want):
        assert g.scene_ids == w.scene_ids == g.scene_id
        for name in ("images", "scene_idx", "trajectories", "mask",
                     "meta_ids"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert rngs[0].random() == rngs[1].random()
    assert sum(b.mask.sum() for b in got) == 15
    assert all(len(b.scene_ids) <= max_scenes for b in got)


def _step_setup():
    params = config.get_params(overrides=dict(
        obs_len=4, pred_len=TOTAL_LEN - 4, waypoints=[7],
        n_semantic_classes=3, encoder_channels=[8, 8, 16, 16, 16],
        decoder_channels=[16, 16, 16, 8, 8], kernlen=31, nsig=4,
        loss_scale=1000, resize_factor=0.25, temperature=1.0, n_goal=4,
        n_traj=1, train_net="train", position=[], lr=1.0,
        segmentation_model_fp=None))
    mcfg, scfg = config.ynet_config(params), config.step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=4, pred_len=8, n_semantic_classes=3,
        encoder_channels=mcfg.encoder_channels,
        decoder_channels=mcfg.decoder_channels, waypoints=(7,))
    jscfg = jsteps.StepConfig(
        obs_len=4, pred_len=8, waypoints=(7,),
        template_size=scfg.template_size, kernlen=31, nsig=4.0,
        loss_scale=1000.0, resize_factor=0.25, temperature=1.0, n_goal=4,
        n_traj=1, packed_decode=False)
    return params, mcfg, scfg, jmcfg, jscfg


def test_bucketed_step_is_the_per_scene_mean_and_mst_tpus(world):
    """A bucketed batch of 2 + 2 rows from two scenes: its loss and
    gradients are the mean of the two per-scene batches' at the same
    weights, and equal mst_tpu's bucketed step (loss 1e-5, gradients 1e-4
    of each leaf's max)."""
    df, tracks, images = world
    params, mcfg, scfg, jmcfg, jscfg = _step_setup()
    per = scenes.split_trajectories_by_scene(tracks, TOTAL_LEN)
    sids = ["synth_0", "synth_1"]
    rows = {s: per[s][0][:2] * 0.25 for s in sids}

    def port_step(batch):
        weights, state = ynet_lib.init_ynet(torch.Generator().manual_seed(0),
                                            mcfg)
        setup = trainer.setup_training(weights, params, 1)
        loss = steps.make_train_step(mcfg, scfg).forward(
            weights, state, batch)
        (loss[0] + loss[1]).backward()
        return float((loss[0] + loss[1]).detach()), {k: v.grad for k, v in
                                          io.flatten(weights).items()
                                          if v.requires_grad}, weights

    losses, grads = [], []
    for s in sids:
        loss, g, weights = port_step({
            "semantic": torch.tensor(images[s][None]),
            "traj": torch.tensor(rows[s]), "mask": torch.ones(2)})
        losses.append(loss)
        grads.append(g)
    bucketed = {"semantic": np.stack([images[s] for s in sids]),
                "traj": np.concatenate([rows[s] for s in sids]),
                "mask": np.ones(4, np.float32),
                "scene_idx": np.asarray([0, 0, 1, 1], np.int32)}
    loss, g, weights = port_step({
        k: torch.tensor(v, dtype=torch.long if k == "scene_idx" else None)
        for k, v in bucketed.items()})
    np.testing.assert_allclose(loss, np.mean(losses), rtol=2e-5)
    for k in g:
        mean = (grads[0][k] + grads[1][k]) / 2
        np.testing.assert_allclose(g[k].numpy(), mean.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(mean.abs().max()),
                                   err_msg=k)

    import jax.numpy as jnp

    flat = io.params_to_numpy(weights)
    jw = io.unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    trainable, frozen = jfreeze.split_params(
        jw, jfreeze.trainable_mask(jw, "train", []))
    opt = optax.chain(capture_grads(), optax.sgd(1.0))
    jstep = jsteps.make_train_step(jmcfg, jscfg, opt)
    _, _, opt_state, metrics = jstep(trainable, frozen, {},
                                     opt.init(trainable), bucketed)
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=LOSS_RTOL)
    want = numpy_leaves(opt_state[0])
    got = io.params_to_numpy(g)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(), err_msg=k)


def test_cross_scene_epoch_matches_mst_tpu(tmp_path, monkeypatch, capsys,
                                          data):
    """One --cross_scene_batching epoch (batches of 4 across the two
    scenes, made and shuffled by the seeded generator) of train() in both
    packages with SGD and a scripted validation: the same epoch loss and
    train ADE/FDE (1e-5), steps, saves and weights (1e-4)."""
    port, jexp, out = run_policy(tmp_path, monkeypatch, capsys, data,
                                 "train", [50.0], cross_scene_batching=True)
    assert_same_policy(out, best=0, stop=0)
    assert [r["n_steps"] for r in out["port"][0]] == [3]
    assert_params_close(port, jexp)
    batches = port.prepare_data(data[1]["train"], None, "train",
                                rng=np.random.default_rng(0))
    assert all(isinstance(b, scenes.BucketedBatch) for b in batches)
    assert any(len(set(b.scene_idx[b.mask.astype(bool)])) > 1
               for b in batches), "no batch crossed scenes"


def test_validation_and_eth_stay_per_scene(tmp_path, data):
    """With --cross_scene_batching the train and test batches cross
    scenes, validation's and forward_test's stay per scene, and on eth
    every batch is per scene, as in mst_tpu (trainer.py:160-176)."""
    frames, tables, images = data
    exp = trainer.Experiment(loop_params(tmp_path, cross_scene_batching=True),
                             images=images)
    for mode, kind in (("train", scenes.BucketedBatch),
                       ("test", scenes.BucketedBatch),
                       ("val", scenes.SceneBatch)):
        got = exp.prepare_data(tables["train"], None, mode,
                               rng=np.random.default_rng(0))
        assert all(isinstance(b, kind) for b in got), mode
    got = exp.prepare_data(tables["train"], None, "test",
                           allow_bucketed=False)
    assert all(isinstance(b, scenes.SceneBatch) for b in got)
    masks = {k: (np.asarray(v).mean(-1) * 3).astype(np.uint8)
             for k, v in images.items()}
    eth = trainer.Experiment(loop_params(
        tmp_path, cross_scene_batching=True, dataset_name="eth"),
        images=masks)
    got = eth.prepare_data(tables["train"], None, "test")
    assert got and all(isinstance(b, scenes.SceneBatch) for b in got)


def test_bucketed_test_rows_and_one_segmentation_a_group(tmp_path, data):
    """A --cross_scene_batching test in bf16 with a shallow backbone: each
    scene group's stack is uploaded once and segmented once a pass (2
    scene maps for 2 rounds of 2 batches of 2: the cache serves the
    rounds),
    the cached maps keep the backbone's f32 as mst_tpu's cache does,
    every metrics row carries its own scene, and the rows are those of
    the per-scene test."""
    frames, tables, images = data
    seg = tmp_path / "sdd_segmentation.npz"
    np.savez(seg, **io.params_to_numpy(unet.unet_init(
        torch.Generator().manual_seed(0), n_classes=3,
        layers=(1, 1, 1, 1))))
    rows = {}
    for cross in (False, True):
        exp = trainer.Experiment(loop_params(
            tmp_path, cross_scene_batching=cross, segmentation_model_fp=str(
                seg), compute_dtype="bfloat16", n_round=2, batch_size=2),
            images=images)
        batches = exp.prepare_data(tables["test"], None, "test")
        cache = {}
        items = exp._device_batches(batches)
        semantic = [exp._step_batch(b, db, cache)["semantic"]
                    for b, db in items]
        assert all(s.dtype == torch.float32 for s in semantic)
        exp.n_segmented = 0
        ade, fde, metrics, _ = exp.test(None, None, batches=batches)
        assert np.isfinite([ade, fde]).all()
        assert exp.n_segmented == 2, (cross, exp.n_segmented)
        if cross:
            assert len(batches) == 2 and len(items[0][1]["image"]) == 2
            assert items[0][1]["image"] is items[1][1]["image"]
        order = np.argsort(metrics[0]["metaId"])
        rows[cross] = [metrics[0][k][order] for k in ("metaId", "sceneId")]
        meta_scene = dict(zip(tables["test"].metaId, tables["test"].sceneId))
        assert all(meta_scene[m] == s for m, s in zip(*rows[cross]))
    for a, b in zip(rows[False], rows[True]):
        np.testing.assert_array_equal(a, b)
