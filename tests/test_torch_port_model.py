"""mst_tpu_torch Y-Net against the JAX package's, on shared weights.

JAX weights go through io.params_from_numpy (HWIO -> OIHW); both packages
run the same numpy inputs on the CPU in f32. The JAX side runs its
unpacked path (packed_decode=False); maps agree within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.ops.pooling import avg_pool_pyramid as javg_pool_pyramid
from mst_tpu.train.checkpoints import save_checkpoint
from mst_tpu_torch import io
from mst_tpu_torch.models import ynet
from mst_tpu_torch.ops.kernels.fused_predict import \
    fused_predictor_softargmax
from mst_tpu_torch.ops.pooling import avg_pool_pyramid
from mst_tpu_torch.ops.softargmax import softargmax2d_nhwc

MAP_TOL = 1e-4
H, W, B = 64, 96, 2
SMALL = dict(obs_len=4, pred_len=6, n_semantic_classes=3,
             encoder_channels=(8, 8, 16, 16, 16),
             decoder_channels=(16, 16, 16, 8, 8), waypoints=(2, 5))


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def to_jax_layout(params):
    """The port's tree -> the JAX package's nested numpy tree."""
    return io.unflatten(io.params_to_numpy(params))


def jax_weights(rng, train_net, position=()):
    """Random weights in the JAX package's layout (made by the port's
    init, which JAX's eager init would take ~30 s to match on the CPU),
    with a random nonzero lora_B so the LoRA term counts; and the same
    weights back through io.params_from_numpy."""
    cfg = jynet.YNetConfig(train_net=train_net, position=position, **SMALL)
    tcfg = ynet.YNetConfig(train_net=train_net, position=position, **SMALL)
    params = to_jax_layout(ynet.init_ynet(torch.Generator().manual_seed(0),
                                          tcfg)[0])
    for stage in params["encoder"]["stages"].values():
        for conv in stage.values():
            if "lora_B" in conv:
                conv["lora_B"] = rng.normal(
                    scale=0.1, size=conv["lora_B"].shape).astype(np.float32)
    return cfg, params, tcfg, io.params_from_numpy(params)


@pytest.mark.parametrize("train_net,position", [
    ("train", ()), ("mosa_2", ("0", "2"))])
def test_init_matches_jax_shapes(train_net, position):
    cfg = jynet.YNetConfig(train_net=train_net, position=position, **SMALL)
    want, _ = jax.eval_shape(lambda key: jynet.init_ynet(key, cfg),
                             jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in io.flatten(want).items()}
    tcfg = ynet.YNetConfig(train_net=train_net, position=position, **SMALL)
    got = to_jax_layout(ynet.init_ynet(torch.Generator().manual_seed(0),
                                       tcfg)[0])
    assert {k: v.shape for k, v in io.flatten(got).items()} == want


def inputs(rng):
    scene = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(B, H, W, 4)).astype(np.float32)
    return scene, motion


@pytest.mark.parametrize("train_net,position", [
    ("train", ()), ("mosa_2", ("0", "1", "2", "3", "4"))])
def test_features_and_goal(rng, train_net, position):
    cfg, jp, tcfg, tp = jax_weights(rng, train_net, position)
    scene, motion = inputs(rng)
    jfeats, _ = jynet.pred_features(jp, {}, cfg, jnp.asarray(scene),
                                    jnp.asarray(motion))
    tfeats, _ = ynet.pred_features(tp, {}, tcfg, t(scene), t(motion))
    assert len(tfeats) == len(jfeats)
    for jf, tf in zip(jfeats, tfeats):
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf),
                                   rtol=MAP_TOL, atol=MAP_TOL)
    np.testing.assert_allclose(
        ynet.pred_goal(tp, tfeats).numpy(),
        np.asarray(jynet.pred_goal(jp, jfeats)), rtol=MAP_TOL, atol=MAP_TOL)


def test_lora_changes_the_features(rng):
    """The random lora_B makes the mosa test above meaningful."""
    _, _, tcfg, tp = jax_weights(rng, "mosa_2", ("0",))
    scene, motion = inputs(rng)
    with_lora = ynet.pred_features(tp, {}, tcfg, t(scene), t(motion))[0][0]
    tp["encoder"]["stages"]["0"]["conv0"]["lora_B"].zero_()
    without = ynet.pred_features(tp, {}, tcfg, t(scene), t(motion))[0][0]
    assert float((with_lora - without).abs().max()) > 1e-3


@pytest.mark.parametrize("K", [1, 3])
def test_shared_pred_traj(rng, K):
    """The K-hoisted trajectory decode against JAX packed_decode=False: its
    pre-predictor output through the 1x1 predictor gives JAX's logits, and
    through the fused tail JAX's soft-argmax points."""
    cfg, jp, tcfg, tp = jax_weights(rng, "train")
    scene, motion = inputs(rng)
    jfeats, _ = jynet.pred_features(jp, {}, cfg, jnp.asarray(scene),
                                    jnp.asarray(motion))
    feats = [np.asarray(f) for f in jfeats]
    wp = rng.uniform(0, 2, size=(K * B, H, W, 2)).astype(np.float32)
    want = jynet.make_shared_pred_traj(jp, [jnp.asarray(f) for f in feats],
                                       2)(javg_pool_pyramid(
                                           jnp.asarray(wp), len(feats)))
    tfeats = [t(f) for f in feats]
    pyr = avg_pool_pyramid(t(wp), len(feats))
    x, w, b = ynet.make_shared_pred_traj(tp, tfeats, 2)(pyr)
    got = torch.einsum("rhwc,cp->rhwp", x, w) + b
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MAP_TOL, atol=MAP_TOL)
    np.testing.assert_allclose(
        fused_predictor_softargmax(x, w, b).numpy(),
        softargmax2d_nhwc(t(want)).numpy(), atol=1e-3)


def test_checkpoint_bridge(rng, tmp_path):
    """A JAX npz checkpoint loads into the port: HWIO -> OIHW, LoRA
    factors unchanged; overlay is non-strict unless asked."""
    _, jp, tcfg, _ = jax_weights(rng, "mosa_2", ("1",))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, jp)
    flat = io.load_checkpoint(path)
    init, _ = ynet.init_ynet(torch.Generator().manual_seed(1), tcfg)
    loaded = io.overlay(init, io.params_from_numpy(flat))
    conv = jp["encoder"]["stages"]["1"]["conv0"]
    got = loaded["encoder"]["stages"]["1"]["conv0"]
    np.testing.assert_array_equal(got["weight"].numpy(),
                                  conv["weight"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["lora_A"].numpy(), conv["lora_A"])
    np.testing.assert_array_equal(got["lora_B"].numpy(), conv["lora_B"])
    assert io.flatten(loaded).keys() == io.flatten(init).keys()
    # and back: the inverse bridge gives the checkpoint's arrays exactly
    back = io.params_to_numpy(loaded)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    extra = {"encoder": {"stages": {"9": {"conv0": {"bias": t([1.0])}}}}}
    assert io.overlay(loaded, extra) is not loaded
    with pytest.raises(KeyError):
        io.overlay(loaded, extra, strict=True)
    bad = {"encoder": {"stages": {"1": {"conv0": {"bias": t([1.0])}}}}}
    with pytest.raises(ValueError):
        io.overlay(loaded, bad)
