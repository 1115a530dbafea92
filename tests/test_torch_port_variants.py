"""The model variants against mst_tpu on the CPU in f32: Y-Net-Mod (the
fusion encoder), the serial/parallel block and in-layer adapters with
their batch-norm state, the semantic adapter and the embed network.

Both packages get the same numpy inputs and the same weights (the port's
init through io.params_to_numpy, JAX's eager init being slow). Every
leaf that starts at zero (lora_B, the adapters' convs, the semantic
adapter) is set to a nonzero random value first, and the batch norms get
non-trivial weights and running statistics, so no branch adds 0. mst_tpu
runs its unpacked path (packed_decode=False). Maps are held to 1e-4,
losses to 1e-5 relative, gradients to 1e-4 of each leaf's max and the
state to 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mst_tpu.models import layers as jlayers
from mst_tpu.models import ynet as jynet
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import steps as jsteps
from mst_tpu.train.trainer import Experiment as JExperiment
from mst_tpu_torch import io
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.data.splits import reduce_df_meta_ids
from mst_tpu_torch.data.synthetic import make_synthetic_dataset
from mst_tpu_torch.models import layers, ynet
from mst_tpu_torch.ops.heatmap import rasterize_dist_nhwc
from mst_tpu_torch.serve import Predictor
from mst_tpu_torch.train import freeze, steps, trainer
from tests.test_torch_port_train import (GRAD_TOL, OTHER_SHARE, SIG,
                                         UPDATE_TOL, assert_grads_close,
                                         assert_metrics_close, capture_grads,
                                         numpy_leaves)

MAP_TOL = 1e-4
STATE_TOL = 1e-5
H, W, B = 64, 96, 4
MASK = [1.0, 1.0, 1.0, 0.0]
WIDTHS = dict(encoder_channels=[8, 8, 16, 16, 16],
              decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3)
MODEL = dict(obs_len=4, pred_len=6, waypoints=(2, 5), **WIDTHS)
FUSION_POS = ["scene", "motion", "fusion"]
ALL_POS = ["0", "1", "2", "3", "4"]
VARIANTS = {
    "serial": dict(train_net="serial", position=["1", "2"]),
    "parallel_1x1": dict(train_net="parallel_1x1", position=["0", "3"]),
    "parallelLayer_3x3": dict(train_net="parallelLayer_3x3",
                              position=ALL_POS),
    "serialLayer": dict(train_net="serialLayer", position=["0", "2"]),
    "semantic_3x3": dict(train_net="semantic_3x3"),
    "embed": dict(network="embed"),
    "fusion_1": dict(network="fusion", n_fusion=1),
    "fusion_2_mosa_1": dict(network="fusion", n_fusion=2, train_net="mosa_1",
                            position=FUSION_POS),
    "fusion_2_serialLayer": dict(network="fusion", n_fusion=2,
                                 train_net="serialLayer",
                                 position=["scene", "fusion"]),
}


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def configs(over, model=MODEL):
    return (jynet.YNetConfig(**model, **over),
            ynet.YNetConfig(**model, **over))


def nonzero(rng, params, state):
    """The port's (params, state) -> numpy copies in the JAX layout with
    every adapter leaf but lora_A random (BN weights about 1), and the
    batch norms' running statistics and counts moved off their init."""
    flat = {k: v.copy() for k, v in io.params_to_numpy(params).items()}
    for k, v in flat.items():
        if ynet.is_adapter_leaf(k) and not k.endswith("lora_A"):
            flat[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            if k.endswith("bn/weight"):
                flat[k] += 1.0
    st = io.state_to_numpy(state)
    for k, v in st.items():
        if k.endswith("running_mean"):
            st[k] = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            st[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
        else:
            st[k] = np.full(v.shape, 3, v.dtype)
    return flat, st


def weights(rng, over, model=MODEL):
    """-> (jax config, port config, JAX params, JAX state, port params,
    port state), all the same nonzero weights."""
    jcfg, tcfg = configs(over, model)
    flat, st = nonzero(rng, *ynet.init_ynet(torch.Generator().manual_seed(0),
                                            tcfg))
    jp = jax.tree.map(jnp.asarray, io.unflatten(flat))
    js = jax.tree.map(jnp.asarray, io.unflatten(st))
    return (jcfg, tcfg, jp, js, io.params_from_numpy(flat),
            io.state_from_numpy(st))


def assert_state_close(got, want):
    got, want = io.state_to_numpy(got), {
        k: np.asarray(v) for k, v in io.flatten(want).items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_matches_jax_shapes(name):
    """Parameter and state trees, keys, shapes and dtypes, against
    jax.eval_shape of mst_tpu's init_ynet."""
    jcfg, tcfg = configs(VARIANTS[name])
    jp, js = jax.eval_shape(lambda key: jynet.init_ynet(key, jcfg),
                            jax.random.PRNGKey(0))
    tp, ts = ynet.init_ynet(torch.Generator().manual_seed(0), tcfg)
    want = {k: tuple(v.shape) for k, v in io.flatten(jp).items()}
    got = {k: v.shape for k, v in io.params_to_numpy(tp).items()}
    assert got == want
    want_state = {k: (tuple(v.shape), np.dtype(v.dtype))
                  for k, v in io.flatten(js).items()}
    assert {k: (v.shape, v.dtype) for k, v in
            io.state_to_numpy(ts).items()} == want_state
    assert bool(want_state) == ("serial" in tcfg.train_net)


def prepared_inputs(rng, jcfg, jp, tcfg, tp):
    """The semantic adapter and the embeddings on the same inputs, each
    side its own -> (JAX scene, motion; port scene, motion)."""
    scene = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(B, H, W, 4)).astype(np.float32)
    js = jynet.scene_embedding(jp, jcfg, jynet.adapt_semantic(
        jp, jcfg, jnp.asarray(scene)))
    jm = jynet.motion_embedding(jp, jcfg, jnp.asarray(motion))
    ts, tm = ynet.adapt_semantic(tp, tcfg, t(scene)), t(motion)
    if tcfg.network == "embed":
        ts, tm = ynet.scene_embedding(tp, ts), ynet.motion_embedding(tp, tm)
    for a, b in ((ts, js), (tm, jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MAP_TOL,
                                   atol=MAP_TOL)
    return js, jm, ts, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_features_match_jax(rng, name, train):
    """pred_features (after the semantic adapter and the embeddings) and
    the goal decoder on the features, and the new state, in train and
    eval mode."""
    jcfg, tcfg, jp, jst, tp, tst = weights(rng, VARIANTS[name])
    js, jm, ts, tm = prepared_inputs(rng, jcfg, jp, tcfg, tp)
    jfeats, jnew = jynet.pred_features(jp, jst, jcfg, js, jm, train=train)
    with torch.no_grad():
        tfeats, tnew = ynet.pred_features(tp, tst, tcfg, ts, tm, train=train)
    assert len(tfeats) == len(jfeats) == len(WIDTHS["encoder_channels"]) + 1
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MAP_TOL,
                                   atol=MAP_TOL, err_msg=f"feature {i}")
    np.testing.assert_allclose(
        ynet.pred_goal(tp, tfeats).numpy(),
        np.asarray(jynet.pred_goal(jp, jfeats)), rtol=MAP_TOL, atol=MAP_TOL)
    assert_state_close(tnew, jnew)
    if train and tst:
        counts = [int(v) for k, v in io.flatten(tnew).items()
                  if k.endswith("num_batches")]
        assert counts and set(counts) == {4}  # 3 + this batch
        assert_state_close(tst, jst)  # the given state is untouched


@pytest.mark.parametrize("name", ["serial", "parallel_1x1",
                                  "parallelLayer_3x3", "serialLayer",
                                  "semantic_3x3", "embed",
                                  "fusion_2_mosa_1"])
def test_each_variant_part_counts(rng, name):
    """Zeroing the variant's own leaves (or, for embed, skipping the
    embeddings) moves the feature maps by well over MAP_TOL: the parity
    above tests parts that do something."""
    _, tcfg, _, _, tp, tst = weights(rng, VARIANTS[name])
    scene, motion = t(rng.normal(size=(B, H, W, 3))), t(
        rng.uniform(size=(B, H, W, 4)))

    def features(params, embed=True):
        s = ynet.adapt_semantic(params, tcfg, scene)
        m = motion
        if embed and tcfg.network == "embed":
            s = ynet.scene_embedding(params, s)
            m = ynet.motion_embedding(params, m)
        return ynet.pred_features(params, tst, tcfg, s, m)[0]

    with torch.no_grad():
        full = features(tp)
        if name == "embed":
            bare = features(tp, embed=False)
        else:
            flat = io.flatten(tp)
            keys = [k for k in flat if ynet.is_adapter_leaf(k)
                    and not k.endswith(("lora_A", "bn/weight", "bn/bias"))]
            assert keys
            bare = features(io.unflatten(
                {k: torch.zeros_like(v) if k in keys else v
                 for k, v in flat.items()}))
        assert max(float((a - b).abs().max())
                   for a, b in zip(full, bare)) > 10 * MAP_TOL


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_matches_jax(rng, train):
    """batchnorm_apply alone: output, new state and (train) the gradients
    of a weighted sum through the batch statistics."""
    x = rng.normal(loc=0.5, scale=2.0, size=(3, 5, 7, 6)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    params = {"weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    state = {"running_mean": rng.normal(size=6).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, 6).astype(np.float32),
             "num_batches": np.int32(7)}

    def jloss(x, p):
        y, s = jlayers.batchnorm_apply(p, jax.tree.map(jnp.asarray, state),
                                       x, train)
        return (y * r).sum(), (y, s)

    (_, (jy, js)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = t(x).requires_grad_()
    tp = {k: t(v).requires_grad_() for k, v in params.items()}
    ts = io.state_from_numpy(state)
    ty, tnew = layers.batchnorm_apply(tp, ts, tx, train)
    (ty * t(r)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    assert_state_close(tnew, js)
    assert_state_close(ts, state)  # not modified in place
    assert tnew["num_batches"].dtype == torch.int32
    want = [jgrads[0], jgrads[1]["weight"], jgrads[1]["bias"]]
    for got, w in zip([tx.grad, tp["weight"].grad, tp["bias"].grad], want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_batchnorm_init_matches_jax():
    jp, js = jlayers.batchnorm_init(5)
    tp, ts = layers.batchnorm_init(5)
    for got, want in ((tp, jp), (ts, js)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype


def test_io_state_round_trip(rng):
    """A state tree through state_to_numpy and back is unchanged,
    num_batches int32 both ways; params_from_numpy keeps integer leaves."""
    _, _, _, _, _, state = weights(rng, VARIANTS["fusion_2_serialLayer"])
    arrays = io.state_to_numpy(state)
    assert {a.dtype for k, a in arrays.items()
            if k.endswith("num_batches")} == {np.dtype(np.int32)}
    back = io.state_from_numpy(arrays)
    assert io.flatten(back).keys() == io.flatten(state).keys()
    for k, v in io.flatten(state).items():
        got = io.flatten(back)[k]
        assert got.dtype == v.dtype
        assert torch.equal(got, v)
    assert io.state_from_numpy(io.unflatten(arrays)).keys() == state.keys()
    mixed = io.params_from_numpy({"a/num_batches": np.int32(2),
                                  "a/weight": np.ones(2, np.float64)})
    assert mixed["a"]["num_batches"].dtype == torch.int32
    assert mixed["a"]["weight"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the freeze matrix
# ---------------------------------------------------------------------------

FUSION_TREE = dict(network="fusion", n_fusion=2, train_net="mosa_1",
                   position=FUSION_POS)
FREEZE_CASES = [
    (FUSION_TREE, s, [], "fusion") for s in
    ("scene", "motion", "fusion", "scene_fusion", "motion_fusion",
     "scene_motion", "scene_motion_fusion")] + [
    (FUSION_TREE, "mosa_1", FUSION_POS, "fusion"),
    (FUSION_TREE, "mosa_1", FUSION_POS, None),
    (FUSION_TREE, "encoder", ["1", "scene"], "fusion"),
    (FUSION_TREE, "encoder", [], "fusion"),
    (VARIANTS["serial"], "serial", ["1", "2"], None),
    (VARIANTS["parallel_1x1"], "parallel_1x1", ["0", "3"], None),
    (VARIANTS["parallelLayer_3x3"], "parallelLayer_3x3", ALL_POS, None),
    (VARIANTS["serialLayer"], "serialLayer", ["0", "2"], None),
    (VARIANTS["semantic_3x3"], "semantic_3x3", [], None),
    (VARIANTS["embed"], "train", [], "embed"),
]


@pytest.mark.parametrize(
    "over,train_net,position,network", FREEZE_CASES,
    ids=[f"{c[1]}-{c[3]}-{'_'.join(c[2]) or 'none'}" for c in FREEZE_CASES])
def test_freeze_matches_jax(over, train_net, position, network):
    """The leaves set_trainable marks trainable equal mst_tpu's
    trainable_mask (encoder with positions selects nothing of a fusion
    tree, as in mst_tpu)."""
    _, tcfg = configs(over)
    tree, _ = ynet.init_ynet(torch.Generator().manual_seed(0), tcfg)
    jtree = io.unflatten(io.params_to_numpy(tree))
    jmask = jfreeze.trainable_mask(jtree, train_net, position, network)
    want = {k for k, v in io.flatten(jmask).items() if v}
    leaves = freeze.set_trainable(tree, train_net, position, network=network)
    got = {k for k, v in io.flatten(tree).items() if v.requires_grad}
    assert got == want
    assert sum(v.numel() for v in leaves) == \
        jfreeze.count_trainable(jmask, jtree)
    if train_net == "encoder" and position:
        assert not got


def test_branch_sets_need_the_fusion_network():
    """A branch set names no strategy of the plain network: mst_tpu's
    predicate raises there too."""
    with pytest.raises(NotImplementedError, match="not a strategy"):
        freeze.make_trainable_predicate("scene_fusion")
    with pytest.raises(NotImplementedError):
        jfreeze.make_trainable_predicate("scene_fusion")("encoder/x")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

LR = 5e-3
STEP_CASES = {
    "fusion_mosa_1": dict(network="fusion", n_fusion=2, train_net="mosa_1",
                          position=FUSION_POS),
    "parallelLayer_3x3": dict(train_net="parallelLayer_3x3",
                              position=ALL_POS),
    "serial": dict(train_net="serial", position=["1", "2"]),
}


def step_params(over, config="inD_longterm_train.yaml", **more):
    return get_params(config, {**WIDTHS, "waypoints": [5, 11],
                               "obs_len": 5, "pred_len": 12, "lr": LR,
                               "position": [], **over, **more})


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
            "traj": rng.uniform(5, 60, size=(B, 17, 2)).astype(np.float32),
            "mask": np.asarray(MASK, np.float32)}


def jax_configs(params):
    scfg = step_config(params)
    mcfg = ynet_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=mcfg.obs_len, pred_len=mcfg.pred_len,
        n_semantic_classes=mcfg.n_semantic_classes,
        encoder_channels=mcfg.encoder_channels,
        decoder_channels=mcfg.decoder_channels, waypoints=mcfg.waypoints,
        train_net=mcfg.train_net, position=mcfg.position,
        network=mcfg.network, n_fusion=mcfg.n_fusion)
    jscfg = jsteps.StepConfig(
        obs_len=scfg.obs_len, pred_len=scfg.pred_len,
        waypoints=scfg.waypoints, template_size=scfg.template_size,
        kernlen=scfg.kernlen, nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False)
    return jmcfg, jscfg


@pytest.fixture(scope="module")
def step_runs():
    """case -> one train step of the port and of mst_tpu's jitted
    unpacked step from the same nonzero weights, state and batch."""
    cache = {}

    def get(case):
        if case not in cache:
            params = step_params(STEP_CASES[case])
            mcfg = ynet_config(params)
            flat, st = nonzero(np.random.default_rng(1), *ynet.init_ynet(
                torch.Generator().manual_seed(0), mcfg))
            batch = make_batch()
            # mst_tpu
            jmcfg, jscfg = jax_configs(params)
            jw = jax.tree.map(jnp.asarray, io.unflatten(flat))
            mask = jfreeze.trainable_mask(jw, mcfg.train_net, mcfg.position,
                                          mcfg.network)
            trainable, frozen = jfreeze.split_params(jw, mask)
            opt = optax.chain(capture_grads(), optax.adam(LR))
            opt_state = opt.init(trainable)
            step = jsteps.make_train_step(jmcfg, jscfg, opt)
            trainable, jnew, opt_state, m = step(
                trainable, frozen, jax.tree.map(jnp.asarray,
                                                io.unflatten(st)),
                opt_state, batch)
            jax_out = {"metrics": {k: float(v) for k, v in m.items()},
                       "grads": numpy_leaves(opt_state[0]),
                       "params": numpy_leaves(trainable), "state": jnew}
            # the port
            tw, tst = io.params_from_numpy(flat), io.state_from_numpy(st)
            setup = trainer.setup_training(tw, params, steps_per_epoch=1)
            tstep = steps.make_train_step(mcfg, step_config(params))
            tnew, tm = tstep(tw, tst, setup["optimizer"], {k: t(v) for k, v in batch.items()})
            trained = {k: v for k, v in io.flatten(tw).items()
                       if v.requires_grad}
            torch_out = {
                "metrics": tm, "state": tnew,
                "grads": io.params_to_numpy({k: v.grad for k, v in
                                             trained.items()}),
                "params": {k: v.copy() for k, v in
                           io.params_to_numpy(trained).items()}}
            cache[case] = dict(init=flat, state=st, jax=jax_out,
                               torch=torch_out, weights=tw, params=params)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(step_runs, case):
    """One step: losses and metrics at 1e-5 relative, the gradients of the
    same trainable leaves at 1e-4 of each leaf's max, the updated leaves
    under the Adam rule of tests/test_torch_port_train.py, and the new
    state (serial: the running statistics moved by the batch)."""
    r = step_runs(case)
    tor, jx = r["torch"], r["jax"]
    assert_metrics_close(tor["metrics"], jx["metrics"])
    assert_grads_close(tor["grads"], jx["grads"], case)
    assert tor["params"].keys() == jx["params"].keys()
    for k, g in jx["grads"].items():
        off = np.abs((tor["params"][k] - r["init"][k])
                     - (jx["params"][k] - r["init"][k]))
        sig = np.abs(g) > SIG * np.abs(g).max()
        assert np.all(off[sig] <= UPDATE_TOL * LR), k
        assert np.sum(off[~sig] > 1e-4 * LR) <= OTHER_SHARE * off.size, k
    assert_state_close(tor["state"], jx["state"])
    if case == "serial":
        moved = io.state_to_numpy(tor["state"])
        assert any(np.abs(moved[k] - r["state"][k]).max() > 1e-3
                   for k in moved if k.endswith("running_mean"))
        assert any(k.endswith("bn/weight") for k in tor["grads"])


def eval_case(rng, over, n_goal=3):
    params = step_params(over, "inD_longterm_eval.yaml", n_goal=n_goal)
    mcfg = ynet_config(params)
    flat, st = nonzero(rng, *ynet.init_ynet(torch.Generator().manual_seed(0),
                                            mcfg))
    return params, flat, st


def test_eval_step_matches_jax(rng):
    """Y-Net-Mod (mosa_1 on scene, motion, fusion): fed the waypoint
    samples JAX's forward drew, the port's decode and score reproduce
    JAX's ade, fde and best_traj; the forward's features too."""
    params, flat, st = eval_case(rng, STEP_CASES["fusion_mosa_1"])
    jmcfg, jscfg = jax_configs(params)
    jw = jax.tree.map(jnp.asarray, io.unflatten(flat))
    jst = jax.tree.map(jnp.asarray, io.unflatten(st))
    b = make_batch(2)
    key = jax.random.PRNGKey(5)
    es = jsteps.make_eval_step(jmcfg, jscfg)
    jfeats, jwps = es.forward(jw, jst, b, key)
    want = es(jw, jst, b, key)
    step = steps.make_eval_step(ynet_config(params), step_config(params))
    tb = {k: t(v) for k, v in b.items()}
    tw, tst = io.params_from_numpy(flat), io.state_from_numpy(st)
    feats, _ = step.forward(tw, tst, tb, torch.Generator().manual_seed(0))
    for a, f in zip(feats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(f), rtol=MAP_TOL,
                                   atol=MAP_TOL)
    got = step.decode_and_score(tw, feats, t(jwps), tb["traj"], tb["mask"])
    for k in ("ade", "fde", "best_traj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("waypoints", [[11], [5, 11]])
def test_decode_tail_operands_are_nhwc_contiguous(rng, waypoints):
    """The fused decode tail takes x contiguous in NHWC order only (on the
    card anything else raises). With two waypoints (the inD configs) the
    distance maps came out laid out (B, T, H, W), and every conv after
    them carried that layout on to x."""
    for T in (1, 2, 5):
        assert rasterize_dist_nhwc(t(rng.uniform(0, 60, size=(3, T, 2))),
                                   16, 24, 1386).is_contiguous()
    params = step_params(STEP_CASES["fusion_mosa_1"],
                         "inD_longterm_eval.yaml", n_goal=2,
                         waypoints=waypoints)
    mcfg = ynet_config(params)
    flat, st = nonzero(rng, *ynet.init_ynet(torch.Generator().manual_seed(0),
                                            mcfg))
    step = steps.make_eval_step(mcfg, step_config(params))
    tw, tst = io.params_from_numpy(flat), io.state_from_numpy(st)
    with torch.no_grad():
        feats, wps = step.forward(
            tw, tst, {k: t(v) for k, v in make_batch(4).items()},
            torch.Generator().manual_seed(0))
        x, w, _ = step.prepredictor(tw, feats)(wps)
    assert all(f.is_contiguous() for f in feats)
    assert x.is_contiguous() and w.is_contiguous()


def test_predictor_serves_a_parallel_style_on_fusion(rng, tmp_path):
    """A fusion Predictor from a base checkpoint without adapter leaves,
    with a parallelLayer_3x3 delta (on scene and fusion) added as a style:
    fed JAX's own waypoint draws, it decodes mst_tpu's make_predict_step
    trajectories on the overlaid weights, and the style moves them."""
    over = dict(network="fusion", n_fusion=2, train_net="parallelLayer_3x3",
                position=["scene", "fusion"])
    params, flat, _ = eval_case(rng, over)
    base = {k: v for k, v in flat.items() if not ynet.is_adapter_leaf(k)}
    delta = {k: v for k, v in flat.items() if "parallel_layer" in k}
    assert delta and len(base) + len(delta) == len(flat)
    np.savez(tmp_path / "base.npz", **base)
    np.savez(tmp_path / "delta.npz", **delta)
    pred = Predictor(params, str(tmp_path / "base.npz"), device="cpu",
                     seed=3)
    pred.add_style("parallel", str(tmp_path / "delta.npz"))
    jmcfg, jscfg = jax_configs(params)
    b = make_batch(3)
    observed = b["traj"][:, :5]
    jout = jsteps.make_predict_step(jmcfg, jscfg)(
        jax.tree.map(jnp.asarray, io.unflatten(flat)), {}, b["semantic"],
        observed, jax.random.PRNGKey(1))
    rf = params["resize_factor"]
    wps = t(jout["waypoints"]) * rf
    feats, _ = pred.forward(b["semantic"], observed, style="parallel")
    got = pred.decode(feats, wps, style="parallel")
    np.testing.assert_allclose(got.numpy(), np.asarray(jout["trajectories"]),
                               atol=4e-3)
    plain_feats, _ = pred.forward(b["semantic"], observed)
    assert float((pred.decode(plain_feats, wps) - got).abs().max()) > 0.01
    out = pred.predict(b["semantic"], observed, seed=1, style="parallel")
    assert out["trajectories"].shape == (3, B, 12, 2)
    assert np.isfinite(out["trajectories"]).all()


def test_predictor_requires_the_base_model(rng, tmp_path):
    """The fusion encoder's and the embed network's weights are the base
    model's: a checkpoint without them raises."""
    for over, key in ((dict(network="fusion", n_fusion=2),
                       "encoder/scene_stages/0/conv0/weight"),
                      (dict(network="embed"), "scene_embedding/0/weight")):
        params, flat, _ = eval_case(rng, over)
        np.savez(tmp_path / "base.npz", **{k: v for k, v in flat.items()
                                            if k != key})
        with pytest.raises(KeyError, match=key):
            Predictor(params, str(tmp_path / "base.npz"), device="cpu")


@pytest.mark.parametrize("name", ["serial", "serialLayer",
                                  "fusion_2_serialLayer"])
def test_predictor_refuses_weights_without_their_state(rng, tmp_path, name):
    """A model with batch-norm running statistics serves its own random
    weights, but a checkpoint or a style would be served with init_ynet's
    statistics (loading a state file is not ported): both raise. The
    parallel adapters have no state and load (the test above)."""
    params, flat, st = eval_case(rng, VARIANTS[name])
    assert st
    np.savez(tmp_path / "model.npz", **flat)
    np.savez(tmp_path / "delta.npz", **{k: v for k, v in flat.items()
                                        if "serial_layer" in k})
    with pytest.raises(NotImplementedError, match="running statistics"):
        Predictor(params, str(tmp_path / "model.npz"), device="cpu")
    pred = Predictor(params, device="cpu")
    with pytest.raises(NotImplementedError, match="a style"):
        pred.add_style("serial", str(tmp_path / "delta.npz"))
    assert pred.styles == []
    b = make_batch(2)
    out = pred.predict(b["semantic"], b["traj"][:, :5], seed=0)
    assert np.isfinite(out["trajectories"]).all()


# ---------------------------------------------------------------------------
# the Experiment loop
# ---------------------------------------------------------------------------

def test_experiment_serial_fine_tune(tmp_path):
    """A 2-epoch serial fine-tune in the port's Experiment: the state
    threads through the steps (num_batches counts them) and keeps
    mst_tpu's keys; the delta holds the adapters' convs and BN weights,
    not the running statistics, as mst_tpu's save writes it, and loads
    into mst_tpu strictly."""
    tracks, images = make_synthetic_dataset(seed=0, n_scenes=1, n_traj=12,
                                            img_hw=(128, 192))
    ids = tracks.meta_ids()
    train, val = (reduce_df_meta_ids(tracks, ids[:8]),
                  reduce_df_meta_ids(tracks, ids[8:]))
    params = get_params("sdd_shortterm_train.yaml", {
        **WIDTHS, "train_net": "serial", "position": ["1", "2"],
        "fine_tune": True, "n_epoch": 2, "batch_size": 4, "n_goal": 2,
        "lr": 1e-3, "seed": 1, "device": "cpu",
        "ckpt_path": str(tmp_path / "ckpts")})
    exp = trainer.Experiment(params, images=images)
    init_state = io.state_to_numpy(exp.model_state)
    exp.train(train, val, None, None, "serial")
    n_steps = sum(r["n_steps"] for r in exp.epoch_log)
    state = io.state_to_numpy(exp.model_state)
    assert state.keys() == init_state.keys()
    for k, v in state.items():
        if k.endswith("num_batches"):
            assert v.dtype == np.int32 and int(v) == n_steps == 4
        else:
            assert np.abs(v - init_state[k]).max() > 0, k

    jcfg = jynet.YNetConfig(obs_len=8, pred_len=12, waypoints=(11,),
                            train_net="serial", position=("1", "2"),
                            **WIDTHS)
    jp, js = jax.eval_shape(lambda key: jynet.init_ynet(key, jcfg),
                            jax.random.PRNGKey(0))
    assert state.keys() == io.flatten(js).keys()
    got = jckpt.load_checkpoint(tmp_path / "ckpts" / "serial.npz")
    jexp = JExperiment.__new__(JExperiment)  # only the save is used
    jexp.params = params
    jexp.model_params = io.unflatten(
        {k: v.copy() for k, v in
         io.params_to_numpy(io.flatten(exp.model_params)).items()})
    jexp.save_params(str(tmp_path / "jax.npz"))
    want = jckpt.load_checkpoint(tmp_path / "jax.npz")
    assert got.keys() == want.keys()
    assert {k.split("/", 3)[-1] for k in got} == {
        "serial_layer/bn/weight", "serial_layer/bn/bias",
        "serial_layer/conv/weight"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "ckpts" / "serial.npz.json") as f:
        assert json.load(f)["train_net"] == "serial"
    full = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp)
    jckpt.overlay_checkpoint(full, got, strict=True)


def test_roll_back_keeps_the_last_state(tmp_path, monkeypatch):
    """The roll back to the best epoch restores the trainable leaves and
    not the model state, as mst_tpu's does (trainer.py:775-781): with the
    best epoch 1 of 3, the weights are epoch 1's and the BN running
    statistics epoch 2's (ROADMAP Queue 3)."""
    tracks, images = make_synthetic_dataset(seed=0, n_scenes=1, n_traj=12,
                                            img_hw=(128, 192))
    ids = tracks.meta_ids()
    train, val = (reduce_df_meta_ids(tracks, ids[:8]),
                  reduce_df_meta_ids(tracks, ids[8:]))
    params = get_params("sdd_shortterm_train.yaml", {
        **WIDTHS, "train_net": "serial", "position": ["1", "2"],
        "fine_tune": True, "n_epoch": 3, "batch_size": 4, "lr": 1e-2,
        "seed": 1, "device": "cpu", "ckpt_path": str(tmp_path / "ckpts")})
    seen = []
    script = iter([50.0, 40.0, 45.0])

    def evaluate(self, *args, **kwargs):
        trained = {k: v.detach().clone() for k, v in
                   io.flatten(self.model_params).items() if v.requires_grad}
        seen.append((trained, io.state_to_numpy(self.model_state)))
        ade = next(script)
        return ade, ade, {}, None

    monkeypatch.setattr(trainer.Experiment, "_evaluate", evaluate)
    exp = trainer.Experiment(params, images=images)
    exp.train(train, val, None, None, "serial")
    assert exp.best_epoch == 1
    flat = io.flatten(exp.model_params)
    for k, v in seen[1][0].items():
        assert torch.equal(flat[k], v), k
    assert any(not torch.equal(seen[2][0][k], v)
               for k, v in seen[1][0].items())
    state = io.state_to_numpy(exp.model_state)
    for k, v in seen[2][1].items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    assert any(np.abs(seen[2][1][k] - v).max() > 0
               for k, v in seen[1][1].items() if "running" in k)
