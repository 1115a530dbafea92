"""The fine-tune slice against mst_tpu on the CPU in f32: masked BCE, the
Gaussian rasterizer, the freeze matrix, make_train_step (loss, metrics,
gradients), Adam with the fine-tune schedule against optax, and the delta
save that mst_tpu loads and Predictor.add_style serves.

Both packages get the same numpy inputs and the same weights (the port's
init through io.params_to_numpy). mst_tpu runs its unpacked train step
(packed_decode=False) jitted; each JAX step is built once per module
(the `runs` fixture). An optax transformation chained before Adam keeps
each step's gradients in the optimizer state, so they are compared
exactly as the step computed them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.ops import heatmap as jheatmap
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import losses as jlosses
from mst_tpu.train import steps as jsteps
from mst_tpu.train.trainer import Experiment
from mst_tpu_torch import io
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.ops.heatmap import (gaussian_template_normalizer,
                                       rasterize_gaussian_nhwc)
from mst_tpu_torch.serve import Predictor
from mst_tpu_torch.train import freeze, losses, steps, trainer

H, W, B = 64, 96, 4
MASK = [1.0, 1.0, 1.0, 0.0]  # the last row is padding
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             waypoints=[5, 11])
POSITIONS = ["0", "1", "2", "3", "4"]
LR, BOUNDARY, N_STEPS = 1e-3, 2, 3
# losses and metrics, relative. mst_tpu's own f32 sum of the 295k BCE
# terms on the CPU can be off its float64 value by more (2.6e-5 measured
# on a one-hot scene; the port's 5e-8), so test_losses_match_float64 holds
# the port's sum at 1e-6 against float64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # gradients, relative to each leaf's max |g|
# Adam's update on elements whose gradient is above 1e-3 of the leaf's
# max, relative to the LR (measured: <= 7.5e-5); below that, Adam's update
# is ~lr * sign(g) of a gradient that is mostly rounding, so only the
# share of elements whose update differs by more than 1e-4 lr is bounded
SIG, UPDATE_TOL, OTHER_SHARE = 1e-3, 1e-3, 0.01


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def train_params(train_net="mosa_2", **over):
    position = POSITIONS if "mosa" in train_net else []
    return get_params("sdd_shortterm_train.yaml", {
        **SMALL, "train_net": train_net, "position": position, "lr": LR,
        "fine_tune": True, "steps": [BOUNDARY], **over})


def make_batch(seed=0):
    """A normal scene map, as bench.py:47-55 draws it, and tracks inside
    the image."""
    rng = np.random.default_rng(seed)
    return {"semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
            "traj": rng.uniform(5, 60, size=(B, 20, 2)).astype(np.float32),
            "mask": np.asarray(MASK, np.float32)}


def jax_configs(params):
    scfg = step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=tuple(SMALL["encoder_channels"]),
        decoder_channels=tuple(SMALL["decoder_channels"]),
        waypoints=tuple(SMALL["waypoints"]), train_net=params["train_net"],
        position=tuple(params["position"]))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=tuple(SMALL["waypoints"]),
        template_size=scfg.template_size, kernlen=scfg.kernlen,
        nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False,
        swap_semantic=scfg.swap_semantic)
    return jmcfg, jscfg


def capture_grads():
    """Pass the gradients on and keep them as the state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, state, params=None: (g, g))


def numpy_leaves(tree):
    return {k: np.asarray(v) for k, v in io.flatten(tree).items()
            if v is not None}


def hwio(flat):
    """The port's {path: tensor} -> numpy copies in the JAX layout."""
    return {k: v.copy() for k, v in io.params_to_numpy(flat).items()}


def run_jax(params, weights, batch):
    jmcfg, jscfg = jax_configs(params)
    jw = io.unflatten(hwio(weights))
    mask = jfreeze.trainable_mask(jw, params["train_net"],
                                  params["position"])
    trainable, frozen = jfreeze.split_params(jw, mask)
    schedule = optax.piecewise_constant_schedule(LR, {BOUNDARY: 0.1})
    opt = optax.chain(capture_grads(), optax.adam(schedule))
    state = opt.init(trainable)
    step = jsteps.make_train_step(jmcfg, jscfg, opt)
    out = []
    for i in range(N_STEPS):
        trainable, _, state, m = step(trainable, frozen, {}, state, batch)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": numpy_leaves(state[0]),
                    "params": numpy_leaves(trainable),
                    "lr": float(schedule(i))})
    return out


def run_torch(params, weights, batch):
    setup = trainer.setup_training(weights, params, steps_per_epoch=1)
    step = steps.make_train_step(ynet_config(params), step_config(params))
    tb = {k: t(v) for k, v in batch.items()}
    out = []
    for _ in range(N_STEPS):
        lr = setup["optimizer"].param_groups[0]["lr"]
        _, m = step(weights, {}, setup["optimizer"], setup["scheduler"], tb)
        trained = {k: v for k, v in io.flatten(weights).items()
                   if v.requires_grad}
        out.append({"metrics": m,
                    "grads": hwio({k: v.grad for k, v in trained.items()}),
                    "params": hwio(trained), "lr": lr})
    return out


@pytest.fixture(scope="module")
def runs():
    """(train_net, swap_semantic) -> the port's and mst_tpu's N_STEPS
    steps from the same initial weights and batch, built once."""
    cache = {}

    def get(train_net, swap=False):
        if (train_net, swap) not in cache:
            params = train_params(train_net, swap_semantic=swap)
            init, _ = init_ynet(torch.Generator().manual_seed(0),
                                ynet_config(params))
            weights, _ = init_ynet(torch.Generator().manual_seed(0),
                                   ynet_config(params))
            batch = make_batch()
            cache[train_net, swap] = dict(
                params=params, init=hwio(init), weights=weights,
                jax=run_jax(params, init, batch),
                torch=run_torch(params, weights, batch))
        return cache[train_net, swap]

    return get


def assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def assert_grads_close(got, want, label=""):
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, MASK, [0.0] * B],
                         ids=["unmasked", "masked", "all-zero mask"])
def test_bce_matches_jax(rng, mask):
    """Value and gradient of the masked BCE at 1e-6 relative. At a logit
    of exactly 0 mst_tpu's gradient is -z (jnp.abs has derivative 1 at
    0); there the port's is torch's BCEWithLogits gradient, 0.5 - z
    (ROADMAP Queue 3)."""
    x = rng.normal(scale=3, size=(B, 8, 12, 5)).astype(np.float32)
    x[0, :2] = 0.0
    zero = x == 0.0
    z = rng.uniform(size=x.shape).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    jm = None if m is None else jnp.asarray(m)
    want, jgrad = jax.value_and_grad(jlosses.bce_with_logits)(
        jnp.asarray(x), jnp.asarray(z), jm)
    xt = t(x).requires_grad_()
    got = losses.bce_with_logits(xt, t(z), None if m is None else t(m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[~zero],
                               np.asarray(jgrad)[~zero], rtol=0,
                               atol=1e-6 * np.abs(jgrad).max())
    x_ref = t(x).requires_grad_()
    weight = None if m is None else t(m)[:, None, None, None].expand(x.shape)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        x_ref, t(z), weight=weight, reduction="sum")
    (ref / max(x.size * (1.0 if m is None else m.mean()), 1.0)).backward()
    np.testing.assert_allclose(xt.grad.numpy()[zero],
                               x_ref.grad.numpy()[zero], rtol=0,
                               atol=1e-6 * np.abs(x_ref.grad.numpy()).max())
    if mask is not None:
        # padded rows add nothing to the loss or the gradients
        np.testing.assert_array_equal(xt.grad.numpy()[m == 0], 0.0)
    if mask == [0.0] * B:
        assert float(got.detach()) == 0.0


@pytest.mark.parametrize("kernlen,nsig", [(31, 4.0), (7, 2.0)])
def test_rasterize_gaussian_matches_jax(rng, kernlen, nsig):
    """Points on half-pixels (round half to even), on the image's edges
    and past them, at 1e-6."""
    pts = np.concatenate([
        rng.uniform(0, 60, size=(3, 5, 2)),
        np.array([[[0.5, 1.5], [2.5, 10.5], [W - 1, H - 1], [W - 0.5, 0.0],
                   [-3.0, H + 2.0]]]),
    ]).astype(np.float32)
    want = jheatmap.rasterize_gaussian_nhwc(jnp.asarray(pts), H, W, kernlen,
                                            nsig)
    got = rasterize_gaussian_nhwc(t(pts), H, W, kernlen, nsig)
    assert got.shape == (4, H, W, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-12)
    assert gaussian_template_normalizer(kernlen, nsig) == \
        jheatmap.gaussian_template_normalizer(kernlen, nsig)


STRATEGIES = [("train", (), False), ("all", (), False),
              ("encoder", (), False), ("encoder", ("1", "3"), False),
              ("mosa_2", POSITIONS, False), ("mosa_2", POSITIONS, True),
              ("biasEncoder", (), False), ("biasGoal", (), False),
              ("biasTraj", (), False), ("bias", (), False),
              ("encoder", ("0",), True)]


@pytest.mark.parametrize("train_net,position,ynet_bias", STRATEGIES)
def test_freeze_matches_jax(train_net, position, ynet_bias):
    """The leaves set_trainable marks requires_grad (and returns, in path
    order) and their count equal mst_tpu's trainable_mask on a real
    parameter tree."""
    cfg = ynet_config(train_params("mosa_2"))
    tree, _ = init_ynet(torch.Generator().manual_seed(0), cfg)
    jtree = io.unflatten(hwio(tree))
    jmask = jfreeze.trainable_mask(jtree, train_net, position, None,
                                   ynet_bias)
    want = {k for k, v in io.flatten(jmask).items() if v}
    leaves = freeze.set_trainable(tree, train_net, position, ynet_bias)
    flat = io.flatten(tree)
    assert want and sum(v.numel() for v in leaves) == \
        jfreeze.count_trainable(jmask, jtree)
    assert [id(v) for v in leaves] == [id(flat[k]) for k in flat
                                       if k in want]
    assert all(v.requires_grad == (k in want) for k, v in flat.items())


@pytest.mark.parametrize("train_net", ["scene", "segmentation_head"])
def test_unported_strategy_raises(train_net):
    """The backbone's strategies are not ported; a branch set without
    network='fusion' is no strategy (mst_tpu's predicate raises too)."""
    with pytest.raises(NotImplementedError,
                       match="not ported|not a strategy"):
        freeze.make_trainable_predicate(train_net)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_net", ["train", "mosa_2"])
def test_train_step_matches_jax(runs, train_net):
    """One step: loss, goal and traj loss, and the top-1 metrics at 1e-5
    relative; the metrics hold no autograd graph."""
    r = runs(train_net)
    got = r["torch"][0]["metrics"]
    assert_metrics_close(got, r["jax"][0]["metrics"])
    assert all(v.grad_fn is None and not v.requires_grad
               for v in got.values())


@pytest.mark.parametrize("train_net", ["train", "mosa_2"])
def test_train_step_gradients_match_jax(runs, train_net):
    """One step's gradients over the same trainable set, at 1e-4 of each
    leaf's max |g|. lora_B starts at 0, so lora_A's gradient is exactly 0
    in both."""
    r = runs(train_net)
    got, want = r["torch"][0]["grads"], r["jax"][0]["grads"]
    assert_grads_close(got, want)
    for k, g in want.items():
        if k.endswith("lora_A"):
            assert not np.any(g) and not np.any(got[k])


def test_losses_match_float64():
    """The port's f32 losses against the same masked BCE summed in
    float64 on the port's own maps, at 1e-6 relative."""
    params = train_params("train")
    step = steps.make_train_step(ynet_config(params), step_config(params))
    weights, _ = init_ynet(torch.Generator().manual_seed(0),
                           ynet_config(params))
    batch = make_batch()
    with torch.no_grad():
        goal_loss, traj_loss, goal_map, traj_map, _ = step.forward(
            weights, {}, {k: t(v) for k, v in batch.items()})
    gt = rasterize_gaussian_nhwc(t(batch["traj"][:, 8:]), H, W).double()
    m = batch["mask"][:, None, None, None]
    for got, logits in ((goal_loss, goal_map), (traj_loss, traj_map)):
        x, z = logits.double().numpy(), gt.numpy()
        per = np.maximum(x, 0) - x * z + np.log1p(np.exp(-np.abs(x)))
        want = (per * m).sum() / (m.sum() * x[0].size) * 1000.0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_three_adam_steps_match_optax(runs):
    """mosa_2, three steps of setup_training's Adam + MultiStepLR against
    optax.adam + piecewise_constant_schedule with a boundary at step 2:
    the LR of each step (optax computes it in f32), then each step's
    update under the masked rule; both LoRA factors move."""
    r = runs("mosa_2")
    prev_t = prev_j = {k: r["init"][k] for k in r["jax"][0]["params"]}
    assert [s["lr"] for s in r["torch"]] == [LR, LR, LR * 0.1]
    for i, (st, sj) in enumerate(zip(r["torch"], r["jax"])):
        np.testing.assert_allclose(st["lr"], sj["lr"], rtol=2 ** -23)
        assert_metrics_close(st["metrics"], sj["metrics"])
        assert_grads_close(st["grads"], sj["grads"], f"step {i}")
        for k, g in sj["grads"].items():
            moved_t = st["params"][k] - prev_t[k]
            moved_j = sj["params"][k] - prev_j[k]
            off = np.abs(moved_t - moved_j)
            sig = np.abs(g) > SIG * np.abs(g).max()
            assert np.all(off[sig] <= UPDATE_TOL * st["lr"]), (i, k)
            assert np.sum(off[~sig] > 1e-4 * st["lr"]) <= \
                OTHER_SHARE * off.size, (i, k)
            if k.endswith("lora_B") or (k.endswith("lora_A") and i > 0):
                assert np.any(moved_t) and np.any(moved_j), (i, k)
            elif k.endswith("lora_A"):
                assert not np.any(moved_t) and not np.any(moved_j)
        prev_t, prev_j = st["params"], sj["params"]
    final = hwio(io.flatten(r["weights"]))
    for k, v in r["init"].items():
        if "lora" not in k:  # frozen leaves are untouched
            np.testing.assert_array_equal(final[k], v, err_msg=k)


@pytest.mark.parametrize("fine_tune,milestones,steps_per_epoch", [
    (True, [2], 1), (True, [1, 1, 3], 2), (True, [], 3),
    (False, [1, 2], 1)])
def test_lr_schedule_matches_optax(fine_tune, milestones, steps_per_epoch):
    """The LR at each optimizer step against the schedule mst_tpu's
    trainer builds (trainer.py:457-467): a repeated milestone decays once,
    a decay first applies at step m * steps_per_epoch, and without
    fine_tune the LR is constant."""
    params = train_params(fine_tune=fine_tune, steps=milestones)
    tree = {"w": torch.zeros(3)}
    setup = trainer.setup_training(
        tree, {**params, "train_net": "train", "position": []},
        steps_per_epoch)
    if fine_tune and milestones:
        schedule = optax.piecewise_constant_schedule(LR, {
            m * steps_per_epoch: 0.1 for m in milestones})
    else:
        schedule = optax.constant_schedule(LR)
    for i in range(10):
        lr = setup["optimizer"].param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(schedule(i)), rtol=2e-7,
                                   err_msg=f"step {i}")
        setup["optimizer"].step()
        setup["scheduler"].step()


def test_adam_places_eps_as_optax(rng):
    """Gradients of the size of eps, where eps inside or outside the
    square root would differ: three steps of torch's Adam against
    optax.adam."""
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(scale=1e-8, size=(64,)).astype(np.float32)
             for _ in range(3)]
    opt = optax.adam(LR)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = t(p0).requires_grad_()
    topt = torch.optim.Adam([tp], lr=LR)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = t(g)
        topt.step()
    moved = np.asarray(jp) - p0
    assert np.abs(moved).max() > 0.1 * LR
    np.testing.assert_allclose(tp.detach().numpy() - p0, moved, rtol=1e-4,
                               atol=1e-3 * LR)


def test_padded_rows_change_nothing():
    """The padded row's track moves neither loss."""
    params = train_params()
    step = steps.make_train_step(ynet_config(params), step_config(params))
    weights, _ = init_ynet(torch.Generator().manual_seed(0),
                           ynet_config(params))
    batch = {k: t(v) for k, v in make_batch().items()}
    moved = dict(batch, traj=batch["traj"].clone())
    moved["traj"][-1] = moved["traj"][-1] * 0.5 + 3.0
    with torch.no_grad():
        a = step.forward(weights, {}, batch)
        b = step.forward(weights, {}, moved)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-7)


def test_swap_semantic_train_step_matches_jax(runs):
    """swap_semantic: the port's step against mst_tpu's (metrics and
    gradients), with gradients far from the unswapped run's. (A
    random-init network's losses move by only ~1e-5 relative when two
    channels swap; its LoRA gradients move far more.)"""
    r, plain = runs("mosa_2", swap=True), runs("mosa_2")
    assert_metrics_close(r["torch"][0]["metrics"], r["jax"][0]["metrics"])
    got = r["torch"][0]["grads"]
    assert_grads_close(got, r["jax"][0]["grads"])
    k = "encoder/stages/0/conv0/lora_B"
    unswapped = plain["torch"][0]["grads"][k]
    assert np.abs(got[k] - unswapped).max() > \
        100 * GRAD_TOL * np.abs(unswapped).max()


# ---------------------------------------------------------------------------
# the delta save closes the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_net", ["mosa_2", "train"])
def test_save_params_matches_jax(runs, tmp_path, train_net):
    """After the steps, save_params writes what mst_tpu's
    Experiment.save_params writes for the same weights (keys, shapes,
    HWIO values, the metadata sidecar); mst_tpu loads it strictly."""
    r = runs(train_net)
    params, weights = r["params"], r["weights"]
    port_path = str(tmp_path / "port.npz")
    trainer.save_params(port_path, weights, params)
    exp = Experiment.__new__(Experiment)  # no init: only the save is used
    exp.params, exp.model_params = params, io.unflatten(
        hwio(io.flatten(weights)))
    jax_path = str(tmp_path / "jax.npz")
    exp.save_params(jax_path)
    got, want = jckpt.load_checkpoint(port_path), jckpt.load_checkpoint(
        jax_path)
    assert got.keys() == want.keys()
    if train_net == "mosa_2":
        assert {k.rsplit("/", 1)[-1] for k in got} == {"lora_A", "lora_B"}
        assert {k.split("/")[2] for k in got} == set(POSITIONS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(port_path + ".json") as f, open(jax_path + ".json") as g:
        assert json.load(f) == json.load(g)
    jckpt.overlay_checkpoint(io.unflatten(r["init"]), got, strict=True)


def test_predictor_serves_the_saved_delta(runs, tmp_path):
    """The mosa_2 delta registers with add_style and moves the served
    trajectories, which stay finite and inside the image."""
    r = runs("mosa_2")
    path = str(tmp_path / "delta.npz")
    trainer.save_params(path, r["weights"], r["params"])
    pred = Predictor(get_params("sdd_shortterm_eval.yaml", dict(
        SMALL, train_net="mosa_2", position=POSITIONS)), device="cpu")
    pred.add_style("tuned", path)
    b = make_batch(1)
    observed = b["traj"][:, :8]
    base = pred.predict(b["semantic"], observed, seed=2)["trajectories"]
    tuned = pred.predict(b["semantic"], observed, seed=2,
                         style="tuned")["trajectories"]
    rf = pred.scfg.resize_factor
    assert np.isfinite(tuned).all() and (tuned >= 0).all()
    assert (tuned[..., 0] <= (W - 1) / rf).all()
    assert (tuned[..., 1] <= (H - 1) / rf).all()
    assert np.abs(tuned - base).max() > 0
