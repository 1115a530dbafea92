"""--fused on the CPU against the loop and against mst_tpu.train.fused, on a
2-stage model: chunk_size, Selection and replay_selection exactly;
pack_batches field by field; three epochs of the port's epoch runner (the
grid's functional form) against mst_tpu's make_epoch_runner with the same
permutations, both on SGD (as tests/test_torch_port_experiment.py runs
the loop: Adam's first update is ~lr * sign(g), which rounding flips
where g is near 0); the learning rate's schedule against MultiStepLR;
Experiment.train(fused=True) against the loop bit for bit (plain,
smooth-val with an early stop mid-chunk, a serial adapter with its batch
norm state); --fused + --resume against an uninterrupted fused run; and
each ineligible run falling back with mst_tpu's reason. The CUDA-graph
capture of the same epochs is chip_smoke.py's phase 12.
"""

import ast
import dataclasses
import inspect
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.models import ynet as jynet
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import fused as jfused
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import config, io
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.models import unet
from mst_tpu_torch.ops.sampling import Draws
from mst_tpu_torch.train import fused, optim, trainer

SMALL = dict(encoder_channels=[8, 8], decoder_channels=[8, 8],
             n_semantic_classes=3, n_goal=4, n_traj=1, batch_size=4)
POSITIONS = ["0", "1"]
LOSS_RTOL = 1e-5  # per-step losses and train sums, relative
SNAP_TOL = 1e-4   # snapshots, of each leaf's max


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """2 scenes of 10 tracks (64 x 96 images), split 12 / 4 / 4: the JAX
    package's frames, the port's tables, the images."""
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=10,
                                        img_hw=(64, 96))
    ids = np.random.default_rng(0).permutation(df.metaId.unique())
    frames = {name: df[df.metaId.isin(part)] for name, part in
              (("train", ids[:12]), ("val", ids[12:16]), ("test", ids[16:]))}
    return frames, {k: Tracks.from_frame(v) for k, v in frames.items()}, \
        images


def params_for(tmp_path, **over):
    return config.get_params("sdd_shortterm_train.yaml", {
        **SMALL, "train_net": "mosa_2", "position": POSITIONS, "lr": 1e-2,
        "seed": 1, "device": "cpu", "fine_tune": True, "n_epoch": 4,
        "save_every_n": 2, "ckpt_path": str(tmp_path / "ckpts"), **over})


def train(params, data, **over):
    exp = trainer.Experiment({**params, **over}, images=data[2])
    exp.train(data[1]["train"], data[1]["val"], None, None, "exp")
    return exp


def assert_bit_equal(a, b, first=0):
    """a's run against b's, bit for bit: the epoch records from epoch
    `first` on (a resumed run logs only those), the val histories, the best
    epoch, the final leaves and model state."""
    for k in ("loss", "train_ade", "train_fde"):
        assert [r[k] for r in a.epoch_log] == \
            [r[k] for r in b.epoch_log[first:]], k
    assert a.val_ADE == b.val_ADE and a.val_FDE == b.val_FDE
    assert a.best_epoch == b.best_epoch
    wa, wb = io.flatten(a.model_params), io.flatten(b.model_params)
    assert wa.keys() == wb.keys()
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k
    sa, sb = io.flatten(a.model_state), io.flatten(b.model_state)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_chunk_size_and_selection_match_mst_tpu():
    for n in list(range(1, 70)) + [97, 121, 128, 1000]:
        for cap in (1, 4, 32):
            assert fused.chunk_size(n, cap) == jfused.chunk_size(n, cap)
    rng = np.random.default_rng(3)
    for trial in range(40):
        vals = list(rng.normal(50, 3, size=rng.integers(1, 30)))
        kw = dict(smooth_val=bool(trial % 2),
                  window_size=int(rng.integers(1, 6)),
                  fine_tune=bool(trial % 3),
                  n_early_stop=int(rng.integers(1, 8)))
        assert fused.replay_selection(vals, **kw) == \
            jfused.replay_selection(vals, **kw)
        a, b = fused.Selection(**kw), jfused.Selection(**kw)
        for e, v in enumerate(vals):
            assert a.step(e, v) == b.step(e, v)
            assert a.live_snapshots() == b.live_snapshots()
            assert (a.best, a.best_epoch, a.best_snap) == \
                (b.best, b.best_epoch, b.best_snap)


def test_pack_batches_match_mst_tpu(tmp_path, data):
    """The same scene batches through both packages' pack_batches: every
    field equal, with and without homographies; None for an empty list,
    for batches of two shapes and for cross-scene batches, in both."""
    exp = trainer.Experiment(params_for(tmp_path), images=data[2])
    batches = exp.prepare_data(data[1]["train"], None, "train",
                               rng=np.random.default_rng(0))

    def sem(b):
        return b.image[None] * 2.0

    def hom(scene):
        return np.eye(3) * (1 + len(scene))

    for h in (None, hom):
        got, want = fused.pack_batches(batches, sem, h), \
            jfused.pack_batches(batches, sem, h)
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
            assert got[0][k].dtype == want[0][k].dtype, k
        np.testing.assert_array_equal(got[1], want[1])
    other = trainer.Experiment(params_for(tmp_path), images={
        k: v[:32] for k, v in data[2].items()}).prepare_data(
            data[1]["train"], None, "train")
    bucketed = trainer.Experiment(params_for(
        tmp_path, cross_scene_batching=True), images=data[2]).prepare_data(
            data[1]["train"], None, "train", rng=np.random.default_rng(0))
    shrunk = dataclasses.replace(other[0], scene_id="synth_small")
    for bad in ([], batches + [shrunk], bucketed):
        assert fused.pack_batches(bad, sem) is None
        assert jfused.pack_batches(bad, sem) is None


def jax_configs(params):
    scfg = config.step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=tuple(SMALL["encoder_channels"]),
        decoder_channels=tuple(SMALL["decoder_channels"]),
        waypoints=tuple(params["waypoints"]), train_net=params["train_net"],
        position=tuple(params["position"]))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=tuple(params["waypoints"]),
        template_size=scfg.template_size, kernlen=scfg.kernlen,
        nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False)
    return jmcfg, jscfg


def test_epoch_runner_matches_mst_tpu(tmp_path, data):
    """Three epochs of make_epoch_runner (the port one epoch a call) from
    the same weights, packs and permutations, SGD on both sides: each
    step's loss and the epochs' train sums at 1e-5 relative, each epoch's
    trainable leaves at 1e-4 of the leaf's max. The validation draws come
    from different generators, so only their rows' shapes and finiteness
    are compared."""
    params = params_for(tmp_path)
    exp = trainer.Experiment(params, images=data[2])
    batches = exp.prepare_data(data[1]["train"], None, "train",
                               rng=np.random.default_rng(0))
    vbatches = exp.prepare_data(data[1]["val"], None, "val")
    trainer.setup_training(exp.model_params, params, len(batches))

    def sem(b):
        return b.image[None]

    tr, va = fused.pack_batches(batches, sem), fused.pack_batches(
        vbatches, sem)
    n = len(batches)
    perms = np.stack([np.random.default_rng(e).permutation(n)
                      for e in range(3)]).astype(np.int32)
    lr = 0.5
    flat = io.flatten(exp.model_params)
    trainable = {k: v.detach().clone() for k, v in flat.items()
                 if v.requires_grad}
    frozen = {k: v.detach() for k, v in flat.items() if not v.requires_grad}
    run = fused.make_epoch_runner(
        exp.mcfg, config.step_config(params),
        config.step_config(params, for_validation=True), optim.sgd)
    opt_state = optim.sgd(torch.tensor(lr)).init(trainable)
    tr_d, va_d = fused.stage_data(*tr, "cpu"), fused.stage_data(*va, "cpu")
    rec = Draws(generator=torch.Generator().manual_seed(0))
    exp._eval_step(for_validation=True)(
        exp.model_params, {}, fused.index_batch(va_d, torch.tensor([0])),
        rec)
    state, got = {}, []
    for e in range(3):
        noise = [[torch.rand(t.shape) + 0.5 for t in rec.drawn]
                 for _ in range(va[0]["traj"].shape[0])]
        trainable, state, opt_state, stats, val = run(
            trainable, frozen, state, opt_state,
            torch.as_tensor(perms[e]).long(), noise, torch.tensor(lr), tr_d,
            va_d)
        assert val.shape == (va[0]["traj"].shape[0], 3, SMALL["batch_size"])
        assert torch.isfinite(val).all()
        got.append((stats.numpy(), io.params_to_numpy(
            {k: v.clone() for k, v in trainable.items()})))
    assert int(opt_state["count"]) == 3 * n

    jmcfg, jscfg = jax_configs(params)
    jw = io.unflatten(io.params_to_numpy(flat))
    mask = jfreeze.trainable_mask(jw, "mosa_2", POSITIONS)
    jtr, jfr = jfreeze.split_params(jax.tree.map(jnp.asarray, jw), mask)
    jrun = jfused.make_epoch_runner(jmcfg, jscfg, jscfg, optax.sgd)
    (_, _, _), ys = jax.jit(jrun)(
        jtr, jfr, {}, optax.sgd(lr).init(jtr), jnp.asarray(perms),
        jnp.arange(3, dtype=jnp.int32), jax.random.PRNGKey(0),
        jnp.float32(lr), jfused.stage_data(None, *tr),
        jfused.stage_data(None, *va))
    for e, (stats, snap) in enumerate(got):
        np.testing.assert_allclose(stats[:, 0], np.asarray(ys["losses"][e]),
                                   rtol=LOSS_RTOL)
        for i, k in ((1, "train_ade_sum"), (2, "train_fde_sum"),
                     (3, "train_n")):
            np.testing.assert_allclose(stats[:, i].sum(),
                                       float(ys[k][e]), rtol=LOSS_RTOL)
        want = {k: np.asarray(v[e]) for k, v in
                jckpt.flatten_tree(ys["snapshot"]).items()}
        assert snap.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(snap[k], w, rtol=0, atol=SNAP_TOL
                                       * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("steps,spe", [([2], 1), ([1, 1, 3], 2), ([], 3)])
def test_lr_schedule_matches_multisteplr(steps, spe):
    """The device-side schedule at each step against MultiStepLR over the
    distinct milestones m * steps_per_epoch (a repeated milestone decays
    once, as optax's dict schedule does), f32 against float64."""
    params = config.get_params("sdd_shortterm_train.yaml", {
        "fine_tune": True, "steps": steps, "lr": 3e-3,
        "lr_decay_ratio": 0.5, "train_net": "train", "position": []})
    setup = trainer.setup_training({"w": torch.zeros(3)}, params, spe)
    ref = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=3e-3)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        ref, sorted({m * spe for m in steps}), gamma=0.5)
    for i in range(12):
        np.testing.assert_allclose(float(setup["optimizer"].lr()),
                                   ref.param_groups[0]["lr"], rtol=2e-7,
                                   err_msg=f"step {i}")
        setup["optimizer"].step()
        ref.step()
        sched.step()
    assert int(setup["optimizer"].count) == 12


@pytest.mark.parametrize("case,over", [
    ("plain", dict(save_every_n=2)),
    ("smooth_early_stop", dict(smooth_val=True, window_size=1,
                               n_early_stop=1, lr=0.3, n_epoch=6,
                               save_every_n=4)),
    ("serial", dict(train_net="serial", position=["1"], lr=3e-2))])
def test_fused_train_equals_loop(tmp_path, data, case, over, capsys):
    """Experiment.train with --fused on the CPU (the same epochs, eager)
    against the loop: the same losses, val histories, best epoch, final
    leaves and model state, bit for bit; the smooth-val case stops early
    inside its first 4-epoch chunk and rolls back to that epoch."""
    loop = train(params_for(tmp_path / "loop", **over), data)
    out = capsys.readouterr().out
    got = train(params_for(tmp_path / "fused", **over), data, fused=True)
    assert got.fused_runner is not None
    assert_bit_equal(got, loop)
    if case == "smooth_early_stop":
        stop = re.search(r"Early stop at epoch (\d+)", out)
        assert stop and int(stop.group(1)) < 3
        assert len(got.epoch_log) == int(stop.group(1)) + 1
    if case == "serial":
        assert io.flatten(got.model_state)


def test_fused_resume_equals_uninterrupted(tmp_path, data):
    """A 2-epoch fused run, then --resume to 4 epochs, against 4 fused
    epochs: the same histories, best epoch and leaves, bit for bit."""
    params = params_for(tmp_path / "a", smooth_val=True, window_size=1,
                        steps=[1])
    whole = train(params, data, fused=True)
    half = params_for(tmp_path / "b", smooth_val=True, window_size=1,
                      steps=[1])
    train(half, data, fused=True, n_epoch=2)
    resumed = train(half, data, fused=True, resume=True)
    assert [r["epoch"] for r in resumed.epoch_log] == [2, 3]
    assert_bit_equal(resumed, whole, first=2)


def test_ineligible_runs_fall_back(tmp_path, data, capsys):
    """Each ineligible case gives mst_tpu's reason (its _fused_pack's own
    strings), and train() prints its fallback and runs the loop."""
    reasons_of_mst_tpu = {
        node.value for node in ast.walk(ast.parse(textwrap.dedent(
            inspect.getsource(jtrainer.Experiment._fused_pack))))
        if isinstance(node, ast.Constant) and isinstance(node.value, str)}
    seg = tmp_path / "seg.npz"
    np.savez(seg, **io.params_to_numpy(unet.unet_init(
        torch.Generator().manual_seed(0), n_classes=3,
        layers=(1, 1, 1, 1))))
    cases = {
        "segment_in_step": dict(segmentation_model_fp=str(seg),
                                train_net="segmentation_head"),
        "e_unfreeze": dict(segmentation_model_fp=str(seg), e_unfreeze=1,
                           train_net="train"),
        "cross_scene": dict(cross_scene_batching=True),
    }
    reasons = {}
    for name, over in cases.items():
        exp = trainer.Experiment(params_for(tmp_path, **over),
                                 images=data[2])
        items = exp._device_batches(exp.prepare_data(
            data[1]["train"], None, "train", rng=np.random.default_rng(0)))
        vitems = exp._device_batches(exp.prepare_data(
            data[1]["val"], None, "val"))
        reasons[name] = exp._fused_pack(items, vitems)
    two = trainer.Experiment(params_for(tmp_path), images={
        "synth_0": data[2]["synth_0"], "synth_1": data[2]["synth_1"][:32]})
    reasons["two_shapes"] = two._fused_pack(
        two._device_batches(two.prepare_data(data[1]["train"], None,
                                             "train")),
        two._device_batches(two.prepare_data(data[1]["val"], None, "val")))
    reasons["empty_split"] = two._fused_pack(two._device_batches(
        two.prepare_data(data[1]["train"], None, "train")), [])
    for name, (tr, va, why) in reasons.items():
        assert tr is None and va is None, name
        assert why in reasons_of_mst_tpu, (name, why)
    assert reasons["segment_in_step"][2] == \
        "segmentation runs inside the train step"
    assert reasons["e_unfreeze"][2] == \
        "e_unfreeze switches programs mid-training"
    shape_reason = ("scene batches span multiple (H, W) shape buckets, are "
                    "cross-scene bucketed, or a split is empty")
    for name in ("cross_scene", "two_shapes", "empty_split"):
        assert reasons[name][2] == shape_reason
    capsys.readouterr()
    exp = train(params_for(tmp_path, cross_scene_batching=True, n_epoch=1),
                data, fused=True)
    assert f"--fused unavailable ({shape_reason}); using the epoch loop" \
        in capsys.readouterr().out
    assert exp.fused_runner is None and len(exp.epoch_log) == 1
