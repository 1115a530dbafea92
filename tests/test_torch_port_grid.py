"""python -m mst_tpu_torch.grid on the CPU, on a 2-stage model: a 2 seeds x
2 lrs grid against four runs of the train CLI's flow (the same best
epochs, val histories at 1e-5 relative, saved weights at 1e-4 of each
leaf's max, test ADE/FDE at 1e-5), the vmapped epoch runner against
jax.vmap of mst_tpu's (SGD on both sides), the forced memory split
against the unsplit sweep, the refusals (a seed-specific frozen base,
differently-shaped runs, --mesh_shape), a diverged run reported and
skipped, and the .out logs read by mst_tpu's epoch-curve parser. The
vmapped runs differ from single runs in their last bits (the batched
LoRA weights make grouped convs), hence the bars. The captured grid on the
card is chip_smoke.py's phase 12.
"""

import contextlib
import io as text_io
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.evaluator.logs import extract_epoch_curve
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import fused as jfused
from mst_tpu_torch import config, grid, io
from mst_tpu_torch.data.splits import prepare_dataset
from mst_tpu_torch.ops.sampling import Draws
from mst_tpu_torch.train import fused, optim, trainer
from mst_tpu_torch.utils.seeding import set_random_seeds
from tests.test_torch_port_fused import jax_configs

VAL_RTOL = 1e-5
WEIGHT_TOL = 1e-4  # of each leaf's max
COMMON = ["--config_filename", "synth.yaml", "--batch_size", "5",
          "--dataset_path", "filter/synth", "--load_data", "predefined",
          "--device", "cpu", "--fine_tune", "--train_net", "mosa_2",
          "--position", "0", "1", "--n_epoch", "3", "--n_train_batch", "2",
          "--smooth_val", "--window_size", "1"]
GRID = ["--seeds", "1", "2", "--lrs", "0.01", "0.003"]


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """2 scenes of 10 tracks as jpgs (64 x 96), predefined 14 / 3 / 3
    pickles, synth.yaml with a 2-stage model, and a full base checkpoint
    (the port's init from seed 0)."""
    root = tmp_path_factory.mktemp("grid")
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=10,
                                        total_len=20, img_hw=(64, 96))
    for scene, im in images.items():
        name, idx = scene.split("_")
        d = root / "data/sdd/raw/annotations" / name / f"video{idx}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "reference.jpg"), (im * 255).astype(np.uint8))
    ddir = root / "data/sdd/filter/synth"
    ddir.mkdir(parents=True)
    ids = df.metaId.unique()
    df[df.metaId.isin(ids[:14])].to_pickle(ddir / "train.pkl")
    df[df.metaId.isin(ids[14:17])].to_pickle(ddir / "val.pkl")
    df[df.metaId.isin(ids[17:])].to_pickle(ddir / "test.pkl")
    cfg = config.get_params("sdd_shortterm_train.yaml")
    cfg = {k: cfg[k] for k in ("resize_factor", "waypoints", "temperature",
                               "loss_scale", "kernlen", "nsig",
                               "use_features_only", "e_unfreeze",
                               "use_TTST", "rel_threshold", "use_CWS",
                               "CWS_params", "obs_len", "pred_len",
                               "use_raw_data", "data_dir", "dataset_name")}
    cfg.update(encoder_channels=[8, 8], decoder_channels=[8, 8],
               n_semantic_classes=3, n_goal=4, n_traj=1, save_every_n=100)
    (root / "synth.yaml").write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        trainer.Experiment(config.get_params(
            "synth.yaml", {"device": "cpu", "seed": 0})).save_params(
                "base.npz")
    finally:
        os.chdir(cwd)
    return root


def run_grid(argv):
    buf = text_io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = grid.run_grid(grid.get_parser().parse_args(argv))
    return summary, buf.getvalue()


def loop_run(seed, lr, ckpt):
    """The train CLI's flow for one (seed, lr) -> (Experiment, test ADE,
    test FDE)."""
    args = config.get_parser(True).parse_args(COMMON + [
        "--pretrained_ckpt", "base.npz", "--seed", str(seed), "--lr",
        str(lr), "--ckpt_path", ckpt])
    set_random_seeds(args.seed)
    params = config.get_params(args=args)
    image_path, data_path = config.get_image_and_data_path(params)
    tr, va, te = prepare_dataset(
        data_path, args.load_data, args.batch_size, args.n_train_batch,
        args.train_files, args.val_files, args.val_split, args.test_splits,
        args.shuffle, args.share_val_test, "train", False)
    name = config.get_experiment_name(args, tr.meta_ids().shape[0])
    with contextlib.redirect_stdout(text_io.StringIO()):
        exp = trainer.Experiment(params)
        exp.load_params("base.npz")
        exp.train(tr, va, image_path, image_path, name)
        set_random_seeds(args.seed)
        ade, fde, _, _ = exp.test(te, image_path)
    return exp, ade, fde, name


def assert_npz_close(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in y.files:
            np.testing.assert_allclose(
                x[k], y[k], rtol=0, atol=WEIGHT_TOL * np.abs(y[k]).max(),
                err_msg=k)


def assert_runs_close(got, want):
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["val_ADE"]) == len(want["val_ADE"])
    np.testing.assert_allclose(got["val_ADE"] + got["val_FDE"],
                               want["val_ADE"] + want["val_FDE"],
                               rtol=VAL_RTOL)


@pytest.fixture(scope="module")
def swept(workdir):
    """The 2 x 2 grid (with --log_dir) -> (summary, stdout)."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return run_grid(COMMON + GRID + ["--pretrained_ckpt", "base.npz",
                                         "--ckpt_path", "grid",
                                         "--log_dir", "logs"])
    finally:
        os.chdir(cwd)


def test_grid_matches_individual_runs(workdir, swept, monkeypatch):
    monkeypatch.chdir(workdir)
    summary, _ = swept
    assert [(s["seed"], s["lr"]) for s in summary] == [
        (1, 0.01), (2, 0.01), (1, 0.003), (2, 0.003)]
    for s in summary:
        exp, ade, fde, name = loop_run(s["seed"], s["lr"], "loop")
        assert name == s["name"]
        assert_runs_close(s, {"best_epoch": exp.best_epoch,
                              "val_ADE": exp.val_ADE,
                              "val_FDE": exp.val_FDE})
        np.testing.assert_allclose([s["ade"], s["fde"]], [ade, fde],
                                   rtol=VAL_RTOL)
        assert_npz_close(f"grid/{name}.npz", f"loop/{name}.npz")


def test_out_logs_parse_with_mst_tpu(workdir, swept):
    """Each run's <name>.out holds its epoch lines in the train CLI's
    format: mst_tpu's extract_epoch_curve reads the val history back."""
    summary, text = swept
    for s in summary:
        log = (workdir / "logs" / f"{s['name']}.out").read_text()
        curve = extract_epoch_curve(log)
        assert list(curve.epoch) == list(range(3))
        np.testing.assert_allclose(curve.val_ade, s["val_ADE"], atol=5e-3)
        assert f"Best epoch at {s['best_epoch']}" in log
        assert log in text


def test_forced_split_equals_unsplit(workdir, swept, monkeypatch):
    """A memory error forced after the first 1-epoch chunk of the 4-run
    program splits it into two 2-run programs that resume at epoch 1: the
    same selections, val histories and saved weights as the unsplit sweep,
    at the grid's bars."""
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("MST_GRID_FORCE_OOM_ABOVE", "2")
    monkeypatch.setenv("MST_GRID_CHUNK_CAP", "1")
    split, text = run_grid(COMMON + GRID + [
        "--pretrained_ckpt", "base.npz", "--ckpt_path", "split"])
    assert "4-run program exhausted device memory at epoch 1" in text
    for got, want in zip(split, swept[0]):
        assert got["name"] == want["name"]
        assert_runs_close(got, want)
        assert_npz_close(f"split/{got['name']}.npz",
                         f"grid/{want['name']}.npz")


def test_vmapped_runner_matches_jax_vmap(workdir, monkeypatch):
    """torch.func.vmap of the port's epoch runner over 2 runs (their own
    lrs and batch orders, SGD) against jax.vmap of mst_tpu's, 2 epochs:
    every step's loss and the train sums at 1e-5 relative, the runs'
    trainable leaves at 1e-4 of each leaf's max."""
    monkeypatch.chdir(workdir)
    params = config.get_params("synth.yaml", {
        "device": "cpu", "seed": 1, "train_net": "mosa_2",
        "dataset_path": "filter/synth", "lr": 0.1,
        "position": ["0", "1"], "batch_size": 5, "fine_tune": True})
    exp = trainer.Experiment(params)
    exp.load_params("base.npz")
    image_path, data_path = config.get_image_and_data_path(params)
    tr_t, va_t, _ = prepare_dataset(data_path, "predefined", 5, None, None,
                                    None, None, None, False, False)
    setup = exp._setup_training(tr_t, va_t, image_path, image_path,
                                np.random.default_rng(1))
    tr, va, _ = exp._fused_pack(setup["train_items"], setup["val_items"])
    n = tr[0]["traj"].shape[0]
    perms = np.stack([[np.random.default_rng(10 * r + e).permutation(n)
                       for e in range(2)] for r in range(2)])
    lrs = np.asarray([0.5, 0.2], np.float32)
    flat = io.flatten(exp.model_params)
    trainable = {k: torch.stack([v.detach()] * 2) for k, v in flat.items()
                 if v.requires_grad}
    frozen = {k: v.detach() for k, v in flat.items() if not v.requires_grad}
    run = torch.func.vmap(fused.make_epoch_runner(
        exp.mcfg, config.step_config(params),
        config.step_config(params, for_validation=True), optim.sgd),
        in_dims=(0, None, 0, 0, 0, 0, 0, 0, 0))
    stack = grid.stack_trees
    tr_d = stack([fused.stage_data(*tr, "cpu")] * 2)
    va_d = stack([fused.stage_data(*va, "cpu")] * 2)
    rec = Draws(generator=torch.Generator().manual_seed(0))
    exp._eval_step(for_validation=True)(
        exp.model_params, {}, fused.index_batch(fused.stage_data(*va, "cpu"),
                                                torch.tensor([0])), rec)
    opt = {"count": torch.zeros(2, dtype=torch.int32)}
    state, got = {}, []
    for e in range(2):
        noise = [[torch.rand((2, *t.shape)) + 0.5 for t in rec.drawn]
                 for _ in range(va[0]["traj"].shape[0])]
        trainable, state, opt, stats, _ = run(
            trainable, frozen, state, opt, torch.as_tensor(perms[:, e]),
            noise, torch.as_tensor(lrs), tr_d, va_d)
        got.append((stats.numpy(), {k: v.clone() for k, v in
                                    trainable.items()}))

    jmcfg, jscfg = jax_configs(params)
    jw = io.unflatten(io.params_to_numpy(flat))
    mask = jfreeze.trainable_mask(jw, "mosa_2", ["0", "1"])
    jtr, jfr = jfreeze.split_params(jax.tree.map(jnp.asarray, jw), mask)
    jtr2 = jax.tree.map(lambda x: jnp.stack([x] * 2), jtr)
    jrun = jax.jit(jax.vmap(
        jfused.make_epoch_runner(jmcfg, jscfg, jscfg, optax.sgd),
        in_axes=(0, None, 0, 0, 0, None, 0, 0, 0, 0)))
    jdata = [jax.tree.map(lambda x: jnp.stack([x] * 2),
                          jfused.stage_data(None, *p)) for p in (tr, va)]
    _, ys = jrun(jtr2, jfr, {}, jax.vmap(optax.sgd(0.1).init)(jtr2),
                 jnp.asarray(perms, jnp.int32),
                 jnp.arange(2, dtype=jnp.int32),
                 jnp.stack([jax.random.PRNGKey(0)] * 2), jnp.asarray(lrs),
                 *jdata)
    for e, (stats, snap) in enumerate(got):
        np.testing.assert_allclose(stats[:, :, 0],
                                   np.asarray(ys["losses"][:, e]),
                                   rtol=VAL_RTOL)
        np.testing.assert_allclose(stats[:, :, 1].sum(1),
                                   np.asarray(ys["train_ade_sum"][:, e]),
                                   rtol=VAL_RTOL)
        want = {k: np.asarray(v[:, e]) for k, v in
                jckpt.flatten_tree(ys["snapshot"]).items()}
        for r in range(2):
            mine = io.params_to_numpy({k: v[r] for k, v in snap.items()})
            for k, w in want.items():
                np.testing.assert_allclose(
                    mine[k], w[r], rtol=0,
                    atol=WEIGHT_TOL * np.abs(w[r]).max(), err_msg=k)


def test_grid_refusals(workdir, monkeypatch):
    """No full base checkpoint: each seed's own random frozen base, which
    the grid refuses to share; seeds whose few-shot subsets batch to
    different shapes; a --mesh_shape that is not the world (2 in a world
    of 1); the spatial mesh (--mesh_axes data space), not ported."""
    monkeypatch.chdir(workdir)
    with pytest.raises(SystemExit, match="frozen parameters"):
        run_grid(COMMON + GRID + ["--ckpt_path", "refused"])
    argv = list(COMMON)
    argv[argv.index("--n_train_batch") + 1] = "1"
    with pytest.raises(SystemExit, match="differently-shaped data"):
        # --shuffle draws each seed's 5 tracks: seed 11's all come from one
        # scene (1 batch), seed 1's from both (2 batches)
        run_grid(argv + ["--shuffle", "--pretrained_ckpt", "base.npz",
                         "--seeds", "1", "11", "--ckpt_path", "refused"])
    with pytest.raises(ValueError, match="mesh_shape 2 spans 2 ranks"):
        run_grid(COMMON + GRID + ["--pretrained_ckpt", "base.npz",
                                  "--mesh_shape", "2"])
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        run_grid(COMMON + GRID + ["--pretrained_ckpt", "base.npz",
                                  "--mesh_shape", "2", "2", "--mesh_axes",
                                  "data", "space"])


def test_diverged_run_is_skipped(workdir, monkeypatch):
    """A learning rate that drives the loss to non-finite values: the run
    is reported and skipped (no checkpoint, NaN test metrics), the other
    run completes."""
    monkeypatch.chdir(workdir)
    summary, text = run_grid(COMMON + [
        "--pretrained_ckpt", "base.npz", "--seeds", "1", "--lrs", "0.01",
        "1e30", "--ckpt_path", "diverged"])
    assert "[grid] run diverged: non-finite loss at epoch" in text
    ok, bad = summary
    assert math.isfinite(ok["ade"]) and math.isnan(bad["ade"])
    assert os.path.exists(f"diverged/{ok['name']}.npz")
    assert not os.path.exists(f"diverged/{bad['name']}.npz")
