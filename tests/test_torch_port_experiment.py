"""The port's Experiment loop and CLIs against mst_tpu on the CPU: the
checkpoints both ways, the loop's policy (scratch train and a mosa_2
fine-tune with smooth-val, a milestone and an early stop), test()'s rounds
and metrics rows, the eval_k_chunk shrink ladder, the unported flags, and
the verify skill's three CLI flows with --device cpu.

Both packages get the same weights (the port's init through
io.params_to_numpy) and the same in-memory synthetic scenes; mst_tpu's
train step runs unpacked (packed_decode=False), the math the port
implements. Two substitutions make the loop comparable step for step:
- validation is the same scripted ADE sequence in both (`_evaluate` is
  replaced), since the two packages' samplers draw from different
  generators;
- both optimizers are SGD (torch.optim.Adam -> SGD, optax.adam ->
  optax.sgd), as tests/test_trainer_policy_parity.py does: Adam's first
  update is ~lr * sign(g), which flips on rounding where g is near 0, so
  weights under Adam drift apart by 2 lr per element and step; one Adam
  step against optax is held in tests/test_torch_port_train.py.
"""

import json
import os
import pathlib
import re

import cv2
import numpy as np
import optax
import pytest
import torch
import yaml

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import config, io
from mst_tpu_torch import test as test_cli
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.train import trainer
from mst_tpu_torch.train.__main__ import main as train_main

SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             n_goal=4, n_traj=1)
POSITIONS = ["0", "1", "2", "3", "4"]
LOSS_RTOL = 1e-5  # per-epoch losses and train ADE/FDE, relative
PARAM_TOL = 1e-4  # final parameters, relative to each leaf's max |w|
# the scratch run: the best epoch is 1, so the weights roll back from 2
SCRATCH_SCRIPT = [50.0, 44.0, 46.0]
# the fine-tune (smooth_val, window 3, n_early_stop 2): the windowed
# mean's best is at epoch 5 (best epoch 4, half a window back), the stop
# at epoch 7, where 35.5 < min(37, 40)
FINETUNE_SCRIPT = [50.0, 44.0, 39.0, 36.0, 35.0, 35.5, 37.0, 40.0, 44.0,
                   48.0]


@pytest.fixture(scope="module")
def data():
    """2 scenes of 10 tracks (128 x 192 images), split 12 / 4 / 4: the
    JAX package's DataFrames and images, and the port's tables."""
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=10,
                                        img_hw=(128, 192))
    ids = np.random.default_rng(0).permutation(df.metaId.unique())
    frames = {name: df[df.metaId.isin(part)] for name, part in
              (("train", ids[:12]), ("val", ids[12:16]), ("test", ids[16:]))}
    tables = {k: Tracks.from_frame(v) for k, v in frames.items()}
    return frames, tables, images


def loop_params(tmp_path, train_net="train", **over):
    return config.get_params("sdd_shortterm_train.yaml", {
        **SMALL, "train_net": train_net,
        "position": POSITIONS if "mosa" in train_net else [],
        "batch_size": 4, "lr": 1e-3, "seed": 1, "device": "cpu",
        "ckpt_path": str(tmp_path / "ckpts"), "save_every_n": 2,
        "metrics_jsonl": str(tmp_path / "metrics.jsonl"), **over})


def hwio(port):
    """Copies of the port's weights in the JAX layout (params_to_numpy's
    arrays may share the tensors' memory, which training updates)."""
    return {k: v.copy() for k, v in
            io.params_to_numpy(io.flatten(port.model_params)).items()}


def flat_numpy(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_tree(tree).items()}


def pair(params, images, base=None, jax_params=None):
    """The port's Experiment and mst_tpu's (on jax_params, else params) on
    the same weights: the port's init, or the checkpoint `base` loaded in
    both."""
    port = trainer.Experiment(params, images=images)
    jexp = jtrainer.Experiment(jax_params or params, images=images)
    jexp.model_params = jckpt.overlay_checkpoint(
        jexp.model_params, hwio(port), strict=True)
    if base is not None:
        port.load_params(base)
        jexp.load_params(base)
    return port, jexp


def assert_params_close(port, jexp, tol=PARAM_TOL):
    got = hwio(port)
    want = flat_numpy(jexp.model_params)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-12),
                                   err_msg=k)


def scripted(script):
    """A stand-in for _evaluate returning script[i] on its i-th call."""
    calls = iter(script)

    def evaluate(*args, **kwargs):
        ade = next(calls)
        return ade, ade * 1.1, {}, None

    return evaluate


def run_policy(tmp_path, monkeypatch, capsys, data, train_net, script,
               train_part="train", base=None, **over):
    """Both packages' train() with the scripted validation and SGD ->
    (port Experiment, mst_tpu Experiment, {side: (epoch records, stdout,
    files written)})."""
    frames, tables, images = data
    monkeypatch.setattr(torch.optim, "Adam",
                        lambda params, lr: torch.optim.SGD(params, lr=lr))
    monkeypatch.setattr(optax, "adam", optax.sgd)
    step_config = jtrainer.Experiment._step_config
    monkeypatch.setattr(
        jtrainer.Experiment, "_step_config", lambda self, *a, **k:
        step_config(self, *a, **k)._replace(packed_decode=False))
    out = {}
    params = {side: loop_params(tmp_path / side, train_net,
                                n_epoch=len(script), **over)
              for side in ("port", "jax")}
    port, jexp = pair(params["port"], images, base, params["jax"])
    for side, exp, split in (("port", port, tables), ("jax", jexp, frames)):
        exp._evaluate = scripted(script)
        capsys.readouterr()
        exp.train(split[train_part], split["val"], None, None, "exp")
        with open(tmp_path / side / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        files = sorted(f for f in os.listdir(tmp_path / side / "ckpts")
                       if "__train_state" not in f)
        out[side] = (records, capsys.readouterr().out, files)
    return port, jexp, out


def assert_same_policy(out, best, stop):
    (got, got_out, got_files), (want, want_out, want_files) = \
        out["port"], out["jax"]
    assert len(got) == len(want) == stop + 1
    for g, w in zip(got, want):
        for k in ("loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {w['epoch']} {k}")
        assert (g["val_ade"], g["val_fde"]) == (w["val_ade"], w["val_fde"])
    for text in (got_out, want_out):
        assert re.search(r"Best epoch at (\d+)", text).group(1) == str(best)
    assert ("Early stop at epoch" in got_out) == \
        ("Early stop at epoch" in want_out)
    # mst_tpu also writes a __train_state for --resume, which is not ported
    assert got_files == want_files


@pytest.fixture(scope="module")
def scratch_base(tmp_path_factory, data):
    """A scratch base checkpoint for the fine-tune tests (the port's init
    weights, saved by the port)."""
    path = tmp_path_factory.mktemp("base") / "base.npz"
    exp = trainer.Experiment(loop_params(path.parent), images=data[2])
    exp.save_params(str(path))
    return str(path)


def test_scratch_train_policy_matches_jax(tmp_path, monkeypatch, capsys,
                                         data):
    """train_net train with augmentation, 3 epochs: the best-weights save on
    each new best, the epoch-1 save (save_every_n 2), the roll back to
    epoch 1's weights, the final save."""
    port, jexp, out = run_policy(tmp_path, monkeypatch, capsys, data,
                                 "train", SCRATCH_SCRIPT, augment=True,
                                 lr=1e-4, batch_size=8)
    assert_same_policy(out, best=1, stop=2)
    assert out["port"][2] == sorted(
        f"exp{s}{ext}" for s in ("", "_weights", "__epoch_1")
        for ext in (".npz", ".npz.json"))
    # augmentation makes 16 scenes of the 2, each with one batch
    assert [r["n_steps"] for r in out["port"][0]] == [16] * 3
    assert_params_close(port, jexp)
    assert port.best_epoch == 1


def test_finetune_policy_matches_jax(tmp_path, monkeypatch, capsys, data,
                                     scratch_base):
    """mosa_2 fine-tune with smooth_val (window 3), a milestone at epoch 2
    and n_early_stop 2: the same smooth-val best epoch, the same early
    stop, the delta saves only (no best-weights save when fine-tuning) and
    the roll back to the windowed best."""
    port, jexp, out = run_policy(
        tmp_path, monkeypatch, capsys, data, "mosa_2", FINETUNE_SCRIPT,
        base=scratch_base, fine_tune=True, smooth_val=True, window_size=3,
        n_early_stop=2, steps=[2], lr=3e-3)
    assert_same_policy(out, best=4, stop=7)
    assert "Early stop at epoch 7" in out["port"][1]
    assert out["port"][2] == sorted(
        f"exp{s}{ext}" for s in ("", "__epoch_1", "__epoch_3", "__epoch_5",
                                 "__epoch_7")
        for ext in (".npz", ".npz.json"))
    assert_params_close(port, jexp)
    with np.load(tmp_path / "port" / "ckpts" / "exp.npz") as z:
        assert sorted(z.files) == sorted(
            k for k in flat_numpy(jexp.model_params) if "lora_" in k)


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------

def randomize(jexp, seed):
    """Give every leaf of mst_tpu's model new values (lora_B included, which
    starts at 0)."""
    rng = np.random.default_rng(seed)
    flat = {k: rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            for k, v in flat_numpy(jexp.model_params).items()}
    jexp.model_params = jckpt.overlay_checkpoint(jexp.model_params, flat,
                                                 strict=True)


def test_jax_checkpoints_load_in_the_port(tmp_path, data):
    """mst_tpu's Experiment.save_params files, whole and delta, load in
    the port: load_params and load_separated_params agree with mst_tpu's
    load_params and load_separated."""
    images = data[2]
    base_params = loop_params(tmp_path)
    _, jbase = pair(base_params, images)
    randomize(jbase, 0)
    jbase.save_params(str(tmp_path / "base.npz"))
    port = trainer.Experiment(base_params, images=images)
    port.load_params(str(tmp_path / "base.npz"))
    assert_params_close(port, jbase, tol=0)

    ft = loop_params(tmp_path, "mosa_2")
    _, jft = pair(ft, images)
    randomize(jft, 1)
    jft.save_params(str(tmp_path / "delta.npz"))
    with np.load(tmp_path / "delta.npz") as z:
        assert z.files and all("lora_" in k for k in z.files)
    port = trainer.Experiment(ft, images=images)
    port.load_separated_params(str(tmp_path / "base.npz"),
                               str(tmp_path / "delta.npz"))
    jsep = jtrainer.restore_model(ft, True, str(tmp_path / "base.npz"),
                                  str(tmp_path / "delta.npz"))
    assert_params_close(port, jsep, tol=0)


def test_port_checkpoints_load_in_jax(tmp_path, data):
    """The port's whole and delta files load in mst_tpu's restore_model,
    monolithic and separated, and in the port's."""
    images = data[2]
    base_params = loop_params(tmp_path)
    port = trainer.Experiment(base_params, images=images)
    port.save_params(str(tmp_path / "base.npz"))
    assert_params_close(port, jtrainer.restore_model(
        base_params, False, str(tmp_path / "base.npz")), tol=0)

    ft = loop_params(tmp_path, "mosa_2")
    tuned = trainer.Experiment(ft, images=images)
    tuned.load_params(str(tmp_path / "base.npz"))
    with torch.no_grad():
        for k, v in io.flatten(tuned.model_params).items():
            if k.endswith("lora_B"):
                v.normal_(generator=torch.Generator().manual_seed(2))
    tuned.save_params(str(tmp_path / "delta.npz"))
    meta = json.loads((tmp_path / "delta.npz.json").read_text())
    assert meta["train_net"] == "mosa_2" and meta["position"] == POSITIONS
    with np.load(tmp_path / "delta.npz") as z:
        assert len(z.files) == 18 and all("lora_" in k for k in z.files)
    for restore in (jtrainer.restore_model, trainer.restore_model):
        restored = restore(base_params, True, str(tmp_path / "base.npz"),
                           str(tmp_path / "delta.npz"))
        if isinstance(restored, trainer.Experiment):
            for k, v in io.flatten(restored.model_params).items():
                torch.testing.assert_close(
                    v, io.flatten(tuned.model_params)[k], rtol=0, atol=0)
        else:
            assert_params_close(tuned, restored, tol=0)


# ---------------------------------------------------------------------------
# test(), the eval streams and the shrink ladder
# ---------------------------------------------------------------------------

def stub_outputs(traj, mask):
    """A deterministic eval step's outputs: ade, fde and the best
    trajectory read off the batch."""
    return {"mask": mask, "ade": traj[:, -1, 0], "fde": traj[:, 0, 1],
            "best_traj": traj[:, 8:] * 4.0}


def test_test_rounds_match_jax(tmp_path, monkeypatch, data):
    """With one deterministic stub eval step in both, test()'s per-round
    and average ADE/FDE, its metrics rows and its predictions
    (return_preds) are the same."""
    frames, tables, images = data
    monkeypatch.setattr(
        jsteps, "cached_eval_step",
        lambda *a, **k: lambda params, state, db, key: stub_outputs(
            db["traj"], db["mask"]))
    monkeypatch.setattr(
        trainer, "make_eval_step",
        lambda *a: lambda params, state, batch, gen: stub_outputs(
            batch["traj"], batch["mask"]))
    params = loop_params(tmp_path, n_round=3)
    port, jexp = pair(params, images)
    got = port.test(tables["test"], None, return_preds=True)
    want = jexp.test(frames["test"], None, return_preds=True)
    assert got[:2] == want[:2]
    for trajs, jtrajs in zip(got[3], want[3]):
        assert trajs.keys() == jtrajs.keys()
        for k in jtrajs:
            np.testing.assert_array_equal(np.concatenate(trajs[k]),
                                          np.concatenate(jtrajs[k]))
    assert port.eval_ADE == jexp.eval_ADE
    assert port.eval_FDE == jexp.eval_FDE
    assert len(got[2]) == len(want[2]) == 3
    for rows, df in zip(got[2], want[2]):
        for c in ("metaId", "sceneId", "ade", "fde"):
            np.testing.assert_array_equal(rows[c], np.asarray(df[c]))


def test_eval_streams_are_deterministic(tmp_path, data):
    """Two Experiments with the same seed and weights score
    bit-identically; another seed draws other samples; the rounds differ."""
    frames, tables, images = data
    params = loop_params(tmp_path, n_round=2)
    runs = [trainer.Experiment(p, images=images).test(tables["test"], None)
            for p in (params, params, dict(params, seed=2))]
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        np.testing.assert_array_equal(a["ade"], b["ade"])
    assert runs[0][2][0]["ade"].tolist() != runs[0][2][1]["ade"].tolist()
    seeds = {trainer.eval_seed(1, s, i) for s in (0, 1, 10_000)
             for i in range(3)}
    assert len(seeds) == 9


def test_shrink_ladder_steps_down_on_oom(tmp_path, monkeypatch, data):
    """An eval step that runs out of device memory above eval_k_chunk 2:
    test() steps K = 4 down to 2 (3 does not divide 4) once, and scores as
    an Experiment run at eval_k_chunk 2 from the start; with no chunk that
    fits, the error is raised."""
    frames, tables, images = data
    real = trainer.make_eval_step
    limit = {"kc": 2}

    def make(mcfg, scfg):
        step = real(mcfg, scfg)

        def eval_step(params, state, batch, gen):
            if not 0 < scfg.eval_k_chunk <= limit["kc"]:
                raise torch.cuda.OutOfMemoryError("out of memory")
            return step(params, state, batch, gen)
        return eval_step

    want = trainer.Experiment(loop_params(tmp_path, eval_k_chunk=2),
                              images=images).test(tables["test"], None)
    monkeypatch.setattr(trainer, "make_eval_step", make)
    exp = trainer.Experiment(loop_params(tmp_path), images=images)
    assert exp.test(tables["test"], None)[:2] == want[:2]
    assert exp.n_shrinks == 1
    limit["kc"] = 0
    exp = trainer.Experiment(loop_params(tmp_path), images=images)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        exp.test(tables["test"], None)
    assert exp.n_shrinks == 2  # 4 -> 2 -> 1, then nothing is left


# ---------------------------------------------------------------------------
# unported flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag,over", [
    ("fused", dict(fused=True)), ("resume", dict(resume=True)),
    ("cross_scene_batching", dict(cross_scene_batching=True)),
    ("mesh_shape", dict(mesh_shape=[2])),
    ("mesh_axes", dict(mesh_axes=["data"])), ("remat", dict(remat=True)),
    ("eth", dict(dataset_name="eth")),
    ("segmentation", dict(segmentation_model_fp=__file__))])
def test_unported_loop_flags_raise(tmp_path, flag, over):
    with pytest.raises(NotImplementedError, match=flag):
        trainer.Experiment(loop_params(tmp_path, **over))


@pytest.mark.parametrize("over", [
    dict(network="embed"), dict(network="fusion", n_fusion=2),
    dict(network="fusion", n_fusion=1, train_net="mosa_1",
         position=["scene", "motion", "fusion"]),
    dict(train_net="serial", position=["1", "2"])])
def test_networks_and_adapters_accepted(tmp_path, over):
    """The embed and fusion networks and the adapters build an Experiment
    whose model matches the flags; the serial adapters bring a state."""
    exp = trainer.Experiment(loop_params(tmp_path, **over))
    assert exp.mcfg.network == over.get("network", "original")
    assert exp.mcfg.n_fusion == over.get("n_fusion")
    assert bool(exp.model_state) == ("serial" in over.get("train_net", ""))


def test_accepted_flags(tmp_path):
    """--seg_cache_device_mb and --max_scenes_per_batch are accepted and
    unused; a segmentation file that does not exist means the identity
    backbone."""
    exp = trainer.Experiment(loop_params(
        tmp_path, seg_cache_device_mb=1, max_scenes_per_batch=2,
        segmentation_model_fp=str(tmp_path / "missing.npz")))
    assert exp.mcfg.n_semantic_classes == 3


# ---------------------------------------------------------------------------
# the CLIs: the verify skill's flows on its on-disk synthetic dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The verify skill's dataset: 2 scenes of 10 tracks as jpgs under
    data/sdd/raw/annotations/synth/video<i>, predefined 14 / 3 / 3 pickles
    under data/sdd/filter/synth, and synth.yaml at small width."""
    root = tmp_path_factory.mktemp("cli")
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=10,
                                        total_len=20, img_hw=(192, 256))
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
    cfg.update(encoder_channels=[8, 8, 16, 16, 16],
               decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
               n_goal=5, n_traj=1, save_every_n=121)
    (root / "synth.yaml").write_text(yaml.safe_dump(cfg))
    return root


COMMON = ["--config_filename", "synth.yaml", "--batch_size", "5",
          "--dataset_path", "filter/synth", "--load_data", "predefined",
          "--device", "cpu"]
BASE = "ckpts/Seed_1__filter_synth__train__original.npz"


def run_train(argv):
    train_main(config.get_parser(True).parse_args(argv))


def test_cli_flows(workdir, monkeypatch, capsys):
    """Scratch train; the LoRA fine-tune with --init_check (a delta of the
    lora_* leaves only); the separated base + delta test."""
    monkeypatch.chdir(workdir)
    run_train(COMMON + ["--seed", "1", "--n_epoch", "2", "--n_round", "1",
                        "--train_net", "train", "--ckpt_path", "ckpts"])
    out = capsys.readouterr().out
    assert "Training from scratch" in out and "Epoch 1:" in out
    assert pathlib.Path(BASE).exists()

    run_train(COMMON + [
        "--seed", "2", "--n_epoch", "1", "--train_net", "mosa_2",
        "--position", *POSITIONS, "--fine_tune", "--n_train_batch", "2",
        "--lr", "0.003", "--steps", "20", "--init_check",
        "--pretrained_ckpt", BASE, "--ckpt_path", "ckpts_ft"])
    out = capsys.readouterr().out
    assert "Passed initialization check" in out
    (delta,) = pathlib.Path("ckpts_ft").glob("Seed_2__*.npz")
    assert delta.name == ("Seed_2__filter_synth__mosa_2__Pos_0_1_2_3_4__"
                          "TrN_10__lr_0.003__original.npz")
    with np.load(delta) as z:
        assert len(z.files) == 18 and all(
            k.rsplit("/", 1)[1] in ("lora_A", "lora_B") for k in z.files)

    test_cli.main(config.get_parser(False).parse_args(COMMON + [
        "--seed", "1", "--n_round", "3", "--pretrained_ckpt", BASE,
        "--tuned_ckpt", str(delta)]))
    out = capsys.readouterr().out
    assert "Average performance (by 3):" in out
    assert len(re.findall(r"Round \d: \nTest ADE: [\d.]+ \nTest FDE: [\d.]+",
                          out)) == 3


def test_clis_need_a_card_unless_told(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in COMMON if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_train(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(config.get_parser(False).parse_args(
            argv + ["--pretrained_ckpt", BASE]))


def test_cli_raises_on_unported_flags(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    for flag in ("--fused", "--resume", "--remat", "--cross_scene_batching"):
        with pytest.raises(NotImplementedError, match=flag[2:]):
            run_train(COMMON + [flag])
