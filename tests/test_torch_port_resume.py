"""--resume on the CPU: the port's training-state file and restore.

- In the port alone, a 4-epoch run equals, bit for bit, a 2-epoch run
  followed by a resumed run to epoch 4: the trainable leaves, the Adam
  state, the val history, the best snapshot, smooth-val's window and the
  saved npz files (plain, with smooth_val, and with a steps schedule that
  crosses the resume point).
- The port's file has mst_tpu's keys, shapes and dtypes, and its JSON
  mst_tpu's fields, for the same run.
- Across packages: mst_tpu's epoch-2 state resumed by the port, and the
  port's resumed by mst_tpu, each held against mst_tpu's uninterrupted
  4-epoch run. The two packages' samplers draw from different generators,
  so validation is the same scripted ADE sequence on both sides (as in
  tests/test_torch_port_experiment.py); the optimizer is Adam, so a
  trained weight (the epoch-4 training state) is held at 1e-4 of its
  leaf's max only where its gradient matters (the Adam caveat of
  tests/test_torch_port_train.py): where Adam's RMS gradient sqrt(nu) is
  above 1e-3 of the leaf's max.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import config, io
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.train import trainer

SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             n_goal=4, n_traj=1)
LOSS_RTOL = 1e-5  # per-epoch losses across packages, relative
PARAM_TOL = 1e-4  # leaves across packages, of each leaf's max |w|
SIG = 1e-3  # where sqrt(nu) > SIG * its leaf's max
SCRIPT = [50.0, 44.0, 46.0, 43.0]  # the scripted validation ADEs
NAME = "exp"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for torch here: these small shapes gain nothing
    from more, and under pytest-xdist more threads than cores slow every
    worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """2 scenes of 6 tracks (128 x 192 images), split 8 / 4."""
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=6,
                                        img_hw=(128, 192))
    ids = np.random.default_rng(0).permutation(df.metaId.unique())
    frames = {name: df[df.metaId.isin(part)] for name, part in
              (("train", ids[:8]), ("val", ids[8:12]))}
    tables = {k: Tracks.from_frame(v) for k, v in frames.items()}
    return frames, tables, images


def params_for(ckpt_path, **over):
    return config.get_params("sdd_shortterm_train.yaml", {
        **SMALL, "batch_size": 4, "lr": 1e-3, "seed": 1, "device": "cpu",
        "ckpt_path": str(ckpt_path), "save_every_n": 2, **over})


def state_file(ckpt_path):
    """-> (arrays, JSON) of the run's training-state file."""
    return state_file_at(ckpt_path, None)


def state_file_at(ckpt_path, epoch):
    """The file, or the copy that the cross-package fixture keeps of
    mst_tpu's at `epoch`."""
    tag = "" if epoch is None else f"_{epoch}"
    path = os.path.join(str(ckpt_path), f"{NAME}__train_state{tag}.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        return arrays, json.load(f)


def run_port(params, data):
    exp = trainer.Experiment(params, images=data[2])
    exp.train(data[1]["train"], data[1]["val"], None, None, NAME)
    return exp


CASES = {"plain": dict(train_net="train"),
         "smooth_val": dict(train_net="train", smooth_val=True,
                            window_size=3),
         "steps": dict(train_net="mosa_2", position=["0", "1", "2", "3", "4"],
                       fine_tune=True, steps=[1, 3], lr=3e-3)}


@pytest.fixture(scope="module")
def warm(data, tmp_path_factory):
    """One throwaway epoch first: the process's first forward on a
    multithreaded CPU can differ in the last bits (ROADMAP Queue 3 #8), and
    the runs compared here must start from the same state of the
    process."""
    run_port(params_for(tmp_path_factory.mktemp("warm"), n_epoch=1), data)


def test_leaf_order_is_jax_tree_order():
    """io.jax_leaf_order sorts each level's keys as jax.tree_util flattens a
    nested dict, also where a key holds a character below '/' (there a sort
    of the joined strings would differ)."""
    import jax

    flat = {"a/b": 0, "a-b/x": 1, "a/c/d": 2, "0/w": 3, "10/w": 4, "2/w": 5}
    tree = io.unflatten(flat)
    want = [jax.tree_util.keystr(p, simple=True, separator="/")
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert io.jax_leaf_order(flat) == want
    assert sorted(flat) != want


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_bitwise_identical(tmp_path, data, warm, case):
    """A 4-epoch run, against a 2-epoch run and a --resume run to epoch 4
    in its checkpoint directory: the same weights, val history, best epoch,
    saved npz files and final training state (Adam's moments and counts,
    the best snapshot, smooth-val's window), bit for bit."""
    over = CASES[case]
    whole = run_port(params_for(tmp_path / "whole", n_epoch=4, **over), data)
    run_port(params_for(tmp_path / "cut", n_epoch=2, **over), data)
    half, half_meta = state_file(tmp_path / "cut")
    assert half_meta["epoch"] == 2 and len(half_meta["val_ADE"]) == 2
    resumed = run_port(params_for(tmp_path / "cut", n_epoch=4, resume=True,
                                  **over), data)

    assert resumed.val_ADE == whole.val_ADE
    assert resumed.val_FDE == whole.val_FDE
    assert resumed.best_epoch == whole.best_epoch
    assert [r["epoch"] for r in resumed.epoch_log] == [2, 3]
    for a, b in zip(resumed.epoch_log, whole.epoch_log[2:]):
        assert (a["loss"], a["train_ade"]) == (b["loss"], b["train_ade"])
    got = io.flatten(resumed.model_params)
    for k, v in io.flatten(whole.model_params).items():
        assert torch.equal(got[k], v), k
    for f in (f"{NAME}.npz", f"{NAME}__epoch_3.npz",
              f"{NAME}__train_state.npz"):
        with np.load(tmp_path / "whole" / f) as a, \
                np.load(tmp_path / "cut" / f) as b:
            assert sorted(a.files) == sorted(b.files), f
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
    final, final_meta = state_file(tmp_path / "cut")
    assert final_meta == state_file(tmp_path / "whole")[1]
    assert final_meta["epoch"] == 4
    if case == "smooth_val":
        assert final_meta["n_snapshots"] == 2 and half_meta["n_snapshots"]
        assert any(k.startswith("snap/1/") for k in final)
    if case == "steps":
        # the schedule's count follows Adam's; the LR was cut at epoch 1
        n_opt = sum(k.startswith("opt/") for k in final)
        assert final[f"opt/{n_opt - 1}"] == final["opt/0"] > 0
        assert any(k.startswith("trainable/") and "lora_A" in k
                   for k in final)
    else:
        assert final_meta["has_best"] and any(k.startswith("best/")
                                              for k in final)


def test_restore_is_exact(tmp_path, data, warm):
    """What a restore puts in the trainable leaves and Adam's count and
    moments is what the file holds (the LR follows from the count: the
    f32 schedule past its milestone): written again at once, the same
    file."""
    params = params_for(tmp_path / "a", n_epoch=2, **CASES["steps"])
    run_port(params, data)
    want, meta = state_file(tmp_path / "a")
    exp = trainer.Experiment(params, images=data[2])
    setup = trainer.setup_training(exp.model_params, params, 3)
    named = {k: v for k, v in io.flatten(exp.model_params).items()
             if v.requires_grad}
    epoch, extras = exp.restore_training_state(
        str(tmp_path / "a" / f"{NAME}__train_state.npz"), named,
        setup["optimizer"])
    assert epoch == 2 and extras["val_ADE"] == meta["val_ADE"]
    assert int(setup["optimizer"].count) == int(want["opt/0"]) == 6
    assert float(setup["optimizer"].lr()) == np.float32(3e-3) * np.float32(
        0.1)
    exp.save_training_state(
        str(tmp_path / "b.npz"), named, setup["optimizer"],
        epoch, extras["val_ADE"], extras["model_state"],
        extras["val_FDE"], extras["best_snapshot"], extras["best_val_ade"],
        extras["best_epoch"], extras["snapshots"])
    with np.load(tmp_path / "b.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

CROSS = dict(train_net="serial", position=["1", "2"], fine_tune=True,
             steps=[2], smooth_val=True, window_size=3, lr=1e-3)


def scripted(script):
    """A stand-in for _evaluate returning script[i] on its i-th call."""
    calls = iter(script)

    def evaluate(*args, **kwargs):
        ade = next(calls)
        return ade, ade * 1.1, {}, None

    return evaluate


def hwio(port):
    return {k: v.copy() for k, v in
            io.params_to_numpy(io.flatten(port.model_params)).items()}


@pytest.fixture(scope="module")
def cross(data, tmp_path_factory, warm):
    """mst_tpu's uninterrupted 4-epoch run (its epoch-2 training state kept
    aside), the port's 2-epoch run, the port resuming mst_tpu's state and
    mst_tpu resuming the port's, all from the port's init weights with the
    scripted validation; mst_tpu's train step unpacked."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("cross")
    frames, tables, images = data
    step_config = jtrainer.Experiment._step_config
    mp.setattr(jtrainer.Experiment, "_step_config", lambda self, *a, **k:
               step_config(self, *a, **k)._replace(packed_decode=False))
    save = jtrainer.Experiment.save_training_state

    def save_each(self, path, *args, **kwargs):
        # keep every epoch's state: the file is rewritten each time
        kwargs["block"] = True
        save(self, path, *args, **kwargs)
        epoch = args[2]
        for ext in ("", ".json"):
            with open(path + ext, "rb") as f:
                blob = f.read()
            with open(path.replace(".npz", f"_{epoch}.npz") + ext,
                      "wb") as f:
                f.write(blob)

    mp.setattr(jtrainer.Experiment, "save_training_state", save_each)

    def jax_exp(ckpt, **over):
        p = params_for(ckpt, n_epoch=4, metrics_jsonl=str(ckpt / "m.jsonl"),
                       **CROSS, **over)
        p.pop("device")
        init = trainer.Experiment(dict(p, device="cpu"), images=images)
        jexp = jtrainer.Experiment(p, images=images)
        jexp.model_params = jckpt.overlay_checkpoint(
            jexp.model_params, hwio(init), strict=True)
        return jexp

    try:
        out = {}
        jexp = jax_exp(tmp / "jax")
        jexp._evaluate = scripted(SCRIPT)
        jexp.train(frames["train"], frames["val"], None, None, NAME)
        out["jax"] = jexp
        with open(tmp / "jax" / "m.jsonl") as f:
            out["jax_log"] = [json.loads(line) for line in f]

        out["jax_epoch2"] = state_file_at(tmp / "jax", 2)
        out["jax_final"] = state_file_at(tmp / "jax", 4)

        # the port resumes mst_tpu's epoch-2 state
        (tmp / "port_r").mkdir()
        for ext in ("", ".json"):
            shutil.copy(tmp / "jax" / f"{NAME}__train_state_2.npz{ext}",
                        tmp / "port_r" / f"{NAME}__train_state.npz{ext}")
        port = trainer.Experiment(params_for(tmp / "port_r", n_epoch=4,
                                             resume=True, **CROSS),
                                  images=images)
        port._evaluate = scripted(SCRIPT[2:])
        port.train(tables["train"], tables["val"], None, None, NAME)
        out["port_resumed"] = port
        out["port_final"] = state_file(tmp / "port_r")

        # mst_tpu resumes the port's epoch-2 state
        cut = trainer.Experiment(params_for(tmp / "jax_r", n_epoch=2,
                                            **CROSS), images=images)
        cut._evaluate = scripted(SCRIPT)
        cut.train(tables["train"], tables["val"], None, None, NAME)
        out["port_cut"] = cut
        out["port_state"] = state_file(tmp / "jax_r")
        jres = jax_exp(tmp / "jax_r", resume=True)
        jres._evaluate = scripted(SCRIPT[2:])
        jres.train(frames["train"], frames["val"], None, None, NAME)
        out["jax_resumed"] = jres
        out["jax_resumed_final"] = state_file(tmp / "jax_r")
        with open(tmp / "jax_r" / "m.jsonl") as f:
            out["jax_resumed_log"] = [json.loads(line) for line in f]
        yield out
    finally:
        mp.undo()


def significant(nu):
    """Where a leaf's RMS gradient (Adam's sqrt(nu)) is above SIG of its
    max."""
    rms = np.sqrt(np.maximum(nu, 0))
    return rms > SIG * rms.max()


def assert_trained_close(got, want):
    """Two epoch-4 training-state files (the leaves as trained, before the
    roll back to the best snapshot, which both runs take from the epoch-2
    file): the same Adam count, and each trainable leaf within PARAM_TOL
    of its max where its RMS gradient is significant."""
    assert got["opt/0"] == want["opt/0"]
    keys = io.jax_leaf_order(k[len("trainable/"):] for k in want
                             if k.startswith("trainable/"))
    assert keys
    for i, k in enumerate(keys):
        sig = significant(want[f"opt/{1 + len(keys) + i}"])
        assert sig.any(), k
        g, w = got[f"trainable/{k}"], want[f"trainable/{k}"]
        assert not np.array_equal(w, cross_init(k, w)), k
        assert np.abs(g - w)[sig].max() <= PARAM_TOL * np.abs(w).max(), k


def cross_init(key, like):
    """The leaf's value at init (serial adapters: conv weight 0, batch
    norm weight 1 and bias 0), to see that it trained."""
    if key.endswith("bn/weight"):
        return np.ones_like(like)
    return np.zeros_like(like)


@pytest.mark.parametrize("epoch", [2, 4])
def test_port_state_file_has_jax_layout(cross, epoch):
    """The port's file and mst_tpu's of the same run at epoch 2 (before
    smooth-val's first best) and 4: the same keys (trainable, opt with the
    schedule's count, state, snap, and best at 4), shapes and dtypes; the
    JSON's fields the same."""
    got, got_meta = cross["port_state" if epoch == 2 else "port_final"]
    want, want_meta = cross[f"jax_epoch{epoch}" if epoch == 2
                            else "jax_final"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
    assert {k.split("/")[0] for k in got} == {
        "trainable", "opt", "state", "snap", *(["best"] * (epoch == 4))}
    assert sorted(got_meta) == sorted(want_meta)
    for k in ("epoch", "val_ADE", "val_FDE", "has_best", "n_snapshots",
              "best_epoch", "train_net", "position", "seed", "lr"):
        assert got_meta[k] == want_meta[k], k
    assert got_meta["val_ADE"] == SCRIPT[:epoch]


def test_port_resumes_jax_state(cross):
    """The port from mst_tpu's epoch-2 state to epoch 4, against mst_tpu's
    uninterrupted run: the losses at 1e-5 relative, the val history, and
    the weights where their gradient matters."""
    port, jexp = cross["port_resumed"], cross["jax"]
    assert port.val_ADE == jexp.val_ADE == SCRIPT
    for a, b in zip(port.epoch_log, cross["jax_log"][2:], strict=True):
        for k in ("loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {b['epoch']} {k}")
    assert_trained_close(cross["port_final"][0], cross["jax_final"][0])
    # both roll back to the best snapshot, smooth-val's from the epoch-2
    # file, and so end on mst_tpu's weights
    want = {k: np.asarray(v) for k, v in
            jckpt.flatten_tree(jexp.model_params).items()}
    got = hwio(port)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_resumes_port_state(cross):
    """mst_tpu from the port's epoch-2 state to epoch 4, against its own
    uninterrupted run: the same bounds."""
    jres, jexp = cross["jax_resumed"], cross["jax"]
    assert jres.val_ADE == jexp.val_ADE == SCRIPT
    for a, b in zip(cross["jax_resumed_log"], cross["jax_log"][2:],
                    strict=True):
        for k in ("loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {b['epoch']} {k}")
    assert_trained_close(cross["jax_resumed_final"][0],
                         cross["jax_final"][0])
