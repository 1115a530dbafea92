"""The log scrapers (mst_tpu_torch/evaluator/logs.py, mst_tpu's
regexes) on the stdout of one run of the port's train CLI against the
stdout of mst_tpu's train.py with the same flags on the same on-disk
data: the frames have mst_tpu's columns and rows, and where the two runs
print the same numbers they parse to the same values. Both packages' eval
steps are one deterministic stub, so the validation and test ADE/FDE
they print are equal; the train top-1 metrics come from each package's
own step and random weights.
"""

import importlib.util
import pathlib

import numpy as np
import pandas as pd
import pytest

from mst_tpu.evaluator import logs as jlogs
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import config
from mst_tpu_torch.evaluator import logs
from mst_tpu_torch.train import trainer
from mst_tpu_torch.train.__main__ import main as train_main
from tests.test_torch_port_experiment import workdir  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--config_filename", "synth.yaml", "--batch_size", "5",
         "--dataset_path", "filter/synth", "--load_data", "predefined",
         "--seed", "1", "--n_epoch", "2", "--n_round", "2", "--train_net",
         "train", "--n_train_batch", "1", "--ckpt_path", "ckpts_logs"]


def stub_outputs(traj, mask):
    return {"mask": mask, "ade": traj[:, -1, 0] * 0.5,
            "fde": traj[:, 0, 1] + 1.0, "best_traj": traj[:, 8:] * 4.0}


@pytest.fixture(scope="module")
def stdouts(workdir):  # noqa: F811
    """(the port's stdout, mst_tpu's stdout) of the same train CLI run."""
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(workdir)
        mp.setattr(jsteps, "cached_eval_step",
                   lambda *a, **k: lambda params, state, db, key:
                   stub_outputs(db["traj"], db["mask"]))
        mp.setattr(trainer, "make_eval_step",
                   lambda *a, **k: lambda params, state, batch, gen:
                   stub_outputs(batch["traj"], batch["mask"]))
        spec = importlib.util.spec_from_file_location(
            "mst_tpu_train_cli", REPO / "train.py")
        jcli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jcli)
        out = {}
        import contextlib
        import io as io_text
        for name, run in (
                ("port", lambda: train_main(config.get_parser(True)
                                            .parse_args(FLAGS + [
                                                "--device", "cpu"]))),
                ("jax", lambda: jcli.main(jcli.config_lib.get_parser(True)
                                          .parse_args(FLAGS)))):
            buf = io_text.StringIO()
            with contextlib.redirect_stdout(buf):
                run()
            out[name] = buf.getvalue()
    finally:
        mp.undo()
    return out["port"], out["jax"]


def test_train_and_test_frames_match_jax(stdouts):
    port, jax_out = stdouts
    got, want = logs.extract_train_metrics(port), \
        jlogs.extract_train_metrics(jax_out)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 1 and got.n_param[0] > 0
    pd.testing.assert_frame_equal(logs.extract_test_metrics(port),
                                  jlogs.extract_test_metrics(jax_out))
    got, want = logs.extract_runs_with_rounds(port), \
        jlogs.extract_runs_with_rounds(jax_out)
    assert got == want and len(got[0]["round_ade"]) == 2


def test_epoch_curve_matches_jax(stdouts):
    port, jax_out = stdouts
    got, want = logs.extract_epoch_curve(port), \
        jlogs.extract_epoch_curve(jax_out)
    assert list(got.columns) == list(want.columns)
    assert list(got.epoch) == list(want.epoch) == [0, 1]
    for c in ("val_ade", "val_fde"):
        np.testing.assert_array_equal(got[c], want[c])
    for c in ("train_ade", "train_fde"):
        assert np.isfinite(got[c]).all()


def test_scrapers_equal_on_either_log(stdouts):
    """The port's scrapers are mst_tpu's: on each log, every frame the
    same, and extract_imp_msg / write_csv as mst_tpu's."""
    imp = ("{'seed': 1, 'pretrained_ckpt': 'a.npz', 'tuned_ckpts': "
           "['b.npz'], 'save_every_n': 10}\nReplacing encoder\n"
           "Average performance (by 1): \nTest ADE: 3.5 \nTest FDE: 7.25\n")
    for text in stdouts + (imp,):
        for name in ("extract_train_metrics", "extract_test_metrics",
                     "extract_epoch_curve", "extract_imp_msg"):
            pd.testing.assert_frame_equal(getattr(logs, name)(text),
                                          getattr(jlogs, name)(text))
        assert logs.extract_runs_with_rounds(text) == \
            jlogs.extract_runs_with_rounds(text)
    assert logs._AVG_RE == jlogs._AVG_RE
    assert logs.extract_imp_msg(imp).layer.tolist() == ["encoder"]
