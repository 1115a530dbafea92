"""The port's CLI flows over a gloo world of 2 CPU processes against a
world of one (tests/torch_port_ranks.py loop_flows): a mosa_2 fine-tune
of 2 epochs with validation through `python -m mst_tpu_torch.train`, the
same with --fused (eager on the CPU), a 2-run grid through
`python -m mst_tpu_torch.grid` (one run a rank) and a base + delta test
through `python -m mst_tpu_torch.test`, on 2 synthetic scenes with
batch_size 6 (3 rows a rank).

Rank 0 alone writes the files (checkpoints every epoch, the training
state, the metrics log, the grid's checkpoints and logs) and they are the
world of one's: the same names, the arrays within 1e-5 of each leaf's
max (the grid's within 1e-4, tests/test_torch_port_grid.py's bar: a rank
vmaps its one run where the world of one vmaps both, and the batched
LoRA weights' grouped convs round otherwise), the metadata equal, one
metrics line an epoch with the validation within 1e-5 relative; the
printed epoch, test and grid lines equal.
"""

import json
import os
import re

import cv2
import numpy as np
import pytest
import torch
import yaml

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu_torch import config
from mst_tpu_torch.train import trainer
from tests import torch_port_ranks as ranks

RTOL = 1e-5
LEAF_TOL = {"loop": 1e-5, "fused": 1e-5, "grid": 1e-4}  # of a leaf's max
FLOWS = tuple(LEAF_TOL)


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """2 scenes of 10 tracks as jpgs (64 x 96), predefined 14 / 3 / 3
    pickles, synth.yaml (a 2-stage model, a checkpoint and a training
    state every epoch) and a full base checkpoint; then the world of 2
    (started first) and the world of one -> (root, world of 2's outputs
    on each rank, the world of one's)."""
    root = tmp_path_factory.mktemp("loop")
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
    for split, part in (("train", ids[:14]), ("val", ids[14:17]),
                        ("test", ids[17:])):
        df[df.metaId.isin(part)].to_pickle(ddir / f"{split}.pkl")
    cfg = config.get_params("sdd_shortterm_train.yaml")
    cfg = {k: cfg[k] for k in ("resize_factor", "waypoints", "temperature",
                               "loss_scale", "kernlen", "nsig", "use_TTST",
                               "rel_threshold", "use_CWS", "obs_len",
                               "pred_len", "use_raw_data", "data_dir",
                               "dataset_name")}
    cfg.update(encoder_channels=[8, 8], decoder_channels=[8, 8],
               n_semantic_classes=3, n_goal=4, n_traj=1, save_every_n=1)
    (root / "synth.yaml").write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        trainer.Experiment(config.get_params(
            "synth.yaml", {"device": "cpu", "seed": 0})).save_params(
                "base.npz")
        handle = ranks.start(root / "ranks", [2], ["loop"])
        one = ranks.loop_flows("w1", [])
    finally:
        os.chdir(cwd)
    return root, ranks.finish(handle)["loop"], one


def files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("flow", FLOWS)
def test_rank_zero_writes_the_world_of_ones_files(flows, flow):
    root, _, _ = flows
    w1, w2 = root / f"w1_{flow}", root / f"w2_{flow}"
    names = files(w1)
    assert names == files(w2) and any(n.endswith(".npz") for n in names)
    for name in names:
        a, b = w2 / name, w1 / name
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in y.files:
                    np.testing.assert_allclose(
                        x[k], y[k], rtol=0,
                        atol=LEAF_TOL[flow] * max(np.abs(y[k]).max(),
                                                  1e-12),
                        err_msg=f"{name}: {k}")
        elif name.endswith("metrics.jsonl"):
            got = [json.loads(line) for line in a.read_text().splitlines()]
            want = [json.loads(line) for line in b.read_text().splitlines()]
            assert len(got) == len(want) == 2  # one line an epoch, once
            for g, w in zip(got, want):
                for k in ("epoch", "train_ade", "train_fde", "val_ade",
                          "val_fde", "loss"):
                    np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
        elif name.endswith(".json"):
            got, want = json.loads(a.read_text()), json.loads(b.read_text())
            for k in ("val_ADE", "val_FDE"):
                np.testing.assert_allclose(got.pop(k, []), want.pop(k, []),
                                           rtol=RTOL)
            assert got == want
        else:  # the grid's logs: their epoch and test lines
            assert lines(a.read_text()) == lines(b.read_text())


def lines(text):
    """The printed lines that carry results (epochs, best epoch, tests),
    numbers rounded to 4 places."""
    keep = [ln for ln in text.splitlines() if re.match(
        r"(Epoch \d|Best epoch|Test ADE|Test FDE|Round|  seed=)", ln)]
    return [re.sub(r"\d+\.\d+", lambda m: f"{float(m.group()):.4f}", ln)
            for ln in keep]


def test_every_rank_prints_the_world_of_ones_results(flows):
    """Each rank's printed lines are the world of one's, but for the grid
    runs' own lines, which rank 0 alone prints (before the summary)."""
    _, got, one = flows
    for r, rank_out in enumerate(got):
        for flow in FLOWS:
            want = lines(one[flow])
            if flow == "grid" and r > 0:
                want = want[next(i for i, ln in enumerate(want)
                                 if ln.startswith("  seed=")):]
            assert want and lines(rank_out[flow]) == want, flow
        assert [s["name"] for s in rank_out["summary"]] == \
            [s["name"] for s in one["summary"]]
        for g, w in zip(rank_out["summary"], one["summary"]):
            np.testing.assert_allclose(
                [g["ade"], g["fde"]] + g["val_ADE"],
                [w["ade"], w["fde"]] + w["val_ADE"], rtol=RTOL)
