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

Adam's first updates are about lr x sign(g), so an element whose
gradient is mostly rounding can take the other sign in the world of 2
(whose all-reduce sums in another order) and move by up to 2 lr a step
(tests/test_spatial_sharding.py:124-138 spells it out for mst_tpu). In
the loop flow the world of one records, for each trainable leaf, the
elements whose |g| fell under SIG of the leaf's max |g| at some step
(chip_smoke.py's P14_SIG rule): those may be off by up to 2 lr a step,
every other element is held at the leaf bar, and at most FLIP_SHARE of a
file's elements may need the looser bound.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from mst_tpu_torch import io
from mst_tpu_torch.train import optim, trainer
from tests import torch_port_ranks as ranks

RTOL = 1e-5
LEAF_TOL = {"loop": 1e-5, "fused": 1e-5, "grid": 1e-4}  # of a leaf's max
FLOWS = tuple(LEAF_TOL)
SIG = 1e-3  # |g| under SIG x the leaf's max |g| at some step: may flip
FLIP_SHARE = 0.02  # of a file's elements, at most, off by more than the bar
LR = float(ranks.LOOP_ARGS[ranks.LOOP_ARGS.index("--lr") + 1])
# the ranks run one thread each: with two, the world of 2's flows gave
# other bits from run to run on a loaded machine, so an element of a
# delta outside the SIG mask could land over its bar; with one, their
# runs repeated their bits under the same load. The world of one here
# keeps two threads, whose runs repeated their bits too, and whose batch
# sums split as the two ranks' do (with one thread the world of one sums
# its 6 rows in one pass, and the metadata's best_val_ade moves in its
# last bits)
RANK_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """The loop world (torch_port_ranks.write_loop_world), then the world
    of 2 (started first) and the world of one -> (root, world of 2's
    outputs on each rank, the world of one's, its runs' small-gradient
    records)."""
    root = tmp_path_factory.mktemp("loop")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ranks.write_loop_world(root)
        handle = ranks.start(root / "ranks", [2], ["loop"],
                             threads=RANK_THREADS)
        with pytest.MonkeyPatch.context() as mp:
            small = record_small_gradients(mp)
            one = ranks.loop_flows("w1", [])
    finally:
        os.chdir(cwd)
    return root, ranks.finish(handle)["loop"], one, small


def record_small_gradients(mp):
    """Patch the trainer's setup_training and Adam's step so that each
    run of this process records, under its ckpt_path's name, the count of
    its optimizer steps and, by the flat key of each trainable leaf in
    the checkpoints' layout (io.params_to_numpy), the elements whose |g|
    fell under SIG of the leaf's max |g| at some step -> the records."""
    records = {}
    setup, step = trainer.setup_training, optim.Adam.step

    def recording_setup(model_params, params_dict, steps_per_epoch):
        out = setup(model_params, params_dict, steps_per_epoch)
        out["optimizer"].small = records.setdefault(
            os.path.basename(str(params_dict["ckpt_path"])), {
                "keys": {id(v): k for k, v in
                         io.flatten(model_params).items()},
                "masks": {}, "steps": 0})
        return out

    def recording_step(self):
        rec = getattr(self, "small", None)
        if rec is not None:
            rec["steps"] += 1
            for p in self.params:
                if p.grad is not None:
                    g = p.grad.abs()
                    key = rec["keys"][id(p)]
                    low = g < SIG * g.max()
                    rec["masks"][key] = rec["masks"].get(
                        key, torch.zeros_like(low)) | low
        return step(self)

    mp.setattr(trainer, "setup_training", recording_setup)
    mp.setattr(optim.Adam, "step", recording_step)
    return records


def leaf_key(name):
    """A checkpoint key's trainable leaf (the training state's
    trainable/, best/ and snap/<i>/ keys hold leaves too)."""
    parts = name.split("/")
    if parts[0] in ("trainable", "best"):
        return "/".join(parts[1:])
    if parts[0] == "snap":
        return "/".join(parts[2:])
    return name


def assert_leaf_held(x, y, key, label, flow, small=None):
    """x within LEAF_TOL[flow] of y's max; but with small (the world of
    one's (masks, steps)), where its gradient may have flipped sign (the
    mask of key's leaf), within 2 lr a step -> how many elements needed
    that bound."""
    bar = LEAF_TOL[flow] * max(np.abs(y).max(), 1e-12)
    mask = None if small is None else small[0].get(leaf_key(key))
    if mask is None:
        np.testing.assert_allclose(x, y, rtol=0, atol=bar, err_msg=label)
        return 0
    d = np.abs(x.astype(np.float64) - y)
    over = d > bar
    assert not (over & ~mask).any(), (label, float(d[~mask].max()))
    assert float(d[mask].max(initial=0.0)) <= 2 * LR * small[1], label
    return int(over.sum())


def files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("flow", FLOWS)
def test_rank_zero_writes_the_world_of_ones_files(flows, flow):
    root, _, _, records = flows
    w1, w2 = root / f"w1_{flow}", root / f"w2_{flow}"
    names = files(w1)
    assert names == files(w2) and any(n.endswith(".npz") for n in names)
    small = None
    if flow == "loop":  # the flow whose elements may flip (the docstring)
        rec = records[f"w1_{flow}"]
        assert rec["steps"] > 0 and rec["masks"]
        small = ({k: v > 0.5 for k, v in io.params_to_numpy(
            {k: m.float() for k, m in rec["masks"].items()}).items()},
            rec["steps"])
    for name in names:
        a, b = w2 / name, w1 / name
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                flipped = sum(assert_leaf_held(x[k], y[k], k,
                                               f"{name}: {k}", flow, small)
                              for k in y.files)
                size = sum(y[k].size for k in y.files)
                assert flipped <= FLIP_SHARE * size, (name, flipped, size)
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
    _, got, one, _ = flows
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
