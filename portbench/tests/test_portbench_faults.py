"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program on the CPU at a small
size and judged by the cell's own limits. And on the card, at the cell's
own size, the control: the reference put in the program's place with
TF32 convolutions and matmuls, one precision below the configuration's
f32."""

import numpy as np
import pytest
import torch

from portbench import core
from portbench.run import Context, measure
from portbench.tests.small import bench, small

SERVE = ("ynet_sdd.serve_ttst", "ynetmod_ind.serve_ttst_cws")
TUNE = ("ynet_sdd.finetune_mosa1", "ynetmod_ind.finetune_mosa1")


def correct(name):
    cell, cfg = small(name)
    line, _ = measure(bench(), name, cell, cfg, 17, 0.5, 0, device="cpu",
                      t0=0.0)
    return line["correct"]


def _altered(out):
    out["trajectories"][-1, 0, -1, 0] += 50.0  # one point, 50 raw px
    return out


def _half_batch(out):
    # the second half of the agents answered with the first half's
    for k in out:
        b = out[k].shape[1]
        if b > 1:
            out[k][:, b - b // 2:] = out[k][:, :b // 2]
    return out


def _waypoint_altered(out):
    out["waypoints"][0, 0, -1, 1] += 50.0
    return out


@pytest.mark.parametrize("fault", [_altered, _half_batch, _waypoint_altered])
@pytest.mark.parametrize("name", SERVE)
def test_serving_fault_is_not_correct(name, fault, monkeypatch):
    from mst_tpu_torch.serve import Predictor

    predict = Predictor.predict
    monkeypatch.setattr(Predictor, "predict",
                        lambda self, *a, **k: fault(predict(self, *a, **k)))
    assert not correct(name)


def _frozen(monkeypatch):
    from mst_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self: None)


def _half_rows(monkeypatch):
    from mst_tpu_torch.train import steps

    bce = steps.bce_with_logits

    def half(logits, targets, mask=None, *a):
        keep = torch.ones_like(mask)
        keep[len(keep) // 2:] = 0
        return bce(logits, targets, mask * keep, *a)

    monkeypatch.setattr(steps, "bce_with_logits", half)


def _grad_doubled(monkeypatch):
    from mst_tpu_torch.train import optim

    step = optim.Adam.step

    def doubled(self):
        self.params[-1].grad.mul_(2.0)
        step(self)

    monkeypatch.setattr(optim.Adam, "step", doubled)


@pytest.mark.parametrize("fault", [_frozen, _half_rows, _grad_doubled])
@pytest.mark.parametrize("name", TUNE)
def test_training_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(name)


@pytest.mark.card
@pytest.mark.parametrize("name", SERVE + TUNE)
def test_control_is_not_correct_on_the_card(name, card):
    """The control at the cell's own size on one seed: at least one of the
    cell's numbers over its limit."""
    from portbench.calibrate import control_finetune, control_serve

    cell = core.read_json("workloads", name)
    cfg = core.read_json("configs", cell["config"])
    loop = core.load_module("loops", cell["loop"])
    result = loop.run(Context(cell, core.run_config(cfg, cell), 29, 1.0,
                                False, "cuda", 0.0))
    readings = (control_serve(loop, result) if cell["loop"] == "serve"
                else control_finetune(loop, result, torch))["control"]
    limits = cell["check"]["limits"]
    assert any(not readings[k] <= limits[k] for k in limits), readings
    assert all(np.isfinite(list(readings.values())))
