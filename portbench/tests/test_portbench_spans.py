"""The readers of the program's spans (portbench/spans.py and the eight
metrics on it): each against a hand count on a stub trace and stub
spans, each None without spans, without a trace and with a program that
has no span recorder, and a traced run of a small serving and a small
fine-tune cell on the CPU printing every one of its cell's metrics."""

import contextlib
import json

import pytest

from mst_tpu_torch.utils import profiling
from portbench import core
from portbench.run import measure
from portbench.tests.small import CELLS, bench, small

SEED = 2 ** 31 + 11
T0 = 100.0  # the window: T0 to T0 + 1 s


class StubTrace:
    """Busy 0-0.2, 0.3-0.6 and 0.8-1.0 s into the window: idle 0.2-0.3
    and 0.6-0.8."""
    t0, t1, window_s = T0, T0 + 1.0, 1.0

    def busy_intervals(self):
        return [[T0, T0 + 0.2], [T0 + 0.3, T0 + 0.6], [T0 + 0.8, T0 + 1.0]]


def spans_of(*requests, at=T0):
    """Each request a tree (name, start s, end s, device ms, attrs,
    children...) -> the dicts profiling.spans() gives, starts offset by
    `at`."""
    out = []

    def add(node, parent, request):
        name, a, b, ms, attrs, *children = node
        index = len(out) + 1000 * int(at != T0)
        out.append({"name": name, "index": index, "parent": parent,
                    "request": index if request is None else request,
                    "start_ns": int((at + a) * 1e9),
                    "end_ns": int((at + b) * 1e9), "device_ms": ms,
                    "attrs": attrs})
        for child in children:
            add(child, index, out[-1]["request"])

    for r in requests:
        add(r, None, None)
    return out


def request(a, b, model, sampling, iters):
    mid = a + (b - a) / 4
    return ("forward", a, b, model + sampling, {},
            ("forward.model", a, mid, model, {}),
            ("forward.sampling", mid, b, sampling, {},
             ("sampling.kmeans", mid, b, sampling / 2,
              {"iterations": iters})))


def step(a, fwd, bwd, opt, ms):
    return ("train.step", a, opt[1] + 0.01, sum(ms), {},
            ("train.forward", a, fwd, ms[0], {}),
            ("train.backward", fwd, bwd, ms[1], {}),
            ("train.optimizer", bwd, opt[1], ms[2], {}))


# sampling 0.125-0.5 and 0.7625-0.95 s: 0.1 + 0.0375 s idle in them;
# the "other" top-level spans count as no request
SERVE = spans_of(request(0.0, 0.5, 10.0, 40.0, 30),
                 ("other", 0.5, 0.7, 80.0, {}),
                 request(0.7, 0.95, 6.0, 24.0, 20),
                 ("other", 0.95, 0.99, 70.0, {})) + spans_of(
    request(0.0, 0.5, 1000.0, 1000.0, 500), at=T0 - 10)  # outside
# backward 0.1-0.3 and 0.6-0.85 s: 0.1 + 0.2 s idle in them
TRAIN = spans_of(step(0.0, 0.1, 0.3, (0.3, 0.35), (10.0, 20.0, 5.0)),
                 step(0.5, 0.6, 0.85, (0.85, 0.9), (12.0, 22.0, 7.0)))

HAND = {"model_ms.serve": (SERVE, 8.0),
        "sampling_ms.serve": (SERVE, 32.0),
        "kmeans_iters.serve": (SERVE, 25.0),
        "idle_share.sampling.serve": (SERVE, 13.75),
        "forward_ms.train": (TRAIN, 11.0),
        "backward_ms.train": (TRAIN, 21.0),
        "optimizer_ms.train": (TRAIN, 6.0),
        "idle_share.backward.train": (TRAIN, 30.0)}


@pytest.mark.parametrize("metric", sorted(HAND))
def test_reader_gives_the_hand_count(metric, monkeypatch):
    found, want = HAND[metric]
    monkeypatch.setattr(profiling, "spans", lambda: found)
    got = core.load_module("metrics", metric).read({"trace": StubTrace()})
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("metric", sorted(HAND))
def test_reader_gives_none_without_spans(metric, monkeypatch):
    reader = core.load_module("metrics", metric)
    found = HAND[metric][0]
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read({"trace": StubTrace()}) is None
    # only another stretch's spans, outside the window
    monkeypatch.setattr(profiling, "spans", lambda: [
        dict(s, start_ns=s["start_ns"] - int(50e9),
             end_ns=s["end_ns"] - int(50e9)) for s in found])
    assert reader.read({"trace": StubTrace()}) is None
    monkeypatch.setattr(profiling, "spans", lambda: found)
    assert reader.read({"trace": None}) is None
    # a program without the span recorder (the parent of this change)
    monkeypatch.delattr(profiling, "spans")
    assert reader.read({"trace": StubTrace()}) is None


def test_new_metrics_listed_for_their_cells():
    want = {m: CELLS[:2] if m.endswith(".serve") else CELLS[2:]
            for m in HAND}
    got = {m["name"]: m for m in bench()["per_layer"] if m["name"] in HAND}
    assert {k: tuple(v["workloads"]) for k, v in got.items()} == want
    assert all(v["source"] in ("program_span", "program_counter")
               for v in got.values())


@contextlib.contextmanager
def no_sync_count(torch, counts):
    """core.count_syncs without torch's sync debug mode, which a build
    without CUDA does not have."""
    yield
    counts.append(0)


@pytest.mark.parametrize("name", [CELLS[0], CELLS[2]])
def test_traced_run_prints_every_new_metric(name, monkeypatch):
    monkeypatch.setattr(core, "count_syncs", no_sync_count)
    cell, cfg = small(name)
    line, _ = measure(bench(), name, cell, cfg, SEED, 0.5, 1,
                      device="cpu", t0=0.0)
    line = json.loads(json.dumps(line))
    assert line["correct"] is True, line["checks"]
    ours = [m for m in HAND if name in next(
        x for x in bench()["per_layer"] if x["name"] == m)["workloads"]]
    assert len(ours) == 4
    for m in ours:
        assert line["metrics"][m]["value"] >= 0, m
    if "serve" in name:
        assert line["metrics"]["kmeans_iters.serve"]["value"] >= 1
