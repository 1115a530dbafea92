"""The port's spans (mst_tpu_torch/utils/profiling.py) on the CPU: off
without a profiler (no record, no CUDA event, no record_function),
nesting and requests under recording(), the host times on the profiler's
clock, k-means' iteration count, the train step's and the predict
step's spans in order, and no span inside torch.export's program. The
case marked `card` (a CUDA-graph capture records no span) skips here; on
a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_port_profiling.py
"""

import statistics
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.ops.kmeans import batched_kmeans
from mst_tpu_torch.ops.sampling import key_from_seed
from mst_tpu_torch.train import steps, trainer
from mst_tpu_torch.utils import profiling

H, W, B = 64, 96, 2
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             n_goal=5, use_TTST=True, train_net="mosa_2",
             position=["0", "1", "2", "3", "4"], lr=1e-3, fine_tune=True)


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    """The SMALL configuration's params, weights and inputs."""
    params = get_params("sdd_shortterm_train.yaml", SMALL)
    weights, _ = init_ynet(torch.Generator().manual_seed(0),
                           ynet_config(params))
    rng = np.random.default_rng(0)
    traj = rng.uniform(5, 60, size=(B, 20, 2)).astype(np.float32)
    return {"params": params, "weights": weights,
            "semantic": torch.tensor(rng.normal(size=(1, H, W, 3)),
                                     dtype=torch.float32),
            "traj": torch.tensor(traj),
            "observed": torch.tensor(traj[:, :params["obs_len"]])}


def names(found):
    return [s["name"] for s in found]


class Counting:
    """Stands in for torch.cuda.Event or record_function and counts."""
    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1

    def record(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_is_off_without_a_profiler(monkeypatch):
    """No profiler and no recording(): nothing recorded, no CUDA event
    and no record_function made, even where CUDA is initialised; the
    same span under recording() makes each."""
    events = type("Events", (Counting,), {"made": 0})
    ranges = type("Ranges", (Counting,), {"made": 0})
    monkeypatch.setattr(torch.cuda, "Event", events)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with profiling.span("off"):
            profiling.note("iterations", 1)
    assert (events.made, ranges.made) == (0, 0)
    assert not profiling.RECORDER.finished
    with profiling.recording():
        with profiling.span("on"):
            profiling.note("iterations", 1)
    assert (events.made, ranges.made) == (2, 1)
    assert [s.name for s in profiling.RECORDER.finished] == ["on"]
    assert profiling.RECORDER.finished[0].attrs == {"iterations": 1}


def test_steps_record_nothing_without_a_profiler(small, monkeypatch):
    """A train step and a predict request with no profiler open no
    record_function and leave no span."""
    ranges = type("Ranges", (Counting,), {"made": 0})
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    p = small["params"]
    weights, _ = init_ynet(torch.Generator().manual_seed(0), ynet_config(p))
    optimizer = trainer.setup_training(weights, p, 1)["optimizer"]
    step = steps.make_train_step(ynet_config(p), step_config(p))
    step(weights, {}, optimizer, {"semantic": small["semantic"],
                                  "traj": small["traj"],
                                  "mask": torch.ones(B)})
    predict = steps.make_predict_step(ynet_config(p), step_config(p))
    predict(small["weights"], {}, small["semantic"], small["observed"],
            key_from_seed(0))
    assert ranges.made == 0
    assert profiling.spans() == []


def test_spans_nest_under_their_request():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("top"):
                with profiling.span("a"):
                    with profiling.span("a.inner"):
                        pass
                with profiling.span("b"):
                    pass
    found = profiling.spans()
    assert names(found) == ["top", "a", "a.inner", "b"] * 2
    for first in (0, 4):
        top, a, inner, b = found[first:first + 4]
        assert top["parent"] is None and top["request"] == top["index"]
        assert a["parent"] == b["parent"] == top["index"]
        assert inner["parent"] == a["index"]
        assert {s["request"] for s in (a, inner, b)} == {top["index"]}
        assert top["start_ns"] <= a["start_ns"] <= inner["start_ns"] \
            <= inner["end_ns"] <= a["end_ns"] <= b["start_ns"] \
            <= b["end_ns"] <= top["end_ns"]
        # on the CPU device_ms is the host duration
        assert top["device_ms"] == pytest.approx(
            (top["end_ns"] - top["start_ns"]) * 1e-6)
    assert found[0]["request"] != found[4]["request"]
    profiling.clear()
    assert profiling.spans() == []


def test_threads_keep_their_own_nesting():
    """More threads than cores, switching often: every span lands, each
    thread's children under its own top-level spans."""
    n_threads, n_spans = 32, 50
    errors = []

    def work(t):
        try:
            for _ in range(n_spans):
                with profiling.span(f"top{t}"):
                    with profiling.span(f"child{t}"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    found = profiling.spans()
    assert len(found) == 2 * n_threads * n_spans
    by_index = {s["index"]: s for s in found}
    for s in found:
        if s["name"].startswith("child"):
            top = by_index[s["parent"]]
            assert top["name"] == "top" + s["name"][len("child"):]
            assert s["request"] == top["index"] == top["request"]


def test_spans_are_on_the_profilers_clock():
    """Under torch.profiler (CPU) each span's host start and end lie
    within 0.5 ms (median of 20) of its own record_function event's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with profiling.span(f"clock{i}"):
                torch.ones(64).sum()
    found = {s["name"]: s for s in profiling.spans()}
    assert len(found) == 20
    starts, ends = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() in found:
            starts.append(abs(e.start_ns() - found[e.name()]["start_ns"]))
            ends.append(abs(e.end_ns() - found[e.name()]["end_ns"]))
    assert len(starts) == 20
    assert statistics.median(starts) < 5e5
    assert statistics.median(ends) < 5e5


def test_kmeans_notes_its_iterations():
    """1 iteration on points that sit on their centres; iter_limit on
    points that never meet tol = 0."""
    centres = torch.tensor([[[0.0, 0.0], [100.0, 100.0]]])
    X = centres.repeat_interleave(25, dim=1)  # (1, 50, 2)
    rng = torch.Generator().manual_seed(0)
    with profiling.recording():
        batched_kmeans(X, 2, init_centers=centres, generator=rng)
        batched_kmeans(torch.randn(3, 200, 2, generator=rng), 5, tol=0.0,
                       iter_limit=3, generator=rng)
    found = profiling.spans()
    assert names(found) == ["sampling.kmeans"] * 2
    assert [s["attrs"]["iterations"] for s in found] == [1, 3]


def test_train_step_spans_in_order(small):
    p = small["params"]
    weights, _ = init_ynet(torch.Generator().manual_seed(0), ynet_config(p))
    optimizer = trainer.setup_training(weights, p, 1)["optimizer"]
    step = steps.make_train_step(ynet_config(p), step_config(p))
    batch = {"semantic": small["semantic"], "traj": small["traj"],
             "mask": torch.ones(B)}
    with profiling.recording():
        step(weights, {}, optimizer, batch)
    found = profiling.spans()
    assert names(found) == ["train.step", "train.forward", "train.backward",
                            "train.optimizer"]
    top = found[0]
    assert all(s["parent"] == top["index"] and s["request"] == top["index"]
               for s in found[1:])
    for a, b in zip(found[1:], found[2:]):
        assert a["end_ns"] <= b["start_ns"]


def test_predict_spans_in_order(small):
    """A request's forward is its one top-level span, with its model and
    sampling parts and k-means under the sampling; the decode opens
    none."""
    p = small["params"]
    predict = steps.make_predict_step(ynet_config(p), step_config(p))
    with profiling.recording():
        out = predict(small["weights"], {}, small["semantic"],
                      small["observed"], key_from_seed(0))
    found = profiling.spans()
    assert names(found) == ["forward", "forward.model", "forward.sampling",
                            "sampling.kmeans"]
    fwd, model, sampling, kmeans = found
    assert fwd["parent"] is None
    assert model["parent"] == sampling["parent"] == fwd["index"]
    assert kmeans["parent"] == sampling["index"]
    assert all(s["request"] == fwd["index"] for s in found)
    assert kmeans["attrs"]["iterations"] >= 1
    # the same request without recording gives the same answer
    again = predict(small["weights"], {}, small["semantic"],
                    small["observed"], key_from_seed(0))
    for k in out:
        assert torch.equal(out[k], again[k])


def test_export_holds_no_span(small):
    """torch.export of the predict forward under recording(): no
    profiler node in the program and no span recorded."""
    from mst_tpu_torch.serve import _Stage

    p = small["params"]
    predict = steps.make_predict_step(ynet_config(p), step_config(p))
    with profiling.recording():
        program = torch.export.export(
            _Stage(predict.forward),
            (small["weights"], {}, small["semantic"], small["observed"],
             key_from_seed(0)), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t
                            or "record_function" in t]
    assert profiling.spans() == []


@pytest.mark.card
def test_graph_capture_records_no_span(card):
    """A span inside a CUDA-graph capture is a no-op, as is its replay;
    the same call outside the capture records, with device time."""
    x = torch.ones(1 << 20, device=card)

    def work(x):
        with profiling.span("captured"):
            return x * 2 + 1

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        work(x)  # warm up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with profiling.recording():
        with torch.cuda.graph(graph):
            y = work(x)
        graph.replay()
        torch.cuda.synchronize()
        assert profiling.spans() == []
        assert torch.equal(y, x * 2 + 1)
        work(x)
    found = profiling.spans()
    assert names(found) == ["captured"] and found[0]["device_ms"] > 0
