"""The port's HTTP daemon (mst_tpu_torch/serve_http.py) on the CPU: the
counterparts of tests/test_serve_http.py on a port model directory, and
one parity case that drives both packages' Batchers with one scripted
submission sequence.

The daemon's predictions must be the model's own: requests batched
together or padded to B change nothing row-wise (the convs are
row-independent; the generator is shared per (scene, style, seed) group
by construction).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mst_tpu import serve_http as jserve_http
from mst_tpu_torch import io, serve
from mst_tpu_torch.config import get_params
from mst_tpu_torch.serve_http import Batcher, Overloaded, run_server
from mst_tpu_torch.train.trainer import Experiment

H, W, B, OBS_LEN = 64, 96, 4, 8
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             n_goal=5, train_net="mosa_2", position=["0", "1", "2", "3", "4"],
             seed=1)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_http")
    exp = Experiment(get_params("sdd_shortterm_eval.yaml", SMALL),
                     device="cpu")
    serve.export_model(exp, tmp / "m", H, W, B)
    # a style delta: the LoRA factors perturbed
    delta = {k: v + np.float32(0.05) for k, v in
             io.params_to_numpy(exp.model_params).items() if "lora" in k}
    delta_path = tmp / "style_biker.npz"
    np.savez(delta_path, **delta)
    rng = np.random.default_rng(0)
    semantic = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    np.save(tmp / "scene.npy", semantic)
    # a first predict before any compared one (see
    # test_torch_port_deploy.warm_up)
    serve.load_model(tmp / "m", device="cpu").predict(
        semantic, rng.uniform(10, 50, size=(B, OBS_LEN, 2)))
    return tmp, semantic, str(delta_path)


def load(deployment):
    return serve.load_model(deployment[0] / "m", device="cpu")


def _request(port, path, payload=None, method=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def start(tmp, **kw):
    ready = threading.Event()
    t = threading.Thread(target=run_server, kwargs=dict(
        model_dir=str(tmp / "m"), port=0,
        scenes=[f"death={tmp / 'scene.npy'}"], ready_event=ready,
        device="cpu", **kw), daemon=True)
    t.start()
    assert ready.wait(timeout=120)
    return ready, t


def stop(ready, thread):
    ready.server.shutdown()
    ready.batcher.stop()
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(deployment):
    ready, thread = start(deployment[0], max_wait_ms=200.0)
    yield ready.server.server_address[1], ready
    stop(ready, thread)


def test_http_predict_matches_direct(server, deployment):
    tmp, semantic, delta_path = deployment
    port, _ = server

    code, health = _request(port, "/healthz")
    assert code == 200 and health["ok"] and health["batch_size"] == B
    assert health["scenes"] == ["death"]

    rng = np.random.default_rng(3)
    rows = rng.uniform(10, 50, size=(B, OBS_LEN, 2)).astype(np.float32)
    code, out = _request(port, "/predict", {
        "scene": "death", "observed": rows.tolist(), "seed": 11})
    assert code == 200, out
    got = np.asarray(out["trajectories"])

    direct = load(deployment).predict(semantic, rows, seed=11)
    want = np.moveaxis(direct["trajectories"], 1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # input validation surfaces as 400s, not dispatcher deaths
    assert _request(port, "/predict", {"scene": "nope",
                                       "observed": rows.tolist()})[0] == 400
    assert _request(port, "/predict", {"observed": [[0, 0]]})[0] == 400
    assert _request(port, "/predict", {"observed": rows.tolist(),
                                       "style": "ghost"})[0] == 400
    assert _request(port, "/nowhere")[0] == 404


def test_http_style_registration_and_scene_upload(server, deployment):
    tmp, semantic, delta_path = deployment
    port, _ = server

    code, out = _request(port, "/styles/biker", {"delta_path": delta_path})
    assert code == 200 and out["styles"] == ["biker"], out
    assert _request(port, "/styles")[1] == {"styles": ["biker"]}

    rng = np.random.default_rng(5)
    rows = rng.uniform(10, 50, size=(B, OBS_LEN, 2)).astype(np.float32)
    code, base_out = _request(port, "/predict", {
        "scene": "death", "observed": rows.tolist(), "seed": 2})
    code2, style_out = _request(port, "/predict", {
        "scene": "death", "observed": rows.tolist(), "seed": 2,
        "style": "biker"})
    assert code == 200 and code2 == 200
    assert not np.allclose(np.asarray(base_out["trajectories"]),
                           np.asarray(style_out["trajectories"]))

    # scene upload
    sem2 = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    code, out = _request(port, "/scenes/upl", {"semantic": sem2.tolist()},
                         method="PUT")
    assert code == 200 and out["shape"] == [1, H, W, 3]
    code, out = _request(port, "/predict", {
        "scene": "upl", "observed": rows.tolist()})
    assert code == 200
    # bad shape rejected
    code, _ = _request(port, "/scenes/bad", {"semantic": [[0.0]]},
                       method="PUT")
    assert code == 400
    # a delta the model refuses is a 400
    code, _ = _request(port, "/styles/ghost", {"delta_path": "/nowhere.npz"})
    assert code == 400


def test_concurrent_clients_stress(server, deployment):
    """N client threads x M mixed-group requests: every response is 200
    (or an honest 503 under burst) and every 200 carries the right row
    count: no cross-request row leakage, no dispatcher deadlock."""
    port, _ = server
    n_threads, n_reqs = 8, 6
    rng = np.random.default_rng(17)
    errors, codes = [], []
    lock = threading.Lock()

    def client(tid):
        for r in range(n_reqs):
            n_rows = 1 + (tid + r) % 3
            with lock:
                rows = rng.uniform(10, 50, size=(n_rows, OBS_LEN, 2))
            try:
                code, out = _request(port, "/predict", {
                    "scene": "death", "observed": rows.tolist(),
                    "seed": tid % 3})
            except Exception as ex:  # noqa: BLE001
                with lock:
                    errors.append(f"{tid}/{r}: {ex}")
                return
            with lock:
                codes.append(code)
                if code == 200:
                    if np.asarray(out["trajectories"]).shape[0] != n_rows:
                        errors.append(f"{tid}/{r}: row count mismatch")
                elif code != 503:
                    errors.append(f"{tid}/{r}: unexpected {code}: {out}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors, errors[:5]
    assert codes.count(200) >= n_threads * n_reqs * 0.8, (
        f"too many rejections: {codes.count(503)}/{len(codes)}")
    code, health = _request(port, "/healthz")
    assert code == 200 and health["ok"]
    assert health["queue_depth"] == 0


def gated(model):
    """Make model.predict wait on the returned event."""
    gate = threading.Event()
    real_predict = model.predict

    def slow_predict(*a, **k):
        gate.wait(timeout=60)
        return real_predict(*a, **k)

    model.predict = slow_predict
    return gate


def test_overload_returns_503(deployment):
    """A bounded queue sheds load: with the dispatcher blocked and
    max_queue=2, further submits raise Overloaded (-> HTTP 503)."""
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    gate = gated(model)
    batcher = Batcher(model, {"s": semantic}, max_wait_ms=1.0, max_queue=2)
    try:
        rng = np.random.default_rng(2)
        rows = rng.uniform(10, 50, size=(B, OBS_LEN, 2)).astype(np.float32)
        pend = [batcher.submit("s", None, i, rows) for i in range(2)]
        time.sleep(0.3)
        for i in range(2, 8):
            try:
                pend.append(batcher.submit("s", None, i, rows))
            except Overloaded:
                break
        else:
            raise AssertionError("queue never filled -> no backpressure")
        gate.set()
        for p in pend:
            assert p.event.wait(timeout=120)
            assert p.error is None, p.error
    finally:
        gate.set()
        batcher.stop()


def test_overload_over_http_sheds_with_503(deployment):
    """The same bound through HTTP: a burst at max_queue=1 while the
    dispatcher is blocked gets 503 with Retry-After: 1."""
    tmp, semantic, delta_path = deployment
    ready, thread = start(tmp, max_wait_ms=1.0, max_queue=1)
    gate = gated(ready.batcher.model)
    port = ready.server.server_address[1]
    rows = np.full((1, OBS_LEN, 2), 20.0)
    try:
        first = threading.Thread(target=_request, args=(
            port, "/predict", {"observed": rows.tolist()}))
        first.start()
        for _ in range(200):
            if ready.batcher.depth() == 1:
                break
            time.sleep(0.01)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"observed": rows.tolist()}).encode())
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(req, timeout=60)
        assert info.value.code == 503
        assert info.value.headers["Retry-After"] == "1"
        gate.set()
        first.join(timeout=60)
        assert not first.is_alive()
    finally:
        gate.set()
        stop(ready, thread)


def test_max_queue_zero_means_unbounded(deployment):
    tmp, semantic, delta_path = deployment
    batcher = Batcher(load(deployment), {"s": semantic}, max_wait_ms=1.0,
                      max_queue=0)
    try:
        assert batcher.max_queue is None
        rows = np.zeros((1, OBS_LEN, 2), np.float32) + 20
        pend = [batcher.submit("s", None, i, rows) for i in range(4)]
        for p in pend:
            assert p.event.wait(timeout=120)
            assert p.error is None, p.error
    finally:
        batcher.stop()


def test_admission_bounds_total_unresolved(deployment):
    """max_queue bounds ALL admitted but unresolved requests: queued,
    in the dispatcher's backlog, and in flight alike."""
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    gate = gated(model)
    batcher = Batcher(model, {"s": semantic}, max_wait_ms=1.0, max_queue=3)
    try:
        full = np.zeros((B, OBS_LEN, 2), np.float32) + 20
        rows = full[:1]
        p0 = batcher.submit("s", None, 0, full)
        for _ in range(200):
            if batcher.q.qsize() == 0:
                break
            time.sleep(0.01)
        assert batcher.q.qsize() == 0
        assert batcher.depth() == 1  # in flight, not merely queued
        p1 = batcher.submit("s", None, 91, rows)
        p2 = batcher.submit("s", None, 92, rows)
        assert batcher.depth() == 3
        with pytest.raises(Overloaded):
            batcher.submit("s", None, 2, rows)
        gate.set()
        for p in [p0, p1, p2]:
            assert p.event.wait(timeout=120) and p.error is None
        for _ in range(200):
            if batcher.depth() == 0:
                break
            time.sleep(0.01)
        assert batcher.depth() == 0
        p3 = batcher.submit("s", None, 3, rows)
        assert p3.event.wait(timeout=120) and p3.error is None
    finally:
        gate.set()
        batcher.stop()


def test_stop_fails_what_is_queued(deployment):
    """stop() resolves every queued request with an error, so no handler
    waits forever."""
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    gate = gated(model)
    batcher = Batcher(model, {"s": semantic}, max_wait_ms=1.0)
    full = np.zeros((B, OBS_LEN, 2), np.float32) + 20
    p0 = batcher.submit("s", None, 0, full)
    for _ in range(200):
        if batcher.q.qsize() == 0:
            break
        time.sleep(0.01)
    queued = [batcher.submit("s", None, i, full) for i in (1, 2)]
    threading.Timer(0.2, gate.set).start()
    batcher.stop()
    assert p0.event.wait(timeout=60)
    for p in queued:
        assert p.event.is_set() and p.error == "server shutting down"
    assert batcher.depth() == 0


def test_style_lru_eviction(deployment):
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    model.max_styles = 2
    model.add_style("a", delta_path)
    model.add_style("b", delta_path)
    rows = np.zeros((B, OBS_LEN, 2), np.float32) + 20
    model.predict(semantic, rows, style="a")
    evicted = model.add_style("c", delta_path)
    assert model.styles == ["a", "c"]
    assert evicted == ["b"]
    with pytest.raises(ValueError, match="unknown serving style"):
        model.predict(semantic, rows, style="b")


def test_max_styles_nonpositive_means_unbounded(deployment):
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    model.max_styles = 0
    for name in ("a", "b", "c"):
        assert model.add_style(name, delta_path) == []
    assert model.styles == ["a", "b", "c"]


def test_scene_lru_eviction_over_http(deployment):
    tmp, semantic, delta_path = deployment
    ready, thread = start(tmp, max_wait_ms=50.0, max_scenes=2)
    port = ready.server.server_address[1]
    try:
        code, health = _request(port, "/healthz")
        assert code == 200 and health["max_scenes"] == 2

        rng = np.random.default_rng(23)
        sem2 = rng.normal(size=(1, H, W, 3)).astype(np.float32)
        code, out = _request(port, "/scenes/s2", {"semantic": sem2.tolist()},
                             method="PUT")
        assert code == 200 and out["evicted"] == []

        # touch 'death' so 's2' is the LRU when 's3' arrives
        rows = rng.uniform(10, 50, size=(1, OBS_LEN, 2)).astype(np.float32)
        code, _ = _request(port, "/predict", {
            "scene": "death", "observed": rows.tolist()})
        assert code == 200
        code, out = _request(port, "/scenes/s3", {"semantic": sem2.tolist()},
                             method="PUT")
        assert code == 200 and out["evicted"] == ["s2"], out
        code, health = _request(port, "/healthz")
        assert sorted(health["scenes"]) == ["death", "s3"]
        code, out = _request(port, "/predict", {
            "scene": "s2", "observed": rows.tolist()})
        assert code == 400 and "unknown scene" in out["error"]
    finally:
        stop(ready, thread)


def test_startup_scenes_above_the_cap_raise(deployment):
    tmp, _, _ = deployment
    with pytest.raises(ValueError, match="max_scenes"):
        run_server(str(tmp / "m"), port=0, device="cpu", max_scenes=1,
                   scenes=[f"a={tmp / 'scene.npy'}", f"b={tmp / 'scene.npy'}"])


def test_batcher_co_batches_and_pads(deployment):
    """Two 1-row submissions in one (scene, style, seed) group dispatch as
    ONE padded batch; each caller gets its own row, equal to the direct
    predict of the padded batch."""
    tmp, semantic, delta_path = deployment
    model = load(deployment)
    batcher = Batcher(model, {"s": semantic}, max_wait_ms=500.0)
    try:
        rng = np.random.default_rng(9)
        r1 = rng.uniform(10, 50, size=(1, OBS_LEN, 2)).astype(np.float32)
        r2 = rng.uniform(10, 50, size=(1, OBS_LEN, 2)).astype(np.float32)
        p1 = batcher.submit("s", None, 4, r1)
        p2 = batcher.submit("s", None, 4, r2)
        assert p1.event.wait(timeout=120) and p2.event.wait(timeout=120)
        assert p1.error is None and p2.error is None, (p1.error, p2.error)
        assert (batcher.dispatches, batcher.dispatched_rows) == (1, 2)

        padded = np.concatenate([r1, r2] + [r1] * (B - 2))
        direct = model.predict(semantic, padded, seed=4)
        want = np.moveaxis(direct["trajectories"], 1, 0)
        np.testing.assert_allclose(p1.result["trajectories"], want[0:1],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p2.result["trajectories"], want[1:2],
                                   rtol=1e-5, atol=1e-5)
    finally:
        batcher.stop()


# ---------------------------------------------------------------------------
# both packages' Batchers on one script
# ---------------------------------------------------------------------------

class StubModel:
    """What a Batcher reads of a model: the manifest's B and predict. Each
    predict is logged as (seed, style, rows); the first blocks until
    `gate` is set, so the script's submissions all queue behind it. A
    row's trajectories are its last observed point, so the fan-out can be
    checked."""

    device = torch.device("cpu")

    def __init__(self, seed_of):
        self.manifest = {"observed_shape": [B, OBS_LEN, 2]}
        self.seed_of = seed_of
        self.log = []
        self.entered, self.gate = threading.Event(), threading.Event()

    def predict(self, semantic, rows, style=None, **draws):
        if not self.log:
            self.entered.set()
            self.gate.wait(timeout=60)
        self.log.append((self.seed_of(draws), style, np.asarray(rows)))
        last = np.asarray(rows)[:, -1]  # (B, 2)
        return {"trajectories": np.broadcast_to(last[None, :, None],
                                                (2, B, 3, 2)),
                "waypoints": np.broadcast_to(last[None, :, None],
                                             (2, B, 1, 2))}


# (scene, style, seed, rows) after a first full-B request that blocks
SCRIPT = [("s", None, 1, 1), ("s", "x", 1, 2), ("s", None, 1, 2),
          ("t", None, 1, 1), ("s", None, 2, 3), ("s", None, 1, 2),
          ("s", "x", 1, 3), ("t", None, 1, 4), ("s", None, 2, 1),
          ("s", None, 1, 1), ("s", "x", 1, 1)]


def run_script(batcher_cls, overloaded, model):
    rng = np.random.default_rng(0)
    scenes = {"s": np.zeros(1, np.float32), "t": np.ones(1, np.float32)}
    batcher = batcher_cls(model, scenes, max_wait_ms=20.0, max_queue=9)
    try:
        first = batcher.submit("s", None, 0, rng.uniform(
            0, 50, size=(B, OBS_LEN, 2)).astype(np.float32))
        assert model.entered.wait(timeout=60)
        admitted, pend = [], [first]
        for scene, style, seed, n in SCRIPT:
            rows = rng.uniform(0, 50, size=(n, OBS_LEN, 2)).astype(np.float32)
            try:
                pend.append(batcher.submit(scene, style, seed, rows))
                admitted.append(True)
            except overloaded:
                admitted.append(False)
        model.gate.set()
        for p in pend:
            assert p.event.wait(timeout=60) and p.error is None, p.error
            np.testing.assert_array_equal(p.result["trajectories"][:, 0, 0],
                                          p.rows[:, -1])
    finally:
        model.gate.set()
        batcher.stop()
    return admitted, model.log


def test_batchers_of_both_packages_dispatch_alike():
    """One scripted sequence of submissions behind a blocked dispatch, to
    mst_tpu's Batcher and to the port's: the same admission outcomes (a
    503 past max_queue) and the same dispatches, in order: group seed and
    style, every row, and the padding (row 0 repeated up to B)."""
    jmodel = StubModel(lambda d: int(np.asarray(d["key"])[-1]))
    tmodel = StubModel(lambda d: d["seed"])
    want = run_script(jserve_http.Batcher, jserve_http.Overloaded, jmodel)
    got = run_script(Batcher, Overloaded, tmodel)
    assert got[0] == want[0] and not all(got[0]) and any(got[0][1:])
    assert len(got[1]) == len(want[1]) > 3
    for (gs, gst, grows), (ws, wst, wrows) in zip(got[1], want[1]):
        assert (gs, gst) == (ws, wst)
        np.testing.assert_array_equal(grows, wrows)
    assert any((rows[1:] == rows[0]).all() for _, _, rows in got[1])


def test_fused_arrivals_are_per_stream():
    """fused_predict's arrival counters: one buffer per (device, stream),
    kept while R fits and grown when it does not, so that two streams
    (the daemon's dispatcher and a caller on a side stream) never share
    one."""
    from mst_tpu_torch.ops.kernels import fused_predict as fp

    dev = torch.device("cpu")
    a = fp._arrivals(dev, 1001, 10)
    assert fp._arrivals(dev, 1001, 200) is a
    b = fp._arrivals(dev, 1002, 10)
    assert b is not a and int(b.abs().sum()) == 0
    grown = fp._arrivals(dev, 1001, 300)
    assert grown is not a and grown.numel() >= 300
    assert fp._arrivals(dev, 1002, 10) is b
    for s in (1001, 1002):
        del fp._ARRIVALS[(dev, s)]
