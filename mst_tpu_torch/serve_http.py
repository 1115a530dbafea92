"""HTTP serving daemon around loader.LoadedModel with continuous batching
(counterpart of mst_tpu/serve_http.py, whose policy it keeps line for line).

A dependency-free (stdlib http.server) daemon that

- keeps the base weights and N style overlays resident on the device (the
  overlays share every tensor but their deltas),
- **batches concurrent requests**: a dispatcher thread collects up to B
  agent rows (the manifest's batch size) from the request queue, grouped
  by (scene, style, seed): rows are independent through the convs, and
  the group shares one seed's key, so a request's samples depend only on
  its group's arrival order. It waits at most --max_wait_ms, pads the
  remainder to B by repeating the first row (the programs take the
  directory's fixed B, and a row's draws depend on the dispatch as in
  mst_tpu),
  runs ONE predict and fans the per-row results back out,
- serves scenes registered at startup (--scene name=path.npy holding the
  preprocessed (1, H, W, C) semantic map) or uploaded via PUT /scenes.

The dispatcher thread is the only one that runs the model. It runs on
the model's device and that device's default stream; each predict entry
point carries its own torch.no_grad(), which is thread-local.

Endpoints (JSON):
  GET  /healthz            -> {ok, batch_size, obs_len, pred_len, styles,
                               scenes}
  GET  /styles             -> {styles: [...]}
  POST /styles/<name>      {"delta_path": server-side npz} -> {ok}
  PUT  /scenes/<name>      {"semantic": nested list (1,H,W,C)} -> {ok}
  POST /predict            {"scene": name, "observed": (obs_len, 2) or
                            (n, obs_len, 2), "style": name|null,
                            "seed": int} ->
                           {"trajectories": (n, K, pred_len, 2),
                            "waypoints": (n, K, n_wp, 2)}  (raw px)

Usage:
  python -m mst_tpu_torch.serve serve --model_dir M --port 8000 \
      --styles biker=ckpts/delta.npz --scene death=death.npy [--device cpu]
"""

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class Overloaded(Exception):
    """Request queue full: the caller gets a 503 with Retry-After."""


class _Pending:
    """One request's rows awaiting a batch slot."""

    def __init__(self, rows):
        self.rows = rows                    # (n, obs_len, 2) float32
        self.event = threading.Event()
        self.result = None                  # {"trajectories", "waypoints"}
        self.error = None


class Batcher:
    """Collects pending rows into dispatches of B rows.

    Rows only co-batch within one (scene, style, seed) group: the model is
    row-independent through the convs, but the key's draws are shared per
    dispatch, so the group key keeps a request's samples reproducible for
    a given arrival order.

    Admission is bounded (max_queue requests): when the dispatcher falls
    behind, submit raises Overloaded and the HTTP layer returns 503 +
    Retry-After. Foreign-group requests pulled during batch top-up move to
    an internal backlog (never re-admitted through the bounded queue, so
    admission never deadlocks against the dispatcher).

    `dispatches` and `dispatched_rows` count the predicts run and the
    requests' rows in them (padding aside).
    """

    def __init__(self, model, scenes, max_wait_ms=5.0, max_queue=64,
                 scenes_lock=None):
        self.model = model
        self.scenes = scenes               # {name: (1, H, W, C) float32}
        # guards every read and write of the (LRU-evicted) scenes dict;
        # the HTTP layer shares it for PUT /scenes
        self.scenes_lock = scenes_lock or threading.Lock()
        self.B = int(model.manifest["observed_shape"][0])
        self.max_wait = max_wait_ms / 1e3
        # max_queue <= 0 means unbounded admission (queue.Queue(0) is
        # unbounded, so the admission check must agree)
        self.max_queue = int(max_queue) if int(max_queue) > 0 else None
        self.q = queue.Queue(maxsize=self.max_queue or 0)
        # serializes the admission check and the counter bump, so that N
        # handler threads cannot all pass at max_queue - 1
        self._admit_lock = threading.Lock()
        # admitted but unresolved requests: queued, in the backlog, or in
        # flight; an explicit counter keeps the bound exact while the
        # dispatcher holds popped items during top-up
        self._pending = 0
        self._backlog = collections.deque()
        self.dispatches = 0
        self.dispatched_rows = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, scene, style, seed, rows):
        p = _Pending(rows)
        # admission bounds ALL unresolved work (queued + backlog +
        # in flight), so the 503 bound holds under mixed-group traffic
        with self._admit_lock:
            if self.max_queue is not None and \
                    self._pending >= self.max_queue:
                raise Overloaded(
                    f"request queue full ({self.max_queue} pending); "
                    f"retry shortly")
            self._pending += 1
        try:
            self.q.put_nowait(((scene, style, int(seed)), p))
        except queue.Full:
            # unreachable when bounded (_pending >= qsize), kept as defense
            with self._admit_lock:
                self._pending -= 1
            raise Overloaded(
                f"request queue full ({self.max_queue} pending); "
                f"retry shortly") from None
        return p

    def depth(self):
        """Admitted but unresolved requests (queue + backlog + in flight)."""
        return self._pending

    def _finish(self, pendings):
        """Resolve requests: wake the handlers, release admission slots."""
        for p in pendings:
            p.event.set()
        if pendings:
            with self._admit_lock:
                self._pending -= len(pendings)

    def stop(self):
        self._stop.set()
        try:
            self.q.put_nowait(None)
        except queue.Full:
            pass  # the loop drains the full queue and sees _stop
        self.thread.join(timeout=5)
        # fail anything still queued so no handler blocks forever
        items = list(self._backlog)
        self._backlog.clear()
        while True:
            try:
                items.append(self.q.get_nowait())
            except queue.Empty:
                break
        dead = [item[1] for item in items if item is not None]
        for p in dead:
            p.error = "server shutting down"
        self._finish(dead)

    # -- dispatcher thread ---------------------------------------------------

    def _loop(self):
        if self.model.device.type == "cuda":
            # a new thread's current device is card 0
            torch.cuda.set_device(self.model.device)
        while not self._stop.is_set():
            if self._backlog:
                item = self._backlog.popleft()
            else:
                item = self.q.get()
            if item is None or self._stop.is_set():
                if item is not None:
                    item[1].error = "server shutting down"
                    self._finish([item[1]])
                continue
            key0, group = item[0], [item[1]]
            n_rows = len(item[1].rows)
            stash = []
            # top up from the backlog first (no waiting: these arrived
            # earlier), then from the queue with the max_wait deadline
            for cand in list(self._backlog):
                if n_rows >= self.B:
                    break
                if cand[0] == key0 and \
                        n_rows + len(cand[1].rows) <= self.B:
                    self._backlog.remove(cand)
                    group.append(cand[1])
                    n_rows += len(cand[1].rows)
            deadline = None
            while n_rows < self.B:
                try:
                    timeout = self.max_wait if deadline is None else \
                        max(deadline - time.monotonic(), 0)
                    nxt = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                if deadline is None:
                    deadline = time.monotonic() + self.max_wait
                if nxt[0] == key0 and n_rows + len(nxt[1].rows) <= self.B:
                    group.append(nxt[1])
                    n_rows += len(nxt[1].rows)
                else:
                    stash.append(nxt)
            self._backlog.extend(stash)
            self._dispatch(key0, group)

    def _dispatch(self, key0, group):
        scene_name, style, seed = key0
        try:
            rows = np.concatenate([p.rows for p in group])  # (n, obs, 2)
            n = rows.shape[0]
            if n < self.B:  # the draws are B rows': pad by repeating row 0
                pad = np.repeat(rows[:1], self.B - n, axis=0)
                rows = np.concatenate([rows, pad])
            with self.scenes_lock:
                sem = self.scenes.get(scene_name)
            if sem is None:
                # the scene was LRU-evicted between admission and dispatch
                raise ValueError(
                    f"scene '{scene_name}' is no longer resident "
                    f"(evicted); re-upload it via PUT /scenes/{scene_name}")
            out = self.model.predict(sem, rows, seed=seed, style=style)
            self.dispatches += 1
            self.dispatched_rows += n
            # (K, B, T, 2) -> per-request (n_i, K, T, 2)
            trajs = np.moveaxis(out["trajectories"], 1, 0)
            wps = np.moveaxis(out["waypoints"], 1, 0)
            i = 0
            for p in group:
                k = len(p.rows)
                p.result = {"trajectories": trajs[i:i + k],
                            "waypoints": wps[i:i + k]}
                i += k
        except Exception as ex:  # noqa: BLE001 (reported to the caller)
            for p in group:
                p.error = str(ex)
        finally:
            self._finish(group)


def make_handler(server_state):
    model = server_state["model"]
    scenes = server_state["scenes"]          # OrderedDict: LRU order
    batcher = server_state["batcher"]
    scenes_lock = server_state.get("scenes_lock") or threading.Lock()
    max_scenes = server_state.get("max_scenes")

    def _register_scene(name, sem):
        """Capped LRU insert (as LoadedModel.add_style): a scene-upload
        flood cannot grow host memory without bound."""
        with scenes_lock:
            scenes[name] = sem
            scenes.move_to_end(name)
            evicted = []
            if max_scenes is not None and int(max_scenes) > 0:
                while len(scenes) > int(max_scenes):
                    old, _ = scenes.popitem(last=False)
                    evicted.append(old)
        return evicted

    def _touch_scene(name):
        with scenes_lock:
            if name in scenes:
                scenes.move_to_end(name)

    def _scene_names():
        """A snapshot of the resident scene names under the lock (PUT
        handlers mutate the dict)."""
        with scenes_lock:
            return sorted(scenes)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; the CLI prints startup
            pass

        def _json(self, code, payload, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/healthz":
                m = model.manifest
                self._json(200, {
                    "ok": True, "batch_size": m["observed_shape"][0],
                    "obs_len": m["obs_len"], "pred_len": m["pred_len"],
                    "n_goal": m.get("n_goal"),
                    "queue_depth": batcher.depth(),
                    "max_queue": batcher.max_queue,
                    "max_styles": model.max_styles,
                    "max_scenes": max_scenes,
                    "styles": model.styles, "scenes": _scene_names()})
            elif self.path == "/styles":
                self._json(200, {"styles": model.styles})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_PUT(self):
            if self.path.startswith("/scenes/"):
                name = self.path.split("/", 2)[2]
                try:
                    sem = np.asarray(self._body()["semantic"], np.float32)
                    want = tuple(model.manifest["semantic_shape"])
                    if sem.shape != want:
                        raise ValueError(
                            f"semantic must match the exported shape "
                            f"{want}, got {sem.shape}")
                    evicted = _register_scene(name, sem)
                    self._json(200, {"ok": True, "scene": name,
                                     "shape": list(sem.shape),
                                     "evicted": evicted})
                except Exception as ex:  # noqa: BLE001
                    self._json(400, {"error": str(ex)})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path.startswith("/styles/"):
                name = self.path.split("/", 2)[2]
                try:
                    evicted = model.add_style(name,
                                              self._body()["delta_path"])
                    self._json(200, {"ok": True, "styles": model.styles,
                                     "evicted": evicted})
                except Exception as ex:  # noqa: BLE001
                    self._json(400, {"error": str(ex)})
                return
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                req = self._body()
                names = _scene_names()
                scene = req.get("scene")
                if not scene:
                    if not names:
                        raise ValueError(
                            "no scenes resident; upload one via "
                            "PUT /scenes/<name>")
                    scene = names[0]
                if scene not in names:
                    raise ValueError(f"unknown scene '{scene}'; "
                                     f"registered: {names}")
                _touch_scene(scene)  # LRU: predict marks use
                rows = np.asarray(req["observed"], np.float32)
                if rows.ndim == 2:
                    rows = rows[None]
                m = model.manifest
                if rows.ndim != 3 or rows.shape[1] != m["obs_len"] \
                        or rows.shape[2] != 2:
                    raise ValueError(
                        f"observed must be (n, {m['obs_len']}, 2), got "
                        f"{rows.shape}")
                if not 1 <= rows.shape[0] <= m["observed_shape"][0]:
                    raise ValueError(
                        f"between 1 and batch_size="
                        f"{m['observed_shape'][0]} rows per request, got "
                        f"{rows.shape[0]}")
                seed = int(req.get("seed", 0) or 0)
                style = req.get("style")
                if style is not None and style not in model.styles:
                    raise ValueError(
                        f"unknown style '{style}'; registered: "
                        f"{model.styles}")
            except Exception as ex:  # noqa: BLE001
                self._json(400, {"error": str(ex)})
                return
            try:
                p = batcher.submit(scene, style, seed, rows)
            except Overloaded as ex:
                self._json(503, {"error": str(ex)},
                           headers=(("Retry-After", "1"),))
                return
            if not p.event.wait(timeout=300):
                self._json(504, {"error": "dispatch timed out"})
                return
            if p.error is not None:
                self._json(500, {"error": p.error})
            else:
                self._json(200, {
                    "trajectories": p.result["trajectories"].tolist(),
                    "waypoints": p.result["waypoints"].tolist()})

    return Handler


def run_server(model_dir, port=8000, styles=(), scenes=(), max_wait_ms=5.0,
               host="127.0.0.1", ready_event=None, max_queue=64,
               max_styles=32, max_scenes=32, device=None):
    """Start the daemon (blocking). styles: ["name=delta.npz"]; scenes:
    ["name=semantic.npy"] with the npy holding (1, H, W, C) float32.
    max_queue bounds pending requests (503 + Retry-After beyond it);
    max_scenes caps resident scene maps (LRU; <= 0 unbounded);
    max_styles caps resident style overlays (LRU; <= 0 unbounded). device:
    'cuda' (the default, which must exist) or 'cpu'. A threading caller
    (tests) gets the server and the batcher as ready_event.server and
    ready_event.batcher, for shutdown."""
    from mst_tpu_torch.loader import load_model

    model = load_model(model_dir, device)
    model.max_styles = max_styles
    for spec in styles:
        name, path = spec.split("=", 1)
        model.add_style(name, path)
    scene_dict = collections.OrderedDict()
    for spec in scenes:
        name, path = spec.split("=", 1)
        scene_dict[name] = np.asarray(np.load(path), np.float32)
    if max_scenes is not None and 0 < int(max_scenes) < len(scene_dict):
        raise ValueError(
            f"--max_scenes {max_scenes} is smaller than the "
            f"{len(scene_dict)} startup scenes; raise the cap or register "
            f"fewer scenes")
    scenes_lock = threading.Lock()  # shared: PUT handlers + dispatcher
    batcher = Batcher(model, scene_dict, max_wait_ms=max_wait_ms,
                      max_queue=max_queue, scenes_lock=scenes_lock)
    state = {"model": model, "scenes": scene_dict, "batcher": batcher,
             "scenes_lock": scenes_lock, "max_scenes": max_scenes}
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"[serve] listening on {host}:{httpd.server_address[1]} "
          f"(B={batcher.B}, device={model.device}, styles={model.styles}, "
          f"scenes={sorted(scene_dict)})")
    if ready_event is not None:
        ready_event.server = httpd
        ready_event.batcher = batcher
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        batcher.stop()
        httpd.server_close()
