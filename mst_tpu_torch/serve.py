"""Serving and deployment (counterpart of mst_tpu/serve.py).

`Predictor` serves a model built from a config (a flat params dict, see
config.py) and optionally an mst_tpu npz checkpoint and a state npz;
without a checkpoint the weights are random from `seed`. It answers
predict(semantic, observed) with all K sampled trajectories, and serves
motion styles: adapter deltas (LoRA factors, the parallel adapters, the
semantic adapter) overlaid on the base weights, which stay shared, with
mst_tpu's LRU cap on the resident styles.

`export_model` writes a model directory and `LoadedModel` serves one:

    model_dir/
      manifest.json  input shapes, protocol constants, the device exported
                     for, and `config`: the flat params dict
      params.npz     every parameter, in mst_tpu's flat-key HWIO layout,
                     the segmentation backbone's ('segmentation/...') too
      state.npz      the model state (batch-norm running statistics), may
                     be empty

mst_tpu's directory also holds its forward and decode programs as
jax.export StableHLO, which load without mst_tpu's model code. This one
holds no program: LoadedModel rebuilds the model from `config` with this
package's code, so a model directory of the port needs the port's source
to load. A serialized program (torch.export, AOTInductor) waits on three
things: k-means runs a data-dependent number of iterations, each syncing
the host (ops/kmeans.py); the samplers draw from a torch.Generator; and
both kernels launch through ctypes, which tracing cannot see until they
are torch.library custom ops with fake implementations.

The model state is the batch norms' running statistics of the serial
adapters. A model with a state serves a checkpoint or a style only with
its state loaded (`state=`, or a model directory's state.npz): otherwise
weights trained with running statistics would be served with init_ynet's,
and Predictor raises NotImplementedError. Styles share the base's state.

With a segmentation backbone (the config's segmentation_model_fp exists,
or a model directory's params.npz holds it) a request's semantic input is
the segmented map; with segment_in_step (`export_model(...,
segment_in_step=True)`) it is the preprocessed RGB scene and the backbone
runs inside the predict step.

    python -m mst_tpu_torch.serve export|check|serve ...

takes mst_tpu's flags, plus --device (cuda, which must exist, or cpu) in
place of --platforms; `serve` starts the HTTP daemon (serve_http.py).
"""

import collections
import json
import os
import pathlib
import threading

import numpy as np
import torch

from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.config import step_config, ynet_config
from mst_tpu_torch.models import segmentation as seg_lib
from mst_tpu_torch.models.ynet import init_ynet, is_adapter_leaf
from mst_tpu_torch.train.steps import make_predict_step

FORMAT = "mst_tpu_torch.serve/1"
_PARAMS_FILE = "params.npz"
_STATE_FILE = "state.npz"
_MANIFEST_FILE = "manifest.json"


def _load_base(init, path, adapters_optional=True):
    """The base weights of a checkpoint, laid over `init` strictly: every
    parameter of `init` must be in the checkpoint, and every key of the
    checkpoint must name a parameter of `init` with its shape. With
    adapters_optional, the adapter leaves (is_adapter_leaf) may be
    missing: a base model trained without them keeps the init's until a
    style delta brings them, as the reference's fine-tune flow does. The
    embed network's and the fusion encoder's weights are the base model's
    own and are required. The backbone's may be missing: a whole-model
    checkpoint leaves them out, and they come from their own file."""
    ckpt = io.params_from_numpy(io.load_checkpoint(path))
    missing = sorted(k for k in io.flatten(init).keys()
                     - io.flatten(ckpt).keys()
                     if not (adapters_optional and is_adapter_leaf(k))
                     and not k.startswith("segmentation/"))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} parameters "
                       f"of the model, e.g. {missing[:3]}")
    return io.overlay(init, ckpt, strict=True)


def _overlay_npz(base, flat, what):
    """Copy-on-write overlay of a flat npz {'a/b/c': array} (mst_tpu's
    layout) onto the port's tree `base`, as strict as mst_tpu's serving
    overlay (serve.py:67-101): a key that names no leaf of `base` raises
    KeyError; a leaf of another dtype (the npz's own, checked before any
    cast) or shape raises ValueError. Untouched tensors stay shared with
    `base`, so a style costs only its delta."""
    leaves = io.flatten(base)
    for key, val in flat.items():
        if key not in leaves:
            raise KeyError(f"{what} key '{key}' does not exist in the base "
                           "model")
        old = torch.empty(0, dtype=leaves[key].dtype).numpy().dtype
        if val.dtype != old:
            raise ValueError(f"{what} key '{key}' has dtype {val.dtype}, the "
                             f"base model has {old}")
    return io.overlay(base, io.params_from_numpy(flat), strict=True)


class Predictor:
    # a checkpoint may lack the adapter leaves (_load_base)
    _adapters_optional = True

    def __init__(self, params: dict, checkpoint=None, *, device=None,
                 seed: int = 0, state=None, **step_overrides):
        """params: flat config dict; checkpoint: optional mst_tpu npz of
        the whole model (see _load_base); state: optional npz of the model
        state (every leaf of it, as a model directory's state.npz);
        device: 'cuda' (the default, which must exist) or 'cpu';
        step_overrides: StepConfig fields, e.g. eval_k_chunk=5. The
        config's compute_dtype (float32 or bfloat16) sets the convs'
        dtype; the weights and the state stay as loaded (f32)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card by its index, which other threads (the daemon's
            # dispatcher) need to run on it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mcfg = ynet_config(params)
        self.scfg = step_config(params, **step_overrides)
        weights, self.state = init_ynet(torch.Generator().manual_seed(seed),
                                        self.mcfg, self.device)
        if self.mcfg.segmentation:
            weights["segmentation"] = seg_lib.load_params(
                params["segmentation_model_fp"], self.device)
        self._state_loaded = state is not None
        if state is not None:
            flat = io.load_checkpoint(state)
            missing = sorted(io.flatten(self.state).keys() - flat.keys())
            if missing:
                raise KeyError(f"state {state} lacks {len(missing)} leaves "
                               f"of the model state, e.g. {missing[:3]}")
            # the backbone's adapted statistics (e_unfreeze) are the
            # file's own: the init state has none to check them against
            seg_bn = {k: v for k, v in flat.items()
                      if k.startswith("segmentation_bn/")}
            self.state = _overlay_npz(
                self.state, {k: v for k, v in flat.items()
                             if k not in seg_bn}, "state")
            if seg_bn:
                self.state = {**self.state, **io.state_from_numpy(
                    seg_bn, self.device)}
        if checkpoint is not None:
            self._refuse_trained_weights("a checkpoint")
            weights = _load_base(weights, checkpoint,
                                 self._adapters_optional)
        self.params = weights
        self._styles = collections.OrderedDict()
        # the HTTP daemon's handler threads register and evict styles
        # while its dispatcher thread reads them
        self._styles_lock = threading.Lock()
        # the resident styles' cap: None or <= 0 means unbounded; beyond
        # it the least recently used style is evicted (predict marks use)
        self.max_styles = None
        self._predict = make_predict_step(self.mcfg, self.scfg)

    def add_style(self, name, delta_path):
        """Register a motion style: a delta checkpoint (the trainable-only
        npz of an adapter fine-tune) overlaid on the base weights, strict
        on keys, shapes and dtypes (_overlay_npz). The styles share the
        model state. -> the names this registration evicted (empty unless
        max_styles is set and was exceeded)."""
        self._refuse_trained_weights("a style")
        overlaid = _overlay_npz(self.params, io.load_checkpoint(delta_path),
                                "delta")
        with self._styles_lock:
            self._styles[name] = overlaid
            self._styles.move_to_end(name)
            evicted = []
            if self.max_styles is not None and int(self.max_styles) > 0:
                while len(self._styles) > int(self.max_styles):
                    evicted.append(self._styles.popitem(last=False)[0])
        return evicted

    def _refuse_trained_weights(self, what):
        if self.state and not self._state_loaded:
            raise NotImplementedError(
                f"train_net={self.mcfg.train_net!r} has batch-norm running "
                f"statistics and none were loaded: {what} would be served "
                "with init_ynet's statistics; pass state= (a state npz, as "
                "a model directory's state.npz)")

    @property
    def styles(self):
        with self._styles_lock:
            return sorted(self._styles)

    def _weights(self, style):
        if style is None:
            return self.params
        with self._styles_lock:
            weights = self._styles.get(style)
            if weights is not None:
                self._styles.move_to_end(style)
        if weights is None:
            raise ValueError(f"unknown serving style '{style}'; registered: "
                             f"{self.styles or '(none; call add_style)'}")
        return weights

    def _inputs(self, semantic, observed, seed, generator=None):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return (torch.as_tensor(semantic, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(observed, dtype=torch.float32,
                                device=self.device), generator)

    @torch.no_grad()
    def forward(self, semantic, observed, seed=0, style=None):
        """Stage 1: encoder, goal decoder and sampling -> (features,
        waypoint samples (K, B, n_wp, 2) in model-space pixels)."""
        return self._predict.forward(
            self._weights(style), self.state,
            *self._inputs(semantic, observed, seed))

    @torch.no_grad()
    def decode(self, features, waypoint_samples, style=None):
        """Stage 2: the K trajectory decodes -> (K, B, pred_len, 2) raw px."""
        trajs = self._predict.decode_trajs(self._weights(style), features,
                                           waypoint_samples)
        return trajs / self.scfg.resize_factor

    @torch.no_grad()
    def predict(self, semantic, observed, seed=0, generator=None, block=True,
                style=None):
        """semantic (1, H, W, C) + observed (B, obs_len, 2) model-space px
        -> {trajectories (K, B, pred_len, 2), waypoints (K, B, n_wp, 2)}
        in raw-image pixels, as numpy arrays.

        The draws come from `generator`, else from a generator on the
        device seeded with `seed`. block=False returns the device tensors
        without the host copy. style selects a registered style (None: the
        base weights); using one marks it recently used."""
        weights = self._weights(style)
        out = self._predict(weights, self.state,
                            *self._inputs(semantic, observed, seed,
                                          generator))
        if not block:
            return out
        return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the model directory
# ---------------------------------------------------------------------------

def export_model(experiment, out_dir, height, width, batch_size,
                 semantic_channels=None, segment_in_step=False,
                 eval_k_chunk=None):
    """Write a restored Experiment's model to the model directory out_dir.

    Args:
      experiment: mst_tpu_torch.train.trainer.Experiment with its
        checkpoints restored (restore_model / load_params).
      height, width: model-space scene-map size; multiples of the encoder's
        division factor (2^n_stages), which preprocessing pads to.
      batch_size: trajectories per predict call (the daemon's B).
      semantic_channels: channels of the semantic input; defaults to
        n_semantic_classes, or 3 with segment_in_step.
      segment_in_step: the input is the preprocessed RGB scene and the
        segmentation backbone (which params.npz holds, as it holds it
        whenever the experiment has one) runs inside the predict step.
      eval_k_chunk: overrides the config's K-chunking of the decode.

    Returns the manifest dict: mst_tpu's fields (format FORMAT, and
    `platforms` the device type exported for; `compute_dtype` the config's,
    which LoadedModel serves in), and `config`.
    """
    p = experiment.params
    div = experiment.division_factor
    if height % div or width % div:
        raise ValueError(f"height/width must be multiples of {div} "
                         f"(got {height}x{width}); preprocess pads to this")
    config = dict(p)
    if eval_k_chunk is not None:
        config["eval_k_chunk"] = int(eval_k_chunk)
    step_config(config)  # raises on a flag the port does not serve
    if semantic_channels is not None:
        sem_c = semantic_channels
    else:
        sem_c = 3 if segment_in_step else int(p["n_semantic_classes"])

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / _PARAMS_FILE, **io.params_to_numpy(experiment.model_params))
    np.savez(out / _STATE_FILE, **io.state_to_numpy(experiment.model_state))
    manifest = {
        "format": FORMAT,
        "platforms": [experiment.device.type],
        "semantic_shape": [1, height, width, sem_c],
        "observed_shape": [batch_size, int(p["obs_len"]), 2],
        "obs_len": int(p["obs_len"]),
        "pred_len": int(p["pred_len"]),
        "n_goal": int(p["n_goal"]),
        "n_traj": int(p["n_traj"]),
        "waypoints": list(map(int, p["waypoints"])),
        "resize_factor": float(p["resize_factor"]),
        "temperature": float(p.get("temperature", 1.0)),
        "use_TTST": bool(p.get("use_TTST", False)),
        "use_CWS": bool(p.get("use_CWS", False)),
        "compute_dtype": str(p.get("compute_dtype", "float32")),
        "segment_in_step": bool(segment_in_step),
        "network": p.get("network", "original"),
        "train_net": p.get("train_net"),
        "files": {"params": _PARAMS_FILE, "state": _STATE_FILE},
        "config": config,
    }
    with open(out / _MANIFEST_FILE, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class LoadedModel(Predictor):
    """A model directory written by export_model, on `device` ('cuda', the
    default, which must exist, or 'cpu'): the model rebuilt from the
    manifest's config, params.npz and state.npz put on the device once.
    Serves like Predictor (mst_tpu's LoadedModel: add_style with the LRU
    cap max_styles, predict with block=False); `manifest` is the dict
    export_model wrote. params.npz must hold every parameter, the adapter
    leaves too, as export_model writes it and as mst_tpu's exported
    program takes them. The backbone comes from params.npz when it holds
    one (in place of the config's segmentation_model_fp), and a
    directory exported with segment_in_step runs it in the predict
    step."""

    _adapters_optional = False

    def __init__(self, model_dir, device=None):
        d = pathlib.Path(model_dir)
        with open(d / _MANIFEST_FILE) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{d} holds format {manifest.get('format')!r}, not "
                f"{FORMAT!r}: export it with mst_tpu_torch.serve")
        files = manifest["files"]
        config = dict(manifest["config"])
        # the manifest's field, as mst_tpu's LoadedModel serves it
        config["compute_dtype"] = manifest["compute_dtype"]
        with np.load(d / files["params"]) as z:
            has_backbone = any(k.startswith("segmentation/")
                               for k in z.files)
        config["segmentation_model_fp"] = (str(d / files["params"])
                                           if has_backbone else None)
        super().__init__(config, d / files["params"], device=device,
                         state=d / files["state"],
                         segment_in_step=bool(manifest["segment_in_step"]))
        self.manifest = manifest


def load_model(model_dir, device=None):
    return LoadedModel(model_dir, device)


# ---------------------------------------------------------------------------
# CLI: python -m mst_tpu_torch.serve export|check|serve
# ---------------------------------------------------------------------------

def check(model, seed=0, styles=(), bench=0):
    """The `check` command on a loaded model: one predict (and one a style
    of `styles`, "NAME=DELTA" each), then with bench > 0 the closed-loop
    latency of `bench` requests (each its own seed, each ending in a host
    read) and the open-loop throughput (all dispatched with block=False,
    the last read). Prints as mst_tpu's check does; -> the bench's stats
    dict, or None."""
    import time

    m = model.manifest
    rng = np.random.default_rng(seed)
    _, h, w, c = m["semantic_shape"]
    b, obs, _ = m["observed_shape"]
    semantic = rng.normal(size=(1, h, w, c)).astype(np.float32)
    observed = rng.uniform(0.25 * min(h, w), 0.75 * min(h, w),
                           size=(b, obs, 2)).astype(np.float32)
    t0 = time.perf_counter()
    out = model.predict(semantic, observed, seed=seed)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.predict(semantic, observed, seed=seed + 1)
    dt2 = time.perf_counter() - t0
    print(f"predict ok: trajectories {out['trajectories'].shape} "
          f"waypoints {out['waypoints'].shape} "
          f"(first call {dt:.2f}s, second {dt2:.3f}s)")
    if not np.isfinite(out["trajectories"]).all():
        raise RuntimeError("predict returned non-finite trajectories")

    for spec in styles:
        name, _, delta = spec.partition("=")
        if not delta:
            raise SystemExit(f"--styles wants NAME=DELTA, got '{spec}'")
        model.add_style(name, delta)
        t0 = time.perf_counter()
        sout = model.predict(semantic, observed, seed=seed, style=name)
        if not np.isfinite(sout["trajectories"]).all():
            raise RuntimeError(f"style '{name}' returned non-finite "
                               "trajectories")
        print(f"style '{name}' ok ({time.perf_counter() - t0:.3f}s)")

    if not bench:
        return None
    lat = []
    for i in range(bench):
        t0 = time.perf_counter()
        out = model.predict(semantic, observed, seed=seed + 2 + i)
        out["trajectories"][0, 0, 0, 0]  # host copy = request complete
        lat.append(time.perf_counter() - t0)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    # open loop: with TTST on, k-means syncs the host each iteration, so
    # the requests cannot queue up on the device ahead of the host
    t0 = time.perf_counter()
    outs = [model.predict(semantic, observed, seed=seed + 2 + bench + i,
                          block=False) for i in range(bench)]
    float(outs[-1]["trajectories"][0, 0, 0, 0])
    pipelined = bench * b / (time.perf_counter() - t0)
    stats = {
        "metric": "serving_latency_ms",
        "n": bench,
        "batch": b,
        "p50": round(float(np.percentile(lat_ms, 50)), 2),
        "p95": round(float(np.percentile(lat_ms, 95)), 2),
        "mean": round(float(lat_ms.mean()), 2),
        "traj_per_sec": round(b / float(np.asarray(lat).mean()), 2),
        "pipelined_traj_per_sec": round(float(pipelined), 2),
    }
    print(json.dumps(stats))
    return stats


def _main():
    import argparse

    parser = argparse.ArgumentParser(
        description="export / check / serve a model directory")
    sub = parser.add_subparsers(dest="command", required=True)

    ex = sub.add_parser("export")
    ex.add_argument("--config_filename", required=True)
    ex.add_argument("--pretrained_ckpt", required=True)
    ex.add_argument("--tuned_ckpt", default=None)
    ex.add_argument("--out_dir", required=True)
    ex.add_argument("--height", type=int, required=True,
                    help="model-space scene-map height (post resize+pad)")
    ex.add_argument("--width", type=int, required=True)
    ex.add_argument("--batch_size", type=int, default=8)
    ex.add_argument("--network", default=None)
    ex.add_argument("--n_fusion", type=int, default=None)
    ex.add_argument("--semantic_channels", type=int, default=None)
    ex.add_argument("--segment_in_step", action="store_true")
    ex.add_argument("--eval_k_chunk", type=int, default=None)

    ck = sub.add_parser("check")
    ck.add_argument("--model_dir", required=True)
    ck.add_argument("--seed", type=int, default=0)
    ck.add_argument("--styles", nargs="+", default=[], metavar="NAME=DELTA",
                    help="motion-style deltas to register and predict with")
    ck.add_argument("--bench", type=int, default=0, metavar="N",
                    help="then time N requests (each its own seed) and "
                         "print p50/p95/mean ms and trajectories/s")

    sv = sub.add_parser("serve", help="HTTP daemon with continuous request "
                                      "batching (serve_http.py)")
    sv.add_argument("--model_dir", required=True)
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--styles", nargs="+", default=[], metavar="NAME=DELTA")
    sv.add_argument("--scene", nargs="+", default=[], metavar="NAME=NPY",
                    help="scenes to register: npy files holding the "
                         "preprocessed (1, H, W, C) semantic map")
    sv.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="how long the batcher waits to fill a batch")
    sv.add_argument("--max_queue", type=int, default=64,
                    help="pending-request bound; beyond it /predict "
                         "returns 503 + Retry-After; <= 0 means unbounded")
    sv.add_argument("--max_styles", type=int, default=32,
                    help="resident styles cap (LRU eviction); <= 0 means "
                         "unbounded")
    sv.add_argument("--max_scenes", type=int, default=32,
                    help="resident scene maps cap (LRU eviction); <= 0 "
                         "means unbounded")
    for p in (ex, ck, sv):
        p.add_argument("--device", default=None,
                       help="cuda (the default, which must exist) or cpu")

    args = parser.parse_args()
    if args.command == "serve":
        from mst_tpu_torch.serve_http import run_server

        run_server(args.model_dir, port=args.port, host=args.host,
                   styles=args.styles, scenes=args.scene,
                   max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
                   max_styles=args.max_styles, max_scenes=args.max_scenes,
                   device=args.device)
        return
    if args.command == "export":
        from mst_tpu_torch import config as config_lib
        from mst_tpu_torch.train.trainer import restore_model

        overrides = {}
        if args.network:
            overrides["network"] = args.network
        if args.n_fusion is not None:
            overrides["n_fusion"] = args.n_fusion
        params = config_lib.get_params(
            config_filename=args.config_filename, overrides=overrides)
        model = restore_model(params, bool(args.tuned_ckpt),
                              args.pretrained_ckpt, args.tuned_ckpt,
                              device=args.device)
        manifest = export_model(
            model, args.out_dir, args.height, args.width, args.batch_size,
            semantic_channels=args.semantic_channels,
            segment_in_step=args.segment_in_step,
            eval_k_chunk=args.eval_k_chunk)
        sizes = {f: os.path.getsize(os.path.join(args.out_dir, f))
                 for f in manifest["files"].values()}
        print(f"exported to {args.out_dir}: {json.dumps(sizes)}")
        return
    check(load_model(args.model_dir, args.device), seed=args.seed,
          styles=args.styles, bench=args.bench)


if __name__ == "__main__":
    _main()
