"""Serving and deployment (counterpart of mst_tpu/serve.py).

`Predictor` serves a model built from a config (a flat params dict, see
config.py) and optionally an mst_tpu npz checkpoint and a state npz;
without a checkpoint the weights are random from `seed`. It answers
predict(semantic, observed) with all K sampled trajectories, and serves
motion styles: adapter deltas (LoRA factors, the parallel adapters, the
semantic adapter) overlaid on the base weights, which stay shared, with
mst_tpu's LRU cap on the resident styles.

`export_model` writes a model directory and `LoadedModel` (loader.py,
re-exported here) serves one. As mst_tpu's directory holds its forward
and decode programs as jax.export StableHLO, this one holds them as
torch.export programs, forward.pt2 and decode.pt2 (the layout is in
loader.py), written at the directory's fixed shapes, in the config's
compute dtype, for the device type the experiment is on. LoadedModel
runs those programs with the weights of params.npz and state.npz and
needs none of the port's model code: a process that cannot import
mst_tpu_torch.models, .train or .config serves the directory.

The draws of a request come from a key (ops/sampling.Key): `key`, or a
key drawn from `generator`, or the key of `seed`; a seed gives the same
draws in Predictor and in LoadedModel, and a key the same bits on the
CPU and on the card. TTST's k-means (ops/kmeans.py) is, on the card,
one launch of a hand-written kernel that runs every row's loop with no
host read (mst_tpu_torch::kmeans2d in a forward program exported
there); on the CPU it is one torch while_loop, in the forward program
too, whose condition reads one flag each iteration.

The model state is the batch norms' running statistics of the serial
adapters. A model with a state serves a checkpoint or a style only with
its state loaded (`state=`, or a model directory's state.npz): otherwise
weights trained with running statistics would be served with init_ynet's,
and Predictor raises NotImplementedError. Styles share the base's state.

With a segmentation backbone (the config's segmentation_model_fp exists,
or the experiment holds one) a request's semantic input is the segmented
map; with segment_in_step (`export_model(..., segment_in_step=True)`) it
is the preprocessed RGB scene and the backbone runs inside the predict
step, and inside forward.pt2.

    python -m mst_tpu_torch.serve export|check|serve ...

takes mst_tpu's flags, plus --device (cuda, which must exist, or cpu) in
place of --platforms; `serve` starts the HTTP daemon (serve_http.py).
This module imports the model code only inside Predictor and
export_model, so `check` and `serve` run without it.
"""

import json
import os
import pathlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mst_tpu_torch import io
from mst_tpu_torch.loader import (DECODE_FILE, FORMAT, FORWARD_FILE,
                                  MANIFEST_FILE, PARAMS_FILE, STATE_FILE,
                                  LoadedModel, StyleTable, card_device,
                                  load_model, overlay_npz, resolve_key)

__all__ = ["FORMAT", "LoadedModel", "Predictor", "check", "export_model",
           "load_model"]


def _load_base(init, path):
    """The base weights of a checkpoint, laid over `init` strictly: every
    parameter of `init` must be in the checkpoint, and every key of the
    checkpoint must name a parameter of `init` with its shape. The
    adapter leaves (is_adapter_leaf) may be missing: a base model trained
    without them keeps the init's until a style delta brings them, as the
    reference's fine-tune flow does. The embed network's and the fusion
    encoder's weights are the base model's own and are required. The
    backbone's may be missing: a whole-model checkpoint leaves them out,
    and they come from their own file."""
    from mst_tpu_torch.models.ynet import is_adapter_leaf

    ckpt = io.params_from_numpy(io.load_checkpoint(path))
    missing = sorted(k for k in io.flatten(init).keys()
                     - io.flatten(ckpt).keys()
                     if not is_adapter_leaf(k)
                     and not k.startswith("segmentation/"))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} parameters "
                       f"of the model, e.g. {missing[:3]}")
    return io.overlay(init, ckpt, strict=True)


class Predictor(StyleTable):
    def __init__(self, params: dict, checkpoint=None, *, device=None,
                 seed: int = 0, state=None, **step_overrides):
        """params: flat config dict; checkpoint: optional mst_tpu npz of
        the whole model (see _load_base); state: optional npz of the model
        state (every leaf of it, as a model directory's state.npz);
        device: 'cuda' (the default, which must exist) or 'cpu';
        step_overrides: StepConfig fields, e.g. eval_k_chunk=5. The
        config's compute_dtype (float32 or bfloat16) sets the convs'
        dtype; the weights and the state stay as loaded (f32)."""
        from mst_tpu_torch.config import step_config, ynet_config
        from mst_tpu_torch.models import segmentation as seg_lib
        from mst_tpu_torch.models.ynet import init_ynet
        from mst_tpu_torch.train.steps import make_predict_step

        super().__init__()
        self.device = card_device(device)
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
            self.state = overlay_npz(
                self.state, {k: v for k, v in flat.items()
                             if k not in seg_bn}, "state")
            if seg_bn:
                self.state = {**self.state, **io.state_from_numpy(
                    seg_bn, self.device)}
        if checkpoint is not None:
            self._refuse_trained_weights("a checkpoint")
            weights = _load_base(weights, checkpoint)
        self.params = weights
        self._predict = make_predict_step(self.mcfg, self.scfg)

    def add_style(self, name, delta_path):
        """Register a motion style: a delta checkpoint (the trainable-only
        npz of an adapter fine-tune) overlaid on the base weights, strict
        on keys, shapes and dtypes (loader.overlay_npz). The styles share
        the model state. -> the names this registration evicted (empty
        unless max_styles is set and was exceeded)."""
        self._refuse_trained_weights("a style")
        return self._register(name, overlay_npz(
            self.params, io.load_checkpoint(delta_path), "delta"))

    def _refuse_trained_weights(self, what):
        if self.state and not self._state_loaded:
            raise NotImplementedError(
                f"train_net={self.mcfg.train_net!r} has batch-norm running "
                f"statistics and none were loaded: {what} would be served "
                "with init_ynet's statistics; pass state= (a state npz, as "
                "a model directory's state.npz)")

    def _inputs(self, semantic, observed):
        return (torch.as_tensor(semantic, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(observed, dtype=torch.float32,
                                device=self.device))

    @torch.no_grad()
    def forward(self, semantic, observed, seed=0, style=None, key=None,
                generator=None):
        """Stage 1: encoder, goal decoder and sampling -> (features,
        waypoint samples (K, B, n_wp, 2) in model-space pixels)."""
        return self._predict.forward(
            self._weights(style), self.state,
            *self._inputs(semantic, observed),
            resolve_key(key, seed, generator, self.device))

    @torch.no_grad()
    def decode(self, features, waypoint_samples, style=None):
        """Stage 2: the K trajectory decodes -> (K, B, pred_len, 2) raw px."""
        trajs = self._predict.decode_trajs(self._weights(style), features,
                                           waypoint_samples)
        return trajs / self.scfg.resize_factor

    @torch.no_grad()
    def predict(self, semantic, observed, key=None, seed=0, generator=None,
                block=True, style=None):
        """semantic (1, H, W, C) + observed (B, obs_len, 2) model-space px
        -> {trajectories (K, B, pred_len, 2), waypoints (K, B, n_wp, 2)}
        in raw-image pixels, as numpy arrays.

        The draws come from `key` (int64 (2,)), else from a key drawn from
        `generator`, else from the key of `seed` (loader.resolve_key), as
        in LoadedModel. block=False returns the device tensors without
        the host copy. style selects a registered style (None: the base
        weights); using one marks it recently used."""
        weights = self._weights(style)
        out = self._predict(weights, self.state,
                            *self._inputs(semantic, observed),
                            resolve_key(key, seed, generator, self.device))
        if not block:
            return out
        return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the model directory
# ---------------------------------------------------------------------------

class _Stage(torch.nn.Module):
    """A predict step's stage as the module torch.export traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _like(program):
    """An exported program's outputs as zero tensors of their shapes and
    dtypes, on their device, in the outputs' pytree."""
    out = next(n for n in program.graph.nodes if n.op == "output")
    return pytree.tree_unflatten(
        [torch.zeros(n.meta["val"].shape, dtype=n.meta["val"].dtype,
                     device=n.meta["val"].device) for n in out.args[0]],
        program.call_spec.out_spec)


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
        whenever the experiment has one) runs inside forward.pt2.
      eval_k_chunk: overrides the config's K-chunking of the decode.

    Both programs are torch.export.export(..., strict=False) of the
    predict step's two stages at these shapes, in the config's compute
    dtype, on the experiment's device, whose type they serve on only.

    Returns the manifest dict: mst_tpu's fields (format FORMAT,
    `platforms` the device type exported for, `compute_dtype` the
    config's), `torch_version` and `config`.
    """
    from mst_tpu_torch.config import step_config, ynet_config
    from mst_tpu_torch.train.steps import make_predict_step

    p = experiment.params
    div = experiment.division_factor
    if height % div or width % div:
        raise ValueError(f"height/width must be multiples of {div} "
                         f"(got {height}x{width}); preprocess pads to this")
    config = dict(p)
    if eval_k_chunk is not None:
        config["eval_k_chunk"] = int(eval_k_chunk)
    scfg = step_config(config, segment_in_step=segment_in_step)
    if semantic_channels is not None:
        sem_c = semantic_channels
    else:
        sem_c = 3 if segment_in_step else int(p["n_semantic_classes"])

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    flat_params = io.params_to_numpy(experiment.model_params)
    flat_state = io.state_to_numpy(experiment.model_state)
    np.savez(out / PARAMS_FILE, **flat_params)
    np.savez(out / STATE_FILE, **flat_state)

    # the programs take the trees LoadedModel rebuilds from the npz files
    dev = experiment.device
    params = io.params_from_numpy(flat_params, dev)
    state = io.state_from_numpy(flat_state, dev)
    step = make_predict_step(ynet_config(config), scfg)
    semantic = torch.zeros((1, height, width, sem_c), device=dev)
    observed = torch.zeros((batch_size, int(p["obs_len"]), 2), device=dev)
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.no_grad():
        forward = torch.export.export(
            _Stage(step.forward), (params, state, semantic, observed, key),
            strict=False)
        decode = torch.export.export(
            _Stage(step.decode_trajs), (params, *_like(forward)),
            strict=False)
    for program, name in ((forward, FORWARD_FILE), (decode, DECODE_FILE)):
        # the example inputs (the weights, and the decode's full-size
        # features) would be saved with the program
        program.example_inputs = None
        torch.export.save(program, out / name)
    manifest = {
        "format": FORMAT,
        "platforms": [dev.type],
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
        "files": {"forward": FORWARD_FILE, "decode": DECODE_FILE,
                  "params": PARAMS_FILE, "state": STATE_FILE},
        "torch_version": torch.__version__,
        "config": config,
    }
    with open(out / MANIFEST_FILE, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


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
    # open loop: on the card no k-means trip reads the host, so requests
    # may queue up on the device ahead of it (on the CPU, and in a
    # program exported there, TTST's k-means reads a flag every trip)
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
