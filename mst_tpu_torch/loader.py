"""The model directory's loader: serves the programs that
serve.export_model writes (counterpart of mst_tpu/serve.py's
LoadedModel), without the port's model code.

    model_dir/
      manifest.json  mst_tpu's fields: input shapes, protocol constants,
                     `platforms` (the one device type the programs were
                     exported for), `files`; and `torch_version`, the
                     torch that wrote the programs, and `config`
      forward.pt2    torch.export program: pad, encoder, goal decoder,
                     goal and waypoint sampling (TTST's k-means, CWS),
                     and with segment_in_step the backbone first
      decode.pt2     torch.export program: the K-chunked trajectory
                     decode ending in the fused predictor kernel
      params.npz     every parameter, in mst_tpu's flat-key HWIO layout
      state.npz      the model state (batch-norm running statistics)

The forward takes (params, state, semantic, observed, key) and returns
(features, waypoint samples); the decode takes (params, features,
waypoint samples). Params and state are inputs, so one program serves
every style. The key is an int64 (2,) tensor (ops/sampling.Key), so the
draws are the program's own. This module imports no model code: only
torch, numpy, the weight bridge (io) and the three serving kernels, whose
custom ops (mst_tpu_torch::softargmax2d_rows,
mst_tpu_torch::fused_predictor_softargmax and, in a program exported on
the card, TTST's mst_tpu_torch::kmeans2d) the programs call, and whose
`launches` count those calls, and ops/conv.py, whose op
(mst_tpu_torch::conv2d_onednn) a CPU program's backbone calls.
"""

import collections
import json
import pathlib
import threading

import torch
from torch.utils import _pytree as pytree

from mst_tpu_torch import io, resolve_device
# registers the custom ops the programs call
from mst_tpu_torch.ops import conv  # noqa: F401 (the backbone's CPU op)
from mst_tpu_torch.ops.kernels import (  # noqa: F401
    fused_predict, kmeans, softargmax_rows)
from mst_tpu_torch.ops.sampling import key_from_generator, key_from_seed

FORMAT = "mst_tpu_torch.serve/2"
FORWARD_FILE = "forward.pt2"
DECODE_FILE = "decode.pt2"
PARAMS_FILE = "params.npz"
STATE_FILE = "state.npz"
MANIFEST_FILE = "manifest.json"


def resolve_key(key=None, seed=0, generator=None, device=None):
    """The request's key on `device`: `key` itself (two 32-bit words),
    else two draws of `generator`, else the key of `seed`
    (sampling.key_from_seed)."""
    if key is not None:
        return torch.as_tensor(key, dtype=torch.int64).to(device)
    if generator is not None:
        return key_from_generator(generator, device)
    return key_from_seed(seed, device)


def card_device(device=None):
    """resolve_device, with a CUDA device given its index, which other
    threads (the daemon's dispatcher) need to run on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def overlay_npz(base, flat, what):
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


class StyleTable:
    """Motion styles over base weights, with mst_tpu's LRU cap
    `max_styles` (None or <= 0: unbounded; beyond it the least recently
    used style is evicted, and predict marks use). The HTTP daemon's
    handler threads register and evict styles while its dispatcher
    thread reads them, hence the lock."""

    def __init__(self):
        self._styles = collections.OrderedDict()
        self._styles_lock = threading.Lock()
        self.max_styles = None

    def _register(self, name, weights):
        with self._styles_lock:
            self._styles[name] = weights
            self._styles.move_to_end(name)
            evicted = []
            if self.max_styles is not None and int(self.max_styles) > 0:
                while len(self._styles) > int(self.max_styles):
                    evicted.append(self._styles.popitem(last=False)[0])
        return evicted

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


def _program_inputs(program, n_args, path):
    """The pytree of an exported program's positional inputs, each leaf
    its flat index."""
    spec = program.call_spec.in_spec
    args, _ = pytree.tree_unflatten(list(range(spec.num_leaves)), spec)
    if len(args) != n_args:
        raise ValueError(f"{path} takes {len(args)} inputs, not {n_args}")
    return args


def _strict_tree(flat_npz, want, what, path, device):
    """The npz as the program's input tree: exactly the leaves the program
    takes, else KeyError."""
    keys = set(io.flatten(want))
    missing = sorted(keys - flat_npz.keys())
    extra = sorted(flat_npz.keys() - keys)
    if missing or extra:
        raise KeyError(
            f"{path} lacks {len(missing)} {what} of the exported program "
            f"(e.g. {missing[:3]}) and holds {len(extra)} it does not take "
            f"(e.g. {extra[:3]})")
    return io.params_from_numpy(flat_npz, device)


class LoadedModel(StyleTable):
    """A model directory written by serve.export_model, on `device`
    ('cuda', the default, which must exist, or 'cpu'): its forward and
    decode programs loaded with torch.export.load, params.npz and
    state.npz put on the device once. It does not rebuild the model. The
    directory serves only on the device type it was exported for (the
    programs hold that device in their factory ops) and only under the
    torch version that wrote it; a directory of another format, such as
    mst_tpu_torch.serve/1 (weights and a config, no program), is refused
    with the reason. `manifest` is the dict export_model wrote."""

    def __init__(self, model_dir, device=None):
        super().__init__()
        d = pathlib.Path(model_dir)
        with open(d / MANIFEST_FILE) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{d} holds format {manifest.get('format')!r}, not "
                f"{FORMAT!r}, whose forward.pt2 and decode.pt2 this loader "
                "serves: export it again with python -m mst_tpu_torch.serve "
                "export")
        self.device = card_device(device)
        if manifest["platforms"] != [self.device.type]:
            raise ValueError(
                f"{d} was exported for {manifest['platforms']} and its "
                f"programs run only there, not on {self.device.type}: "
                "export it on the device that serves it")
        if manifest["torch_version"] != torch.__version__:
            raise ValueError(
                f"{d}'s programs were written by torch "
                f"{manifest['torch_version']}, this is torch "
                f"{torch.__version__}: export it again with this torch")
        self.manifest = manifest
        files = manifest["files"]
        forward = torch.export.load(d / files["forward"])
        decode = torch.export.load(d / files["decode"])
        p_in, s_in = _program_inputs(forward, 5, d / files["forward"])[:2]
        self.params = _strict_tree(io.load_checkpoint(d / files["params"]),
                                   p_in, "parameters", d / files["params"],
                                   self.device)
        self.state = _strict_tree(io.load_checkpoint(d / files["state"]),
                                  s_in, "state leaves", d / files["state"],
                                  self.device)
        self._forward = forward.module()
        self._decode = decode.module()
        self._rf = float(manifest["resize_factor"])

    def add_style(self, name, delta_path):
        """Register a motion style: a delta checkpoint overlaid on the
        base weights, strict on keys, shapes and dtypes (overlay_npz);
        the programs take it as their params. -> the names this
        registration evicted (empty unless max_styles was exceeded)."""
        return self._register(name, overlay_npz(
            self.params, io.load_checkpoint(delta_path), "delta"))

    def _inputs(self, semantic, observed):
        return (torch.as_tensor(semantic, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(observed, dtype=torch.float32,
                                device=self.device))

    @torch.no_grad()
    def forward(self, semantic, observed, key=None, seed=0, generator=None,
                style=None):
        """forward.pt2 -> (features, waypoint samples (K, B, n_wp, 2) in
        model-space pixels)."""
        return self._forward(self._weights(style), self.state,
                             *self._inputs(semantic, observed),
                             resolve_key(key, seed, generator, self.device))

    @torch.no_grad()
    def decode(self, features, waypoint_samples, style=None):
        """decode.pt2 -> (K, B, pred_len, 2) raw px."""
        return self._decode(self._weights(style), features,
                            waypoint_samples) / self._rf

    @torch.no_grad()
    def predict(self, semantic, observed, key=None, seed=0, generator=None,
                block=True, style=None):
        """semantic (1, H, W, C) + observed (B, obs_len, 2) model-space px
        -> {trajectories (K, B, pred_len, 2), waypoints (K, B, n_wp, 2)}
        in raw-image pixels, as numpy arrays.

        The draws come from `key` (int64 (2,)), else from a key drawn from
        `generator`, else from the key of `seed`, as in Predictor.
        block=False returns the device tensors without the host copy.
        style selects a registered style (None: the base weights)."""
        weights = self._weights(style)
        features, wps = self._forward(
            weights, self.state, *self._inputs(semantic, observed),
            resolve_key(key, seed, generator, self.device))
        out = {"trajectories": self._decode(weights, features, wps) /
               self._rf, "waypoints": wps / self._rf}
        if not block:
            return out
        return {k: v.cpu().numpy() for k, v in out.items()}


def load_model(model_dir, device=None):
    return LoadedModel(model_dir, device)
