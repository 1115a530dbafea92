"""Serving: `Predictor`, the counterpart of mst_tpu.serve.LoadedModel
(mst_tpu/serve.py:225-338).

A Predictor is built from a config (a flat params dict, see config.py) and
optionally an mst_tpu npz checkpoint; without one the weights are random
from `seed`. It answers predict(semantic, observed) with all K sampled
trajectories, and serves motion styles: adapter deltas (LoRA factors, the
parallel adapters, the semantic adapter) overlaid on the base
weights, which stay shared. The model state (batch-norm running
statistics) is init_ynet's; loading a state file, export to a model
directory and the HTTP daemon are not ported yet. So a model with a state
(the serial adapters) serves only its own random weights: a checkpoint or
a style would bring weights trained with running statistics it cannot
load, and raises NotImplementedError.
"""

import numpy as np
import torch

from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.config import step_config, ynet_config
from mst_tpu_torch.models.ynet import init_ynet, is_adapter_leaf
from mst_tpu_torch.train.steps import make_predict_step


def _load_base(init, path):
    """The base weights of a checkpoint, laid over `init` strictly: every
    parameter of `init` must be in the checkpoint, and every key of the
    checkpoint must name a parameter of `init` with its shape. Only the
    adapter leaves (is_adapter_leaf) may be missing: a base model trained
    without them keeps the init's until a style delta brings them, as the
    reference's fine-tune flow does. The embed network's and the fusion
    encoder's weights are the base model's own and are required."""
    ckpt = io.params_from_numpy(io.load_checkpoint(path))
    missing = sorted(k for k in io.flatten(init).keys()
                     - io.flatten(ckpt).keys() if not is_adapter_leaf(k))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} parameters "
                       f"of the model, e.g. {missing[:3]}")
    return io.overlay(init, ckpt, strict=True)


class Predictor:
    def __init__(self, params: dict, checkpoint=None, *, device=None,
                 seed: int = 0, **step_overrides):
        """params: flat config dict; checkpoint: optional mst_tpu npz of
        the whole model (see _load_base); device: 'cuda' (the default,
        which must exist) or 'cpu'; step_overrides: StepConfig fields,
        e.g. eval_k_chunk=5."""
        self.device = resolve_device(device)
        self.mcfg = ynet_config(params)
        self.scfg = step_config(params, **step_overrides)
        weights, self.state = init_ynet(torch.Generator().manual_seed(seed),
                                        self.mcfg, self.device)
        if checkpoint is not None:
            self._refuse_trained_weights("a checkpoint")
            weights = _load_base(weights, checkpoint)
        self.params = weights
        self._styles = {}
        self._predict = make_predict_step(self.mcfg, self.scfg)

    def add_style(self, name, delta_path):
        """Register a motion style: a delta checkpoint (the trainable-only
        npz of an adapter fine-tune) overlaid on the base weights. Strict:
        every delta key must name an existing weight of the same shape.
        The styles share the Predictor's model state."""
        self._refuse_trained_weights("a style")
        delta = io.params_from_numpy(io.load_checkpoint(delta_path))
        self._styles[name] = io.overlay(self.params, delta, strict=True)

    def _refuse_trained_weights(self, what):
        if self.state:
            raise NotImplementedError(
                f"train_net={self.mcfg.train_net!r} has batch-norm running "
                f"statistics, and loading them is not ported yet: {what} "
                "would be served with init_ynet's statistics")

    @property
    def styles(self):
        return sorted(self._styles)

    def _weights(self, style):
        if style is None:
            return self.params
        if style not in self._styles:
            raise ValueError(f"unknown serving style '{style}'; registered: "
                             f"{self.styles or '(none; call add_style)'}")
        return self._styles[style]

    def _inputs(self, semantic, observed, seed):
        semantic = torch.as_tensor(np.asarray(semantic, np.float32),
                                   device=self.device)
        observed = torch.as_tensor(np.asarray(observed, np.float32),
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return semantic, observed, gen

    @torch.no_grad()
    def forward(self, semantic, observed, seed=0, style=None):
        """Stage 1: encoder, goal decoder and sampling -> (features,
        waypoint samples (K, B, n_wp, 2) in model-space pixels)."""
        return self._predict.forward(self._weights(style), self.state,
                                     *self._inputs(semantic, observed, seed))

    @torch.no_grad()
    def decode(self, features, waypoint_samples, style=None):
        """Stage 2: the K trajectory decodes -> (K, B, pred_len, 2) raw px."""
        trajs = self._predict.decode_trajs(self._weights(style), features,
                                           waypoint_samples)
        return trajs / self.scfg.resize_factor

    @torch.no_grad()
    def predict(self, semantic, observed, seed=0, style=None):
        """semantic (1, H, W, C) + observed (B, obs_len, 2) model-space px
        -> {trajectories (K, B, pred_len, 2), waypoints (K, B, n_wp, 2)}
        as numpy arrays in raw-image pixels."""
        out = self._predict(self._weights(style), self.state,
                            *self._inputs(semantic, observed, seed))
        return {k: v.cpu().numpy() for k, v in out.items()}
