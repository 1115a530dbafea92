"""A model directory's programs against mst_tpu's on the CPU at small
width (test_torch_port_export.py's model: encoder 8,8,16,16,16, B = 2 at
64 x 96, n_goal 5, TTST on, mosa_2 with every lora_B moved): both
packages export the same weights, mst_tpu for the CPU with its unpacked
decode (packed_decode=False, the math the port's decode runs); mst_tpu's
forward.jaxir draws the waypoints, and decode.pt2 fed its features and
waypoints lands within DECODE_TOL of decode.jaxir; forward.pt2's
features lie within 1e-4 of each map's max from forward.jaxir's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu import config as jconfig
from mst_tpu import serve as jserve
from mst_tpu.models import ynet as jynet
from mst_tpu.train.trainer import Experiment as JExperiment
from mst_tpu_torch import io
from mst_tpu_torch.ops.sampling import key_from_seed
from tests.test_torch_port_export import (B, SMALL, H, W, export, inputs,
                                          two_threads)  # noqa: F401

# raw px, decode.pt2 against decode.jaxir. The logits agree to 3e-8; the
# rest is the soft-argmax of a near-uniform 64 x 96 map, a 6144-term f32
# sum that XLA and ATen take in other orders: on the same logits the two
# packages' soft-argmax lie 1.2e-4 raw px apart (3e-5 model px, 6-9 f32
# ulps of the ~47.5 model-px coordinates), and decode.pt2 lay 0.9e-4 to
# 1.4e-4 raw px from decode.jaxir over six seeds, while decode.jaxir
# equals mst_tpu's eager unpacked decode exactly.
DECODE_TOL = 2e-4
FEATURE_TOL = 1e-4  # of each feature map's max


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """-> (params, the port's directory, mst_tpu's LoadedModel of the same
    weights)."""
    tmp = tmp_path_factory.mktemp("both")
    params, d, _, _ = export(tmp, "port")
    trees = (jax.tree.map(jnp.asarray, io.unflatten(io.load_checkpoint(
        d / "params.npz"))), {})
    step_config = JExperiment._step_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jynet, "init_ynet", lambda key, cfg: trees)
        mp.setattr(JExperiment, "_step_config",
                   lambda self, *a, **k: step_config(self, *a, **k)._replace(
                       packed_decode=False))
        jexp = JExperiment(jconfig.get_params(
            config_filename="sdd_shortterm_eval.yaml", overrides=SMALL))
        jserve.export_model(jexp, tmp / "jax", H, W, B, platforms=("cpu",))
    return params, d, jserve.load_model(tmp / "jax")


def test_decode_program_matches_mst_tpus(both):
    params, d, jmodel = both
    semantic, observed = inputs(3)
    jfeats, jwps = jmodel._forward.call(jmodel.params, jmodel.state,
                                        semantic, observed,
                                        jax.random.PRNGKey(0))
    want = np.asarray(jmodel._decode.call(jmodel.params, jfeats, jwps))
    weights = io.params_from_numpy(io.load_checkpoint(d / "params.npz"))
    decode = torch.export.load(d / "decode.pt2").module()
    got = decode(weights, [torch.tensor(np.asarray(f)) for f in jfeats],
                 torch.tensor(np.asarray(jwps))).numpy()
    assert got.shape == want.shape == (5, B, 12, 2)
    err = np.abs(got - want).max() / params["resize_factor"]
    assert err <= DECODE_TOL, err


def test_forward_program_features_match_mst_tpus(both):
    params, d, jmodel = both
    semantic, observed = inputs(4)
    jfeats, _ = jmodel._forward.call(jmodel.params, jmodel.state, semantic,
                                     observed, jax.random.PRNGKey(1))
    weights = io.params_from_numpy(io.load_checkpoint(d / "params.npz"))
    forward = torch.export.load(d / "forward.pt2").module()
    feats, wps = forward(weights, {}, torch.tensor(semantic),
                         torch.tensor(observed), key_from_seed(1))
    assert len(feats) == len(jfeats) and wps.shape == (5, B, 1, 2)
    for a, b in zip(feats, jfeats):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a.numpy() - b).max()
        assert err <= FEATURE_TOL * np.abs(b).max(), err
