"""The probe paths of mst_tpu_torch against the JAX package, on the CPU in
f32: the 3x3 conv kernels' and the decoder-chain kernels' wrappers (which
take their plain versions on CPU tensors) against the TPU probes' Pallas
kernels run in interpret mode, as the probes' own --cpu mode runs them,
and the probe entry points themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.pallas_chain_probe import (pallas_chain, pallas_chain_v2,
                                           xla_chain)
from benchmarks.pallas_conv_probe import (pallas_conv3x3, pallas_conv3x3_v2,
                                          xla_conv3x3)
from mst_tpu.ops.pallas.fused_predict import \
    unify_packed_stats as j_unify_packed_stats
from mst_tpu.ops.softargmax import softargmax2d_packed as j_packed
from mst_tpu_torch.ops import softargmax
from mst_tpu_torch.ops.kernels import conv3x3, decoder_chain
from mst_tpu_torch.probes import chain_probe, conv_probe

CONV_RTOL = 1e-5  # f32, the same products summed in another order
CHAIN_TOL = 1e-4  # px; the JAX probe's own oracle check gives ~2e-5


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def conv_inputs(rng, B, H, W, C, Co):
    return (rng.normal(scale=0.5, size=(B, H, W, C)).astype(np.float32),
            rng.normal(scale=0.05, size=(3, 3, C, Co)).astype(np.float32))


def chain_inputs(rng, KB, Hp, Wp, C, CA, P):
    """x, wa, ba, wb, bb, wpred, bpred at the TPU probe's scales."""
    def mk(shape, scale):
        return rng.normal(scale=scale, size=shape).astype(np.float32)
    return (mk((KB, Hp, Wp, C), 0.5), mk((3, 3, C, CA), 0.08), mk((CA,), 0.1),
            mk((3, 3, CA, CA), 0.08), mk((CA,), 0.1), mk((CA, 4 * P), 0.2),
            mk((4 * P,), 0.1))


@pytest.mark.parametrize("port,pallas", [
    (conv3x3.conv3x3_taps, lambda x, w: pallas_conv3x3(x, w, True)),
    (conv3x3.conv3x3_im2col, lambda x, w: pallas_conv3x3_v2(x, w, 8, True)),
    (conv3x3.conv3x3_im2col, lambda x, w: pallas_conv3x3_v2(x, w, 16, True)),
], ids=["taps-v1", "im2col-v2.bh8", "im2col-v2.bh16"])
def test_conv3x3_matches_pallas(rng, port, pallas):
    x, w = conv_inputs(rng, 2, 16, 32, 8, 8)
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(port(t(x), t(w)).numpy(), want,
                               rtol=CONV_RTOL, atol=1e-6)


@pytest.mark.parametrize("port,pallas", [
    (decoder_chain.chain_plane,
     lambda *a: pallas_chain(*a, 3, True)),
    (decoder_chain.chain_stream,
     lambda *a: pallas_chain_v2(*a, 3, 16, True)),
], ids=["plane-v1", "stream-v2.bh16"])
def test_chain_matches_pallas(rng, port, pallas):
    args = chain_inputs(rng, 2, 32, 24, 8, 16, 3)
    want = np.asarray(pallas(*map(jnp.asarray, args)))
    got = port(*map(t, args), 3)
    assert got.shape == (2, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=CHAIN_TOL)


@pytest.mark.parametrize("port", [conv3x3.conv3x3_taps,
                                  conv3x3.conv3x3_im2col])
def test_conv3x3_ragged_matches_xla(rng, port):
    """H and W divisible by no tile: the port takes any shape."""
    x, w = conv_inputs(rng, 1, 37, 53, 8, 16)
    want = np.asarray(xla_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(port(t(x), t(w)).numpy(), want,
                               rtol=CONV_RTOL, atol=1e-6)


@pytest.mark.parametrize("port", [decoder_chain.chain_plane,
                                  decoder_chain.chain_stream])
def test_chain_ragged_matches_xla(rng, port):
    P = 5
    args = chain_inputs(rng, 2, 37, 53, 8, 16, P)
    want = np.asarray(xla_chain(*map(jnp.asarray, args), P,
                                f32_logits=True))  # (KB, P, 2)
    got = port(*map(t, args), P)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               atol=CHAIN_TOL)


@pytest.mark.parametrize("port", [decoder_chain.chain_plane,
                                  decoder_chain.chain_stream])
@pytest.mark.parametrize("bias", ["zero", "equal across sub-positions"])
def test_chain_uniform_logits_closed_form(rng, port, bias):
    """With wpred = 0 and a predictor bias equal across the four
    sub-positions of each channel, every full-resolution map is uniform:
    X = (2 Wp - 1) / 2 and Y = (2 Hp - 1) / 2 (up to the eps term)."""
    KB, Hp, Wp, P = 2, 12, 20, 3
    x, wa, ba, wb, bb, wpred, _ = map(t, chain_inputs(rng, KB, Hp, Wp, 8, 16,
                                                      P))
    bpred = torch.zeros(4 * P) if bias == "zero" else \
        t(rng.normal(size=P)).repeat(4)
    got = port(x, wa, ba, wb, bb, torch.zeros_like(wpred), bpred, P)
    np.testing.assert_allclose(got[:, 0].numpy(), (2 * Wp - 1) / 2,
                               atol=1e-3)
    np.testing.assert_allclose(got[:, 1].numpy(), (2 * Hp - 1) / 2,
                               atol=1e-3)


def test_softargmax2d_packed_matches_jax(rng):
    x = rng.normal(scale=3.0, size=(3, 12, 20, 4 * 5)).astype(np.float32)
    want = np.asarray(j_packed(jnp.asarray(x), 5))
    np.testing.assert_allclose(softargmax.softargmax2d_packed(t(x), 5).numpy(),
                               want, rtol=1e-5, atol=1e-4)


def test_unify_packed_stats_matches_jax(rng):
    P = 4
    m = rng.normal(scale=5.0, size=(1, 4 * P)).astype(np.float32)
    s = rng.uniform(0.5, 50, size=(1, 4 * P)).astype(np.float32)
    sx = s * rng.uniform(0, 30, size=(1, 4 * P)).astype(np.float32)
    sy = s * rng.uniform(0, 20, size=(1, 4 * P)).astype(np.float32)
    want = j_unify_packed_stats(*map(jnp.asarray, (m, s, sx, sy)), P, 1e-6)
    got = softargmax.unify_packed_stats(*map(t, (m, s, sx, sy)), P, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[0], np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("probe", [conv_probe, chain_probe],
                         ids=["conv", "chain"])
def test_probe_runs_on_cpu_when_told(probe, capsys):
    assert probe.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "(CPU: correctness only)" in out
    records = probe.run("cpu")
    assert [r["name"] for r in records] == [n for n, _ in probe.KERNELS]
    assert all(r["max_abs_err"] <= probe.CPU_TOL for r in records)


@pytest.mark.parametrize("probe", [conv_probe, chain_probe],
                         ids=["conv", "chain"])
def test_probe_needs_a_card_unless_told(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run()


@pytest.mark.parametrize("fn,args", [
    (conv3x3.conv3x3_taps, lambda: (torch.zeros(1, 4, 4, 32),
                                    torch.zeros(3, 3, 32, 128))),
    (decoder_chain.chain_stream, lambda: (
        torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 128),
        torch.zeros(128), torch.zeros(3, 3, 128, 128), torch.zeros(128),
        torch.zeros(128, 12), torch.zeros(12), 3)),
])
def test_wrappers_refuse_other_devices(fn, args):
    """A CPU tensor takes the plain version; any device but cpu and cuda
    raises before a launch."""
    a = args()
    assert fn(*a).shape[0] == 1
    with pytest.raises(ValueError, match="unsupported device"):
        fn(a[0].to("meta"), *a[1:])
