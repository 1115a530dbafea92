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


def _v1(x, w):
    return pallas_conv3x3(x, w, True)


def _v2(bh):
    return lambda x, w: pallas_conv3x3_v2(x, w, bh, True)


def conv_atol(C):
    """The f32 reference sums 9C products in another order than the
    float64 plain version: its absolute error grows as sqrt(9C), from 1e-6
    at the TPU probe's C = 8."""
    return 1e-6 * (C / 8) ** 0.5


def conv_out_channels(C):
    """The TPU probe's CPU shape has C = Co = 8; at the kernels' own
    channel counts Co is 128, the only Co they compute."""
    return 8 if C == 8 else conv3x3.CHANNELS_OUT


@pytest.mark.parametrize("port,pallas,C", [
    pytest.param(conv3x3.conv3x3_taps, _v1, 8, id="taps-v1"),
    pytest.param(conv3x3.conv3x3_im2col, _v2(8), 8, id="im2col-v2.bh8"),
    pytest.param(conv3x3.conv3x3_im2col, _v2(16), 8, id="im2col-v2.bh16"),
    pytest.param(conv3x3.conv3x3_taps, _v1, 32, id="taps-v1-C32"),
    pytest.param(conv3x3.conv3x3_taps, _v1, 96, id="taps-v1-C96"),
    pytest.param(conv3x3.conv3x3_im2col, _v2(8), 32, id="im2col-v2.bh8-C32"),
    pytest.param(conv3x3.conv3x3_im2col, _v2(16), 96,
                 id="im2col-v2.bh16-C96"),
])
def test_conv3x3_matches_pallas(rng, port, pallas, C):
    x, w = conv_inputs(rng, 2, 16, 32, C, conv_out_channels(C))
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(port(t(x), t(w)).numpy(), want,
                               rtol=CONV_RTOL, atol=conv_atol(C))


def _chain_v1(*a):
    return pallas_chain(*a, 3, True)


def _chain_v2(*a):
    return pallas_chain_v2(*a, 3, 16, True)


@pytest.mark.parametrize("port,pallas,C", [
    pytest.param(decoder_chain.chain_plane, _chain_v1, 8, id="plane-v1"),
    pytest.param(decoder_chain.chain_stream, _chain_v2, 8,
                 id="stream-v2.bh16"),
    pytest.param(decoder_chain.chain_plane, _chain_v1, 32, id="plane-v1-C32"),
    pytest.param(decoder_chain.chain_plane, _chain_v1, 96, id="plane-v1-C96"),
    pytest.param(decoder_chain.chain_stream, _chain_v2, 32,
                 id="stream-v2.bh16-C32"),
    pytest.param(decoder_chain.chain_stream, _chain_v2, 128,
                 id="stream-v2.bh16-C128"),
])
def test_chain_matches_pallas(rng, port, pallas, C):
    args = chain_inputs(rng, 2, 32, 24, C, 16, 3)
    want = np.asarray(pallas(*map(jnp.asarray, args)))
    got = port(*map(t, args), 3)
    assert got.shape == (2, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=CHAIN_TOL)


@pytest.mark.parametrize("port,C", [
    pytest.param(conv3x3.conv3x3_taps, 8, id="conv3x3_taps"),
    pytest.param(conv3x3.conv3x3_im2col, 8, id="conv3x3_im2col"),
    pytest.param(conv3x3.conv3x3_taps, 32, id="taps-C32"),
    pytest.param(conv3x3.conv3x3_taps, 96, id="taps-C96"),
    pytest.param(conv3x3.conv3x3_im2col, 32, id="im2col-C32"),
    pytest.param(conv3x3.conv3x3_im2col, 96, id="im2col-C96"),
])
def test_conv3x3_ragged_matches_xla(rng, port, C):
    """H and W divisible by no tile: the port takes any shape."""
    x, w = conv_inputs(rng, 1, 37, 53, C, 16 if C == 8 else 128)
    want = np.asarray(xla_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(port(t(x), t(w)).numpy(), want,
                               rtol=CONV_RTOL, atol=conv_atol(C))


@pytest.mark.parametrize("C", [32, 64, 96, 128])
def test_kmajor_weight_product_matches_conv(rng, C):
    """The kernels' K-major weight: one plain product of the im2col matrix
    (each tap's C channels padded with zeros to a whole 64-row K block)
    with it is the conv."""
    B, H, W = 2, 9, 11
    x, w = (t(a).double() for a in conv_inputs(rng, B, H, W, C, 128))
    wk = conv3x3.kmajor_weight(w)
    cp = wk.shape[1] // 9
    assert wk.shape == (128, 9 * cp) and cp % conv3x3.K_BLOCK == 0
    assert cp - C < conv3x3.K_BLOCK
    xp = torch.nn.functional.pad(x, (0, cp - C, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], dim=-1)
    np.testing.assert_allclose((cols @ wk.T).numpy(),
                               conv3x3.conv3x3_sum(x, w).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,tiles", [
    (conv_probe.FULL[:4], 160 * 11 * 15),  # the probe
    ((1, 5, 7, 64), 1),                    # smaller than a tile
    ((3, 40, 33, 96), 27),                 # ragged, two channel blocks
])
def test_l2_weight_bytes(shape, tiles):
    """Each 16 x 16 tile reads the (128, 9 Cp) weight from L2 once: at the
    probe's shape 7.79 GB a call, half of what the 8 x 16 tiles of the
    mma.sync kernels read (15.6 GB)."""
    B, H, W, C = shape
    cp = -(-C // 64) * 64
    assert conv3x3.l2_weight_bytes(B, H, W, C) == tiles * 9 * cp * 128 * 2
    if shape == conv_probe.FULL[:4]:
        assert conv3x3.l2_weight_bytes(B, H, W, C) * 2 == \
            160 * 22 * 15 * 9 * 128 * 128 * 2 <= 2 * 7.8e9


def test_conv_probe_holds_share_to_the_library():
    conv_probe.check_share("k", 1e-4, 1e-4)
    with pytest.raises(RuntimeError, match="more than the library"):
        conv_probe.check_share("k", 2e-4, 1e-4)


@pytest.mark.parametrize("port,C", [
    pytest.param(decoder_chain.chain_plane, 8, id="chain_plane"),
    pytest.param(decoder_chain.chain_stream, 8, id="chain_stream"),
    pytest.param(decoder_chain.chain_plane, 32, id="plane-C32"),
    pytest.param(decoder_chain.chain_plane, 96, id="plane-C96"),
    pytest.param(decoder_chain.chain_stream, 64, id="stream-C64"),
    pytest.param(decoder_chain.chain_stream, 128, id="stream-C128"),
])
def test_chain_ragged_matches_xla(rng, port, C):
    """H and W divisible by no 16 x 16 tile, P = 5 (4P = 20 of the kernels'
    64 predictor columns), at the TPU probe's C = 8 and at the channel
    counts the kernels take (C = 32 and 96 fill a 64-channel block
    partly)."""
    P = 5
    args = chain_inputs(rng, 2, 37, 53, C, 16, P)
    want = np.asarray(xla_chain(*map(jnp.asarray, args), P,
                                f32_logits=True))  # (KB, P, 2)
    got = port(*map(t, args), P)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               atol=CHAIN_TOL)


@pytest.mark.parametrize("n_pred", [3, 5, 12, 16])
def test_kmajor_predictor_product(rng, n_pred):
    """The kernels' predictor: K-major, zero rows up to 64 packed channels;
    its product with stage B's output is the predictor's, and the padded
    columns are zero."""
    b = t(rng.normal(size=(50, 128))).double()
    wpred = t(rng.normal(scale=0.2, size=(128, 4 * n_pred))).double()
    wk = decoder_chain.kmajor_predictor(wpred)
    assert wk.shape == (decoder_chain.MAX_PACKED, 128)
    got = b @ wk.T
    np.testing.assert_allclose(got[:, :4 * n_pred].numpy(),
                               (b @ wpred).numpy(), rtol=1e-12, atol=1e-12)
    assert not got[:, 4 * n_pred:].any()


@pytest.mark.parametrize("hw,tiles", [
    (chain_probe.FULL[1:3], 165),  # the probe: 11 x 15
    ((5, 7), 1),                   # smaller than a tile
    ((37, 53), 12),                # ragged: 3 x 4
    ((40, 56), 12),
    ((32, 48), 6),                 # whole tiles
])
def test_chain_tiles(hw, tiles):
    """The chains' 16 x 16 output tiles an image, each writing one set of
    partial statistics (chip_smoke.py holds it to the library's
    decoder_chain_tiles on the card)."""
    assert decoder_chain.chain_tiles(*hw) == tiles


@pytest.mark.parametrize("shape,sms,group", [
    ((160,) + chain_probe.FULL[1:3], 132, 4),  # 660 tiles: 5 whole rounds
    ((160, 40, 56), 132, 76),   # 76 planes fit; 15 rounds, as 66 would
    ((3, 37, 53), 132, 3),      # all images in one group
    ((1, 5, 7), 132, 1),
    ((160,) + chain_probe.FULL[1:3], 100, 3),  # 495 tiles fill 5 rounds
])
def test_plane_group(shape, sms, group):
    """chain_plane's images a launch: as many planes as L2_PLANE_BYTES
    holds at most, the fewest rounds of persistent tiles summed over the
    groups, the larger group on a tie."""
    KB, Hp, Wp = shape
    assert decoder_chain.plane_group(KB, Hp, Wp, sms) == group
    plane = Hp * Wp * 128 * 2
    assert group * plane <= max(plane, decoder_chain.L2_PLANE_BYTES)


@pytest.mark.parametrize("kernel,shape,gb", [
    ("chain_plane", chain_probe.FULL[:4], 11.68),
    ("chain_stream", chain_probe.FULL[:4], 15.57),
    ("chain_plane", (2, 37, 53, 96), None),
    ("chain_stream", (1, 5, 7, 32), None),
])
def test_chain_l2_weight_bytes(kernel, shape, gb):
    """Every 16 x 16 tile reads stage B's (128, 1152) weight from L2 once
    and stage A's (128, 9 Cp) once (chain_plane) or twice (chain_stream's
    two stage-A passes): at the probe's shape 3.89 + 7.79 GB and 2 x 3.89 +
    7.79 GB a call, against the 23.4 GB of 8 x 16 tiles."""
    KB, Hp, Wp, C = shape
    cp = -(-C // 64) * 64
    passes = 2 if kernel == "chain_stream" else 1
    tiles = KB * decoder_chain.chain_tiles(Hp, Wp)
    want = tiles * (passes * 9 * cp * 128 + 9 * 128 * 128) * 2
    assert decoder_chain.l2_weight_bytes(kernel, KB, Hp, Wp, C) == want
    if gb is not None:
        assert round(want / 1e9, 2) == gb
        # 8 x 16 tiles streaming both weights once a tile: 23.4 GB
        assert want < 160 * 22 * 15 * 9 * (64 + 128) * 128 * 2


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
