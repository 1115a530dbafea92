"""The work splits of the serving path's two CUDA kernels, on the CPU.

csrc/fused_predict.cu and csrc/softargmax_rows.cu run only on the card;
their splits are mirrored in Python (fused_work, row_split) and their
merge arithmetic in mst_tpu_torch/ops/kernels/online_stats.py. These
tests check that every pixel and column is covered exactly once, and
that a torch reduction split the kernels' way and merged with their
arithmetic matches the TPU kernels (Pallas, interpret mode) on seeded
numpy inputs. chip_smoke.py holds each mirror against its library's own
split on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import packed as jpacked
from mst_tpu.ops.pallas.fused_predict import fused_predictor_softargmax
from mst_tpu.ops.pallas.softargmax import softargmax2d_pallas
from mst_tpu_torch.ops.kernels import fused_predict as tfused
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.ops.kernels import softargmax_rows as trows

H100_SMS = 132


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---- the fused kernel's split

@pytest.mark.parametrize("R,HW,sms", [
    (160, 352 * 480, H100_SMS),   # the eval decode tail
    (5, 1536, 7),                 # rows split across blocks, odd ranges
    (1, 200, H100_SMS),           # one image smaller than a stage
    (3, 5, H100_SMS),             # fewer pixels than SMs: one a block
    (200, 7, 3),                  # many rows a block
])
def test_fused_work_covers_each_pixel_once(R, HW, sms):
    """The blocks' items tile the R * HW pixels in order, each block's
    range is one of equal shares (+-1 pixel), no block is empty, and each
    row's blocks are block_of(first pixel) .. block_of(last pixel)."""
    blocks = tfused.fused_blocks(R, HW, sms)
    assert blocks == min(sms, R * HW)
    work = tfused.fused_work(R, HW, blocks)
    flat, sizes = 0, []
    for items in work:
        assert items, "a block without work"
        size = 0
        for row, begin, end in items:
            assert 0 <= begin < end <= HW
            assert row * HW + begin == flat
            flat = row * HW + end
            size += end - begin
        sizes.append(size)
    assert flat == R * HW
    assert max(sizes) - min(sizes) <= 1
    T = R * HW
    for row in {0, R // 2, R - 1}:
        first = tfused.block_of(row * HW, T, blocks)
        last = tfused.block_of(row * HW + HW - 1, T, blocks)
        holders = [b for b, items in enumerate(work)
                   if any(r == row for r, _, _ in items)]
        assert holders == list(range(first, last + 1))


def test_fused_stage_and_channel_groups():
    """A stage is at most 64 KB of x in whole 128-pixel blocks, and its
    pixel groups (p + 32 i, i < kPix) cover it once; P up to 12 is one
    channel group, more P two or four groups of at most 12 channels, never
    past 32; 4 pixels a thread only in groups of 8 channels; and a
    512-pixel stage gives every consumer thread work."""
    assert tfused.stage_pixels(32) == 512
    assert tfused.stage_pixels(6) == 2688
    assert tfused.stage_pixels(128) == 128
    for C in range(1, tfused.MAX_IN_CHANNELS + 1):
        sp = tfused.stage_pixels(C)
        assert sp % 128 == 0 and 0 < sp * C * 4 <= tfused.STAGE_BYTES
    for kpix in (2, 4):
        for n in (1, 31, 32, 33, 64, 100, 129, 511, 512):
            first = tfused.stage_groups(n, kpix).numpy()
            assert (first < n).all()
            pixels = (first[:, None] + 32 * np.arange(kpix)).ravel()
            np.testing.assert_array_equal(np.sort(pixels[pixels < n]),
                                          np.arange(n))
    assert tfused.group_width(12) == 12 and tfused.groups(12) == 1
    assert tfused.group_width(30) == 8 and tfused.groups(30) == 4
    for P in range(1, tfused.MAX_CHANNELS + 1):
        g, n = tfused.group_width(P), tfused.groups(P)
        assert g % 4 == 0 and g <= 12 and n in (1, 2, 4)
        assert P <= n * g <= 32
        assert tfused.pixels_per_thread(P) * g <= 32
        threads = tfused.CONSUMER_THREADS // n
        assert len(tfused.stage_groups(512, tfused.pixels_per_thread(P))) \
            % threads == 0


@pytest.mark.parametrize("R,H,W,C,P,sms", [
    (2, 32, 48, 32, 12, 3),   # several stages an item, rows split
    (5, 32, 48, 32, 12, 7),   # odd item lengths: a lone last pixel
    (1, 16, 8, 32, 12, H100_SMS),  # one pixel a block
    (2, 16, 24, 6, 5, 5),     # C = 6: unaligned pixels, the scalar path
    (3, 16, 24, 32, 30, 4),   # P = 30: four groups of 8, 4 pixels a thread
    (2, 16, 24, 32, 20, 3),   # P = 20: two groups of 12, 2 pixels a thread
])
def test_fused_split_matches_pallas(rng, R, H, W, C, P, sms):
    """The fused kernel's split and merge arithmetic on the unpacked input
    against the TPU kernel on its space-to-depth packing, within 1e-3 px."""
    x = np.maximum(rng.normal(size=(R, H, W, C)), 0).astype(np.float32)
    w = (rng.normal(size=(1, 1, C, P)) * 0.3).astype(np.float32)
    b = rng.normal(size=(P,)).astype(np.float32)
    want = fused_predictor_softargmax(
        jpacked.space_to_depth(jnp.asarray(x)),
        jpacked.pack_conv1x1_kernel(jnp.asarray(w)),
        jpacked.pack_bias(jnp.asarray(b)), P, interpret=True)
    blocks = tfused.fused_blocks(R, H * W, sms)
    got = tfused.fused_split_reference(t(x), t(w[0, 0]), t(b), blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


# ---- the rows kernel's split

@pytest.mark.parametrize("HW", [1, 3, 5, 64, 37 * 53, 352 * 480])
@pytest.mark.parametrize("cluster", [8, trows.CLUSTER])
def test_row_split_covers_each_logit_once(HW, cluster):
    """At every alignment of the row start, the head, the ranks' float4
    slices and the tail cover the row once; slices differ by at most one
    float4, and a row shorter than the cluster leaves ranks without work."""
    for lead in range(4):
        count = np.zeros(HW, np.int32)
        slices = []
        for rank in range(cluster):
            head, h0, h1, v0, v1 = trows.row_split(HW, lead, cluster, rank)
            assert (lead + head) % 4 == 0 or head == HW
            count[h0:h1] += 1
            count[head + 4 * v0:head + 4 * v1] += 1
            slices.append(v1 - v0)
        np.testing.assert_array_equal(count, 1)
        assert max(slices) - min(slices) <= 1
        if HW < 4 * cluster:
            assert min(slices) == 0


def _rows_case(rng, case):
    if case == "peaked":
        x = np.full((1, 32, 64), -30.0, np.float32)
        x[0, 17, 42] = 30.0
        return x, 0
    shape, lead = {"one_row": ((1, 32, 64), 0),
                   "rows": ((8, 32, 32), 0),
                   "unaligned_rows": ((3, 32, 32), 1),
                   "hw_mod_4": ((3, 37, 53), 0),
                   "tiny_rows": ((5, 3, 5), 2)}[case]
    return (rng.normal(size=shape) * 4).astype(np.float32), lead


@pytest.mark.parametrize("case", ["one_row", "rows", "unaligned_rows",
                                  "hw_mod_4", "tiny_rows", "peaked"])
def test_rows_split_matches_pallas(rng, case):
    """The rows kernel's split (the ranks of a cluster, each thread's load
    rounds, the scalar head and tail) and merge arithmetic against the TPU
    kernel in interpret mode, within 1e-4 px."""
    x, lead = _rows_case(rng, case)
    want = np.asarray(softargmax2d_pallas(jnp.asarray(x), interpret=True))
    got = trows.rows_split_reference(t(x), lead).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    if case == "peaked":
        np.testing.assert_allclose(got[0], [42.0, 17.0], atol=1e-2)


# ---- the merge arithmetic

def test_merge2_and_push_group(rng):
    """Merging with an empty partial changes nothing; a masked (-inf) slot
    adds nothing; pushing two halves and merging equals one push."""
    logits = t(rng.normal(size=(6, 8)) * 3)
    fx, fy = t(rng.uniform(0, 9, size=8)), t(rng.uniform(0, 9, size=8))
    whole = ost.push_group(ost.empty((6,)), logits, fx, fy)
    a = ost.push_group(ost.empty((6,)), logits[:, :3], fx[:3], fy[:3])
    b = ost.push_group(ost.empty((6,)), logits[:, 3:], fx[3:], fy[3:])
    for got in (ost.merge2(a, b), ost.merge2(ost.merge2(a, ost.empty((6,))),
                                             b)):
        np.testing.assert_allclose(ost.finish(got, 1e-6).numpy(),
                                   ost.finish(whole, 1e-6).numpy(),
                                   rtol=1e-5)
    masked = torch.cat([logits, torch.full((6, 1), -float("inf"))], 1)
    pad = ost.push_group(ost.empty((6,)), masked, torch.cat([fx, t([0])]),
                         torch.cat([fy, t([0])]))
    for x, y in zip(pad, whole):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)
    kept = ost.push_group(whole, logits, fx, fy, torch.zeros(6, dtype=bool))
    for x, y in zip(kept, whole):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
