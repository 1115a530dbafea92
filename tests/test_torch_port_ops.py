"""mst_tpu_torch ops against the JAX package's, on the CPU in f32.

The same numpy inputs go through both packages. Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them; the port's
kernel wrappers take their plain PyTorch versions on CPU tensors. The
samplers and k-means get the JAX package's own random draws injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.evaluator import metrics as jmetrics
from mst_tpu.ops import heatmap as jheatmap
from mst_tpu.ops import kmeans as jkmeans
from mst_tpu.ops import packed as jpacked
from mst_tpu.ops import pooling as jpooling
from mst_tpu.ops import sampling as jsampling
from mst_tpu.ops import softargmax as jsoftargmax
from mst_tpu.ops.pallas.fused_predict import fused_predictor_softargmax
from mst_tpu.ops.pallas.softargmax import softargmax2d_pallas
from mst_tpu_torch.evaluator import metrics
from mst_tpu_torch.ops import heatmap, kmeans, pooling, sampling, softargmax
from mst_tpu_torch.ops.kernels import fused_predict as tfused
from mst_tpu_torch.ops.kernels import softargmax_rows as trows

TOL = 1e-5  # f32 ops computed in the same order up to reassociation


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("name,shape", [
    ("softargmax2d", (3, 4, 24, 40)),
    ("softargmax2d_auto", (3, 4, 24, 40)),
    ("softargmax2d_nhwc", (3, 24, 40, 5)),
    ("softargmax_on_prob_map", (2, 3, 24, 40)),
])
def test_softargmax_variants(rng, name, shape):
    x = rng.normal(size=shape).astype(np.float32) * 3
    if name == "softargmax_on_prob_map":
        x = np.exp(x) / np.exp(x).sum(axis=(-2, -1), keepdims=True)
        want = jsoftargmax.softargmax_on_prob_map(jnp.asarray(x))
    elif name == "softargmax2d_auto":
        want = jsoftargmax.softargmax2d(jnp.asarray(x))
    else:
        want = getattr(jsoftargmax, name)(jnp.asarray(x))
    got = getattr(softargmax, name)(t(x))
    # coordinates span [0, 40): 1e-5 of the map's width
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL * 40)


def _rows_cases(rng):
    peaked = np.full((1, 1, 32, 64), -30.0, np.float32)
    peaked[0, 0, 17, 42] = 30.0
    return {
        "random": rng.normal(size=(3, 4, 32, 32)).astype(np.float32) * 4,
        "row_padding": rng.normal(size=(5, 32, 32)).astype(np.float32) * 3,
        "peaked": peaked,
        "ragged_hw": rng.normal(size=(3, 40, 56)).astype(np.float32) * 3,
    }


@pytest.mark.parametrize("case", ["random", "row_padding", "peaked",
                                  "ragged_hw"])
def test_rows_plain_matches_pallas(rng, case):
    """The rows kernel's plain version (taken for CPU tensors) against the
    TPU kernel in interpret mode; 1e-4 px covers the online max-rescaling,
    which sums in another order."""
    x = _rows_cases(rng)[case]
    want = np.asarray(softargmax2d_pallas(jnp.asarray(x), interpret=True))
    got = trows.softargmax2d_rows(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    if case == "peaked":
        np.testing.assert_allclose(got[0, 0], [42.0, 17.0], atol=1e-2)


@pytest.mark.parametrize("R,H,W,C,P", [(5, 32, 48, 32, 12),
                                       (2, 16, 32, 8, 3)])
def test_fused_plain_matches_pallas(rng, R, H, W, C, P):
    """The fused kernel's plain version on the unpacked (R, H, W, C) input
    against the TPU kernel on its space-to-depth packing, within 1e-3 px."""
    x = np.maximum(rng.normal(size=(R, H, W, C)), 0).astype(np.float32)
    w = (rng.normal(size=(1, 1, C, P)) * 0.3).astype(np.float32)
    b = rng.normal(size=(P,)).astype(np.float32)
    want = fused_predictor_softargmax(
        jpacked.space_to_depth(jnp.asarray(x)),
        jpacked.pack_conv1x1_kernel(jnp.asarray(w)),
        jpacked.pack_bias(jnp.asarray(b)), P, interpret=True)
    got = tfused.fused_predictor_softargmax(t(x), t(w[0, 0]), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_kernel_wrappers_reject_other_devices():
    x = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        trows.softargmax2d_rows(x)
    with pytest.raises(ValueError):
        tfused.fused_predictor_softargmax(
            torch.empty((2, 8, 8, 4), device="meta"),
            torch.empty((4, 3), device="meta"),
            torch.empty((3,), device="meta"))


def test_rasterize_dist_rounds_half_to_even(rng):
    pts = rng.uniform(0, 60, size=(3, 5, 2)).astype(np.float32)
    pts[0, :4] = [[2.5, 3.5], [4.5, 0.5], [7.5, 8.5], [1.5, 10.5]]
    want = jheatmap.rasterize_dist_nhwc(jnp.asarray(pts), 40, 56, 1050)
    got = heatmap.rasterize_dist_nhwc(t(pts), 40, 56, 1050)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert heatmap.dist_template_scale(1050) == \
        jheatmap.dist_template_scale(1050)


@pytest.mark.parametrize("op", ["max_pool_2x2", "avg_pool_pyramid",
                                "upsample_bilinear_2x"])
def test_pooling(rng, op):
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    if op == "avg_pool_pyramid":
        want = jpooling.avg_pool_pyramid(jnp.asarray(x), 4)
        got = pooling.avg_pool_pyramid(t(x), 4)
    else:
        want = [getattr(jpooling, op)(jnp.asarray(x))]
        got = [getattr(pooling, op)(t(x))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_min_ade_fde(rng):
    gt = rng.uniform(0, 100, size=(4, 12, 2)).astype(np.float32)
    trajs = rng.uniform(0, 100, size=(5, 4, 12, 2)).astype(np.float32)
    goals = rng.uniform(0, 100, size=(5, 4, 2)).astype(np.float32)
    want = jmetrics.min_ade_fde(gt, trajs, goals, 0.25)
    got = metrics.min_ade_fde(t(gt), t(trajs), t(goals), 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL)


def _prob_maps(rng, shape):
    # sigmoid-like maps with a few hot spots, as the goal decoder gives
    logits = rng.normal(size=shape) * 2 - 3
    return (1 / (1 + np.exp(-logits))).astype(np.float32)


@pytest.mark.parametrize("rel_threshold", [None, 0.01])
def test_sample_with_replacement_same_draws(rng, rel_threshold):
    """Inverse-CDF sampling on JAX's own uniforms. The two f32 cumsums may
    differ in the last bit, which moves a draw that falls within that bit
    of a CDF boundary to the neighbouring pixel: at most 0.1% of draws may
    differ, and none by more than one pixel index."""
    p = _prob_maps(rng, (3, 2, 24, 40))
    key = jax.random.PRNGKey(7)
    n = 2000
    want = np.asarray(jsampling.sample_heatmap(
        key, jnp.asarray(p), n, rel_threshold=rel_threshold,
        replacement=True))
    u = jax.random.uniform(key, (6, n), dtype=jnp.float32, maxval=1.0)
    got = sampling.sample_heatmap(t(p), n, rel_threshold=rel_threshold,
                                  replacement=True, u=t(u)).numpy()
    W = p.shape[-1]
    flat_w = want[..., 1] * W + want[..., 0]
    flat_g = got[..., 1] * W + got[..., 0]
    differ = flat_w != flat_g
    assert differ.sum() <= 0.001 * differ.size, differ.sum()
    assert np.abs(flat_w - flat_g).max() <= 1


@pytest.mark.parametrize("rel_threshold", [None, 0.05])
def test_sample_without_replacement_same_draws(rng, rel_threshold):
    """Gumbel top-k on JAX's own Gumbel noise gives the same indices."""
    p = _prob_maps(rng, (2, 3, 24, 40))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsampling.sample_heatmap(
        key, jnp.asarray(p), 5, rel_threshold=rel_threshold))
    g = jax.random.gumbel(key, (6, 24 * 40), dtype=jnp.float32)
    got = sampling.sample_heatmap(t(p), 5, rel_threshold=rel_threshold,
                                  gumbel=t(g)).numpy()
    np.testing.assert_array_equal(got, want)


def _points(rng, kind, B=3, k=4):
    """Per-row point sets and initial centres. 'blobs': separated blobs
    whose spread and initial offset grow with the row, so the rows converge
    at different iterations. 'uniform': uniform points on squares of
    growing size, where the centres still drift when a row stops at a
    loose tol."""
    X, init = [], []
    for b in range(B):
        if kind == "blobs":
            centers = rng.uniform(0, 100, size=(k, 2))
            pts = centers[:, None] + rng.normal(scale=2.0 + 6.0 * b,
                                                size=(k, 200, 2))
            X.append(pts.reshape(-1, 2))
            init.append(centers + rng.normal(scale=4.0 * (b + 1),
                                             size=(k, 2)))
        else:
            pts = rng.uniform(0, 10 * (b + 1), size=(600, 2))
            X.append(pts)
            init.append(pts[rng.choice(600, k, replace=False)])
    return np.asarray(X, np.float32), np.asarray(init, np.float32)


@pytest.mark.parametrize("kind,tol", [("blobs", 1e-3), ("uniform", 0.5)])
def test_batched_kmeans_rows_stop_on_their_own(rng, kind, tol):
    """Centres match the JAX vmap of lax.while_loop, where each row stops on
    its own. On 'uniform' at tol=0.5 a row that went on iterating until
    the slowest row converged would end up elsewhere."""
    X, init = _points(rng, kind)
    _, want = jkmeans.batched_kmeans(jax.random.PRNGKey(0), jnp.asarray(X),
                                     4, tol=tol,
                                     init_centers=jnp.asarray(init))
    assign, got = kmeans.batched_kmeans(t(X), 4, tol=tol,
                                        init_centers=t(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert assign.shape == X.shape[:2]
    # each row alone gives the same centres as in the batch
    for b in range(X.shape[0]):
        _, alone = kmeans.batched_kmeans(t(X[b:b + 1]), 4, tol=tol,
                                         init_centers=t(init[b:b + 1]))
        np.testing.assert_allclose(alone.numpy()[0], got.numpy()[b],
                                   atol=1e-6)


def test_batched_kmeans_random_init_is_distinct_points(rng):
    X, _ = _points(rng, "blobs")
    gen = torch.Generator().manual_seed(0)
    _, c = kmeans.batched_kmeans(t(X), 4, generator=gen)
    assert c.shape == (3, 4, 2) and torch.isfinite(c).all()
