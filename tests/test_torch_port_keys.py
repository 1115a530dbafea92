"""The draws from a key (ops/sampling.Key) and the while_loop k-means
(ops/kmeans.py) on the CPU, torch on two intra-op threads: a key's bits
repeat and differ as a counter-based hash's must, a million uniforms,
exponentials and randints are uniform within stated bounds, every one of
the 2^24 exponentials is positive and finite; the while_loop k-means
against the Python loop it replaced (kept here as the plain reference)
bit for bit, with a row stopping at iter_limit and an emptied cluster;
its export as one loop; the cosine distance and kmeans_predict against
mst_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.ops import kmeans as jkmeans
from mst_tpu_torch.ops import kmeans
from mst_tpu_torch.ops.sampling import (Key, exponential_of_24_bits,
                                        key_from_generator, key_from_seed)

N_DRAWS = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# draws from a key
# ---------------------------------------------------------------------------

def test_key_draws_repeat_and_differ():
    """The same key, stream and counter give the same bits; another key,
    stream or counter other bits; within one stream the bits of the
    elements are distinct 32-bit words (the hash is a bijection). A seed's
    key is a generator's first two draws."""
    key = key_from_seed(3)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert torch.equal(key, key_from_generator(
        torch.Generator().manual_seed(3)))
    a, b = Key(key), Key(key.clone())
    first = a.bits((4, 25_000))
    assert torch.equal(first, b.bits((4, 25_000)))
    assert first.min() >= 0 and first.max() < 2 ** 32
    assert first.unique().numel() == first.numel()
    second = a.bits((4, 25_000))  # the next stream
    other_key = Key(key_from_seed(4)).bits((4, 25_000))
    other_counter = Key(key).bits((4, 25_000), stream=0, counter=1)
    for other in (second, other_key, other_counter):
        assert (other == first).float().mean() < 1e-3
    assert torch.equal(Key(key).bits((4, 25_000), stream=0, counter=0),
                       first)


def test_key_draws_are_uniform_over_a_million():
    """1e6 uniforms: in [0, 1) on the 2^-24 grid, the mean within 1.5e-3
    of 1/2 (5 sigma) and each of 100 bins within 600 of 10^4 (6 sigma);
    1e6 exponentials: the mean within 5e-3 of 1 (5 sigma), positive and
    finite; 1e6 randints of [0, 7): each value's count within 6 sigma of
    1e6 / 7."""
    key = Key(key_from_seed(0))
    u = key.uniform((N_DRAWS,))
    assert u.dtype == torch.float32 and u.min() >= 0 and u.max() < 1
    assert torch.equal(u * 2 ** 24, (u * 2 ** 24).round())
    assert abs(float(u.double().mean()) - 0.5) < 1.5e-3
    counts = torch.bincount((u * 100).long(), minlength=100)
    assert int((counts - N_DRAWS // 100).abs().max()) < 600
    e = key.exponential(torch.empty(N_DRAWS))
    assert bool((e > 0).all()) and bool(torch.isfinite(e).all())
    assert abs(float(e.double().mean()) - 1.0) < 5e-3
    r = key.randint(7, (N_DRAWS,))
    assert r.min() == 0 and r.max() == 6
    sigma = (N_DRAWS * (1 / 7) * (6 / 7)) ** 0.5
    assert float((torch.bincount(r) - N_DRAWS / 7).abs().max()) < 6 * sigma


def test_exponential_of_every_24_bit_uniform():
    """All 2^24 exponential draws: positive, finite, falling with the
    uniform, from -log(2^-24) down to the 2^-25 that stands in for 0."""
    m = torch.arange(1 << 24, dtype=torch.int64)
    e = exponential_of_24_bits(m)
    assert e.dtype == torch.float32
    assert bool(torch.isfinite(e).all()) and bool((e > 0).all())
    assert bool((e[1:] <= e[:-1]).all())
    assert float(e[0]) == pytest.approx(24 * np.log(2), rel=1e-7)
    assert float(e[-1]) == 2.0 ** -25


# ---------------------------------------------------------------------------
# k-means: one while_loop
# ---------------------------------------------------------------------------

def loop_kmeans(X, k, tol, iter_limit, init_centers, key):
    """The Python loop ops/kmeans.py ran before its while_loop, its
    draws from the same Key in the same order (the initial points'
    bits, then the reseeds with the iteration as the counter) -> (the
    assignments, the centres, each row's iterations, the empty clusters
    reseeded)."""
    draws = Key(key)
    B, N, D = X.shape
    rows = torch.arange(B)[:, None]
    if init_centers is None:
        idx = draws.bits((B, N)).topk(k, dim=1).indices
    else:
        idx = kmeans.pairwise_sq_dist(X, init_centers).argmin(dim=1)
    centers = X[rows, idx]
    reseed = draws.stream()
    active = torch.ones(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int64)
    it, empties = 0, 0
    while bool(active.any()):
        choice = kmeans.pairwise_sq_dist(X, centers).argmin(dim=2)
        onehot = torch.nn.functional.one_hot(choice, k).to(X.dtype)
        counts = onehot.sum(dim=1)
        empties += int(((counts == 0) & active[:, None]).sum())
        means = (onehot.transpose(1, 2) @ X) / counts.clamp(min=1.0)[..., None]
        ridx = draws.randint(N, (B, k), stream=reseed, counter=it)
        new_centers = torch.where((counts > 0)[..., None], means,
                                  X[rows, ridx])
        shift = torch.sqrt(((new_centers - centers) ** 2).sum(-1)).sum(-1)
        centers = torch.where(active[:, None, None], new_centers, centers)
        iters = iters + active.to(torch.int64)
        active = active & (shift ** 2 >= tol) & (iters < iter_limit)
        it += 1
    return (kmeans.pairwise_sq_dist(X, centers).argmin(dim=2), centers,
            iters, empties)


def kmeans_points(rng, k=4):
    """Three rows: tight blobs (converge in 2 iterations), uniform points
    (still moving at iter_limit 6), and wider blobs whose first two
    initial centres snap to one point, so one cluster starts empty."""
    c0 = rng.uniform(0, 100, (k, 2))
    r0 = (c0[:, None] + rng.normal(scale=1.0, size=(k, 50, 2))).reshape(-1, 2)
    r1 = rng.uniform(0, 100, (200, 2))
    r2 = (c0[:, None] + rng.normal(scale=3.0, size=(k, 50, 2))).reshape(-1, 2)
    X = np.stack([r0, r1, r2]).astype(np.float32)
    init = np.stack([c0 + 5, r1[:4], np.stack(
        [r2[0], r2[0] + 0.01, r2[60], r2[120]])]).astype(np.float32)
    return torch.tensor(X), torch.tensor(init)


@pytest.mark.parametrize("given_init", [True, False])
def test_while_loop_kmeans_equals_the_loop(given_init):
    """batched_kmeans (torch while_loop) against the loop it replaced, on
    the same key: assignments and centres bit for bit. With the given
    centres one row stops at iter_limit while the others converge before
    it, and one cluster empties and is reseeded from the key."""
    X, init = kmeans_points(np.random.default_rng(0))
    init = init if given_init else None
    key = key_from_seed(5)
    want_assign, want, iters, empties = loop_kmeans(X, 4, 1e-3, 6, init,
                                                    key)
    if given_init:
        assert iters.tolist() == [2, 6, 4] and empties == 1
    got_assign, got = kmeans.batched_kmeans(X, 4, tol=1e-3, iter_limit=6,
                                            init_centers=init,
                                            generator=Key(key))
    assert torch.equal(got, want) and torch.equal(got_assign, want_assign)


def test_kmeans_exports_as_one_loop():
    """torch.export of batched_kmeans records one while_loop, whose
    program gives the eager centres for the key it is given."""
    X, init = kmeans_points(np.random.default_rng(1))

    class Cluster(torch.nn.Module):
        def forward(self, X, init, key):
            return kmeans.batched_kmeans(X, 4, iter_limit=6,
                                         init_centers=init,
                                         generator=Key(key))

    program = torch.export.export(Cluster(), (X, init, key_from_seed(0)),
                                  strict=False)
    loops = [n for n in program.graph.nodes
             if n.op == "call_function" and "while_loop" in str(n.target)]
    assert len(loops) == 1
    for seed in (0, 9):
        got = program.module()(X, init, key_from_seed(seed))
        want = kmeans.batched_kmeans(X, 4, iter_limit=6, init_centers=init,
                                     generator=Key(key_from_seed(seed)))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_kmeans_distances_and_predict_match_mst_tpu(distance):
    """k-means under both of the reference's distances from the same
    initial centres, and kmeans_predict on 2-D and batched points, against
    mst_tpu's (no cluster empties here, so no reseed draw differs)."""
    rng = np.random.default_rng(2)
    c0 = rng.uniform(10, 100, (3, 4, 2))
    X = (c0[:, :, None] + rng.normal(scale=4.0, size=(3, 4, 60, 2))
         ).reshape(3, -1, 2).astype(np.float32)
    init = (c0 + rng.normal(scale=3.0, size=c0.shape)).astype(np.float32)
    ja, jc = jkmeans.batched_kmeans(jax.random.PRNGKey(0), jnp.asarray(X), 4,
                                    1e-4, 100, jnp.asarray(init), distance)
    ta, tc = kmeans.batched_kmeans(torch.tensor(X), 4, tol=1e-4,
                                   iter_limit=100,
                                   init_centers=torch.tensor(init),
                                   distance=distance)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for x, c in ((X, np.asarray(jc)), (X[0], np.asarray(jc)[0])):
        want = jkmeans.kmeans_predict(jnp.asarray(x), jnp.asarray(c),
                                      distance)
        got = kmeans.kmeans_predict(torch.tensor(x), torch.tensor(c),
                                    distance)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
