"""TTST's k-means kernel (csrc/kmeans.cu, ops/kernels/kmeans.py) against
the torch while_loop it replaces on the card (ops/kmeans.lloyd) and
against mst_tpu's k-means.

On the CPU: batched_kmeans hands a CUDA input to the custom op (on fake
CUDA tensors) and raises there for the cosine distance; the op's
refusals of malformed operands, its fake rule, its plain version (the
while_loop) on CPU tensors; and that the centres the card cases hold the
kernel to are mst_tpu's (MST_TPU_CENTRES). The cases marked `card` skip
here; they call the kernel and the while_loop on the same CUDA tensors
with the same draws, and need no JAX. On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_port_kmeans_kernel.py
"""

import hashlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mst_tpu_torch.ops import kmeans
from mst_tpu_torch.ops.kernels import kmeans as kernel
from mst_tpu_torch.ops.sampling import Key, key_from_seed, sample_heatmap
from mst_tpu_torch.utils import profiling

# TTST's goal samples, the centres (n_goal - 1 of the shipped configs)
N, K = 10000, 19
# centres of the two paths on points off any grid, below 480 px (an f32
# ulp there: 3.1e-5 px): the means are summed in two orders, the loop's
# cuBLAS bmm up to 4.3e-4 px from float64's means, the kernel's tree up
# to 5.3e-5 (measured on the card, PERF.md)
BLOB_TOL_PX = 2e-3
# centres of the two paths on TTST's own draws (whole pixels: sums exact)
TTST_TOL_PX = 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


# ---------------------------------------------------------------------------
# the CPU: dispatch, the fake rule, the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, k, iter_limit", [(1, K, 1000), (7, 3, 5),
                                              (16, 24, 1)])
def test_fake_rule_gives_the_outputs_shapes(B, k, iter_limit):
    """mst_tpu_torch::kmeans2d on fake CUDA tensors -> (assignments (B, N)
    int64, centres (B, k, 2) f32, trips (B,) int64) on the device, with no
    launch counted."""
    before = kernel.lloyd2d.launches
    with FakeTensorMode():
        X = torch.empty((B, N, 2), device="cuda")
        centers = torch.empty((B, k, 2), device="cuda")
        reseed = torch.empty((iter_limit, B, k), dtype=torch.int64,
                             device="cuda")
        assign, out, iters = kernel.lloyd2d(X, centers, reseed, 1e-3,
                                            iter_limit)
    for t, shape, dtype in ((assign, (B, N), torch.int64),
                            (out, (B, k, 2), torch.float32),
                            (iters, (B,), torch.int64)):
        assert tuple(t.shape) == shape and t.dtype == dtype
        assert t.device.type == "cuda"
    assert kernel.lloyd2d.launches == before


def test_cuda_refuses_the_cosine_distance():
    """On a CUDA device batched_kmeans has only the kernel, which takes the
    euclidean distance: the cosine one raises before any draw."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        X = torch.empty((2, N, 2), device="cuda")
        with pytest.raises(ValueError, match="cosine distance on a CUDA"):
            kmeans.batched_kmeans(X, K, distance="cosine")


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_cpu_runs_the_while_loop(monkeypatch, distance):
    """On CPU tensors batched_kmeans never reaches the op: the while_loop
    runs, and notes its trips."""
    def refuse(*args):
        raise AssertionError("the kernel's op on the CPU")

    monkeypatch.setattr(kernel, "lloyd2d", refuse)
    X, init = blobs(np.random.default_rng(3), 2, 300, 4, 2.0)
    with profiling.recording():
        assign, centers = kmeans.batched_kmeans(
            X, 4, init_centers=init, distance=distance,
            generator=Key(key_from_seed(1)))
    assert tuple(assign.shape) == (2, 300) and tuple(centers.shape) == (
        2, 4, 2)
    [found] = profiling.spans()
    assert found["name"] == "sampling.kmeans"
    assert found["attrs"]["iterations"] >= 1


@pytest.mark.parametrize("iter_limit", [2, 50])
def test_plain_op_is_the_while_loop(iter_limit):
    """The op on CPU tensors is its plain version, the while_loop, bit for
    bit (rows stopping at different trips, one at iter_limit 2), and
    counts no launch."""
    X, init = blobs(np.random.default_rng(4), 3, 400, 5, 3.0)
    X[2] = torch.rand(400, 2, generator=torch.Generator().manual_seed(0)
                      ) * 100
    reseed = Key(key_from_seed(2)).randint(400, (3, 5), counter=torch.arange(
        iter_limit))
    before = kernel.lloyd2d.launches
    got = kernel.lloyd2d(X, init, reseed, 1e-3, iter_limit)
    want = kmeans.lloyd(X, init, reseed, 1e-3, iter_limit,
                        kmeans.pairwise_sq_dist)[:3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernel.lloyd2d.launches == before
    if iter_limit == 50:
        assert len(set(got[2].tolist())) > 1


def test_op_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.lloyd2d(torch.empty(1, 4, 2, device="meta"),
                       torch.empty(1, 2, 2, device="meta"),
                       torch.empty(1, 1, 2, dtype=torch.int64,
                                   device="meta"), 1e-3, 1)


def _operands(B=3, n=50, k=4, iter_limit=6):
    return (torch.empty(B, n, 2, device="meta"),
            torch.empty(B, k, 2, device="meta"),
            torch.empty(iter_limit, B, 4, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("arg, bad", [
    (0, torch.empty(3, 50, 2, dtype=torch.float64, device="meta")),
    (0, torch.empty(3, 50, 2, dtype=torch.bfloat16, device="meta")),
    (0, torch.empty(3, 50, 3, device="meta")),
    (0, torch.empty(50, 2, device="meta")),
    (0, torch.empty(3, 2, 50, device="meta").transpose(1, 2)),
    (1, torch.empty(3, 4, 2, dtype=torch.float64, device="meta")),
    (1, torch.empty(2, 4, 2, device="meta")),
    (1, torch.empty(3, 4, 3, device="meta")),
    (1, torch.empty(3, 4, 2)),
    (2, torch.empty(6, 3, 4, dtype=torch.int32, device="meta")),
    (2, torch.empty(7, 3, 4, dtype=torch.int64, device="meta")),
    (2, torch.empty(6, 3, 5, dtype=torch.int64, device="meta")),
])
def test_cuda_op_refuses_malformed_operands(arg, bad):
    """The op's CUDA implementation refuses an operand of another dtype,
    shape, layout or device before it loads the kernel's library, and
    counts no launch."""
    args = list(_operands())
    args[arg] = bad
    before = kernel.lloyd2d.launches
    with pytest.raises(ValueError, match="must be a contiguous"):
        kernel._kmeans_cuda(*args, 1e-3, 6)
    assert kernel.lloyd2d.launches == before


# mst_tpu's batched_kmeans (PRNGKey(0), k = 4, init_centers) on the points
# of test_torch_port_ops.test_batched_kmeans_rows_stop_on_their_own: the
# centres the card holds the kernel to, with no JAX on the card. The
# digest is of those points and initial centres as parity_points makes
# them.
MST_TPU_CENTRES = {
    "blobs": ("5d52b09d3e7d0ba2", 1e-3, [
        [[63.44222640991211, 27.06308364868164],
         [4.039223670959473, 1.6351935863494873],
         [81.1900634765625, 91.22589874267578],
         [60.938697814941406, 72.92183685302734]],
        [[21.368240356445312, 89.69127655029297],
         [77.0882797241211, 45.624107360839844],
         [97.17866516113281, 31.479127883911133],
         [59.22319030761719, 20.46068000793457]],
        [[81.16036224365234, 57.63378143310547],
         [81.20228576660156, 9.725914001464844],
         [33.73029708862305, 2.0842292308807373],
         [94.45238494873047, 79.1713638305664]]]),
    "uniform": ("8370136ca8f81e50", 0.5, [
        [[7.205195903778076, 2.3120574951171875],
         [7.8050103187561035, 6.840303421020508],
         [2.680278778076172, 7.677884101867676],
         [2.2718162536621094, 2.477572441101074]],
        [[4.650518417358398, 15.729987144470215],
         [15.276759147644043, 14.938691139221191],
         [14.735833168029785, 4.704497337341309],
         [4.840394973754883, 5.70829439163208]],
        [[24.33367919921875, 7.77410364151001],
         [7.0014729499816895, 21.764497756958008],
         [21.47098159790039, 22.369359970092773],
         [8.960888862609863, 7.313360691070557]]]),
}


# mst_tpu's centres on 'blobs' sit up to 4.3e-5 px from the float64 means
# of their clusters (f32 sums of 200 points near 100 px, where an ulp is
# 7.6e-6 px); the kernel sums in another order (a tree: measured 3.8e-5 px
# from mst_tpu's), so it is held to them within this, and to the float64
# means no further than mst_tpu is
MST_TPU_TOL_PX = 5e-5


def parity_points(kind, B=3, k=4):
    """test_torch_port_ops._points from default_rng(0): 'blobs' whose
    spread and initial offset grow with the row, or 'uniform' points on
    squares of growing size -> X (B, n, 2), init (B, k, 2) f32, checked
    against MST_TPU_CENTRES' digest."""
    rng = np.random.default_rng(0)
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
    X, init = np.asarray(X, np.float32), np.asarray(init, np.float32)
    digest = hashlib.sha256(X.tobytes() + init.tobytes()).hexdigest()[:16]
    assert digest == MST_TPU_CENTRES[kind][0], "numpy drew other points"
    return torch.tensor(X), torch.tensor(init)


@pytest.mark.parametrize("kind", ["blobs", "uniform"])
def test_stored_centres_are_mst_tpus(kind):
    """MST_TPU_CENTRES is what mst_tpu's k-means gives on parity_points."""
    import jax

    from mst_tpu.ops import kmeans as jkmeans

    X, init = parity_points(kind)
    _, want = jkmeans.batched_kmeans(
        jax.random.PRNGKey(0), X.numpy(), 4, tol=MST_TPU_CENTRES[kind][1],
        init_centers=init.numpy())
    np.testing.assert_allclose(np.asarray(want), MST_TPU_CENTRES[kind][2],
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the card: the kernel against the while_loop on the same tensors
# ---------------------------------------------------------------------------

def blobs(rng, B, n, k, scale, spread=(20.0, 460.0), grid=None):
    """B rows of n points in k Gaussian blobs of std `scale` px around
    centres in `spread`, and initial centres 5 px off the blobs' -> X
    (B, n, 2), init (B, k, 2) f32. grid: round the points to 1/grid px."""
    c = rng.uniform(*spread, (B, k, 2))
    lab = rng.integers(0, k, (B, n))
    X = np.take_along_axis(c, lab[..., None], 1) + rng.normal(
        scale=scale, size=(B, n, 2))
    if grid:
        X = np.round(X * grid) / grid
    return (torch.tensor(X, dtype=torch.float32),
            torch.tensor(c + 5.0, dtype=torch.float32))


# points on a quarter-pixel grid below 640 px: a cluster's sums are exact
# in f32 in any order up to 6,553 points (2^22 / 640), so both paths give
# the same bits, as on TTST's whole-pixel draws
GRID = 4


def both(X, centers, reseed, tol=1e-3, iter_limit=1000):
    """(the kernel's, the while_loop's) (assign, centres, trips) on the
    same tensors."""
    got = kernel.lloyd2d(X, centers, reseed, tol, iter_limit)
    want = kmeans.lloyd(X, centers, reseed, tol, iter_limit,
                        kmeans.pairwise_sq_dist)[:3]
    torch.cuda.synchronize()
    return got, want


def same(got, want):
    """The two paths' trips, assignments and centres, bit for bit."""
    (a, c, it), (wa, wc, wit) = got, want
    assert torch.equal(it, wit), (it.tolist(), wit.tolist())
    assert torch.equal(a, wa), int((a != wa).sum())
    assert torch.equal(c, wc), gap(c, wc)


def gap(a, b):
    return float((a - b).abs().max())


def draws(device, B, iter_limit=1000, seed=0):
    return Key(key_from_seed(seed, device)).randint(
        N, (B, K), counter=torch.arange(iter_limit, device=device))


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 7, 16])
def test_card_blobs(card, B):
    """(a) well-separated blobs on the grid, B rows of N = 10,000 points,
    k = 19: the same trips, assignments and centres (within 1e-5 px: here
    bit for bit); one launch."""
    X, init = blobs(np.random.default_rng(B), B, N, K, 3.0, grid=GRID)
    X, init = X.to(card), init.to(card)
    before = kernel.lloyd2d.launches
    got, want = both(X, init, draws(card, B))
    assert kernel.lloyd2d.launches == before + 1
    same(got, want)


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 7, 16])
def test_card_blobs_off_the_grid(card, B):
    """(a) on points that are not on a grid, where the two orders of
    summing a mean round differently: the same trips; centres within
    BLOB_TOL_PX in every row whose assignments agree, and at most one row
    where a point within rounding of two centres' boundary went the other
    way (measured: one row of 16, 8.6e-3 px, PERF.md)."""
    X, init = blobs(np.random.default_rng(B), B, N, K, 3.0)
    X, init = X.to(card), init.to(card)
    (a, c, it), (wa, wc, wit) = both(X, init, draws(card, B))
    assert torch.equal(it, wit), (it.tolist(), wit.tolist())
    agree = (a == wa).all(dim=1)
    assert int((~agree).sum()) <= 1
    assert gap(c[agree], wc[agree]) <= BLOB_TOL_PX, gap(c[agree], wc[agree])


@pytest.mark.card
def test_card_reseeds_from_the_table(card):
    """(b) initial centres far from every point snap to one point, so all
    but the first cluster start empty and are reseeded from the table:
    the two paths' bits as in (a)."""
    X, _ = blobs(np.random.default_rng(11), 4, N, K, 3.0, grid=GRID)
    X = X.to(card)
    far = torch.full((4, K, 2), -1e4, device=card)
    snapped = X[torch.arange(4, device=card)[:, None],
                kmeans.pairwise_sq_dist(X, far).argmin(dim=1)]
    assert bool((snapped == snapped[:, :1]).all())
    same(*both(X, snapped.contiguous(), draws(card, 4, seed=3)))


@pytest.mark.card
def test_card_rows_stop_on_their_own(card):
    """(c) rows of tight blobs, wide blobs and uniform points converge at
    different trips, each row's count the while_loop's."""
    rng = np.random.default_rng(12)
    X, init = blobs(rng, 6, N, K, 1.0, grid=GRID)
    for r, scale in ((1, 8.0), (2, 25.0), (3, 60.0)):
        X[r], init[r] = (t[0] for t in blobs(rng, 1, N, K, scale,
                                             grid=GRID))
    X[4] = torch.tensor(np.round(rng.uniform(0, 480, (N, 2)) * GRID) / GRID,
                        dtype=torch.float32)
    X, init = X.to(card), init.to(card)
    got, want = both(X, init, draws(card, 6, seed=4))
    same(got, want)
    assert len(set(got[2].tolist())) >= 3, got[2].tolist()


@pytest.mark.card
@pytest.mark.parametrize("iter_limit", [1, 4])
def test_card_stops_at_iter_limit(card, iter_limit):
    """(d) uniform points still moving at iter_limit: every row stops
    there in both paths."""
    X = torch.rand(5, N, 2, generator=torch.Generator().manual_seed(5))
    X = (torch.round(X * 480 * GRID) / GRID).to(card)
    init = X[:, :K].contiguous()
    got, want = both(X, init, draws(card, 5, iter_limit),
                     iter_limit=iter_limit)
    assert got[2].tolist() == [iter_limit] * 5
    same(got, want)


@pytest.mark.card
def test_card_repeats_its_bits(card):
    """(e) two calls on the same operands are equal bit for bit."""
    X, init = blobs(np.random.default_rng(13), 16, N, K, 6.0)
    X, init = X.to(card), init.to(card)
    reseed = draws(card, 16, seed=6)
    first = kernel.lloyd2d(X, init, reseed, 1e-3, 1000)
    second = kernel.lloyd2d(X, init, reseed, 1e-3, 1000)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("n, k, iter_limit", [(N, 25, 10), (300000, K, 10),
                                              (N, K, 0), (10, 11, 10)])
def test_card_refuses_what_it_cannot_take(card, n, k, iter_limit):
    """More than 24 clusters, a row beyond its CTAs' shared memory (an
    H100's 227 KiB a block: 8 slices of 28,636 points), iter_limit 0 or
    more clusters than points: a ValueError before any launch."""
    X = torch.zeros(2, n, 2, device=card)
    reseed = torch.zeros(iter_limit, 2, k, dtype=torch.int64, device=card)
    before = kernel.lloyd2d.launches
    with pytest.raises(ValueError, match="the kernel refused"):
        kernel.lloyd2d(X, torch.zeros(2, k, 2, device=card), reseed, 1e-3,
                       iter_limit)
    assert kernel.lloyd2d.launches == before


def cluster_means(X, assign, k):
    """The float64 means of each row's clusters: X (B, n, 2), assign (B,
    n) -> (B, k, 2)."""
    X, assign = X.double(), assign.cpu()
    return torch.stack([torch.stack([X[b][assign[b] == j].mean(0)
                                     for j in range(k)])
                        for b in range(X.shape[0])])


@pytest.mark.card
@pytest.mark.parametrize("kind", ["blobs", "uniform"])
def test_card_matches_mst_tpu(card, kind):
    """batched_kmeans on the card (the kernel) from init_centers gives
    mst_tpu's centres (MST_TPU_CENTRES) within MST_TPU_TOL_PX, in one
    launch; on the converged 'blobs' no further from the float64 means of
    their clusters than mst_tpu's own."""
    X, init = parity_points(kind)
    want = torch.tensor(MST_TPU_CENTRES[kind][2])
    before = kernel.lloyd2d.launches
    assign, got = kmeans.batched_kmeans(
        X.to(card), 4, tol=MST_TPU_CENTRES[kind][1],
        init_centers=init.to(card), generator=Key(key_from_seed(0, card)))
    assert kernel.lloyd2d.launches == before + 1
    got = got.cpu()
    assert gap(got, want) <= MST_TPU_TOL_PX, gap(got, want)
    if kind == "blobs":
        exact = cluster_means(X, assign, 4)
        assert gap(got.double(), exact) <= gap(want.double(), exact), (
            gap(got.double(), exact), gap(want.double(), exact))


def goal_maps(seed, B, H=352, W=480, device="cpu"):
    """B smooth random goal probability maps: sums of a few Gaussian
    bumps."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    maps = np.zeros((B, H, W))
    for b in range(B):
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            s = rng.uniform(5, 40)
            maps[b] += rng.uniform(0.2, 1) * np.exp(
                -((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    return torch.tensor(maps, dtype=torch.float32, device=device)


@pytest.mark.card
def test_card_ttst_draws(card):
    """(f) TTST's own draws: 10,000 samples with replacement of random
    goal maps (rel_threshold 0.002, the shipped configs'), then
    batched_kmeans to 19 centres, on 20 seeds, on the card (the kernel,
    one launch) and on the CPU (the while_loop) with the same key: trips
    within 2, centres within TTST_TOL_PX."""
    worst, trips = 0.0, []
    for seed in range(20):
        key = key_from_seed(seed, card)
        X = sample_heatmap(goal_maps(seed, 8, device=card), N,
                           rel_threshold=0.002, replacement=True,
                           generator=Key(key))
        before = kernel.lloyd2d.launches
        with profiling.recording():
            _, c = kmeans.batched_kmeans(X, K, generator=Key(key))
            _, wc = kmeans.batched_kmeans(X.cpu(), K,
                                          generator=Key(key.cpu()))
        assert kernel.lloyd2d.launches == before + 1
        n, wn = (s["attrs"]["iterations"] for s in profiling.spans())
        profiling.clear()
        trips.append((n, wn))
        assert abs(n - wn) <= 2, (seed, n, wn)
        worst = max(worst, gap(c.cpu(), wc))
    assert worst <= TTST_TOL_PX, (worst, trips)
