"""The gradients of the spatial ('data', 'space') mesh's collectives, and
the rows kernel's partial-statistics variant, on the CPU.

gloo worlds of 2 and 4 processes (tests/torch_port_ranks.py, one thread
a rank) on (1, 2), (2, 2) and (1, 4) meshes, each rank holding its
'data' block of 4 rows and its slab of the maps' H, against the world of
one's autograd in this process:

- a chain of conv -> max-pool -> conv -> avg-pool -> conv -> bilinear x2
  -> conv -> bilinear x2 -> 1x1 conv -> loss on slabs, at 24 rows (level
  2 runs whole over 2 ranks, levels 1-2 over 4) and 12 rows (3-row slabs
  over 4, odd: they gather before their pool): the ranks' loss shares
  sum to the world of one's loss (1e-6 relative), the parameter
  gradients summed over the world match its autograd within 1e-5 of each
  one's max, and each rank's input gradient equals its rows and slab of
  the whole input's within 1e-6 of the whole gradient's max;
- a train-mode batch norm at a sliced level (statistics over the world,
  mesh.Shards.spanning) and at a level that runs whole (its slabs
  gathered; statistics over the 'data' ranks): outputs, gradients and
  running statistics within 1e-5 (of each one's max);
- halo.exchange and halo.gather are torch.autograd.Functions;
- the partial variant's plain version: its statistics merged over 2 and
  4 slabs (online_stats.fold, merge_ranks' arithmetic) give the whole
  map's soft-argmax within chip_smoke.py's bar, 32 f32 ulps at the map's
  extent (64 px here); the kernel's own split and merge order on the CPU
  (rows_split_reference, partial) against the plain version; the custom
  op's fake, vmap rule and opcheck; another device raises.
"""

import numpy as np
import pytest
import torch

from mst_tpu_torch.ops import softargmax
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.ops.kernels import softargmax_rows as sr
from mst_tpu_torch.parallel import halo
from tests import torch_port_ranks as ranks

SHAPES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
HEIGHTS = (24, 12)
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5     # of each parameter gradient's max
INPUT_TOL = 1e-6    # of the whole input gradient's max
BN_TOL = 1e-5       # of each output's, gradient's or statistic's max
EXTENT = 64         # the partial kernel's maps: 64 x 64
MERGE_TOL = 32 * 2.0 ** -23 * EXTENT  # 32 f32 ulps at the map's extent
SPLIT_TOL = 1e-4    # px, the kernel's split and order against plain
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world started together, the world of one run here meanwhile
    -> ({shape id: (shape, results)}, the world of one's)."""
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 ["spatial_chain", "spatial_bn"],
                                 ["data", "space"], THREADS)
               for name, shape in SHAPES.items()}
    one = {"chain": ranks.case_spatial_chain(None),
           "bn": ranks.spatial_bn(None)}
    return {name: (SHAPES[name], ranks.finish(handles[name]))
            for name in SHAPES}, one


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


def of_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def block(whole, rank, shape):
    """Rank `rank`'s rows and slab of a whole (N, H, ...) array."""
    data, space = shape
    d, s = divmod(rank, space)
    n, h = whole.shape[0] // data, whole.shape[1] // space
    return whole[d * n:(d + 1) * n, s * h:(s + 1) * h]


@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_chain_gradients_match_the_world_of_one(worlds, one, shape,
                                                height):
    (data, space), res = worlds[shape]
    want = one["chain"][height]
    outs = [r[height] for r in res["spatial_chain"]]
    # 24 rows: level 2 whole over 2 ranks, levels 1-2 over 4; 12 rows:
    # levels 1-2 whole, the slabs' 3 rows odd over 4
    rows = {(24, 2): [12, 6, 6], (24, 4): [6, 12, 6], (12, 2): [6, 6, 3],
            (12, 4): [3, 6, 3]}[height, space]
    assert all(out["rows"] == rows for out in outs)
    loss = sum(out["loss"] for out in outs)
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for out in outs:
        for k, g in want["grads"].items():
            assert of_max(out["grads"][k], g) <= GRAD_TOL, k
    scale = np.abs(want["x_grad"]).max()
    for rank, out in enumerate(outs):
        d = np.abs(out["x_grad"] - block(want["x_grad"], rank,
                                         (data, space))).max()
        assert d <= INPUT_TOL * scale, rank


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_norm_over_slabs_matches_the_world_of_one(worlds, one, shape):
    (data, space), res = worlds[shape]
    want = one["bn"]
    for rank, out in enumerate(res["spatial_bn"]):
        for k in ("y", "y2", "x_grad", "x2_grad"):
            assert of_max(out[k], block(want[k], rank, (data, space))) <= \
                BN_TOL, k
        for g, w in zip(out["grads"], want["grads"]):
            assert of_max(g, w) <= BN_TOL
        for st, w in zip(out["state"], want["state"]):
            assert st.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(st[k], w[k], rtol=0,
                                           atol=BN_TOL * max(
                                               np.abs(w[k]).max(), 1.0))
        assert int(out["state"][0]["num_batches"]) == 1


def test_the_collectives_are_autograd_functions():
    assert issubclass(halo._Exchange, torch.autograd.Function)
    assert issubclass(halo._Gather, torch.autograd.Function)


def partial_maps(dtype, seed=3, scale=3.0):
    """(2, 3) maps of 64 x 64 logits from a seed, peaked (scale)."""
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(2, 3, EXTENT, EXTENT, generator=gen)).to(
        dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_partial_plain_merges_to_the_whole_map(n_slabs, dtype):
    x = partial_maps(dtype)
    whole = softargmax.softargmax2d(x)
    rows = EXTENT // n_slabs
    parts = [sr.softargmax2d_rows_partial(
        x[..., lo:lo + rows, :].contiguous(), lo)
        for lo in range(0, EXTENT, rows)]
    assert parts[0].shape == (2, 3, 4) and parts[0].dtype == torch.float32
    assert float((ost.fold(parts) - whole).abs().max()) <= MERGE_TOL
    # a wrong merge (a slab dropped, or y from row 0) is far off
    from0 = [sr.softargmax2d_rows_partial(
        x[..., lo:lo + rows, :].contiguous(), 0)
        for lo in range(0, EXTENT, rows)]
    for bad in (parts[:-1], from0):
        assert float((ost.fold(bad) - whole).abs().max()) > 100 * MERGE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_kernel_split_matches_plain(dtype):
    """The kernel's split and merge order (rows_split_reference, partial)
    on a slab at row 40, a row start off 16-byte alignment included."""
    x = partial_maps(dtype, seed=4)[:, :, 40:51, :]
    plain = sr.softargmax2d_rows_partial_plain(x, 40)
    split = sr.rows_split_reference(x, lead0=1, row0=40, partial=True)
    assert split.shape == plain.shape == (2, 3, 4)
    np.testing.assert_allclose(split[..., 0], plain[..., 0], rtol=0,
                               atol=1e-4)
    assert float((ost.fold([split]) - ost.fold([plain])).abs().max()) <= \
        SPLIT_TOL


def test_partial_op_fake_vmap_and_devices():
    x = partial_maps(torch.float32)
    torch.library.opcheck(torch.ops.mst_tpu_torch.softargmax2d_rows_partial,
                          (x, 5))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        out = sr.softargmax2d_rows_partial(mode.from_tensor(x), 5)
    assert out.shape == (2, 3, 4) and out.dtype == torch.float32
    folded = torch.func.vmap(
        lambda t: sr.softargmax2d_rows_partial(t, 5))(x)
    torch.testing.assert_close(folded, sr.softargmax2d_rows_partial(x, 5),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        sr.softargmax2d_rows_partial(x.to("meta"), 0)
