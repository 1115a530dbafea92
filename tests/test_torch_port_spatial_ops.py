"""The spatial ('data', 'space') mesh's pieces on the CPU: gloo worlds of
2 and 4 processes (tests/torch_port_ranks.py) on (1, 2) and (1, 4)
meshes, and single-process checks.

- the meshes: axis names, layout, each rank's block of the batch and its
  slab, Shards reducing over the 'data' ranks alone;
- each op on a rank's H slab, gathered, against the whole-map op within
  1e-6: the halo conv (3x3, 1x1, a LoRA conv), the bilinear x2, both
  pools and both rasterizers at the slab's first row;
- the partition is real (the counterpart of
  tests/test_spatial_sharding.py::test_spatial_sharding_actually_
  partitions): each rank's finest feature map and goal map hold H / S
  rows, and the 'space' ranks gather only at the level the odd-slab rule
  names (mesh.Slab.down);
- the partial-statistics variant of the fused kernel's plain version:
  slabs cut at arbitrary rows, merged by merge_ranks' arithmetic
  (online_stats.fold), against fused_predictor_softargmax_plain on the
  whole map within 1e-5 px;
- the refusals: a height that does not divide the 'space' ranks, a
  spatial mesh across hosts (mst_tpu's message), --mesh_axes space data,
  training on the spatial mesh.
"""

import pytest
import torch

from mst_tpu_torch import config
from mst_tpu_torch.ops.kernels import fused_predict as fp
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.parallel import hostdata
from mst_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_port_ranks as ranks

OP_TOL = 1e-6
PX_TOL = 1e-5
SPACES = {"1x2": [1, 2], "1x4": [1, 4]}
# one thread a process, here and in each rank: the bit-equality holds
# between runs of one thread's kernels (with more, the CPU's reductions
# were seen to round otherwise in 1 of 6 runs of a loaded machine)
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started together -> {shape id: (shape, results)}."""
    cases = ["spatial_mesh", "spatial_ops", "spatial_partition"]
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 cases, ["data", "space"], THREADS)
               for name, shape in SPACES.items()}
    return {name: (SPACES[name], ranks.finish(handles[name]))
            for name in SPACES}


@pytest.fixture(params=list(SPACES))
def world(request, worlds):
    return worlds[request.param]


def test_spatial_mesh_of_the_world(world):
    shape, res = world
    space = shape[1]
    for rank, out in enumerate(res["spatial_mesh"]):
        assert out["names"] == ("data", "space")
        assert out["ranks"].tolist() == [list(range(space))]
        assert out["shards"] == (0, 1) and out["batch_shard_count"] == 1
        rows = ranks.H // space
        assert out["slab"] == (rank, space, rank * rows, (rank + 1) * rows)
        # a sum over the 'data' ranks alone: one rank, not the world
        assert out["sum"].tolist() == [1.0] * 3
        assert out["gathered"].tolist() == [float(rank)] * 2
        if space == 4:  # 62 rows divide 2 ranks, not 4
            assert "height 62 does not divide the mesh's 'space' axis " \
                "(4)" in out["refused"]
        else:
            assert out["refused"] is None


OPS = ("conv3x3", "conv1x1", "lora3x3", "upsample", "max_pool", "avg_pool",
       "dist", "gaussian")


@pytest.mark.parametrize("op", OPS)
def test_op_on_slabs_equals_the_whole_map(world, op):
    _, res = world
    for out in res["spatial_ops"]:
        assert out[op] <= OP_TOL, (op, out[op])


# (space count, height) -> the rows a rank holds at each level, and the
# height of the one level the 'space' ranks gather: the first whose slab
# would hold odd rows
PARTITION = {(2, 64): ([32, 16, 8, 4, 2, 2], 2),
             (2, 32): ([16, 8, 4, 2, 2, 1], 2),
             (4, 64): ([16, 8, 4, 2, 4, 2], 4),
             (4, 32): ([8, 4, 2, 4, 2, 1], 4)}


def test_the_partition_is_real(world):
    """Rows a rank holds at each level of a 64- and a 32-row scene: H / S
    at the finest and in the goal map, halving while a slab's rows stay
    even, then whole; one gather, at the first whole level."""
    shape, res = world
    for out in res["spatial_partition"]:
        for height, (finest, levels, goal, log) in out.items():
            want, gathered = PARTITION[shape[1], height]
            assert finest == goal == height // shape[1]
            assert levels == want
            assert log == [("gather", gathered)]


def test_slab_levels_follow_the_odd_slab_rule():
    """352 x 480 (the shipped SDD eval height): at S = 2 the slabs run 176,
    88, 44, 22, then level 4 (11 rows a slab) runs whole; at S = 4 level 3
    (11 rows) already does."""
    rows = {s: [None if sl is None else sl.rows
                for sl in mesh_lib.Slab(0, s, None, 352).levels(6)]
            for s in (2, 4)}
    assert rows[2] == [176, 88, 44, 22, None, None]
    assert rows[4] == [88, 44, 22, None, None, None]


@pytest.mark.parametrize("cuts", [(0, 7, 16), (0, 3, 9, 16),
                                  (0, 1, 2, 15, 16), (0, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_statistics_merge_to_the_whole_map(cuts, dtype):
    """2 to 4 slabs cut at arbitrary rows: each slab's partial statistics
    (the plain version, y offset by its first row), folded in slab order,
    equal the whole map's soft-argmax."""
    gen = torch.Generator().manual_seed(len(cuts))
    R, H, W, C, P = 6, cuts[-1], 20, 8, 12
    x = torch.randn(R, H, W, C, generator=gen).to(dtype)
    w = torch.randn(C, P, generator=gen).to(dtype)
    b = torch.randn(P, generator=gen)
    want = fp.fused_predictor_softargmax_plain(x, w, b)
    parts = [fp.fused_predictor_softargmax_partial(
        x[:, lo:hi].contiguous(), w, b, lo)
        for lo, hi in zip(cuts[:-1], cuts[1:])]
    assert parts[0].shape == (R, P, 4)
    got = ost.fold(parts)
    assert float((got - want).abs().max()) <= PX_TOL


def test_partial_variant_is_a_custom_op_with_a_fake():
    x = torch.randn(2, 4, 6, 8)
    w, b = torch.randn(8, 3), torch.randn(3)
    torch.library.opcheck(
        torch.ops.mst_tpu_torch.fused_predictor_softargmax_partial,
        (x, w, b, 2))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        out = fp.fused_predictor_softargmax_partial(
            mode.from_tensor(x), mode.from_tensor(w), mode.from_tensor(b), 2)
    assert out.shape == (2, 3, 4) and out.dtype == torch.float32


def test_spatial_refusals():
    """A height that does not divide the 'space' ranks (naming 'space'),
    a spatial mesh whose ranks span two hosts (mst_tpu's message), the
    axes in the other order; training on the spatial mesh is no longer
    refused (check_loop_ported takes it); none starts a process group."""
    with pytest.raises(ValueError, match="'space'"):
        mesh_lib.Slab(0, 4, None, 30)
    hostdata.check_spatial_hosts(["a", "a", "a", "a"])
    with pytest.raises(NotImplementedError,
                       match="multi-host spatial meshes are not supported"):
        hostdata.check_spatial_hosts(["a", "a", "b", "b"])
    with pytest.raises(ValueError, match="unsupported --mesh_axes"):
        mesh_lib.mesh_from_shape([1, 2], ["space", "data"], "cpu")
    config.check_loop_ported({"mesh_axes": ["data", "space"]})
    config.check_loop_ported({"mesh_shape": [2, 2],
                              "mesh_axes": ["data", "space"],
                              "compute_dtype": "bfloat16"})
    assert not torch.distributed.is_initialized()

