"""The port's eval step on the spatial ('data', 'space') mesh against its
world of one: gloo worlds of 2 and 4 CPU processes on (1, 2) and (2, 2)
meshes (tests/torch_port_ranks.py), each rank holding its 'data' block
of the B = 8 rows (the last 3 padding) and its H slab of the scene map:

- TTST (sdd_shortterm: the goal alone), CWS on sampled goals (a
  longterm setting, two waypoints), a 32-row scene, whose slabs go odd
  before the coarsest level at S = 2, and TTST with a shallow
  segmentation backbone in the step (segment_in_step: each rank
  segments the whole scene and keeps its slab of the map);
- the bars: each 'data' row's waypoint samples bit-equal to its rows of
  the world of one's (the CPU's convs give the same bits on a slab and
  its halo as on the whole map), ade and fde within 1e-5 relative,
  best_traj within 1e-4 model px, and with collect_samples the payload
  (goal maps, waypoint samples) within 1e-5 of each one's max; every
  rank holds the same global outputs.
"""

import numpy as np
import pytest
import torch

from mst_tpu_torch import config
from tests import torch_port_ranks as ranks

VAL_RTOL = 1e-5
PX_TOL = 1e-4     # model px
MAP_TOL = 1e-5    # of each payload map's max
SHAPES = {"1x2": [1, 2], "2x2": [2, 2]}
# one thread a process, here and in each rank: the bit-equality holds
# between runs of one thread's kernels (with more, the CPU's reductions
# were seen to round otherwise in 1 of 6 runs of a loaded machine)
THREADS = 1
CASES = ["spatial_ttst", "spatial_cws", "spatial_odd", "spatial_segment",
         "spatial_samples"]


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started together -> {shape id: (shape, results)}."""
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 ["spatial_mesh"] + CASES, ["data", "space"],
                                 THREADS)
               for name, shape in SHAPES.items()}
    return {name: (SHAPES[name], ranks.finish(handles[name]))
            for name in SHAPES}


@pytest.fixture(scope="module")
def one():
    """The world of one's outputs of each case."""
    return {case: ranks.spatial_eval(
        None, "cws" if case == "spatial_samples" else case[len("spatial_"):],
        collect_samples=case == "spatial_samples") for case in CASES}


@pytest.fixture(params=list(SHAPES))
def world(request, worlds):
    return worlds[request.param]


def test_spatial_mesh_splits_the_batch_over_data(world):
    """(1, 2) and (2, 2): 1 and 2 blocks of the batch; Shards sums and
    gathers over a rank's 'data' column alone (2 ranks of 4, not the
    world), its slab is its 'space' coordinate's."""
    (data, space), res = world
    for rank, out in enumerate(res["spatial_mesh"]):
        d, s = divmod(rank, space)
        assert out["names"] == ("data", "space")
        assert out["ranks"].tolist() == [[r * space + c for c in range(space)]
                                         for r in range(data)]
        assert out["batch_shard_count"] == data
        assert out["shards"] == (d, data)
        assert out["sum"].tolist() == [float(data)] * 3
        # each 'data' rank's 2 rows hold its world rank, gathered in order
        assert out["gathered"].tolist() == [
            float(r * space + s) for r in range(data) for _ in range(2)]
        rows = ranks.H // space
        assert out["slab"] == (s, space, s * rows, (s + 1) * rows)


def rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("case", CASES)
def test_spatial_eval_matches_the_world_of_one(world, one, case):
    (data, space), res = world
    want = one[case]
    got = res[case]
    rf = config.step_config(ranks.step_params()).resize_factor
    height = ranks.SPATIAL_EVALS["odd"][1] if case == "spatial_odd" \
        else ranks.H
    # each 'data' row's draws: its rows of the world of one's, bit for bit
    per = want["wps"].shape[1] // data
    for r, out in enumerate(got):
        d = r // space
        np.testing.assert_array_equal(out["wps"],
                                      want["wps"][:, d * per:(d + 1) * per])
        assert out["rows"] == height // space
    for out in got:
        for k in ("ade", "fde", "ade_sum", "fde_sum"):
            assert rel(out[k], want[k]) <= VAL_RTOL, k
        assert float(np.abs(out["best_traj"] - want["best_traj"]).max()) \
            * rf <= PX_TOL
        np.testing.assert_array_equal(out["mask"], want["mask"])
        assert float(out["n"]) == float(want["n"]) == 5.0
        for k in ("goal_map", "goal_sigmoid_map", "waypoint_samples"):
            if case == "spatial_samples":
                assert out[k].shape == want[k].shape, k
                assert float(np.abs(out[k] - want[k]).max()) <= \
                    MAP_TOL * float(np.abs(want[k]).max()), k
            else:
                assert k not in out
        for k in out:
            if k not in ("wps", "rows"):
                np.testing.assert_array_equal(out[k], got[0][k], err_msg=k)
