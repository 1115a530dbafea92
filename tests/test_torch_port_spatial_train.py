"""The port's train step on the spatial ('data', 'space') mesh against its
world of one: gloo worlds of 2 and 4 CPU processes (tests/
torch_port_ranks.py, one thread a rank) on (1, 2), (2, 2) and (1, 4)
meshes, each rank holding its 'data' block of the B = 8 rows (the last 3
padding) and its H slab of the 64 x 64 scene map, Adam at lr 1e-3:

- 3 mosa_2 steps (LoRA on stages 0-4), a serial-adapter step (train-mode
  batch norms over the slabs), 2 'train' steps (every leaf), a --remat
  step (the recomputed forward runs its halo collectives again in the
  backward, in the same order on every rank, or the world would hang or
  disagree), a bf16 step (--compute_dtype bfloat16), a cross-scene
  step (two scene maps, each row's scene_idx) and a segmentation_head
  step with a shallow backbone in the step in train mode
  (segment_in_step, segment_train_mode: every rank segments the whole
  scene and cuts its slab, whose adjoint makes each rank's backbone
  gradient its slab's share), and a step each of Y-Net-Mod's fusion
  encoder (mosa_1 on its branches), parallel block adapters and the
  embed network;
- the bars, of chip_smoke.py's phase 14 (P14_SIG): every step's losses
  and metric sums within 1e-5 relative; each trainable leaf after the
  steps within 1e-5 of its max where every step's |g| in the world of
  one exceeds 1e-3 of its leaf's max, and within 2 lr a step elsewhere
  (Adam's update there is about lr x the sign of a gradient that is
  mostly rounding); the batch norms' running statistics within 1e-5;
  every rank holds the same leaves; the remat step equals the 'train'
  step's first on the same world bit for bit. The bf16 step's gradients
  are bf16 sums of other slabs (2^-8 of their scale apart), which turn
  Adam's first update, about lr x sign(g), at many elements: its
  gradients are held leaf by leaf within twice the world of one's own
  bf16-to-f32 distance (tests/test_torch_port_bf16.py's rule), its
  leaves within 2 lr a step.
"""

import numpy as np
import pytest
import torch

from tests import torch_port_ranks as ranks

SHAPES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5   # of each leaf's max, where the gradient is significant
SIG = 1e-3        # significant: every step's |g| above this of max |g|
BF16_RATIO = 2.0  # the bf16 step's gradients: of the bf16-to-f32 distance
STAT_TOL = 1e-5
METRICS = ("loss", "goal_loss", "traj_loss", "ade_sum", "fde_sum", "n")
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
    -> ({shape id: results}, the world of one's)."""
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 ["spatial_train"], ["data", "space"],
                                 THREADS)
               for name, shape in SHAPES.items()}
    one = ranks.case_spatial_train(None)
    return {name: ranks.finish(handles[name])["spatial_train"]
            for name in SHAPES}, one


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one(runs):
    return runs[1]


def of_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", list(ranks.SPATIAL_TRAINS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_spatial_train_step_matches_the_world_of_one(worlds, one, shape,
                                                     case):
    want = one[case]
    n_steps = ranks.SPATIAL_TRAINS[case][2]
    assert len(want["steps"]) == n_steps
    lr_steps = 2 * ranks.ADAM_LR * n_steps
    for out in worlds[shape]:
        got = out[case]
        for mine, ref in zip(got["steps"], want["steps"]):
            for k in METRICS:
                assert abs(mine["metrics"][k] - ref["metrics"][k]) <= \
                    LOSS_RTOL * abs(ref["metrics"][k]), k
            assert ref["metrics"]["n"] == 5.0
        assert got["leaves"].keys() == want["leaves"].keys()
        for k, leaf in want["leaves"].items():
            g = [np.abs(s["grads"][k]) for s in want["steps"]]
            sig = np.logical_and.reduce([x > SIG * x.max() for x in g])
            d = np.abs(got["leaves"][k] - leaf)
            if case == "bf16":
                f32 = one["train"]["steps"][0]["grads"][k]
                bf16 = want["steps"][0]["grads"][k]
                assert of_max(got["steps"][0]["grads"][k], bf16) <= \
                    BF16_RATIO * of_max(bf16, f32), k
            else:
                assert float(d[sig].max(initial=0.0)) <= \
                    LEAF_TOL * np.abs(leaf).max(), k
            assert float(d.max()) <= lr_steps, k
            np.testing.assert_array_equal(got["leaves"][k],
                                          worlds[shape][0][case]["leaves"][k])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=0,
                                       atol=STAT_TOL, err_msg=k)
    if case == "serial":
        assert any(k.endswith("running_var") for k in want["state"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_remat_equals_the_step_without(worlds, shape):
    for out in worlds[shape]:
        remat, plain = out["remat"], out["train"]
        assert remat["steps"][0]["metrics"] == plain["steps"][0]["metrics"]
        for k, g in plain["steps"][0]["grads"].items():
            np.testing.assert_array_equal(remat["steps"][0]["grads"][k], g)
