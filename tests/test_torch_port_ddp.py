"""The port's data-parallel steps on a gloo world of 2 CPU processes
against the port's world of one (tests/torch_port_ranks.py runs the
ranks): B = 8 rows, the last 3 padding, so the ranks hold 4 and 1 valid
rows, and a mean that each rank took over its own rows would differ.

- the train step ('train': every leaf trains): 2 SGD steps, the losses
  within 1e-6 relative, the leaves within 1e-5 of each leaf's max, and
  every rank's leaves bit-equal to the others';
- a serial adapter's 2 SGD steps, whose train-mode batch norms take the
  global batch's statistics: the running statistics within 1e-6, the
  losses within 1e-6 relative, each step's gradients within 1e-4 of each
  leaf's max;
- the eval step with TTST and CWS: each rank's waypoint draws bit-equal
  to its rows of the world of one's, and the gathered outputs equal (the
  CPU's convs give the same bits at both batch sizes);
- torch.distributed.checkpoint from 2 ranks to 2 and to 1, and from 1 to
  2;
- shard_batch_global's refusals with mst_tpu's messages.
"""

import numpy as np
import pytest
import torch

from mst_tpu_torch.train import sharded_ckpt
from tests import torch_port_ranks as ranks

LOSS_RTOL = 1e-6
LEAF_TOL = 1e-5   # of each leaf's max
STAT_TOL = 1e-6
GRAD_TOL = 1e-4   # of each leaf's max


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one world of 2, after a world of one saved ckpt1."""
    out = tmp_path_factory.mktemp("world2")
    sharded_ckpt.save_sharded(str(out / "ckpt1"), ranks.checkpoint_tree())
    res = ranks.launch(out, [2], ["train", "serial", "eval", "checkpoint",
                                  "restore_one", "errors"])
    res["dir"] = out
    return res


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def of_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_train_step_matches_world_of_one(world):
    one = ranks.case_train(None)
    got = world["train"]
    for step, want in zip(got[0]["steps"], one["steps"]):
        m = step["metrics"]
        assert m["n"] == 5.0  # the global count, on rank 0 of 4 + 1
        for k in ("loss", "goal_loss", "traj_loss", "ade_sum", "fde_sum"):
            assert rel(m[k], want["metrics"][k]) <= LOSS_RTOL, k
    for k, w in one["weights"].items():
        assert of_max(got[0]["weights"][k], w) <= LEAF_TOL, k
        np.testing.assert_array_equal(got[1]["weights"][k],
                                      got[0]["weights"][k])
    assert got[1]["steps"][-1]["metrics"] == got[0]["steps"][-1]["metrics"]


def test_serial_batch_norm_step_matches_world_of_one(world):
    one = ranks.case_serial(None)
    got = world["serial"]
    assert any("serial_layer/bn/running_var" in k for k in one["state"])
    for k, want in one["state"].items():
        for r in range(2):
            np.testing.assert_allclose(got[r]["state"][k], want, rtol=0,
                                       atol=STAT_TOL, err_msg=k)
    assert len(one["steps"]) == 2
    for m, want in zip(got[0]["steps"], one["steps"]):
        for k in ("loss", "goal_loss", "traj_loss"):
            assert rel(m["metrics"][k], want["metrics"][k]) <= LOSS_RTOL, k
        for k, g in want["grads"].items():
            assert of_max(m["grads"][k], g) <= GRAD_TOL, k


def test_eval_draws_and_outputs_match_world_of_one(world):
    one = ranks.case_eval(None)
    got = world["eval"]
    B = len(ranks.MASK)
    for r in range(2):
        # each rank's draws: its rows of the world of one's, bit for bit
        np.testing.assert_array_equal(
            got[r]["wps"], one["wps"][:, r * B // 2:(r + 1) * B // 2])
        for k in ("ade", "fde", "mask", "best_traj", "ade_sum", "fde_sum",
                  "n"):
            np.testing.assert_array_equal(got[r][k], one[k], err_msg=k)


def test_sharded_checkpoint_round_trips(world):
    """2 -> 2: each rank's restore; 2 -> 1: this process restores the
    world's directory; 1 -> 2: each rank restored what this process
    saved."""
    want = ranks.numpy_tree(ranks.checkpoint_tree())
    template = ranks.checkpoint_tree(zero=True)
    sharded_ckpt.restore_sharded(str(world["dir"] / "ckpt2"), template)
    trees = [ranks.numpy_tree(template)]
    for r in range(2):
        trees += [world["checkpoint"][r]["restored"],
                  world["restore_one"][r]["restored"]]
    for tree in trees:
        assert tree.keys() == want.keys()
        for k in want:
            assert tree[k].dtype == want[k].dtype
            np.testing.assert_array_equal(tree[k], want[k])


def test_shard_batch_global_refusals(world):
    for r in range(2):
        assert world["errors"][r]["messages"] == [
            "global_batch_size=7 is not divisible by process_count=2; pad "
            "the global batch to a multiple of the process count first "
            "(pad_batch_to_multiple)",
            "batch key 'traj': 3 local rows but global_batch_size=8 over 2 "
            "processes expects 4"]
