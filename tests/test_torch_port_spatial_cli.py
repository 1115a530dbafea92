"""The spatial ('data', 'space') mesh through the port's CLIs on the CPU:
`python -m mst_tpu_torch.test --mesh_shape 1 2 --mesh_axes data space
--device cpu` in a gloo world of 2 (tests/torch_port_ranks.py, on the
loop world's 2 synthetic scenes) prints the test lines of the run without
a mesh (4 places); on that mesh the train CLI (a mosa_2 fine-tune, 2
epochs), the same with --fused (eager on gloo) and Experiment.train with
--cross_scene_batching and --remat train as they do without a mesh:
each epoch's val ADE/FDE, loss and train ADE/FDE within 1e-5 relative,
the saved delta within 1e-4 of each leaf's max
(test_torch_port_experiment.py's PARAM_TOL: 4 Adam steps at lr 0.01,
whose near-zero gradients' signs may differ); the grid exits with
mst_tpu's SystemExit.
"""

import os
import re

import numpy as np
import pytest
import torch

from mst_tpu_torch import config, grid
from mst_tpu_torch import test as test_cli
from tests import torch_port_ranks as ranks

VAL_RTOL = 1e-5
PARAM_TOL = 1e-4  # of each leaf's max

@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 2 (started first), the test CLI without a mesh and
    the training flows without one -> (its outputs on each rank, the
    world of one's stdout, its training flows)."""
    root = tmp_path_factory.mktemp("spatial_cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ranks.write_loop_world(root)
        handle = ranks.start(root / "ranks", [1, 2], ["spatial_cli"],
                             ["data", "space"])
        with pytest.MonkeyPatch.context() as mp:
            lines = []
            mp.setattr("builtins.print", lambda *a, **k: lines.append(
                " ".join(map(str, a))))
            test_cli.main(config.get_parser(False).parse_args(
                ranks.SPATIAL_TEST_ARGS))
        flows = ranks.spatial_train_flows("one", [])
    finally:
        os.chdir(cwd)
    return ranks.finish(handle)["spatial_cli"], "\n".join(lines), flows


def results(text):
    """The printed test lines, numbers to 4 places."""
    keep = [ln for ln in text.splitlines()
            if re.search(r"(Test ADE|Test FDE|Round|Average)", ln)]
    return [re.sub(r"\d+\.\d+", lambda m: f"{float(m.group()):.4f}", ln)
            for ln in keep]


def test_spatial_test_cli_prints_the_runs_without_a_mesh(runs):
    got, one, _ = runs
    want = results(one)
    assert sum("Test ADE" in ln for ln in want) == 3  # 2 rounds + average
    for out in got:  # main() in-process: every rank prints
        assert results(out["test"]) == want


def test_each_rank_uploads_its_slab_of_each_scene(runs):
    """On the spatial mesh Experiment uploads, for each scene, rank r's
    rows [r H / 2, (r + 1) H / 2) of its image (the semantic map without
    a backbone), cut from the image its batches hold."""
    got, _, _ = runs
    for rank, out in enumerate(got):
        assert out["uploads"]
        for whole, held in out["uploads"].values():
            rows = whole.shape[1] // 2
            assert whole.shape[1] == 2 * rows
            np.testing.assert_array_equal(
                held, whole[:, rank * rows:(rank + 1) * rows])


@pytest.mark.parametrize("flow", ["train", "fused", "experiment"])
def test_training_on_the_spatial_mesh_raises(runs, flow):
    """Training on the spatial mesh no longer raises: the train CLI,
    --fused and Experiment.train (cross-scene, remat) on the (1, 2) mesh
    against the same runs without a mesh."""
    got, _, flows = runs
    records1, delta1 = flows[flow]
    assert len(records1) == (1 if flow == "experiment" else 2)
    for out in got:
        records, delta = out[flow]
        assert len(records) == len(records1)
        for rec, rec1 in zip(records, records1):
            for k in ("val_ade", "val_fde", "loss", "train_ade",
                      "train_fde"):
                assert abs(rec[k] - rec1[k]) <= VAL_RTOL * abs(rec1[k]), k
        assert delta.keys() == delta1.keys() and delta1
        for k, v in delta1.items():
            assert float(np.abs(delta[k] - v).max()) <= \
                PARAM_TOL * float(np.abs(v).max()), k


def test_the_grid_refuses_the_spatial_mesh():
    with pytest.raises(SystemExit, match="use a 1D --mesh_shape \\(no "
                       "'space' axis\\)"):
        grid.run_grid(grid.get_parser().parse_args(
            ranks.LOOP_ARGS + ranks.GRID_ARGS + [
                "--mesh_shape", "1", "2", "--mesh_axes", "data", "space"]))
