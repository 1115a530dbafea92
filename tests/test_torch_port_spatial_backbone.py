"""The segmentation backbone (models/unet.py) on H slabs of the spatial
('data', 'space') mesh against its world of one: gloo worlds of 2 and 4
CPU processes on (1, 2) and (1, 4) meshes (tests/torch_port_ranks.py,
one thread a rank), a shallow backbone (the U-Net's real widths and
decoder, one block a stage) on a stack of two 96-column images:

- the level rule (unet.backbone_slabs): at 352 rows over 2 ranks layer4
  runs whole, at 1408 every level slices, an odd slab runs whole below
  the image; mesh.Slab.down, the Y-Net's rule, is unchanged;
- heights where every level slices (64 rows over 2, 128 over 4) and
  where the coarsest levels run whole (96 over 2: layer4; 96 over 4:
  layer3-4), each rank's features holding its slabs' rows (or the whole
  map's at a whole level) and no conv input more than its slab and halo
  (the stem's 3 rows above and 2 below);
- eval mode in f32: the gathered output within 1e-5 of its max of the
  whole map's (on the CPU the backbone's convs are oneDNN's, whose sums
  do not depend on the slab, so it is bit-equal), each leaf's gradient
  summed over the world within 1e-5 of the leaf's max;
- train mode (the batch norms on the image's statistics over the 'space'
  ranks): in float64 the output within 1e-5 of its max, the running
  statistics within 1e-6, each leaf's gradient within 1e-5 of its max
  in f32 the output and the running statistics within twice the world
  of one's own f32-to-float64 distance (tests/test_torch_port_bf16.py's
  rule). f32 train-mode gradients are no check of the slabs on this
  random model: the world of one's own lie far from float64 (a rounding
  in the last bit flips ReLUs and moves the batch norms' backward), and
  another summation order lands as far;
- each piece at the global top and bottom (the 7x7/2 stem, the 3x3/2
  max-pool of a ReLU's output, a stride-2 3x3 conv, a stride-2 1x1
  downsample, a 3x3 conv) at 16 and 24 rows: output, input and weight
  gradients within 1e-5 of their max.
"""

import numpy as np
import pytest
import torch

from mst_tpu_torch.models import unet
from mst_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_port_ranks as ranks

SHAPES = {"1x2": (1, 2), "1x4": (1, 4)}
OUT_TOL = 1e-5    # of the output's max
GRAD_TOL = 1e-5   # of each leaf's max
STAT_TOL = 1e-6
F32_RATIO = 2.0   # f32 train mode: of the world of one's f32-to-f64 distance
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started together, the world of one run here meanwhile
    -> ({shape id: each rank's results}, the world of one's)."""
    handles = {name: ranks.start(tmp_path_factory.mktemp(name), shape,
                                 ["spatial_backbone"], ["data", "space"],
                                 THREADS)
               for name, shape in SHAPES.items()}
    one = {}
    for height in sorted({h for hs in ranks.BACKBONE_HEIGHTS.values()
                          for h in hs}):
        for mode, train, dtype in (("eval", False, torch.float32),
                                   ("train", True, torch.float32),
                                   ("train64", True, torch.float64)):
            one[height, mode] = ranks.backbone_run(None, height, train,
                                                   dtype)
    for name in ranks.BACKBONE_PIECES:
        for height in ranks.PIECE_HEIGHTS:
            one[name, height] = ranks.backbone_piece(None, name, height)
    return {name: ranks.finish(handles[name])["spatial_backbone"]
            for name in SHAPES}, one


def of_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def slab_rows(height, space):
    return [None if s is None else s.rows for s in unet.backbone_slabs(
        mesh_lib.Slab(0, space, None, height))]


def test_the_level_rule():
    assert slab_rows(352, 2) == [176, 88, 44, 22, 11, None]
    assert slab_rows(1408, 2) == [704, 352, 176, 88, 44, 22]
    assert slab_rows(64, 2) == [32, 16, 8, 4, 2, 1]
    assert slab_rows(96, 2) == [48, 24, 12, 6, 3, None]
    assert slab_rows(128, 4) == [32, 16, 8, 4, 2, 1]
    assert slab_rows(96, 4) == [24, 12, 6, 3, None, None]
    assert slab_rows(6, 2) == [3, None, None, None, None, None]
    assert unet.backbone_slabs(None) == [None] * 6
    # the Y-Net's own rule stays: a level runs whole from the first whose
    # pooled slab would hold odd rows
    assert [None if s is None else s.rows for s in mesh_lib.Slab(
        0, 2, None, 352).levels(6)] == [176, 88, 44, 22, None, None]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_rank_holds_its_slabs(runs, shape):
    worlds, one = runs
    space = SHAPES[shape][1]
    for height in ranks.BACKBONE_HEIGHTS[space]:
        want = [r if r is not None else height >> level for level, r in
                enumerate(slab_rows(height, space))]
        for out in worlds[shape]:
            got = out[height, "eval"]
            assert got["feat_rows"] == want
            # the stem reads its slab and 3 rows above, 2 below, and no
            # conv reads more rows than that
            assert got["conv_rows"][0] == (7, 2, height // space + 5)
            assert max(r for _, _, r in got["conv_rows"]) == \
                height // space + 5
        assert one[height, "eval"]["feat_rows"] == [
            height >> level for level in range(6)]


@pytest.mark.parametrize("mode", ["eval", "train64"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_backbone_on_slabs_equals_the_whole_map(runs, shape, mode):
    worlds, one = runs
    for height in ranks.BACKBONE_HEIGHTS[SHAPES[shape][1]]:
        want = one[height, mode]
        for out in worlds[shape]:
            got = out[height, mode]
            assert got["out"].dtype == want["out"].dtype
            assert of_max(got["out"], want["out"]) <= OUT_TOL
            if mode == "eval":
                np.testing.assert_array_equal(got["out"], want["out"])
            assert got["grads"].keys() == want["grads"].keys()
            for k, g in want["grads"].items():
                assert of_max(got["grads"][k], g) <= GRAD_TOL, (height, k)
            assert got["stats"].keys() == want["stats"].keys()
            assert bool(want["stats"]) == (mode != "eval")
            for k, v in want["stats"].items():
                np.testing.assert_allclose(got["stats"][k], v, rtol=0,
                                           atol=STAT_TOL, err_msg=k)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_f32_train_mode_within_the_world_of_ones_rounding(runs, shape):
    worlds, one = runs
    for height in ranks.BACKBONE_HEIGHTS[SHAPES[shape][1]]:
        want, exact = one[height, "train"], one[height, "train64"]
        for out in worlds[shape]:
            got = out[height, "train"]
            assert of_max(got["out"], want["out"]) <= F32_RATIO * of_max(
                want["out"], exact["out"])
            own = max(float(np.abs(v - exact["stats"][k]).max())
                      for k, v in want["stats"].items())
            for k, v in want["stats"].items():
                assert float(np.abs(got["stats"][k] - v).max()) <= \
                    F32_RATIO * own, k


@pytest.mark.parametrize("name", list(ranks.BACKBONE_PIECES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_each_piece_at_the_global_edges(runs, shape, name):
    worlds, one = runs
    space = SHAPES[shape][1]
    for height in ranks.PIECE_HEIGHTS:
        want = one[name, height]
        rows = height // space
        for r, out in enumerate(worlds[shape]):
            got = out[name, height]
            assert of_max(got["out"], want["out"]) <= OUT_TOL
            x_grad = want["x_grad"][:, :, r * rows:(r + 1) * rows]
            assert got["x_grad"].shape == x_grad.shape
            assert of_max(got["x_grad"], x_grad) <= GRAD_TOL
            assert of_max(got["w_grad"], want["w_grad"]) <= GRAD_TOL
