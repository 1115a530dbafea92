"""A segment_in_step model directory on the CPU at small width
(test_torch_port_export.py's widths, B = 2 at 64 x 96, n_goal 5, torch on
two intra-op threads): a shallow segmentation backbone (the U-Net's real
widths, one block a stage, random weights from seed 0) inside
forward.pt2, which takes the raw 3-channel scene; its programs against
the eager predict step with the same key, and LoadedModel against the
Predictor with a style, bit for bit.
"""

import numpy as np
import torch

from mst_tpu_torch import io
from mst_tpu_torch.models.unet import unet_init
from tests.test_torch_port_export import (export,
                                          programs_equal_the_eager_step,
                                          two_threads)  # noqa: F401


def test_segment_in_step_directory_equals_the_eager_step(tmp_path):
    backbone = tmp_path / "backbone.npz"
    np.savez(backbone, **io.params_to_numpy(unet_init(
        torch.Generator().manual_seed(0), n_classes=3,
        layers=(1, 1, 1, 1))))
    case = export(tmp_path, "seg", segment_in_step=True,
                  segmentation_model_fp=str(backbone))
    with np.load(case[1] / "params.npz") as z:
        assert any(k.startswith("segmentation/") for k in z.files)
    programs_equal_the_eager_step(*case)
