"""bf16 and Y-Net-Mod model directories on the CPU at small width
(test_torch_port_export.py's widths, B = 2 at 64 x 96, n_goal 5, torch on
two intra-op threads): a bf16 directory (its programs run the bf16 step,
bf16 features) and Y-Net-Mod (inD_longterm_eval.yaml, network fusion,
n_fusion 2, mosa_1 on scene, motion and fusion, TTST and CWS on, the
fused predictor at P = 30): their programs against the eager predict
step with the same key, and LoadedModel against the Predictor with a
style, bit for bit.
"""

from tests.test_torch_port_export import (export,
                                          programs_equal_the_eager_step,
                                          two_threads)  # noqa: F401


def test_bf16_directory_equals_the_eager_step(tmp_path):
    programs_equal_the_eager_step(*export(tmp_path, "bf16",
                                          compute_dtype="bfloat16"))


def test_ynet_mod_directory_equals_the_eager_step(tmp_path):
    case = export(tmp_path, "ymod", config="inD_longterm_eval.yaml",
                  network="fusion", n_fusion=2, train_net="mosa_1",
                  position=["scene", "motion", "fusion"], use_CWS=True)
    params = case[0]
    assert params["pred_len"] == 30 and len(params["waypoints"]) == 2
    programs_equal_the_eager_step(*case)
