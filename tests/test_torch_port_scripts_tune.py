"""`scripts/sdd/ped_to_biker/tune_mosa.sh` (the train CLI's MoSA fine-tune with smooth-val), unchanged, through
the port's harness on the CPU (mst_tpu_torch/utils/scripts_e2e.py): the
sandbox's train.py / test.py shims and bin/python run the port's CLIs
with --device cpu, jax and mst_tpu unimportable in every process of the
suite; it exits 0 and prints its expected 'Average performance (by N)'
blocks, as tests/test_scripts_e2e.py holds mst_tpu's CLIs to.
"""

import re

from mst_tpu_torch.utils import scripts_e2e

SCRIPT = "scripts/sdd/ped_to_biker/tune_mosa.sh"


def test_suite_runs_green_on_the_port(tmp_path):
    scripts_e2e.build_sandbox(tmp_path, scripts=[SCRIPT], device="cpu")
    rc, out = scripts_e2e.run_script(SCRIPT, tmp_path, timeout=300)
    assert rc == 0, f"{SCRIPT} rc={rc}\n{out[-3000:]}"
    n_avg = len(re.findall(r"Average performance \(by ", out))
    assert n_avg >= scripts_e2e.expected_runs(SCRIPT) >= 1, out[-3000:]
    assert "may not be imported" not in out
    assert re.search(r"Test ADE: [\d.]+ \nTest FDE: [\d.]+", out)
