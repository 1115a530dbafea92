"""A run end to end on the CPU at a small size (the harness's look for a
card skipped): the result line's schema, and the runs that must print no
result."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import core
from portbench.run import main, measure
from portbench.tests.small import CELLS, bench, small

SEED = 2 ** 31 + 11  # a seed may pass 32 signed bits


@pytest.mark.parametrize("name", CELLS)
def test_result_line_schema(name):
    cell, cfg = small(name)
    line, checks = measure(bench(), name, cell, cfg, SEED, 0.5, 0,
                           device="cpu", t0=0.0)
    line = json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"]: m["unit"] for m in bench()["end_to_end"]
            if name in m.get("workloads", [name])}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {k: {"value": v, "limit": lim}
                              for k, (v, lim) in checks.items()}


def test_same_seed_same_inputs():
    cell, cfg = small(CELLS[0])
    from portbench import traffic

    a = traffic.requests(SEED, cell, cfg)
    b = traffic.requests(SEED, cell, cfg)
    assert all((x["observed"] == y["observed"]).all() and x["key"].tolist()
               == y["key"].tolist() and x["style"] == y["style"]
               for x, y in zip(a, b))
    other = traffic.requests(SEED + 1, cell, cfg)
    # another seed draws other inputs of the same sizes, block by block
    block = cell["agents"][1] - cell["agents"][0] + 1
    n = len(a) // block * block
    assert sorted(len(r["observed"]) for r in a[:n]) == sorted(
        len(r["observed"]) for r in other[:n])


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) \
        != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(core.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[2],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
