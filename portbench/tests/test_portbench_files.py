"""Every file the benchmark names is there and loads, and the
configurations hold their published settings."""

import re

import pytest
import yaml

from portbench import core
from portbench.tests.small import CELLS, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
YAMLS = {"ynet_sdd": "sdd_shortterm_train.yaml",
         "ynetmod_ind": "inD_longterm_train.yaml"}


def test_benchmark_names_cells_in_order():
    b = bench()
    assert [w["name"] for w in b["workloads"]] == list(CELLS)
    assert {c["name"] for c in b["configs"]} == set(YAMLS)
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    for m in b["end_to_end"] + b["per_layer"] + b["workloads"]:
        assert NAME.match(m["name"]), m["name"]
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m


@pytest.mark.parametrize("name", CELLS)
def test_workload_loads(name):
    cell = core.read_json("workloads", name)
    entry = next(w for w in bench()["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"]
    assert cell["chips"] == entry["chips"] == 1
    core.read_json("configs", cell["config"])
    core.load_module("loops", cell["loop"])
    assert set(cell["check"]["limits"]), name


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_config_holds_its_yaml(name):
    cfg = core.read_json("configs", name)
    entry = next(c for c in bench()["configs"] if c["name"] == name)
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert cfg["reduced"] == entry["reduced"] == []
    assert len(entry["source"]) <= 200 and entry["source"] == cfg["source"]
    with open(core.CHECKOUT / "mst_tpu_torch" / "configs" / YAMLS[name]) as f:
        published = yaml.safe_load(f)
    for key, value in published.items():
        assert cfg[key] == value, key


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_metric_reader_loads(metric):
    reader = core.load_module("metrics", metric)
    assert reader.read({}) is None
