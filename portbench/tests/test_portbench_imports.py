"""Nothing the harness loads is jax, jaxlib, flax or the JAX package,
compared by whole top-level name (the port, mst_tpu_torch, begins with
the JAX package's name and is not it)."""

import ast
import json
import subprocess
import sys

from portbench import core

LOADS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import core
core.set_environment()
from portbench.tests.small import small
from portbench.run import Context
for name in ("ynetmod_ind.serve_ttst_cws", "ynet_sdd.finetune_mosa1"):
    cell, cfg = small(name)
    cell = dict(cell, requests=4)
    drv = core.load_module("loops", cell["loop"])
    drv.run(Context(cell, core.run_config(cfg, cell), 3, 0.0, False, "cpu",
                    0.0))
for m in ("forward_ms.serve", "mfu.train", "roofline.fused_predict.serve"):
    core.load_module("metrics", m)
print(json.dumps([core.forbidden_modules(),
                  "mst_tpu_torch" in sys.modules]))
"""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for path in core.HERE.rglob("*.py"):
        assert not set(_imports(path)) & core.FORBIDDEN, path
    for path in (core.HERE / "reference").rglob("*.py"):
        assert "mst_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_the_port_and_nothing_forbidden():
    out = subprocess.run([sys.executable, "-c",
                          LOADS.format(root=str(core.CHECKOUT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    found, port_loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and port_loaded


def test_whole_names_are_compared(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in core.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "mst_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mst_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert core.forbidden_modules() == ["jax", "mst_tpu"]
