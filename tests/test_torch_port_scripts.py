"""The port's experiment-suite harness (mst_tpu_torch/utils/
scripts_e2e.py) against mst_tpu's: the script scanners over every script
of scripts/, and the sandbox: mst_tpu's file tree with equal pickles,
configs, scene images and grid overrides, and tiny checkpoints (the
port's init, in mst_tpu's npz layout) that mst_tpu's load_checkpoint
reads with the keys, shapes and dtypes of mst_tpu's own init. The suites
themselves run in tests/test_torch_port_scripts_*.py.
"""

import os
import pathlib

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import yaml

from mst_tpu import config as jconfig
from mst_tpu.models import ynet as jynet
from mst_tpu.train import checkpoints as jckpt
from mst_tpu.utils import scripts_e2e as jharness
from mst_tpu_torch.utils import scripts_e2e as harness

SCRIPTS = harness.experiment_scripts()
# the redirections the port's sandbox adds, and mst_tpu's root links
OWN = ("train.py", "test.py", "bin/python", "guard/sitecustomize.py")


def test_script_scanners_match_jax():
    assert SCRIPTS == jharness.experiment_scripts()
    assert len(SCRIPTS) == 92
    for rel in SCRIPTS:
        path = os.path.join(harness.REPO_ROOT, rel)
        assert harness.parse_script_vars(path) == \
            jharness.parse_script_vars(path), rel
        assert harness.expected_runs(rel) == jharness.expected_runs(rel)
    assert harness.collect_requirements(SCRIPTS) == \
        jharness.collect_requirements(SCRIPTS)
    assert harness._GRID_OVERRIDES == jharness._GRID_OVERRIDES
    assert harness._TINY_OVERRIDES == jharness._TINY_OVERRIDES


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def sandboxes(tmp_path_factory):
    """Both packages' sandboxes for every script; mst_tpu's without its
    checkpoints (its JAX init of each takes seconds)."""
    port = tmp_path_factory.mktemp("port")
    jax_sb = tmp_path_factory.mktemp("jax")
    harness.build_sandbox(port, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jharness, "_build_ckpts", lambda dst, ckpts: None)
    try:
        jharness.build_sandbox(jax_sb)
    finally:
        mp.undo()
    return port, jax_sb


def test_sandbox_tree_matches_jax(sandboxes):
    port, jax_sb = sandboxes
    _, ckpts = harness.collect_requirements(SCRIPTS)
    got = [f for f in files(port) if f not in OWN]
    want = [f for f in files(jax_sb) if f not in ("train.py", "test.py")]
    ck = sorted(c for rel in ckpts for c in (rel, rel + ".json"))
    assert got == sorted(want + ck)
    assert len(want) > 50
    for rel in want:
        a, b = port / rel, jax_sb / rel
        if rel.endswith(".pkl"):
            pd.testing.assert_frame_equal(pd.read_pickle(a),
                                          pd.read_pickle(b))
        elif rel.endswith((".jpg", ".png")):
            np.testing.assert_array_equal(cv2.imread(str(a)),
                                          cv2.imread(str(b)))
        elif rel.endswith(".yaml"):
            assert yaml.safe_load(a.read_text()) == \
                yaml.safe_load(b.read_text()), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_checkpoints_load_in_jax(sandboxes):
    """Each tiny checkpoint: mst_tpu's load_checkpoint gives the keys,
    shapes and dtypes of mst_tpu's init_ynet of the same family."""
    port, _ = sandboxes
    _, ckpts = harness.collect_requirements(SCRIPTS)
    assert len(ckpts) == 9
    for rel, (cfg_name, network, n_fusion) in ckpts.items():
        over = dict(harness._TINY_OVERRIDES, network=network,
                    segmentation_model_fp=None)
        if n_fusion is not None:
            over["n_fusion"] = n_fusion
        mcfg = jconfig.ynet_config(jconfig.get_params(
            config_filename=str(port / "config" / cfg_name),
            overrides=over))
        shapes, _ = jax.eval_shape(
            lambda: jynet.init_ynet(jax.random.PRNGKey(7), mcfg))
        want = {jckpt.path_to_str(p): (tuple(s.shape), np.dtype(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        got = jckpt.load_checkpoint(str(port / rel))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want, rel
        meta = yaml.safe_load((port / (rel + ".json")).read_text())
        assert meta == {"synthetic_fixture": True, "network": network,
                        "config": cfg_name}


def test_shims_fix_the_device(tmp_path):
    paths = harness.write_shims(tmp_path, "cuda")
    assert "--device" in paths["train.py"].read_text()
    assert "'cuda'" in paths["python"].read_text()
    assert os.access(paths["python"], os.X_OK)
    harness.write_shims(tmp_path, "cpu")
    assert "'cpu'" in paths["test.py"].read_text()
    with pytest.raises(ValueError):
        harness.write_shims(tmp_path, "tpu")
    env = harness.suite_env(tmp_path)
    assert env["PATH"].split(os.pathsep)[0] == str(tmp_path / "bin")
    assert env["PYTHONPATH"].split(os.pathsep)[:2] == [
        str(tmp_path / "guard"), harness.REPO_ROOT]
    assert "JAX_PLATFORMS" not in set(env) - set(os.environ)
    assert pathlib.Path(env["MST_GRID_OVERRIDES"]).name == "overrides.sh"


def test_empty_selection_trains_nothing_as_jax(tmp_path):
    """mosa_1 on positions 0-4 of the fusion network (the sdd
    biker_low_to_high and ped_to_biker_modular suites) selects no leaf:
    the adapters of Y-Net-Mod are keyed scene/motion/fusion. mst_tpu
    steps an empty tree and writes an empty delta; so does the port,
    which raised in its step and its save until the sweep found it."""
    import torch

    from mst_tpu.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch import io
    from mst_tpu_torch.data.tracks import Tracks
    from tests.test_torch_port_experiment import loop_params, pair

    df, images = make_synthetic_dataset(seed=0, n_scenes=1, n_traj=6,
                                        img_hw=(128, 192))
    params = loop_params(tmp_path, "mosa_1", network="fusion", n_fusion=2,
                         n_epoch=1, fine_tune=True, batch_size=4)
    port, jexp = pair(params, images)
    before = {k: v.clone() for k, v in io.flatten(port.model_params).items()}
    tracks = Tracks.from_frame(df)
    port.train(tracks, tracks, None, None, "empty")
    for k, v in io.flatten(port.model_params).items():
        assert torch.equal(v, before[k]), k
    port.save_params(str(tmp_path / "port.npz"))
    jexp.save_params(str(tmp_path / "jax.npz"))
    for name in ("port.npz", "jax.npz"):
        with np.load(tmp_path / name) as z:
            assert z.files == [], name
