"""The slice as a whole: mst_tpu_torch's eval/predict steps and Predictor
against the JAX package, on the CPU in f32, plus the port's boundary (it
imports neither jax nor mst_tpu, and needs a card unless told otherwise).
"""

import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import io
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.models import unet
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.ops.softargmax import softargmax2d_nhwc
from mst_tpu_torch.serve import Predictor
from mst_tpu_torch.train import steps

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W, B = 64, 96, 4
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def small_params(config="sdd_shortterm_eval.yaml", **over):
    return get_params(config, {**SMALL, **over})


def batch(rng, obs_len, pred_len):
    return {
        "semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
        "traj": rng.uniform(10, 50, size=(B, obs_len + pred_len, 2)
                            ).astype(np.float32),
        "mask": np.ones(B, np.float32),
    }


@pytest.mark.parametrize("eval_k_chunk", [0, 3])
def test_eval_step_matches_jax(rng, eval_k_chunk):
    """Fed the waypoint samples JAX's forward drew, the port's decode and
    score reproduce JAX's ade, fde and best_traj within 1e-3 px."""
    params = small_params(waypoints=[5, 11], n_goal=3, n_traj=2,
                          eval_k_chunk=eval_k_chunk)
    mcfg = ynet_config(params)
    scfg = step_config(params)
    weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=(8, 8, 16, 16, 16),
        decoder_channels=(16, 16, 16, 8, 8), waypoints=(5, 11))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=(5, 11),
        template_size=scfg.template_size, kernlen=31, nsig=4.0,
        loss_scale=1000.0, resize_factor=scfg.resize_factor,
        temperature=1.0, n_goal=3, n_traj=2, packed_decode=False)
    jweights = io.unflatten(io.params_to_numpy(weights))
    b = batch(rng, 8, 12)
    key = jax.random.PRNGKey(5)
    es = jsteps.make_eval_step(jmcfg, jscfg)
    _, jwps = es.forward(jweights, {}, b, key)
    want = es(jweights, {}, b, key)

    step = steps.make_eval_step(mcfg, scfg)
    tb = {k: t(v) for k, v in b.items()}
    feats, _ = step.forward(weights, state, tb,
                            torch.Generator().manual_seed(0))
    got = step.decode_and_score(weights, feats, t(jwps), tb["traj"],
                                tb["mask"])
    for k in ("ade", "fde", "best_traj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3)
    np.testing.assert_allclose(float(got["ade_sum"]),
                               float(want["ade_sum"]), atol=1e-2)


def test_cws_prior_matches_jax(rng):
    mean = rng.uniform(10, 50, size=(3, 2, 2)).astype(np.float32)
    dist = rng.normal(scale=8, size=(3, 2, 2)).astype(np.float32)
    sf = rng.uniform(3, 6, size=(3, 2)).astype(np.float32)
    for rot in (False, True):
        want = jsteps.cws_gaussian_prior(jnp.asarray(mean), jnp.asarray(dist),
                                         jnp.asarray(sf), 2.0, rot, 40, 56)
        got = steps.cws_gaussian_prior(t(mean), t(dist), t(sf), 2.0, rot,
                                       40, 56)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-7)


def _in_image(a, rf):
    return (np.isfinite(a).all() and (a >= 0).all()
            and (a[..., 0] <= (W - 1) / rf).all()
            and (a[..., 1] <= (H - 1) / rf).all())


def test_predictor_ttst_cws_on_cpu(rng, tmp_path):
    """The whole predict path on the CPU with TTST and CWS on: finite
    coordinates inside the image; a LoRA style moves them; the decode's
    fused tail equals the 1x1 conv + soft-argmax on the same draws."""
    params = small_params("inD_shortterm_eval.yaml", waypoints=[5, 11],
                          use_TTST=True, use_CWS=True, train_net="mosa_2",
                          position=["0", "1"])
    pred = Predictor(params, device="cpu", seed=1)
    b = batch(rng, 8, 0)
    out = pred.predict(b["semantic"], b["traj"], seed=3)
    rf = params["resize_factor"]
    assert out["trajectories"].shape == (20, B, 12, 2)
    assert out["waypoints"].shape == (20, B, 2, 2)
    assert _in_image(out["trajectories"], rf)
    assert _in_image(out["waypoints"], rf)

    delta = {k: rng.normal(scale=0.1, size=v.shape).astype(np.float32)
             for k, v in io.params_to_numpy(pred.params).items()
             if k.endswith("lora_B")}
    np.savez(tmp_path / "style.npz", **delta)
    pred.add_style("s", str(tmp_path / "style.npz"))
    styled = pred.predict(b["semantic"], b["traj"], seed=3, style="s")
    assert _in_image(styled["trajectories"], rf)
    assert np.abs(styled["trajectories"] - out["trajectories"]).max() > 0
    np.savez(tmp_path / "bad.npz", **{"encoder/nope/lora_B": np.zeros(2)})
    with pytest.raises(KeyError):
        pred.add_style("bad", str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError):
        pred.predict(b["semantic"], b["traj"], style="missing")

    feats, wps = pred.forward(b["semantic"], b["traj"], seed=3)
    np.testing.assert_array_equal(wps.numpy() / rf, out["waypoints"])
    x, w, bias = steps.make_eval_step(pred.mcfg, pred.scfg).prepredictor(
        pred.params, feats)(wps)
    plain = softargmax2d_nhwc(torch.einsum("rhwc,cp->rhwp", x, w) + bias)
    np.testing.assert_allclose(pred.decode(feats, wps).numpy(),
                               plain.reshape(20, B, 12, 2).numpy() / rf,
                               atol=4e-3)


def test_predictor_checkpoint_matches_jax_forward(rng, tmp_path):
    """A Predictor built from a JAX-format checkpoint decodes JAX's own
    waypoint draws to JAX's trajectories (make_predict_step)."""
    params = small_params(n_goal=3)
    weights, _ = init_ynet(torch.Generator().manual_seed(2),
                           ynet_config(params))
    flat = io.params_to_numpy(weights)
    np.savez(tmp_path / "ckpt.npz", **flat)
    pred = Predictor(params, str(tmp_path / "ckpt.npz"), device="cpu",
                     seed=9)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=(8, 8, 16, 16, 16),
        decoder_channels=(16, 16, 16, 8, 8), waypoints=(11,))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=(11,),
        template_size=pred.scfg.template_size, kernlen=31, nsig=4.0,
        loss_scale=1000.0, resize_factor=0.25, temperature=1.0, n_goal=3,
        n_traj=1, packed_decode=False)
    b = batch(rng, 8, 0)
    jpredict = jsteps.make_predict_step(jmcfg, jscfg)
    key = jax.random.PRNGKey(1)
    jout = jpredict(io.unflatten(flat), {}, b["semantic"], b["traj"], key)
    feats, _ = pred.forward(b["semantic"], b["traj"])
    got = pred.decode(feats, t(jout["waypoints"]) * 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout["trajectories"]),
                               atol=4e-3)


def test_predictor_checkpoint_is_strict(tmp_path):
    """A base checkpoint must hold every parameter (adapter leaves aside)
    and nothing the model lacks; else the Predictor raises instead of
    serving some of the seed's random weights."""
    params = small_params(train_net="mosa_2", position=["0"])
    flat = io.params_to_numpy(init_ynet(torch.Generator().manual_seed(2),
                                        ynet_config(params))[0])
    base = {k: v for k, v in flat.items() if "lora_" not in k}
    np.savez(tmp_path / "base.npz", **base)
    pred = Predictor(params, str(tmp_path / "base.npz"), device="cpu",
                     seed=9)
    got = io.params_to_numpy(pred.params)
    for k, v in base.items():
        np.testing.assert_array_equal(got[k], v)
    missing = dict(base)
    del missing["traj_decoder/predictor/bias"]
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(KeyError, match="traj_decoder/predictor/bias"):
        Predictor(params, str(tmp_path / "missing.npz"), device="cpu")
    np.savez(tmp_path / "extra.npz", **base,
             **{"traj_decoder/renamed/bias": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="traj_decoder/renamed/bias"):
        Predictor(params, str(tmp_path / "extra.npz"), device="cpu")


def test_predictor_swap_semantic_matches_jax(rng, tmp_path):
    """swap_semantic: fed JAX's own waypoint draws, the Predictor decodes
    mst_tpu's swapped make_predict_step trajectories, and lands well away
    from its unswapped decode of the same draws."""
    params = small_params(n_goal=3, swap_semantic=True)
    flat = io.params_to_numpy(init_ynet(torch.Generator().manual_seed(2),
                                        ynet_config(params))[0])
    np.savez(tmp_path / "ckpt.npz", **flat)
    jmcfg = jynet.YNetConfig(
        obs_len=8, pred_len=12, n_semantic_classes=3,
        encoder_channels=(8, 8, 16, 16, 16),
        decoder_channels=(16, 16, 16, 8, 8), waypoints=(11,))
    jscfg = jsteps.StepConfig(
        obs_len=8, pred_len=12, waypoints=(11,),
        template_size=step_config(params).template_size, kernlen=31,
        nsig=4.0, loss_scale=1000.0, resize_factor=0.25, temperature=1.0,
        n_goal=3, n_traj=1, packed_decode=False, swap_semantic=True)
    b = batch(rng, 8, 0)
    jout = jsteps.make_predict_step(jmcfg, jscfg)(
        io.unflatten(flat), {}, b["semantic"], b["traj"],
        jax.random.PRNGKey(1))
    decoded = {}
    for swap in (True, False):
        pred = Predictor(small_params(n_goal=3, swap_semantic=swap),
                         str(tmp_path / "ckpt.npz"), device="cpu")
        feats, _ = pred.forward(b["semantic"], b["traj"])
        decoded[swap] = pred.decode(feats, t(jout["waypoints"]) * 0.25)
    np.testing.assert_allclose(decoded[True].numpy(),
                               np.asarray(jout["trajectories"]), atol=4e-3)
    assert float((decoded[True] - decoded[False]).abs().max()) > 10 * 4e-3


@pytest.mark.parametrize("flag,over", [
    ("compute_dtype", dict(compute_dtype="bfloat16")),
    ("eth_world_coords", dict(dataset_name="eth", eth_world_coords=True)),
    ("use_features_only", dict(use_features_only=True,
                               segmentation_model_fp=__file__))])
def test_unported_flags_raise(tmp_path, flag, over):
    """A flag mst_tpu acts on and the port does not yet raises, naming
    itself, instead of being dropped. use_features_only with a backbone
    is ported: the model takes the backbone's 16 decoder channels, and a
    backbone file that exists but is no backbone npz (this test file)
    raises where it is loaded. So are eth_world_coords on eth: the eval
    step scores in world coordinates, and serving, which scores nothing,
    takes the flag. And compute_dtype bfloat16: the step config and a
    Predictor carry it, and a dtype mst_tpu does not name raises."""
    params = small_params(**over)
    if flag == "compute_dtype":
        assert step_config(params).compute_dtype == torch.bfloat16
        assert Predictor(params, device="cpu").scfg.compute_dtype == \
            torch.bfloat16
        with pytest.raises(ValueError, match=flag):
            step_config(dict(params, compute_dtype="float16"))
        return
    if flag == "eth_world_coords":
        assert step_config(params).world_coords
        assert not step_config(dict(params, dataset_name="sdd")).world_coords
        assert not step_config(dict(params, eth_world_coords=False)
                               ).world_coords
        assert Predictor(params, device="cpu").mcfg == ynet_config(params)
        return
    if flag == "use_features_only":
        assert ynet_config(params).n_semantic_classes == 16
        assert step_config(params).use_features_only
        with pytest.raises(ValueError, match="not a backbone npz"):
            Predictor(params, device="cpu")
        seg = tmp_path / "sdd_segmentation.npz"
        np.savez(seg, **io.params_to_numpy(unet.unet_init(
            torch.Generator().manual_seed(0), layers=(1, 1, 1, 1))))
        pred = Predictor(dict(params, segmentation_model_fp=str(seg)),
                         device="cpu")
        assert pred.mcfg.feature_channels == 16 + 8
        return
    for build in (ynet_config, step_config,
                  lambda p: Predictor(p, device="cpu")):
        with pytest.raises(NotImplementedError, match=flag):
            build(params)


@pytest.mark.parametrize("over", [
    dict(compute_dtype="float32"), dict(compute_dtype="f32"),
    dict(eth_world_coords=True), dict(use_features_only=True),
    dict(n_fusion=None), dict(n_fusion=2),
    dict(network="fusion", n_fusion=2), dict(network="embed")])
def test_flags_at_what_the_port_does_are_accepted(over):
    """float32, world coordinates outside eth, feature-only without a
    backbone, no n_fusion (or one the plain network ignores), the fusion
    and embed networks: what mst_tpu also does there."""
    params = small_params(**over)
    mcfg = ynet_config(params)
    assert mcfg.n_semantic_classes == 3
    assert (mcfg.network, mcfg.n_fusion) == (
        params["network"], params["n_fusion"])
    assert step_config(params).obs_len == 8
    assert Predictor(params, device="cpu").mcfg == mcfg


def test_step_config_for_validation():
    """for_validation turns TTST off and keeps CWS (trainer.py:314-317)."""
    params = small_params(use_TTST=True, use_CWS=True)
    scfg = step_config(params, for_validation=True)
    assert not scfg.use_ttst and scfg.use_cws
    assert step_config(params).use_ttst


def test_predictor_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(small_params())
    assert Predictor(small_params(), device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _import_targets(path):
    """Every module an import names, `from a import b` giving both a and
    a.b (b may be a submodule)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _module_level_imports(path):
    """The imports that run when the module is imported: those outside any
    function body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


PORT_FILES = sorted((REPO / "mst_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_mst_tpu():
    """An ast scan (a preloaded jax would fool a sys.modules check). Every
    kernel of the port is CUDA C++ built by nvcc, so triton is banned too.
    pandas and cv2 may be imported only inside a function (the pickle
    readers, load_images): the card's machine need not have them."""
    assert len(PORT_FILES) > 15
    for new in ("native/__init__.py", "data/trajectories.py", "data/sdd.py",
                "data/ind.py", "data/split_dataset.py",
                "data/filter_dataset.py", "data/generate_varf.py",
                "train/fused.py", "train/optim.py", "grid.py",
                "ops/kernels/launches.py", "loader.py"):
        assert REPO / "mst_tpu_torch" / new in PORT_FILES, new
    for path in PORT_FILES:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "mst_tpu", "optax",
                                "benchmarks", "triton"), \
                f"{os.path.relpath(path, REPO)} imports {name}"
        for name in _module_level_imports(path):
            assert name.split(".")[0] not in ("pandas", "cv2"), \
                f"{os.path.relpath(path, REPO)} imports {name} at module level"
    # the model directory's loader serves without the model code: it and
    # every port module it imports, at any depth, import none of
    # mst_tpu_torch.models, .train or .config, anywhere in the file, and
    # serve.py and serve_http.py import them only inside functions
    model_code = ("mst_tpu_torch.models", "mst_tpu_torch.train",
                  "mst_tpu_torch.config")
    seen, todo = set(), [REPO / "mst_tpu_torch" / "loader.py"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _import_targets(path):
            assert not name.startswith(model_code), \
                f"{os.path.relpath(path, REPO)} imports {name}"
            if name.startswith("mst_tpu_torch"):
                base = REPO / pathlib.Path(*name.split("."))
                todo += [p for p in (base.with_suffix(".py"),
                                     base / "__init__.py") if p.exists()]
    assert REPO / "mst_tpu_torch" / "ops" / "kernels" / \
        "fused_predict.py" in seen
    for path in ("serve.py", "serve_http.py"):
        for name in _module_level_imports(REPO / "mst_tpu_torch" / path):
            assert not name.startswith(model_code), f"{path} imports {name}"


def test_module_level_import_scan(tmp_path):
    """The scan finds imports at module level, under if/try too, and not
    those inside a function."""
    path = tmp_path / "m.py"
    path.write_text("import a\ntry:\n    from b import c\nexcept E:\n"
                    "    pass\ndef f():\n    import d\nclass K:\n"
                    "    import e\n")
    assert sorted(_module_level_imports(path)) == ["a", "b", "e"]


def test_scripts_sandbox_shims_run_the_port(tmp_path):
    """The suites' harness writes its shims at run time, out of the
    scan's sight: they import no jax or mst_tpu, the modules they run are
    the port's (mst_tpu_torch.train / .test), and the sandbox's python
    turns `-m mst_tpu.<x>` into mst_tpu_torch.<x>, in a process where
    jax and mst_tpu cannot be imported."""
    import re
    import subprocess
    import sys

    from mst_tpu_torch.utils import scripts_e2e

    paths = scripts_e2e.write_shims(tmp_path, "cpu")
    for name, path in paths.items():
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mst_tpu"), \
                f"{name} imports {mod}"
    for name, module in (("train.py", "mst_tpu_torch.train"),
                         ("test.py", "mst_tpu_torch.test")):
        text = paths[name].read_text()
        assert set(re.findall(r"'(mst_tpu\w*(?:\.\w+)*)'", text)) == \
            {module}, name
    env = scripts_e2e.suite_env(tmp_path)
    listed = subprocess.run(
        [str(paths["python"]), "-m", "mst_tpu.utils.scripts_e2e", "list"],
        env=env, capture_output=True, text=True, timeout=120)
    assert listed.returncode == 0, listed.stderr[-2000:]
    assert listed.stdout.split() == scripts_e2e.experiment_scripts()
    for mod in ("mst_tpu", "jax"):
        blocked = subprocess.run(
            [str(paths["python"]), "-c", f"import {mod}"], env=env,
            capture_output=True, text=True, timeout=60)
        assert blocked.returncode != 0
        assert "may not be imported" in blocked.stderr
    assert sys.executable in paths["python"].read_text().splitlines()[0]
