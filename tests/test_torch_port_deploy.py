"""The deployment path against mst_tpu on the CPU in f32: the model
directory (export_model), LoadedModel with its LRU of styles and the
style overlay's strictness, Predictor's state=, and the export|check CLI.

Both packages export the same weights (the port's init carried across by
io, every zero-init leaf made nonzero and the batch-norm statistics moved,
as in test_torch_port_variants). mst_tpu's Experiment gets them through
its own constructor with init_ynet replaced, JAX's eager init being slow
on the CPU; it exports for the CPU only.
"""

import ast
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mst_tpu import config as jconfig
from mst_tpu import serve as jserve
from mst_tpu.models import ynet as jynet
from mst_tpu.train import steps as jsteps
from mst_tpu.train.trainer import Experiment as JExperiment
from mst_tpu_torch import io, serve
from mst_tpu_torch.config import get_params, ynet_config
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.serve import LoadedModel, Predictor
from mst_tpu_torch.train.trainer import Experiment
from tests.test_torch_port_variants import jax_configs, nonzero

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W, B = 64, 96, 4
MODEL_PX_TOL = 1e-4  # trajectories against mst_tpu's predict step
OVERRIDES = dict(encoder_channels=[8, 8, 16, 16, 16],
                 decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
                 n_goal=5, use_TTST=True, seed=1)
MODELS = {"serial": dict(train_net="serial", position=["1", "2"]),
          "mosa_2": dict(train_net="mosa_2", position=["0", "1", "2", "3",
                                                        "4"])}


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def model_params(name):
    return {**OVERRIDES, **MODELS[name]}


def strong(flat, st, rng):
    """nonzero()'s weights and state, the serial adapters' convs scaled up
    and their statistics moved further, so that the state moves the
    served trajectories well past the parity tolerance."""
    flat = {k: v * 10 if "serial_layer/conv" in k else v
            for k, v in flat.items()}
    st = dict(st)
    for k, v in st.items():
        if k.endswith("running_mean"):
            st[k] = rng.normal(scale=2.0, size=v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            st[k] = rng.uniform(0.05, 0.5, size=v.shape).astype(np.float32)
    return flat, st


def inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, H, W, 3)).astype(np.float32),
            rng.uniform(10, 50, size=(B, 8, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{model name: dict(flat, state, params, port dir, mst_tpu dir)}: one
    export of the same nonzero weights by each package."""
    tmp = tmp_path_factory.mktemp("deploy")
    rng = np.random.default_rng(0)
    out = {}
    for name in MODELS:
        over = model_params(name)
        params = get_params("sdd_shortterm_eval.yaml", over)
        flat, st = strong(*nonzero(rng, *init_ynet(
            torch.Generator().manual_seed(0), ynet_config(params))), rng)
        exp = Experiment(params, device="cpu")
        exp.model_params = io.params_from_numpy(flat)
        exp.model_state = io.state_from_numpy(st)
        serve.export_model(exp, tmp / name / "port", H, W, B)
        trees = (jax.tree.map(jnp.asarray, io.unflatten(flat)),
                 jax.tree.map(jnp.asarray, io.unflatten(st)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jynet, "init_ynet", lambda key, cfg: trees)
            jexp = JExperiment(jconfig.get_params(
                config_filename="sdd_shortterm_eval.yaml", overrides=over))
        jserve.export_model(jexp, tmp / name / "jax", H, W, B,
                            platforms=("cpu",))
        out[name] = dict(flat=flat, state=st, params=params,
                         port=tmp / name / "port", jax=tmp / name / "jax",
                         trees=trees)
    warm_up()
    return out


def warm_up():
    """One predict before any compared one: on a multithreaded CPU the
    process's first forward has been seen to differ in the last bits from
    every later one (3e-5 in the features, 1e-3 px after k-means; never
    with one thread), which the exact comparisons below would catch."""
    pred = Predictor(get_params("sdd_shortterm_eval.yaml", model_params(
        "mosa_2")), device="cpu")
    pred.predict(*inputs(0))


FIRST_FORWARD = """
import json, sys
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
from mst_tpu_torch.config import get_params
from mst_tpu_torch.serve import Predictor
jnp.ones(3).block_until_ready()
H, W, B = json.loads(sys.argv[3])
pred = Predictor(get_params("sdd_shortterm_eval.yaml", json.loads(
    sys.argv[2])), device="cpu")
rng = np.random.default_rng(0)
semantic = rng.normal(size=(1, H, W, 3)).astype(np.float32)
observed = rng.uniform(10, 50, size=(B, 8, 2)).astype(np.float32)
(f1, wps), (f2, _) = (pred.forward(semantic, observed, seed=3)
                      for _ in range(2))
d1, d2 = pred.decode(f1, wps), pred.decode(f2, wps)
print(json.dumps({
    "features": max(float((a - b).abs().max()) for a, b in zip(f1, f2)),
    "model_px": float((d1 - d2).abs().max()) * pred.scfg.resize_factor}))
"""


def test_first_forward_differs_only_in_the_last_bits():
    """What warm_up steps around, held to a bound: in fresh processes
    (JAX imported, as here), the first forward's features differ from the
    second's by at most 1e-4 and its decode by at most MODEL_PX_TOL, the
    parity tests' tolerances. (Seen in about 1 fresh process of 5: 4.3e-5
    in the first encoder stage's features, with or without oneDNN and
    with MKL_DYNAMIC off; never with one thread.)"""
    import subprocess

    argv = [sys.executable, "-c", FIRST_FORWARD, str(REPO),
            json.dumps(model_params("mosa_2")), json.dumps([H, W, B])]
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        got = json.loads(out.strip().splitlines()[-1])
        assert got["features"] <= 1e-4, got
        assert got["model_px"] <= MODEL_PX_TOL, got


def read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# (a) the model directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_export_writes_mst_tpus_params_and_state(exports, name):
    """params.npz and state.npz: the same keys, dtypes and values, exactly,
    as mst_tpu's export of the same weights; the manifests agree on every
    field both have, but the format and the programs' files."""
    e = exports[name]
    for f in ("params.npz", "state.npz"):
        got, want = read_npz(e["port"] / f), read_npz(e["jax"] / f)
        assert got.keys() == want.keys(), f
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert bool(read_npz(e["port"] / "state.npz")) == (name == "serial")
    got = json.loads((e["port"] / "manifest.json").read_text())
    want = json.loads((e["jax"] / "manifest.json").read_text())
    assert got["format"] == serve.FORMAT
    assert want.keys() - got.keys() == set()
    assert got.keys() - want.keys() == {"config", "torch_version"}
    for k in want.keys() - {"format", "files"}:
        assert got[k] == want[k], k
    assert got["files"] == {**{k: want["files"][k] for k in ("params",
                                                             "state")},
                            "forward": "forward.pt2", "decode": "decode.pt2"}
    assert want["files"].keys() == got["files"].keys()
    assert got["config"] == json.loads(json.dumps(e["params"]))


def test_export_refuses_what_it_cannot_serve(exports, tmp_path):
    exp = Experiment(exports["mosa_2"]["params"], device="cpu")
    with pytest.raises(ValueError, match="multiples"):
        serve.export_model(exp, tmp_path / "bad", 60, W, B)
    # segment_in_step is ported: the input is the raw 3-channel scene
    # (here the identity backbone's), the backbone runs in the step
    manifest = serve.export_model(exp, tmp_path / "seg", H, W, B,
                                  segment_in_step=True)
    assert manifest["segment_in_step"] and \
        manifest["semantic_shape"] == [1, H, W, 3]
    assert LoadedModel(tmp_path / "seg",
                       device="cpu").manifest["segment_in_step"]
    with pytest.raises(ValueError, match="not a backbone npz"):
        Experiment(dict(exports["mosa_2"]["params"],
                        segmentation_model_fp=__file__), device="cpu")
    with pytest.raises(ValueError, match="mst_tpu_torch.serve"):
        LoadedModel(exports["mosa_2"]["jax"], device="cpu")


# ---------------------------------------------------------------------------
# (b) LoadedModel against Predictor and against mst_tpu's predict step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_loaded_model_equals_predictor(exports, name):
    """The model directory serves what a Predictor given the same weights
    and state serves, seed for seed, TTST on; and it holds its state."""
    e = exports[name]
    loaded = LoadedModel(e["port"], device="cpu")
    pred = Predictor(e["params"], e["port"] / "params.npz", device="cpu",
                     seed=5, state=e["port"] / "state.npz")
    assert loaded.manifest["observed_shape"] == [B, 8, 2]
    st = io.state_to_numpy(loaded.state)
    assert st.keys() == e["state"].keys()
    for k, v in e["state"].items():
        assert st[k].dtype == v.dtype
        np.testing.assert_array_equal(st[k], v)
    semantic, observed = inputs(1)
    got = loaded.predict(semantic, observed, seed=3)
    want = pred.predict(semantic, observed, seed=3)
    for k in ("trajectories", "waypoints"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["trajectories"].shape == (5, B, 12, 2)
    lazy = loaded.predict(semantic, observed, seed=3, block=False)
    assert isinstance(lazy["trajectories"], torch.Tensor)
    np.testing.assert_array_equal(lazy["trajectories"].numpy(),
                                  got["trajectories"])


def test_loaded_model_needs_every_adapter_leaf(exports, tmp_path):
    """A model directory whose params.npz lacks one adapter leaf is
    refused, as mst_tpu's exported program, which takes every parameter,
    refuses it; a Predictor given the same file as a checkpoint keeps
    the init's leaf (a base trained without adapters)."""
    import shutil

    from mst_tpu_torch.models.ynet import is_adapter_leaf

    e = exports["mosa_2"]
    d = tmp_path / "model"
    shutil.copytree(e["port"], d)
    flat = read_npz(d / "params.npz")
    gone = next(k for k in sorted(flat) if k.endswith("lora_B"))
    assert is_adapter_leaf(gone)
    del flat[gone]
    np.savez(d / "params.npz", **flat)
    with pytest.raises(KeyError, match="lacks 1 parameters"):
        LoadedModel(d, device="cpu")
    pred = Predictor(e["params"], d / "params.npz", device="cpu")
    assert not io.flatten(pred.params)[gone].any()


def test_predict_draws_from_the_generator_given(exports):
    """predict(generator=) draws from that generator: one seeded with s
    gives what seed=s gives, and another seed other samples."""
    loaded = LoadedModel(exports["mosa_2"]["port"], device="cpu")
    semantic, observed = inputs(5)
    want = loaded.predict(semantic, observed, seed=7)
    got = loaded.predict(semantic, observed,
                         generator=torch.Generator().manual_seed(7))
    other = loaded.predict(semantic, observed,
                           generator=torch.Generator().manual_seed(8))
    for k in ("trajectories", "waypoints"):
        np.testing.assert_array_equal(got[k], want[k])
    assert np.abs(other["waypoints"] - want["waypoints"]).max() > 1e-3


def test_loaded_weights_are_contiguous(exports):
    """A model directory's conv weights load as contiguous OIHW tensors,
    as init_ynet makes them: torch.tensor keeps the strides of the
    transposed numpy view, which left them HWIO-ordered in memory."""
    loaded = LoadedModel(exports["serial"]["port"], device="cpu")
    leaves = io.flatten(loaded.params)
    assert sum(v.dim() == 4 for v in leaves.values()) > 10
    assert all(v.is_contiguous() for v in leaves.values())


def test_loaded_serial_matches_mst_tpu_predict_step(exports):
    """A serial model (BN statistics moved) served from its model
    directory: fed the waypoints mst_tpu's make_predict_step drew, the
    port's features and trajectories match mst_tpu's within 1e-4 model
    px; served with the init statistics instead, they do not."""
    e = exports["serial"]
    loaded = LoadedModel(e["port"], device="cpu")
    jmcfg, jscfg = jax_configs(e["params"])
    semantic, observed = inputs(2)
    jstep = jsteps.make_predict_step(jmcfg, jscfg)
    key = jax.random.PRNGKey(4)
    jout = jstep(*e["trees"], semantic, observed, key)
    jfeats, _ = jstep.forward(*e["trees"], semantic, observed, key)
    rf = loaded.manifest["resize_factor"]
    wps = t(jout["waypoints"]) * rf
    feats, _ = loaded.forward(semantic, observed)
    for a, f in zip(feats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(f), rtol=1e-4,
                                   atol=1e-4)
    got = loaded.decode(feats, wps).numpy()
    err = np.abs(got - np.asarray(jout["trajectories"])).max() * rf
    assert err <= MODEL_PX_TOL, err
    init = Predictor(e["params"], e["port"] / "params.npz", device="cpu",
                     state=_init_state(e))
    init_feats, _ = init.forward(semantic, observed)
    moved = np.abs(init.decode(init_feats, wps).numpy() - got).max() * rf
    assert moved > 10 * MODEL_PX_TOL, moved


def _init_state(e):
    path = e["port"].parent / "init_state.npz"
    np.savez(path, **io.state_to_numpy(init_ynet(
        torch.Generator().manual_seed(0), ynet_config(e["params"]))[1]))
    return path


# ---------------------------------------------------------------------------
# (c) styles: the LRU and the overlay's strictness, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deltas(exports, tmp_path_factory):
    """Delta npz files of the serial model: its adapter leaves moved, and
    three deltas both packages must refuse."""
    tmp = tmp_path_factory.mktemp("deltas")
    flat = exports["serial"]["flat"]
    keys = [k for k in flat if "serial_layer" in k and "conv" in k]
    good = {k: flat[k] + np.float32(0.05) for k in keys}
    bad = {"dtype": {**good, keys[0]: good[keys[0]].astype(np.float64)},
           "shape": {**good, keys[0]: good[keys[0]][..., :1]},
           "key": {**good, "encoder/nowhere/weight": good[keys[0]]}}
    paths = {}
    for name, arrays in [("good", good), *bad.items()]:
        paths[name] = str(tmp / f"{name}.npz")
        np.savez(paths[name], **arrays)
    return paths, keys


def test_style_lru_matches_mst_tpu(exports, deltas):
    """One scripted sequence of add_style and predict(style=) under
    max_styles = 2: the same evicted names and resident styles in both
    packages' LoadedModel; an evicted style is unknown in both; and a
    style shares every tensor of the base but its delta's."""
    paths, keys = deltas
    e = exports["serial"]
    models = {"port": LoadedModel(e["port"], device="cpu"),
              "jax": jserve.load_model(e["jax"])}
    semantic, observed = inputs(3)
    script = [("add", "a"), ("add", "b"), ("use", "a"), ("add", "c"),
              ("use", "c"), ("add", "d"), ("add", "a"), ("use", "d"),
              ("add", "b")]
    logs = {}
    for pkg, m in models.items():
        m.max_styles = 2
        log = []
        for op, name in script:
            if op == "add":
                log.append((name, m.add_style(name, paths["good"]),
                            m.styles))
            else:
                m.predict(semantic, observed, style=name)
                log.append((name, m.styles))
        with pytest.raises(ValueError, match="unknown serving style"):
            m.predict(semantic, observed, style="c")
        logs[pkg] = log
    assert logs["port"] == logs["jax"]
    assert [x[1] for x in logs["port"] if len(x) == 3] == [
        [], [], ["b"], ["a"], ["c"], ["a"]]
    port = models["port"]
    base = io.flatten(port.params)
    style = io.flatten(port._styles["b"])
    shared = [k for k in base if style[k] is base[k]]
    assert sorted(base.keys() - set(shared)) == sorted(keys)
    port.max_styles = 0
    assert port.add_style("x", paths["good"]) == []
    assert port.add_style("y", paths["good"]) == []
    assert port.styles == ["b", "d", "x", "y"]


@pytest.mark.parametrize("bad, error", [("dtype", ValueError),
                                        ("shape", ValueError),
                                        ("key", KeyError)])
def test_both_packages_refuse_a_mismatched_delta(exports, deltas, bad,
                                                 error):
    """mst_tpu's serving overlay refuses a delta leaf of another dtype,
    shape or name (serve.py:67-101); so does the port, with the same error
    type, for LoadedModel and Predictor alike, and registers nothing. An
    f64 leaf is refused on the npz's own dtype, before any cast."""
    paths, _ = deltas
    e = exports["serial"]
    jmodel = jserve.load_model(e["jax"])
    with pytest.raises(error):
        jmodel.add_style("bad", paths[bad])
    pred = Predictor(e["params"], e["port"] / "params.npz", device="cpu",
                     state=e["port"] / "state.npz")
    for m in (LoadedModel(e["port"], device="cpu"), pred):
        with pytest.raises(error):
            m.add_style("bad", paths[bad])
        assert m.styles == [] and jmodel.styles == []


# ---------------------------------------------------------------------------
# (d) Predictor's state=
# ---------------------------------------------------------------------------

def test_predictor_state_lifts_the_refusal(exports, deltas, tmp_path):
    """With its state a serial Predictor takes a checkpoint and a style;
    without one both stay refused. A state file must hold every leaf of
    the model state, with its dtype."""
    paths, _ = deltas
    e = exports["serial"]
    ckpt, state = e["port"] / "params.npz", e["port"] / "state.npz"
    with pytest.raises(NotImplementedError, match="running statistics"):
        Predictor(e["params"], ckpt, device="cpu")
    with pytest.raises(NotImplementedError, match="a style"):
        Predictor(e["params"], device="cpu").add_style("s", paths["good"])
    pred = Predictor(e["params"], ckpt, device="cpu", state=state)
    assert pred.add_style("s", paths["good"]) == [] and pred.styles == ["s"]
    semantic, observed = inputs(4)
    base = pred.predict(semantic, observed, seed=1)["trajectories"]
    styled = pred.predict(semantic, observed, seed=1,
                          style="s")["trajectories"]
    assert np.isfinite(styled).all()
    assert np.abs(styled - base).max() > 1e-3
    st = dict(e["state"])
    k = next(k for k in st if k.endswith("num_batches"))
    np.savez(tmp_path / "wide.npz", **{**st, k: st[k].astype(np.int64)})
    with pytest.raises(ValueError, match="dtype"):
        Predictor(e["params"], ckpt, device="cpu", state=tmp_path / "wide.npz")
    del st[k]
    np.savez(tmp_path / "short.npz", **st)
    with pytest.raises(KeyError, match="lacks 1 leaves"):
        Predictor(e["params"], ckpt, device="cpu",
                  state=tmp_path / "short.npz")


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

def _mst_tpu_bench_keys():
    """The keys of the JSON line mst_tpu's `check --bench` prints (the dict
    literal assigned to `stats` in mst_tpu/serve.py)."""
    tree = ast.parse((REPO / "mst_tpu" / "serve.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "stats"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no stats dict in mst_tpu/serve.py")


def test_cli_export_and_check(exports, tmp_path, monkeypatch, capsys):
    """python -m mst_tpu_torch.serve export, then check --bench 2, with
    --device cpu: the export restores the checkpoint, and check prints
    mst_tpu's JSON line, with its keys."""
    import yaml

    e = exports["mosa_2"]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(e["params"]))
    np.savez(tmp_path / "ckpt.npz", **e["flat"])
    out_dir = tmp_path / "model"

    def run(*argv):
        monkeypatch.setattr(sys, "argv", ["serve", *argv, "--device", "cpu"])
        serve._main()
        return capsys.readouterr().out

    out = run("export", "--config_filename", str(cfg), "--pretrained_ckpt",
              str(tmp_path / "ckpt.npz"), "--out_dir", str(out_dir),
              "--height", str(H), "--width", str(W), "--batch_size", str(B))
    assert "exported to" in out
    got = read_npz(out_dir / "params.npz")
    for k, v in e["flat"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    out = run("check", "--model_dir", str(out_dir), "--bench", "2")
    assert "predict ok" in out
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats.keys() == _mst_tpu_bench_keys()
    assert stats["metric"] == "serving_latency_ms" and stats["batch"] == B
    assert stats["p50"] > 0 and stats["pipelined_traj_per_sec"] > 0


def test_cli_needs_a_card_unless_told(exports, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["serve", "check", "--model_dir",
                                      str(exports["mosa_2"]["port"])])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve._main()
