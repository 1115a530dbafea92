"""The serialized program on the CPU at small width (encoder 8,8,16,16,16,
B = 2 at 64 x 96, n_goal 5, TTST on, mosa_2, torch on two intra-op
threads): a model directory's forward.pt2 and decode.pt2
(serve.export_model, loader.LoadedModel) against the eager predict step
with the same key, bit for bit, with a style, and in a process that
cannot import the port's model code; and the directories the loader
refuses. The draws and k-means are in test_torch_port_keys.py, the
programs against mst_tpu's forward.jaxir and decode.jaxir in
test_torch_port_export_jax.py, the bf16 and Y-Net-Mod directories in
test_torch_port_export_variants.py and the segment_in_step one in
test_torch_port_export_backbone.py.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mst_tpu_torch import io, loader, serve
from mst_tpu_torch.config import get_params, step_config, ynet_config
from mst_tpu_torch.ops.sampling import key_from_seed
from mst_tpu_torch.train.steps import make_predict_step
from mst_tpu_torch.train.trainer import Experiment

REPO = pathlib.Path(__file__).resolve().parents[1]
H, W, B = 64, 96, 2
SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=3,
             n_goal=5, use_TTST=True, seed=0, train_net="mosa_2",
             position=["0", "1", "2", "3", "4"])


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the model directory's programs
# ---------------------------------------------------------------------------

def inputs(seed, obs_len=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, H, W, 3)).astype(np.float32),
            rng.uniform(10, 50, size=(B, obs_len, 2)).astype(np.float32))


def export(tmp, name, config="sdd_shortterm_eval.yaml",
           segment_in_step=False, **over):
    """An Experiment of SMALL (+ over) with every lora_B leaf moved off
    zero, exported to tmp/name; a style delta beside it. -> (params,
    directory, style path, segment_in_step)."""
    params = get_params(config, {**SMALL, **over})
    exp = Experiment(params, device="cpu")
    rng = np.random.default_rng(1)
    flat = io.params_to_numpy(exp.model_params)
    lora = [k for k in flat if k.endswith("lora_B")]
    for k in lora:
        flat[k] = rng.normal(scale=0.05, size=flat[k].shape).astype(
            np.float32)
    exp.model_params = io.params_from_numpy(flat)
    d = tmp / name
    serve.export_model(exp, d, H, W, B, segment_in_step=segment_in_step)
    style = tmp / f"{name}_style.npz"
    np.savez(style, **{k: rng.normal(scale=0.05, size=flat[k].shape).astype(
        np.float32) for k in lora})
    return params, d, style, segment_in_step


@pytest.fixture(scope="module")
def directories(tmp_path_factory):
    return {"f32": export(tmp_path_factory.mktemp("programs"), "f32")}


def programs_equal_the_eager_step(params, d, style, segment_in_step):
    """forward.pt2 and decode.pt2 against the eager predict step on the
    same weights, inputs and key, bit for bit; LoadedModel against a
    Predictor of params.npz, seed for seed, key for key and with a
    style, bit for bit. The manifest names the programs, the format and
    the torch that wrote them."""
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["format"] == loader.FORMAT == "mst_tpu_torch.serve/2"
    assert manifest["files"] == {"forward": "forward.pt2",
                                 "decode": "decode.pt2",
                                 "params": "params.npz",
                                 "state": "state.npz"}
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert manifest["compute_dtype"] == params["compute_dtype"]
    assert manifest["segment_in_step"] == segment_in_step
    obs_len = params["obs_len"]
    semantic, observed = (torch.tensor(a) for a in inputs(0, obs_len))
    loaded = serve.LoadedModel(d, device="cpu")
    weights = io.params_from_numpy(io.load_checkpoint(d / "params.npz"))
    step = make_predict_step(ynet_config(params), step_config(
        params, segment_in_step=segment_in_step))
    # the programs as loaded (torch.export.load, .module())
    forward, decode = loaded._forward, loaded._decode
    for seed in (0, 7):
        key = key_from_seed(seed)
        feats, wps = forward(weights, {}, semantic, observed, key)
        want_feats, want_wps = step.forward(weights, {}, semantic, observed,
                                            key)
        assert len(feats) == len(want_feats)
        for a, b in zip(feats, want_feats):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(wps, want_wps)
        assert torch.equal(decode(weights, feats, wps),
                           step.decode_trajs(weights, feats, wps))

    pred = serve.Predictor(params, d / "params.npz", device="cpu",
                           segment_in_step=segment_in_step)
    loaded.add_style("s", style)
    pred.add_style("s", style)
    semantic, observed = inputs(1, obs_len)
    served = {}
    for name, kw in (("seed", dict(seed=3)), ("key", dict(key=[12, 34])),
                     ("style", dict(seed=3, style="s")),
                     ("generator", dict(generator=3))):
        got, want = (m.predict(semantic, observed, **(
            dict(generator=torch.Generator().manual_seed(3))
            if name == "generator" else kw)) for m in (loaded, pred))
        for k in ("trajectories", "waypoints"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)
        served[name] = got["trajectories"]
    np.testing.assert_array_equal(served["generator"], served["seed"])
    assert np.abs(served["style"] - served["seed"]).max() > 1e-3


def test_programs_equal_the_eager_step(directories):
    programs_equal_the_eager_step(*directories["f32"])


BLOCKED_SERVE = """
import json, sys
BLOCKED = ("mst_tpu_torch.models", "mst_tpu_torch.train",
           "mst_tpu_torch.config")
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(2)
from mst_tpu_torch.loader import LoadedModel
from mst_tpu_torch.ops.kernels.fused_predict import \\
    fused_predictor_softargmax as fused
from mst_tpu_torch.ops.kernels.softargmax_rows import \\
    softargmax2d_rows as rows
model = LoadedModel(sys.argv[2], device="cpu")
model.add_style("s", sys.argv[3])
with np.load(sys.argv[4]) as z:
    semantic, observed = z["semantic"], z["observed"]
out = {}
for i, style in enumerate((None, "s")):
    for k, v in model.predict(semantic, observed, seed=3,
                              style=style).items():
        out[f"{i}/{k}"] = v
np.savez(sys.argv[5], **out)
try:
    import mst_tpu_torch.models.ynet
    blocked = False
except ImportError:
    blocked = True
print(json.dumps({"blocked": blocked, "leaked": sorted(
    m for m in sys.modules if m.startswith(tuple(b + "." for b in BLOCKED))
    and sys.modules[m] is not None)}))
"""


def test_directory_serves_without_the_model_code(directories, tmp_path):
    """A process in which mst_tpu_torch.models, .train and .config cannot
    be imported loads the directory, registers a style and answers what
    this process's LoadedModel answers, bit for bit."""
    params, d, style, _ = directories["f32"]
    semantic, observed = inputs(2)
    np.savez(tmp_path / "inputs.npz", semantic=semantic, observed=observed)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_SERVE, str(REPO), str(d), str(style),
         str(tmp_path / "inputs.npz"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"blocked": True, "leaked": []}
    loaded = serve.LoadedModel(d, device="cpu")
    loaded.add_style("s", style)
    with np.load(tmp_path / "out.npz") as served:
        for i, s in enumerate((None, "s")):
            want = loaded.predict(semantic, observed, seed=3, style=s)
            for k, v in want.items():
                np.testing.assert_array_equal(served[f"{i}/{k}"], v)


def _edit(d, **fields):
    manifest = json.loads((d / "manifest.json").read_text())
    manifest.update(fields)
    (d / "manifest.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("case, error, match", [
    ("format 1", ValueError, "mst_tpu_torch.serve/1"),
    ("mst_tpu", ValueError, "mst_tpu.serve/1"),
    ("exported for the card", ValueError, r"exported for \['cuda'\]"),
    ("another torch", ValueError, "written by torch 0.0"),
    ("a broken program", Exception, None),
])
def test_the_loader_refuses(directories, tmp_path, case, error, match):
    """A directory of format /1 (weights and a config, no program), one
    of mst_tpu's, one exported for another device, one written by another
    torch, or one whose program does not load: each raises, with its
    reason, and nothing falls back to rebuilding the model."""
    d = tmp_path / "model"
    shutil.copytree(directories["f32"][1], d)
    if case == "format 1":
        _edit(d, format="mst_tpu_torch.serve/1",
              files={"params": "params.npz", "state": "state.npz"})
        (d / "forward.pt2").unlink()
        (d / "decode.pt2").unlink()
    elif case == "mst_tpu":
        _edit(d, format="mst_tpu.serve/1")
    elif case == "exported for the card":
        _edit(d, platforms=["cuda"])
    elif case == "another torch":
        _edit(d, torch_version="0.0")
    else:
        (d / "forward.pt2").write_bytes(b"not a program")
    with pytest.raises(error, match=match):
        serve.LoadedModel(d, device="cpu")
