"""bf16 compute (--compute_dtype bfloat16) and --remat against mst_tpu on
the CPU.

Both kernels' plain versions and work splits on bf16 operands against the
Pallas kernels in interpret mode on the same bf16 operands (1e-4 px). The
model, the eval and predict decode and the train step in bf16 against
mst_tpu's bf16 (unpacked): the dtype at every boundary equal, and each
output of the port within twice mst_tpu's own distance between its bf16
and f32 runs (bf16 rounds at other places in XLA's and PyTorch's CPU
kernels, so the port cannot sit closer to mst_tpu's bf16 than bf16 sits
to f32; the bar is mst_tpu's alone, so a port that rounds in the wrong
place cannot widen it); ADE/FDE on the same injected
waypoint draws within mst_tpu's own bar (rtol 0.02, tests/test_bf16.py);
trainable leaves, gradients and Adam's moments f32. remat gives the same
loss and gradients bit for bit. The serial adapters' batch norm keeps
mst_tpu's dtypes (bf16 out in train mode, f32 against its f32 running
statistics in eval mode), so their eval raises in bf16 in both packages.
The model is 2 stages deep: mst_tpu's train steps compile in a few
seconds each on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mst_tpu.models import ynet as jynet
from mst_tpu.ops import packed as jpacked
from mst_tpu.ops.pallas.fused_predict import fused_predictor_softargmax
from mst_tpu.ops.pallas.softargmax import softargmax2d_pallas
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import io, serve
from mst_tpu_torch.config import (get_params, parse_compute_dtype,
                                  step_config, ynet_config)
from mst_tpu_torch.evaluator.metrics import ade_fde_per_sample
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.ops.kernels import fused_predict as tfused
from mst_tpu_torch.ops.kernels import softargmax_rows as trows
from mst_tpu_torch.train import steps, trainer

H, W, B = 64, 96, 4
SMALL = dict(encoder_channels=[8, 16],
             decoder_channels=[16, 8], n_semantic_classes=3,
             waypoints=[5, 11])
POSITIONS = ["0", "1"]
KERNEL_TOL = 1e-4  # px, the kernels' bf16 splits against the Pallas kernels
BF16_BAR = 2.0  # the port's distance from mst_tpu's bf16, over mst_tpu's
# own bf16-to-f32 distance
ADE_RTOL = 0.02  # tests/test_bf16.py:83
BF = torch.bfloat16

torch.set_num_threads(2)


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def bf16_numpy(rng, shape, scale=1.0):
    """Normals rounded to bf16, as f32 numpy (both packages cast them)."""
    return t(rng.normal(size=shape) * scale, BF).float().numpy()


# ---------------------------------------------------------------------------
# the kernels' plain versions and splits on bf16 operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,H,W,C,P,sms", [
    (2, 32, 48, 32, 12, 3),   # stages of 1024 bf16 pixels, rows split
    (2, 16, 24, 6, 5, 5),     # C = 6: the scalar path
    (3, 16, 24, 32, 30, 4),   # P = 30: four groups of 8, 4 pixels a thread
])
def test_fused_bf16_matches_pallas(rng, R, H, W, C, P, sms):
    """The fused kernel's split and merge on bf16 x and weight (its stages
    of bf16 pixels), and its plain version, against the TPU kernel on the
    same bf16 operands, space-to-depth packed, within 1e-4 px."""
    x = np.maximum(bf16_numpy(rng, (R, H, W, C)), 0)
    w = bf16_numpy(rng, (1, 1, C, P), 0.3)
    b = rng.normal(size=(P,)).astype(np.float32)
    want = np.asarray(fused_predictor_softargmax(
        jpacked.space_to_depth(jnp.asarray(x, jnp.bfloat16)),
        jpacked.pack_conv1x1_kernel(jnp.asarray(w, jnp.bfloat16)),
        jpacked.pack_bias(jnp.asarray(b)), P, interpret=True))
    xb, wb = t(x, BF), t(w[0, 0], BF)
    blocks = tfused.fused_blocks(R, H * W, sms)
    assert tfused.stage_pixels(32, 2) == 2 * tfused.stage_pixels(32) == 1024
    got = tfused.fused_split_reference(xb, wb, t(b), blocks)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL)
    plain = tfused.fused_predictor_softargmax(xb, wb, t(b, BF))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=KERNEL_TOL)
    assert plain.dtype == torch.float32


@pytest.mark.parametrize("HW", [1, 5, 37 * 53, 352 * 480])
def test_row_split_covers_each_logit_once_bf16(HW):
    """At 8 bf16 logits a 16-byte vector and every alignment of the row
    start, the head, the ranks' slices and the tail cover the row once."""
    for lead in range(8):
        count = np.zeros(HW, np.int32)
        for rank in range(trows.CLUSTER):
            head, h0, h1, v0, v1 = trows.row_split(HW, lead, trows.CLUSTER,
                                                   rank, 8)
            assert (lead + head) % 8 == 0 or head == HW
            count[h0:h1] += 1
            count[head + 8 * v0:head + 8 * v1] += 1
        np.testing.assert_array_equal(count, 1)
    assert trows.vec_width(BF) == 8 and trows.vec_width(torch.float32) == 4


@pytest.mark.parametrize("shape,lead", [((8, 32, 32), 0), ((3, 32, 32), 3),
                                        ((3, 37, 53), 5), ((5, 3, 5), 7)],
                         ids=["rows", "unaligned_rows", "hw_mod_8",
                              "tiny_rows"])
def test_rows_bf16_matches_pallas(rng, shape, lead):
    """The rows kernel's split and merge on bf16 logits (rows starting
    `lead` bf16 elements past 16 bytes), and its plain version, against
    the TPU kernel, which widens them, within 1e-4 px. Where H*W is no
    multiple of the TPU kernel's 1024-column block, mst_tpu's wrapper
    falls back to XLA on the logits as given, so it gets the widened
    values there, which is what its kernel would read."""
    x = bf16_numpy(rng, shape, 4.0)
    tiles = shape[1] * shape[2] % 1024 == 0
    want = np.asarray(softargmax2d_pallas(
        jnp.asarray(x, jnp.bfloat16 if tiles else jnp.float32),
        interpret=True))
    got = trows.rows_split_reference(t(x, BF), lead)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL)
    plain = trows.softargmax2d_rows(t(x, BF))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=KERNEL_TOL)


# ---------------------------------------------------------------------------
# the model and the steps in bf16 against mst_tpu's
# ---------------------------------------------------------------------------

def model_params(train_net="mosa_2", **over):
    position = POSITIONS if "mosa" in train_net else (
        ["0", "1"] if train_net in ("serial", "parallel_1x1") else [])
    return get_params("sdd_shortterm_train.yaml", {
        **SMALL, "train_net": train_net, "position": position, "lr": 1e-3,
        **over})


def jax_configs(params, dtype):
    mcfg, scfg = ynet_config(params), step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=mcfg.obs_len, pred_len=mcfg.pred_len,
        n_semantic_classes=mcfg.n_semantic_classes,
        encoder_channels=mcfg.encoder_channels,
        decoder_channels=mcfg.decoder_channels, waypoints=mcfg.waypoints,
        train_net=mcfg.train_net, position=mcfg.position,
        network=mcfg.network, n_fusion=mcfg.n_fusion)
    jscfg = jsteps.StepConfig(
        obs_len=scfg.obs_len, pred_len=scfg.pred_len,
        waypoints=scfg.waypoints, template_size=scfg.template_size,
        kernlen=scfg.kernlen, nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False,
        compute_dtype=dtype)
    return jmcfg, jscfg


def init(params, seed=0):
    """Weights with every LoRA and adapter leaf moved off zero, so no
    gradient or output is vacuous, and their JAX trees."""
    weights, state = ynet_lib.init_ynet(torch.Generator().manual_seed(seed),
                                        ynet_config(params))
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in io.flatten(weights).items():
        if ynet_lib.is_adapter_leaf(k) and k.endswith(("lora_B", "weight")):
            v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    flat = io.params_to_numpy(weights)
    jtrees = (io.unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
              io.unflatten({k: jnp.asarray(v) for k, v in
                            io.state_to_numpy(state).items()}))
    return weights, state, jtrees


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
            "traj": rng.uniform(5, 60, size=(B, 20, 2)).astype(np.float32),
            "mask": np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)}


def dist(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def assert_bar(port, jax_, what):
    """port / jax_: {'float32': output, 'bfloat16': output} of one output
    -> the port's bf16 within BF16_BAR x mst_tpu's own bf16-to-f32
    distance of mst_tpu's bf16; returns (that distance, mst_tpu's own)."""
    cross = dist(port["bfloat16"], jax_["bfloat16"])
    own = dist(jax_["bfloat16"], jax_["float32"])
    print(f"{what}: port to mst_tpu {cross:.3e}, mst_tpu bf16 to f32 "
          f"{own:.3e}, port bf16 to f32 "
          f"{dist(port['bfloat16'], port['float32']):.3e}")
    assert cross <= BF16_BAR * own, (what, cross, own)
    return cross, own


def jdtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def jax_forward(jmcfg, jscfg, jtrees, batch):
    """mst_tpu's eval inputs, features and goal logits (f32) in its
    compute dtype, jitted (its eager ops are slow on the CPU)."""
    def forward(params, state, semantic, traj):
        p = jsteps._compute_params(params, jscfg)
        sem, obs, _ = jsteps._prepare_inputs(jmcfg, jscfg, p, semantic, traj,
                                             train=False)
        feats, _ = jynet.pred_features(p, state, jmcfg, sem, obs)
        return sem, obs, feats, jynet.pred_goal(p, feats).astype(jnp.float32)

    return jax.jit(forward)(jtrees[0], jtrees[1],
                            jnp.asarray(batch["semantic"]),
                            jnp.asarray(batch["traj"]))


@pytest.fixture(scope="module")
def evals():
    """The eval forward and the decode on injected waypoint draws, in f32
    and bf16, both packages, plain Y-Net with mosa_2 on 0-4."""
    params = model_params()
    batch = make_batch()
    weights, state, jtrees = init(params)
    rng = np.random.default_rng(3)
    wps = rng.uniform(8, 56, size=(6, B, 2, 2)).astype(np.float32)
    out = {"port": {}, "jax": {}}
    for dtype in ("float32", "bfloat16"):
        p = dict(params, compute_dtype=dtype)
        mcfg, scfg = ynet_config(p), step_config(p)
        cp = steps._compute_params(weights, scfg)
        sem, obs, _ = steps._prepare_inputs(mcfg, scfg, cp,
                                            t(batch["semantic"]),
                                            t(batch["traj"]))
        feats, _ = ynet_lib.pred_features(cp, state, mcfg, sem, obs)
        es = steps.make_eval_step(mcfg, scfg)
        with torch.no_grad():
            goal = ynet_lib.pred_goal(cp, feats).float()
            trajs = es.decode_trajs(weights, feats, t(wps))
        out["port"][dtype] = dict(
            semantic=sem, observed=obs, features=feats, goal=goal,
            trajs=trajs, tail=es.prepredictor(weights, feats)(t(wps)))
        jmcfg, jscfg = jax_configs(p, jdtype(dtype))
        jsem, jobs, jfeats, jgoal = jax_forward(jmcfg, jscfg, jtrees, batch)
        jes = jsteps.make_eval_step(jmcfg, jscfg)
        out["jax"][dtype] = dict(
            semantic=jsem, observed=jobs, features=jfeats, goal=jgoal,
            trajs=jes.decode_trajs(jtrees[0], jfeats, jnp.asarray(wps)))
    out["wps"], out["batch"], out["params"] = wps, batch, params
    return out


def test_bf16_features_really_bf16(evals):
    """tests/test_bf16.py::test_bf16_features_really_bf16's check in both
    packages: the inputs and every feature map bf16, as mst_tpu's, the
    eval goal logits f32, the decode tail's operands bf16 (the fused
    kernel takes them), and f32 the identity."""
    port, jx = evals["port"]["bfloat16"], evals["jax"]["bfloat16"]
    for name in ("semantic", "observed"):
        assert port[name].dtype == BF and jx[name].dtype == jnp.bfloat16
    assert len(port["features"]) == len(jx["features"]) == 3
    for f, jf in zip(port["features"], jx["features"]):
        assert f.dtype == BF and jf.dtype == jnp.bfloat16
        assert f.is_contiguous(memory_format=torch.channels_last) or \
            f.permute(0, 3, 1, 2).is_contiguous(
                memory_format=torch.channels_last)
    assert port["goal"].dtype == torch.float32
    assert jx["goal"].dtype == jnp.float32
    assert all(v.dtype == BF for v in port["tail"])
    assert port["trajs"].dtype == torch.float32
    f32 = evals["port"]["float32"]
    assert all(f.dtype == torch.float32 for f in f32["features"])
    scfg = step_config(evals["params"])
    w, _ = ynet_lib.init_ynet(torch.Generator().manual_seed(0),
                              ynet_config(evals["params"]))
    assert steps._compute_params(w, scfg) is w


@pytest.mark.parametrize("output", ["features", "goal", "trajs"])
def test_bf16_eval_matches_jax(evals, output):
    """Each feature map, the eval goal logits and the K decodes on the
    same injected waypoints: the port's bf16 within BF16_BAR x mst_tpu's
    own bf16-to-f32 distance of mst_tpu's bf16."""
    port = {d: evals["port"][d][output] for d in ("float32", "bfloat16")}
    jx = {d: evals["jax"][d][output] for d in ("float32", "bfloat16")}
    if output == "features":
        for i in range(3):
            assert_bar({d: v[i] for d, v in port.items()},
                       {d: v[i] for d, v in jx.items()}, f"features[{i}]")
    else:
        cross, own = assert_bar(port, jx, output)
        assert own > 0


def test_bf16_ade_fde_within_mst_tpus_bar(evals):
    """min-over-K ADE and FDE of the decodes on the same draws: the
    port's bf16 against mst_tpu's bf16 and against the port's f32 within
    rtol 0.02."""
    batch = evals["batch"]
    gt = t(batch["traj"])[:, 8:]
    goals = t(evals["wps"])[:, :, -1]
    rf = step_config(evals["params"]).resize_factor
    got = {}
    for side, dtype in (("port", "float32"), ("port", "bfloat16"),
                        ("jax", "bfloat16")):
        trajs = evals[side][dtype]["trajs"]
        ade, fde = ade_fde_per_sample(gt, t(trajs), goals, rf)
        got[side, dtype] = np.array([ade.min(0).values.mean().item(),
                                     fde.min(0).values.mean().item()])
    want = got["jax", "bfloat16"]
    np.testing.assert_allclose(got["port", "bfloat16"], want, rtol=ADE_RTOL)
    np.testing.assert_allclose(got["port", "bfloat16"],
                               got["port", "float32"], rtol=ADE_RTOL)


def capture_grads():
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def train_runs():
    """One train step (Adam) in f32, f32 with remat, bf16 and bf16 with
    remat in the port, and for mosa_2 f32 and bf16 in mst_tpu, from the
    same weights: metrics, gradients, the new state, and the port's Adam
    moments."""
    cache = {}

    def get(train_net):
        if train_net in cache:
            return cache[train_net]
        params = model_params(train_net)
        batch = make_batch()
        runs = {}
        for dtype in ("float32", "bfloat16"):
            for remat in (False, True):
                p = dict(params, compute_dtype=dtype, remat=remat)
                weights, state, _ = init(params)
                setup = trainer.setup_training(weights, p, 1)
                step = steps.make_train_step(ynet_config(p), step_config(p))
                new_state, m = step(weights, state, setup["optimizer"],
                                    {k: t(v) for k, v in batch.items()})
                trained = {k: v for k, v in io.flatten(weights).items()
                           if v.requires_grad}
                runs["port", dtype, remat] = dict(
                    metrics={k: v for k, v in m.items()},
                    grads={k: v.grad for k, v in trained.items()},
                    leaves=trained, state=new_state,
                    adam=[s for s in setup["optimizer"].state.values()])
            if train_net != "mosa_2":
                continue
            _, _, jtrees = init(params)
            jmcfg, jscfg = jax_configs(params, jdtype(dtype))
            mask = jfreeze.trainable_mask(jtrees[0], train_net,
                                          params["position"])
            tr, fr = jfreeze.split_params(jtrees[0], mask)
            opt = optax.chain(capture_grads(), optax.adam(1e-3))
            jstep = jsteps.make_train_step(jmcfg, jscfg, opt)
            tr2, jstate, ostate, jm = jstep(tr, fr, jtrees[1], opt.init(tr),
                                            batch)
            runs["jax", dtype] = dict(
                metrics={k: float(v) for k, v in jm.items()},
                grads={k: np.asarray(v) for k, v in
                       io.flatten(ostate[0]).items() if v is not None},
                leaves=tr2, state=jstate)
        cache[train_net] = runs
        return runs

    return get


def test_bf16_train_step_matches_jax(train_runs):
    """The losses and top-1 metrics and every gradient leaf of one bf16
    mosa_2 step: the port within BF16_BAR x mst_tpu's own bf16-to-f32
    distance of mst_tpu's."""
    r = train_runs("mosa_2")
    for k in ("loss", "goal_loss", "traj_loss", "ade_sum", "fde_sum"):
        assert_bar({d: float(r["port", d, False]["metrics"][k])
                    for d in ("float32", "bfloat16")},
                   {d: r["jax", d]["metrics"][k]
                    for d in ("float32", "bfloat16")}, k)
    grads = {d: io.params_to_numpy(r["port", d, False]["grads"])
             for d in ("float32", "bfloat16")}
    assert grads["bfloat16"].keys() == r["jax", "bfloat16"]["grads"].keys()
    for k in grads["bfloat16"]:
        assert_bar({d: grads[d][k] for d in grads},
                   {d: r["jax", d]["grads"][k] for d in grads}, k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_bf16_matches_jax(rng, train):
    """The serial adapters' batch norm on a bf16 activation with bf16
    weights and f32 running statistics: in train mode the output stays
    bf16 and the moved statistics f32, in eval mode the output is f32 (JAX
    promotes against the f32 statistics), in both packages; the values
    within the bar."""
    from mst_tpu.models import layers as jlayers
    from mst_tpu_torch.models import layers

    x = rng.normal(size=(2, 6, 8, 4)).astype(np.float32) * 2 + 1
    w, b = rng.normal(size=4).astype(np.float32), rng.normal(size=4)
    st = {"running_mean": rng.normal(size=4).astype(np.float32),
          "running_var": rng.uniform(0.5, 2, size=4).astype(np.float32),
          "num_batches": np.int32(3)}
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        td, jd = (BF, jnp.bfloat16) if dtype == "bfloat16" else (
            torch.float32, jnp.float32)
        y, s2 = layers.batchnorm_apply(
            {"weight": t(w, td), "bias": t(b, td)},
            {k: torch.tensor(v) for k, v in st.items()}, t(x, td), train)
        jy, js2 = jlayers.batchnorm_apply(
            {"weight": jnp.asarray(w, jd), "bias": jnp.asarray(b, jd)},
            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(x, jd),
            train)
        assert str(y.dtype).split(".")[-1] == str(jy.dtype)
        for k in st:
            assert str(s2[k].dtype).split(".")[-1] == str(js2[k].dtype), k
        got[dtype], want[dtype] = (y, s2), (jy, js2)
    assert got["bfloat16"][0].dtype == (BF if train else torch.float32)
    assert_bar({d: v[0] for d, v in got.items()},
               {d: np.asarray(v[0], np.float32) for d, v in want.items()},
               "y")
    if train:
        for k in ("running_mean", "running_var"):
            assert_bar({d: v[1][k] for d, v in got.items()},
                       {d: np.asarray(v[1][k]) for d, v in want.items()}, k)


def test_bf16_master_leaves_and_adam_stay_f32(train_runs):
    """bf16 trains f32 master leaves: the trainable leaves, their
    gradients and Adam's moments f32, in mst_tpu too; the metrics f32."""
    r = train_runs("mosa_2")
    port = r["port", "bfloat16", False]
    assert port["leaves"] and all(v.dtype == torch.float32
                                  for v in port["leaves"].values())
    assert all(g.dtype == torch.float32 for g in port["grads"].values())
    for s in port["adam"]:
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in port["metrics"].values())
    assert all(v.dtype == jnp.float32
               for v in jax.tree.leaves(r["jax", "bfloat16"]["leaves"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train_net", ["mosa_2", "serial"])
def test_remat_matches_the_plain_step(train_runs, train_net, dtype):
    """--remat recomputes the encoder and the map decoders in the
    backward: the same metrics, gradients, updated leaves and state, bit
    for bit on the CPU."""
    r = train_runs(train_net)
    a, b = r["port", dtype, False], r["port", dtype, True]
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
    for name in ("grads", "leaves"):
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    sa, sb = io.flatten(a["state"]), io.flatten(b["state"])
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_serial_eval_raises_in_bf16_as_in_mst_tpu():
    """A serial adapter's eval-mode batch norm promotes a bf16 activation
    to f32 against the f32 running statistics, so the conv after it meets
    a bf16 weight: mst_tpu's lax conv raises TypeError, and so does the
    port's; f32 runs."""
    params = model_params("serial", compute_dtype="bfloat16")
    weights, state, jtrees = init(params)
    batch = make_batch()
    scfg = step_config(params)
    with pytest.raises(TypeError, match="same dtype"):
        steps.make_eval_step(ynet_config(params), scfg).forward(
            weights, state, {k: t(v) for k, v in batch.items()},
            torch.Generator().manual_seed(0))
    jmcfg, jscfg = jax_configs(params, jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jsteps.make_eval_step(jmcfg, jscfg).forward(
            jtrees[0], jtrees[1], batch, jax.random.PRNGKey(0))
    steps.make_eval_step(ynet_config(params), step_config(
        dict(params, compute_dtype="float32"))).forward(
        weights, state, {k: t(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("network", ["fusion", "parallel_1x1"])
def test_bf16_variants_stay_bf16(network):
    """Y-Net-Mod (fusion, n_fusion 1, mosa_1 on its branches) and the
    parallel adapters keep bf16 features in both packages, and the
    port's last feature map is within the bar of mst_tpu's."""
    if network == "fusion":
        params = model_params("mosa_1", network="fusion", n_fusion=1,
                              position=["scene", "motion", "fusion"])
    else:
        params = model_params("parallel_1x1")
    weights, state, jtrees = init(params)
    batch = make_batch()
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        p = dict(params, compute_dtype=dtype)
        mcfg, scfg = ynet_config(p), step_config(p)
        cp = steps._compute_params(weights, scfg)
        sem, obs, _ = steps._prepare_inputs(mcfg, scfg, cp,
                                            t(batch["semantic"]),
                                            t(batch["traj"]))
        feats, _ = ynet_lib.pred_features(cp, state, mcfg, sem, obs)
        jmcfg, jscfg = jax_configs(p, jdtype(dtype))
        jfeats = jax_forward(jmcfg, jscfg, jtrees, batch)[2]
        assert [str(f.dtype).split(".")[-1] for f in feats] == \
            [str(f.dtype) for f in jfeats]
        got[dtype], want[dtype] = feats[-1], jfeats[-1]
    assert got["bfloat16"].dtype == BF
    assert_bar(got, want, "the last feature map")


def test_compute_params_and_the_flag():
    """_compute_params casts every floating leaf and keeps integer ones;
    the gradient reaches the f32 leaf through the cast. --compute_dtype
    takes mst_tpu's names and raises on others; the step config carries
    the dtype and remat."""
    leaf = torch.ones(3, requires_grad=True)
    tree = {"w": leaf, "n": torch.zeros((), dtype=torch.int32)}
    scfg = step_config(model_params(compute_dtype="bf16", remat=True))
    assert scfg.compute_dtype == BF and scfg.remat
    cast = steps._compute_params(tree, scfg)
    assert cast["w"].dtype == BF and cast["n"].dtype == torch.int32
    (cast["w"].float() * 2).sum().backward()
    assert leaf.grad.dtype == torch.float32 and torch.equal(
        leaf.grad, torch.full((3,), 2.0))
    for name, want in (("float32", torch.float32), ("f32", torch.float32),
                       ("bfloat16", BF), ("BF16", BF)):
        assert parse_compute_dtype(name) == want
    with pytest.raises(ValueError, match="compute_dtype"):
        parse_compute_dtype("float16")


def test_bf16_predictor_and_model_directory(tmp_path):
    """A bf16 config reaches Predictor, export_model's manifest (written
    as mst_tpu writes it) and LoadedModel, which reads it back and serves
    what the Predictor serves; the weights stay f32."""
    params = get_params("sdd_shortterm_eval.yaml", dict(
        SMALL, compute_dtype="bfloat16", use_TTST=False,
        ckpt_path=str(tmp_path)))
    rng = np.random.default_rng(0)
    semantic = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    observed = rng.uniform(10, 50, size=(B, 8, 2)).astype(np.float32)
    exp = trainer.Experiment(params, device="cpu")
    pred = serve.Predictor(params, device="cpu", seed=exp.seed)
    assert pred.scfg.compute_dtype == BF
    manifest = serve.export_model(exp, tmp_path / "model", H, W, B)
    assert manifest["compute_dtype"] == "bfloat16"
    loaded = serve.LoadedModel(tmp_path / "model", device="cpu")
    assert loaded.manifest["compute_dtype"] == "bfloat16"
    # the programs were exported in bf16: their features are bf16
    assert {f.dtype for f in loaded.forward(semantic, observed)[0]} == {BF}
    assert all(v.dtype == torch.float32
               for v in io.flatten(loaded.params).values())
    want = pred.predict(semantic, observed, seed=0)
    got = loaded.predict(semantic, observed, seed=0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert np.isfinite(want["trajectories"]).all()
