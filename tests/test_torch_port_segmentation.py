"""The segmentation backbone's pieces on the CPU in f32: the port's U-Net
(models/unet.py) against mst_tpu's, whole (shallow and at ResNet101
depth) and piece by piece, the stride-2 3x3 convs' SAME padding on even
and odd sizes and on a two-rank slab, the reference's function
(tests/test_convert.py's TorchUnet, smp 0.1.0's Unet('resnet101') in
torch) everywhere but those three convs, the weight bridge, the backbone
file's loading, the segmentation_* freeze rule (mst_tpu's mask, the
running statistics included), the config, and the segmentation_head and
segmentation_bn train steps with the backbone inside the step.

Weights: the port's unet_init with every batch norm moved off its init
(weight, bias and running statistics random), carried to mst_tpu and to
TorchUnet through the npz layout (io.params_to_numpy, the converter's).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from mst_tpu import config as jconfig
from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.models import unet as junet
from mst_tpu.models import ynet as jynet
from mst_tpu.train import freeze as jfreeze
from mst_tpu.train import steps as jsteps
from mst_tpu_torch import config, io
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.models import segmentation, unet
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.models.convert import convert_torch_segmentation
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.ops.heatmap import rasterize_gaussian_nhwc
from mst_tpu_torch.train import freeze, optim, steps, trainer
from tests import torch_port_ranks as ranks
from tests.test_convert import TorchUnet
from tests.test_torch_port_train import (OTHER_SHARE, SIG, UPDATE_TOL,
                                         assert_grads_close, capture_grads)

SHALLOW = (1, 1, 1, 1)
H, W = 64, 96
OP_TOL = 1e-5  # ops and pieces, relative to each output's max
MAP_TOL = 1e-4  # class maps against mst_tpu
# the three stride-2 3x3 convs, the one place where the padding of
# mst_tpu (and the port) and of smp differ (ROADMAP Queue 3 #9)
STRIDE2 = [f"encoder/layer{li}/0/conv2/weight" for li in (2, 3, 4)]


def moved(tree, seed=0):
    """Numpy copies of a port tree in the npz layout, every batch norm's
    weight, bias and running statistics and the head's bias random."""
    rng = np.random.default_rng(seed)
    flat = {k: v.copy() for k, v in io.params_to_numpy(tree).items()}
    for k, v in flat.items():
        if k.endswith("running_mean") or k.endswith("/bias"):
            flat[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
        elif k.endswith("running_var"):
            flat[k] = rng.uniform(0.7, 1.5, v.shape).astype(np.float32)
        elif v.ndim == 1:  # batch-norm weights
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def shallow():
    """-> (npz-layout numpy leaves, port tree, mst_tpu tree) of one
    shallow backbone."""
    flat = moved(unet.unet_init(torch.Generator().manual_seed(0),
                                layers=SHALLOW))
    return (flat, io.params_from_numpy(flat),
            io.unflatten({k: jnp.asarray(v) for k, v in flat.items()}))


def image(seed=0, hw=(H, W), b=1):
    return np.random.default_rng(seed).normal(
        size=(b, *hw, 3)).astype(np.float32)


def close(got, want, tol=OP_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


@functools.partial(jax.jit, static_argnames="train")
def jax_encoder(enc, x, bn_state, train):
    """mst_tpu's encoder (jitted: its eager op-by-op run is slow on the
    CPU) -> (features, running-statistic updates)."""
    bn, upd = junet._make_bn(bn_state, train)
    return junet._resnet_encoder_apply(enc, x, SHALLOW, bn), upd


@functools.partial(jax.jit, static_argnames="layers")
def jax_unet(params, x, layers):
    """mst_tpu's whole U-Net in eval mode (jitted)."""
    return junet.unet_apply(params, x, layers=layers)


def torch_unet(flat, layers=SHALLOW):
    """TorchUnet in eval mode with the npz-layout leaves of flat."""
    tmodel = TorchUnet(layers).eval()
    with torch.no_grad():
        for k, v in tmodel.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            a = flat[k.replace(".", "/")]
            v.copy_(torch.tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4
                                 else a))
    return tmodel


@functools.partial(jax.jit, static_argnames=("train", "head"))
def jax_decoder(params, feats, bn_state, train, head):
    """mst_tpu's decoder, then its head and softmax when head."""
    bn, upd = junet._make_bn(bn_state, train)
    x = junet._unet_decoder_apply(params["decoder"], feats, bn=bn)
    if head:
        x = jax.nn.softmax(junet._conv(params["segmentation_head"]["0"], x),
                           axis=-1)
    return x, upd



# ---------------------------------------------------------------------------
# init and the reference's function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [SHALLOW, unet.RESNET101_LAYERS])
def test_init_matches_jax_tree(layers):
    """unet_init's leaves in the npz layout: mst_tpu's keys and shapes,
    f32, and the int '_meta/activation'; 51,513,958 parameters (beside
    the running statistics) at ResNet101 depth with 6 classes."""
    tree = unet.unet_init(torch.Generator().manual_seed(0), layers=layers)
    got = io.params_to_numpy(tree)
    want = io.flatten(jax.eval_shape(
        lambda k: junet.unet_init(k, layers=layers), jax.random.PRNGKey(0)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == tuple(v.shape), k
        assert got[k].dtype == (np.int32 if k == "_meta/activation"
                                else np.float32), k
    if layers == unet.RESNET101_LAYERS:
        assert sum(v.size for k, v in got.items()
                   if not k.startswith("_meta")
                   and "running" not in k) == 51_513_958


@pytest.mark.parametrize("activation", ["none", "softmax"])
def test_unet_matches_reference_function(shallow, activation):
    """The whole port U-Net against mst_tpu's unet_apply on the same
    weights (eval mode, moved statistics, the stride-2 convs live) at
    1e-5 of the map's max; the softmax head's rows sum to 1."""
    flat, params, jparams = shallow
    act = int(activation == "softmax")
    params = {**params, "_meta": {"activation": torch.tensor(
        act, dtype=torch.int32)}}
    jparams = {**jparams, "_meta": {"activation": jnp.asarray(act)}}
    x = image(1)
    with torch.no_grad():
        got = unet.unet_apply(params, torch.tensor(x))
    close(got, jax_unet(jparams, jnp.asarray(x), SHALLOW))
    assert got.is_contiguous()
    if activation == "softmax":
        close(got.sum(-1), np.ones((1, H, W)))


def test_unet_full_depth_matches_reference_function():
    """ResNet101 depth (3, 4, 23, 3) at 64 x 64 against mst_tpu's
    unet_apply on TorchUnet's init (random statistics), converted, at
    1e-5 of the map's max."""
    torch.manual_seed(0)
    tmodel = TorchUnet(unet.RESNET101_LAYERS).eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.7, 1.5)
    flat = convert_torch_segmentation(tmodel.state_dict(), "none")
    x = image(2, (64, 64))
    with torch.no_grad():
        got = unet.unet_apply(io.params_from_numpy(flat), torch.tensor(x))
    want = jax_unet(io.unflatten({k: jnp.asarray(v) for k, v in
                                  flat.items()}), jnp.asarray(x),
                    unet.RESNET101_LAYERS)
    close(got, want)


def test_unet_is_smps_function_off_the_stride2_convs(shallow):
    """smp's function everywhere but the three stride-2 3x3 convs: with
    those convs' weights zero (where their padding cannot show), the port
    U-Net equals TorchUnet on the same weights at 1e-5."""
    flat = dict(shallow[0])
    for k in STRIDE2:
        flat[k] = np.zeros_like(flat[k])
    tmodel = torch_unet(flat)
    x = image(1)
    with torch.no_grad():
        got = unet.unet_apply(io.params_from_numpy(flat), torch.tensor(x))
        want = torch.softmax(nhwc(tmodel(torch.tensor(x).permute(
            0, 3, 1, 2))), dim=-1)
    close(got, want)


# ---------------------------------------------------------------------------
# against mst_tpu, piece by piece
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stem_and_layer1_match_jax(shallow, train):
    """The image, stem and layer1 features (stride 1 and the max-pool:
    the two packages agree there) at 1e-5; in train mode also those
    batch norms' running-statistic updates."""
    _, params, jparams = shallow
    x = image(3, b=2)
    bn, upd = unet.make_bn(None, train)
    with torch.no_grad():
        feats = unet.encoder_apply(params["encoder"], torch.tensor(x),
                                   SHALLOW, bn)
    jfeats, jupd = jax_encoder(jparams["encoder"], jnp.asarray(x), None,
                               train=train)
    for i in range(3):
        close(nhwc(feats[i]), jfeats[i], what=f"feature {i}")
    if train:
        paths = [p for p in jupd if p.startswith(("encoder/bn1",
                                                  "encoder/layer1/"))]
        assert len(paths) == 5 and set(paths) <= set(upd)
        for p in paths:
            for leaf in ("running_mean", "running_var"):
                close(upd[p][leaf], jupd[p][leaf], what=f"{p}/{leaf}")


@pytest.mark.parametrize("mode", ["eval", "train", "bn_state",
                                  "features_only"])
def test_decoder_and_head_match_jax(shallow, mode):
    """The decoder and the head fed the same encoder features (mst_tpu's)
    at 1e-5: eval mode, train mode with its updates, eval with an external
    bn_state, and the 16 decoder channels without the head."""
    _, params, jparams = shallow
    jfeats, _ = jax_encoder(jparams["encoder"], jnp.asarray(image(4)),
                            None, train=False)
    feats = [torch.tensor(np.asarray(f)).permute(0, 3, 1, 2)
             for f in jfeats]
    train = mode == "train"
    state = None
    if mode == "bn_state":
        rng = np.random.default_rng(5)
        flat = io.params_to_numpy(unet.extract_bn_stats(params))
        flat = {k: (rng.uniform(-0.5, 0.5, v.shape) if "mean" in k else
                    rng.uniform(0.3, 3.0, v.shape)).astype(np.float32)
                for k, v in flat.items()}
        state = io.state_from_numpy(flat)
        jstate = io.unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    bn, upd = unet.make_bn(state, train)
    with torch.no_grad():
        x = unet.decoder_apply(params["decoder"], feats, bn=bn)
        got = x if mode == "features_only" else unet.head_apply(params, x)
    want, jupd = jax_decoder(jparams, jfeats,
                             None if state is None else jstate, train=train,
                             head=mode != "features_only")
    close(nhwc(got), want)
    assert got.shape[1] == (16 if mode == "features_only" else 6)
    if train:
        assert upd.keys() == jupd.keys() and len(upd) == 10
        for p in jupd:
            for leaf in ("running_mean", "running_var"):
                close(upd[p][leaf], jupd[p][leaf], what=f"{p}/{leaf}")


@pytest.fixture(scope="module", autouse=True)
def stride2_world(tmp_path_factory):
    """ranks' stride2_same on a (1, 2) spatial mesh, started with the
    module and run beside its other tests -> a handle for ranks.finish."""
    return ranks.start(tmp_path_factory.mktemp("stride2"), (1, 2),
                       ["stride2_same"], axes=["data", "space"], threads=1)


@pytest.fixture(scope="module")
def stride2_slabs(stride2_world):
    """Each rank's stride2_same output, gathered."""
    return ranks.finish(stride2_world)["stride2_same"]


@pytest.mark.parametrize("hw", [(16, 24), (15, 23), (16, 23), (15, 24),
                                "slab"],
                         ids=["even", "odd", "even-odd", "odd-even",
                              "slab"])
def test_stride2_padding_is_torchvisions(request, hw):
    """A stride-2 3x3 conv (block 0's conv2 of layer2-4) is mst_tpu's
    _conv, SAME, at 1e-5: (0, 1) on an even size, (1, 1) on an odd one,
    where torchvision pads (1, 1) on both (and differs from both packages
    on an even size). 'slab': each of two ranks' H slabs of a 16-row map
    (its halo 0 rows above and 1 below), gathered, at even and odd W."""
    cases = ranks.STRIDE2_SHAPES if hw == "slab" else [hw]
    for height, width in cases:
        x, w = ranks.stride2_inputs(height, width)
        want = torch.tensor(np.asarray(junet._conv(
            {"weight": jnp.asarray(w.transpose(2, 3, 1, 0))},
            jnp.asarray(x.transpose(0, 2, 3, 1)), stride=2)))
        if hw == "slab":
            for got in request.getfixturevalue("stride2_slabs"):
                close(nhwc(torch.tensor(got[height, width])), want)
            continue
        got = unet.conv({"weight": torch.tensor(w)}, torch.tensor(x), 2)
        close(nhwc(got), want)
        vision = nhwc(F.conv2d(torch.tensor(x), torch.tensor(w), stride=2,
                               padding=1))
        differ = float((vision - want).abs().max()) > \
            0.1 * float(want.abs().max())
        assert differ == (height % 2 == 0 or width % 2 == 0)


def test_extract_bn_stats_matches_jax(shallow):
    """Every batch norm's statistics, nested by path, equal to mst_tpu's
    and copies (not the params' tensors)."""
    _, params, jparams = shallow
    got = io.state_to_numpy(unet.extract_bn_stats(params))
    want = io.flatten(junet.extract_bn_stats(jparams))
    assert got.keys() == want.keys() and len(got) == 2 * 27
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    stats = unet.extract_bn_stats(params)
    assert stats["encoder"]["bn1"]["running_mean"].data_ptr() != \
        params["encoder"]["bn1"]["running_mean"].data_ptr()


# ---------------------------------------------------------------------------
# the weight bridge and the backbone file
# ---------------------------------------------------------------------------

def test_io_carries_the_backbone_and_its_state(shallow):
    """params_to/from_numpy round-trip the backbone (conv weights HWIO in
    the npz, OIHW and contiguous here; the int32 '_meta' leaf kept), and
    the state bridge the nested 'segmentation_bn' statistics (no
    num_batches leaf)."""
    flat, params, _ = shallow
    assert params["encoder"]["conv1"]["weight"].shape == (64, 3, 7, 7)
    assert all(v.is_contiguous() for v in io.flatten(params).values())
    assert params["_meta"]["activation"].dtype == torch.int32
    back = io.params_to_numpy(params)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    state = {"segmentation_bn": unet.extract_bn_stats(params)}
    st = io.state_to_numpy(state)
    assert all(k.startswith("segmentation_bn/") and
               k.endswith(("running_mean", "running_var")) for k in st)
    again = io.flatten(io.state_from_numpy(st))
    for k, v in io.flatten(state).items():
        assert torch.equal(again[k], v), k


def test_load_params(tmp_path, shallow):
    """A converter's npz and a model directory's params.npz (the
    'segmentation/' leaves) load as the same tree, '_meta' int32; no file
    means None (the identity); a file that is no npz, or an npz without a
    backbone, raises."""
    flat, params, _ = shallow
    assert segmentation.load_params(None, "cpu") is None
    assert segmentation.load_params(tmp_path / "missing.npz", "cpu") is None
    conv = dict(flat, **{"_meta/activation": np.array(1)})  # int64
    np.savez(tmp_path / "seg.npz", **conv)
    np.savez(tmp_path / "params.npz", **{"encoder/stages/0/conv0/bias":
                                         np.zeros(3, np.float32)},
             **{f"segmentation/{k}": v for k, v in flat.items()})
    for name in ("seg.npz", "params.npz"):
        tree = segmentation.load_params(tmp_path / name, "cpu")
        assert tree["_meta"]["activation"].dtype == torch.int32
        got = io.flatten(tree)
        assert got.keys() == io.flatten(params).keys()
        for k, v in io.flatten(params).items():
            assert torch.equal(got[k], v), k
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(ValueError, match="not a backbone npz"):
        segmentation.load_params(bad, "cpu")
    np.savez(tmp_path / "ynet.npz", **{"encoder/stages/0/conv0/bias":
                                       np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not a backbone npz"):
        segmentation.load_params(tmp_path / "ynet.npz", "cpu")
    x = torch.tensor(image(7))
    assert segmentation.apply(None, x) is x
    assert segmentation.apply(None, x, train=True) == (x, {})


# ---------------------------------------------------------------------------
# the freeze rule and the config
# ---------------------------------------------------------------------------

SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_semantic_classes=6,
             waypoints=[11])


def backbone_file(tmp_path, flat):
    path = tmp_path / "sdd" / "sdd_segmentation.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    return path


@pytest.mark.parametrize("train_net,position,ynet_bias", [
    ("segmentation_head", [], False), ("segmentation_bias", [], False),
    ("segmentation_bn", [], False), ("segmentation_conv1", [], False),
    ("segmentation_conv2", [], True), ("train", [], False),
    ("mosa_2", ["0", "1", "2", "3", "4"], False), ("bias", [], False)])
def test_freeze_selection_matches_jax(shallow, train_net, position,
                                      ynet_bias):
    """set_trainable on a Y-Net with a backbone marks exactly the leaves
    mst_tpu's trainable_mask marks, key for key, with its quirks ('bn'
    selects the encoder's bn1-bn3, a layer word selects
    'decoder/blocks/<i>/<word>', a segmentation_* strategy selects the
    matching norms' running statistics too, '_meta' never trains, every
    other strategy leaves the backbone frozen)."""
    flat, _, _ = shallow
    params = config.get_params("sdd_shortterm_train.yaml", dict(
        SMALL, train_net=train_net, position=position))
    tree, _ = init_ynet(torch.Generator().manual_seed(0),
                        config.ynet_config(params))
    tree["segmentation"] = io.params_from_numpy(flat)
    jtree = io.unflatten(io.params_to_numpy(tree))
    want = {k for k, v in io.flatten(jfreeze.trainable_mask(
        jtree, train_net, position, None, ynet_bias)).items() if v}
    leaves = freeze.set_trainable(tree, train_net, position, ynet_bias)
    got = {k for k, v in io.flatten(tree).items() if v.requires_grad}
    assert got == want and len(leaves) == len(want) > 0
    seg = {k for k in got if k.startswith("segmentation/")}
    assert not any("_meta" in k for k in got)
    assert bool(seg) == train_net.startswith("segmentation")
    if train_net == "segmentation_bn":
        # 13 encoder norms' weight, bias and running statistics
        assert len(seg) == 4 * 13 and all("/encoder/" in k for k in seg)


@pytest.mark.parametrize("train_net", ["segmentation_head",
                                       "segmentation_bias",
                                       "segmentation_bn",
                                       "segmentation_conv1",
                                       "segmentation_conv2"])
def test_segmentation_mask_differs_from_mst_tpu_only_in_running_stats(
        shallow, train_net):
    """The port's selection is mst_tpu's mask, key for key (ROADMAP Queue
    3 #10, closed: the running statistics are leaves in both): none for
    the head and the biases, the encoder norms' for 'bn', the decoder
    norms' for a layer word."""
    flat, _, _ = shallow
    params = config.get_params("sdd_shortterm_train.yaml", dict(
        SMALL, train_net=train_net))
    tree, _ = init_ynet(torch.Generator().manual_seed(0),
                        config.ynet_config(params))
    tree["segmentation"] = io.params_from_numpy(flat)
    want = {k for k, v in io.flatten(jfreeze.trainable_mask(
        io.unflatten(io.params_to_numpy(tree)), train_net)).items() if v}
    freeze.set_trainable(tree, train_net)
    got = {k for k, v in io.flatten(tree).items() if v.requires_grad}
    assert got == want
    stats = {k for k in got if k.endswith(("/running_mean",
                                            "/running_var"))}
    if train_net == "segmentation_bn":
        assert len(stats) == 2 * 13
        assert all("/encoder/" in k for k in stats)
    if train_net in ("segmentation_conv1", "segmentation_conv2"):
        assert stats and all("/decoder/blocks/" in k for k in stats)
    if train_net in ("segmentation_head", "segmentation_bias"):
        assert not stats


@pytest.mark.parametrize("train_net", ["segmentation_bn",
                                       "segmentation_conv1"])
def test_segmentation_strategies_leave_running_stats(world, jax_step,
                                                     train_net):
    """One Adam step of a segmentation_* strategy moves the matching
    norms' running statistics as mst_tpu's step moves them (the gradients
    within 1e-4 of each leaf's max, the updates under the fine-tune tests'
    rule), by about lr (Adam's first step: lr times the gradient's sign),
    and leaves every other norm's statistics bit-identical."""
    params, weights, init, batch = step_inputs(world, train_net)
    setup = trainer.setup_training(weights, params, steps_per_epoch=1)
    step = steps.make_train_step(config.ynet_config(params),
                                 config.step_config(params,
                                                    segment_in_step=True))
    step(weights, {}, setup["optimizer"], {k: t(v) for k, v in
                                            batch.items()})
    _, jgrads, jparams = jax_step
    after = hwio(weights)
    stats = [k for k in init if k.startswith("segmentation/")
             and k.endswith(("/running_mean", "/running_var"))]
    trained = {k for k, v in io.flatten(weights).items() if v.requires_grad}
    moved = [k for k in stats if k in trained]
    assert moved and len(moved) < len(stats)
    grads = hwio({k: v.grad for k, v in io.flatten(weights).items()
                  if k in trained and k in moved})
    assert_grads_close(grads, {k: jgrads[k] for k in grads})
    lr = params["lr"]
    for k in stats:
        if k not in trained:
            np.testing.assert_array_equal(after[k], init[k], err_msg=k)
            continue
        g = grads[k]
        delta, jdelta = after[k] - init[k], jparams[k] - init[k]
        sig = np.abs(g) > SIG * np.abs(g).max()
        assert np.all(np.abs(delta - jdelta)[sig] <= UPDATE_TOL * lr), k
        # Adam's first step: -lr g / (|g| + eps), about lr in size
        np.testing.assert_allclose(
            delta, -lr * g / (np.abs(g) + optim.EPS), rtol=1e-3,
            atol=1e-6 * lr, err_msg=k)


@pytest.mark.parametrize("features_only", [False, True])
def test_config_with_a_backbone_matches_jax(tmp_path, shallow,
                                            features_only):
    """With the backbone's file present, ynet_config says 'unet' and the
    shipped config's 6 classes (16 channels under use_features_only), as
    mst_tpu's does; step_config carries use_features_only; without the
    file, the identity backbone and the config's classes."""
    over = dict(segmentation_model_fp=str(backbone_file(tmp_path,
                                                        shallow[0])),
                use_features_only=features_only)
    params = config.get_params("sdd_shortterm_train.yaml", over)
    jparams = jconfig.get_params(config_filename="sdd_shortterm_train.yaml",
                                 overrides=over)
    assert config.has_backbone(params)
    got, want = config.ynet_config(params), jconfig.ynet_config(jparams)
    for f in ("n_semantic_classes", "segmentation", "use_features_only",
              "feature_channels"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_semantic_classes == (16 if features_only else 6)
    scfg = config.step_config(params, segment_in_step=True)
    assert (scfg.use_features_only, scfg.segment_in_step,
            scfg.segment_train_mode) == (features_only, True, False)
    params["segmentation_model_fp"] = str(tmp_path / "missing.npz")
    assert config.ynet_config(params).segmentation is None
    assert config.ynet_config(params).n_semantic_classes == 6


# ---------------------------------------------------------------------------
# the segmentation_* train steps: the backbone inside the step
# ---------------------------------------------------------------------------
#
# Both packages' U-Nets on the same weights, the stride-2 convs live. The
# Y-Net has the CPU tests' small widths and the shipped config's 6
# classes; scenes are 64 x 96 after the config's resize (256 x 384
# synthetic RGB images).

B = 4
PATH_SMALL = dict(encoder_channels=[8, 8, 16, 16, 16],
                  decoder_channels=[16, 16, 16, 8, 8], waypoints=[11],
                  n_goal=4, n_traj=1, batch_size=B, seed=1, lr=1e-3)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The backbone file and the scenes: mst_tpu's DataFrames, the port's
    tables, the raw images, 8 / 4 / 4 tracks."""
    tmp = tmp_path_factory.mktemp("backbone")
    flat = moved(unet.unet_init(torch.Generator().manual_seed(0),
                                layers=SHALLOW), seed=1)
    seg = tmp / "sdd" / "sdd_segmentation.npz"
    seg.parent.mkdir()
    np.savez(seg, **flat)
    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=8,
                                        img_hw=(4 * H, 4 * W))
    ids = np.random.default_rng(0).permutation(df.metaId.unique())
    frames = {name: df[df.metaId.isin(part)] for name, part in
              (("train", ids[:8]), ("val", ids[8:12]), ("test", ids[12:]))}
    tables = {k: Tracks.from_frame(v) for k, v in frames.items()}
    return dict(tmp=tmp, seg=str(seg), flat=flat, frames=frames,
                tables=tables, images=images)


def params_for(world, side="port", **over):
    """The shipped sdd_shortterm_train.yaml (6 classes) at small width
    with the backbone file, as each package's get_params builds it."""
    over = {**PATH_SMALL, "segmentation_model_fp": world["seg"],
            "ckpt_path": str(world["tmp"] / side / "ckpts"),
            "metrics_jsonl": str(world["tmp"] / side / "metrics.jsonl"),
            **over}
    if side == "jax":
        return jconfig.get_params(config_filename="sdd_shortterm_train.yaml",
                                  overrides=over)
    return config.get_params("sdd_shortterm_train.yaml",
                             dict(over, device="cpu"))


def scene(seed=0):
    """A preprocessed RGB scene (ImageNet-normalised values)."""
    return np.random.default_rng(seed).normal(
        size=(1, H, W, 3)).astype(np.float32)


def jax_configs(params, **scfg_over):
    """mst_tpu's model and (unpacked) step config of a port params dict."""
    mcfg = config.ynet_config(params)
    scfg = config.step_config(params)
    jmcfg = jynet.YNetConfig(
        obs_len=mcfg.obs_len, pred_len=mcfg.pred_len,
        n_semantic_classes=mcfg.n_semantic_classes,
        encoder_channels=mcfg.encoder_channels,
        decoder_channels=mcfg.decoder_channels, waypoints=mcfg.waypoints,
        train_net=mcfg.train_net, position=mcfg.position,
        use_features_only=mcfg.use_features_only,
        segmentation=mcfg.segmentation)
    jscfg = jsteps.StepConfig(
        obs_len=scfg.obs_len, pred_len=scfg.pred_len,
        waypoints=scfg.waypoints, template_size=scfg.template_size,
        kernlen=scfg.kernlen, nsig=scfg.nsig, loss_scale=scfg.loss_scale,
        resize_factor=scfg.resize_factor, temperature=scfg.temperature,
        n_goal=scfg.n_goal, n_traj=scfg.n_traj, packed_decode=False,
        use_features_only=scfg.use_features_only, **scfg_over)
    return jmcfg, jscfg


def jax_tree(flat):
    return io.unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def hwio(tree):
    return {k: v.copy() for k, v in io.params_to_numpy(tree).items()}


# the losses against mst_tpu's, relative: on this scene mst_tpu's f32 sum
# of the BCE terms on the CPU lands further from the float64 value of its
# own maps than 1e-5 (ROADMAP Queue 3 #3: XLA's CPU reduction is the
# coarser), so the losses are held at 1e-4 here and the port's sum against
# float64 at 1e-6
LOSS_RTOL = 1e-4
STRATEGIES = ("segmentation_head", "segmentation_bn")
# the leaves jax_step trains: the strategies' and segmentation_conv1's
STEPPED = STRATEGIES + ("segmentation_conv1",)


def assert_losses_exact(step, weights, batch):
    """The port's losses at 1e-6 of the float64 masked BCE on its own
    maps (tests/test_torch_port_train.py's test_losses_match_float64)."""
    with torch.no_grad():
        goal_loss, traj_loss, goal_map, traj_map, _ = step.forward(
            weights, {}, batch)
    gt = rasterize_gaussian_nhwc(batch["traj"][:, 8:], H, W).double().numpy()
    m = batch["mask"].numpy()[:, None, None, None]
    for got, logits in ((goal_loss, goal_map), (traj_loss, traj_map)):
        x = logits.double().numpy()
        per = np.maximum(x, 0) - x * gt + np.log1p(np.exp(-np.abs(x)))
        want = (per * m).sum() / (m.sum() * x[0].size) * 1000.0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def step_inputs(world, train_net):
    """-> (params, the port's weights with the backbone, their npz-layout
    copies, the batch): the same for every strategy."""
    params = params_for(world, train_net=train_net)
    weights, _ = ynet_lib.init_ynet(torch.Generator().manual_seed(0),
                                    config.ynet_config(params))
    weights["segmentation"] = segmentation.load_params(params[
        "segmentation_model_fp"], "cpu")
    rng = np.random.default_rng(2)
    batch = {"semantic": scene(2),
             "traj": rng.uniform(5, 60, size=(B, 20, 2)).astype(np.float32),
             "mask": np.asarray([1, 1, 1, 0], np.float32)}
    return params, weights, hwio(weights), batch


@pytest.fixture(scope="module")
def jax_step(world):
    """One Adam step of mst_tpu's train step (the backbone in the step)
    training the union of STEPPED's leaves, each strategy's set by
    mst_tpu's own trainable_mask. Adam and the gradients are per leaf, so
    each strategy's leaves step as they would alone; one compile serves
    every case. -> (metrics, gradients, updated leaves)."""
    params, _, init, batch = step_inputs(world, STRATEGIES[0])
    jmcfg, jscfg = jax_configs(params, segment_in_step=True)
    jw = jax_tree(init)
    masks = [jfreeze.trainable_mask(jw, s) for s in STEPPED]
    mask = jax.tree.map(lambda *m: any(m), *masks)
    trainable, frozen = jfreeze.split_params(jw, mask)
    opt = optax.chain(capture_grads(), optax.adam(params["lr"]))
    state = opt.init(trainable)
    trainable, _, state, jm = jsteps.make_train_step(jmcfg, jscfg, opt)(
        trainable, frozen, {}, state, batch)
    return ({k: float(v) for k, v in jm.items()},
            {k: np.asarray(v) for k, v in io.flatten(state[0]).items()
             if v is not None},
            {k: np.asarray(v) for k, v in io.flatten(trainable).items()
             if v is not None})


@pytest.mark.parametrize("train_net", STRATEGIES)
def test_segmentation_train_steps_match_jax(world, jax_step, train_net):
    """An Adam step of a segmentation_* strategy from the same weights on
    the raw scene (the backbone in the step): the top-1 metrics at 1e-5
    and the losses at LOSS_RTOL (the port's at 1e-6 of float64 on its own
    maps); the gradients of its leaves (the head; the encoder's bn1-bn3
    weights, biases and running statistics, as mst_tpu's mask selects
    them), every one nonzero with the stride-2 convs live, within 1e-4 of
    each leaf's max; each update under the fine-tune tests' rule; every
    other leaf untouched."""
    params, weights, init, batch = step_inputs(world, train_net)
    setup = trainer.setup_training(weights, params, steps_per_epoch=1)
    step = steps.make_train_step(config.ynet_config(params),
                                 config.step_config(params,
                                                    segment_in_step=True))
    tbatch = {k: t(v) for k, v in batch.items()}
    assert_losses_exact(step, weights, tbatch)
    _, m = step(weights, {}, setup["optimizer"], tbatch)
    leaves = {k: v for k, v in io.flatten(weights).items() if v.requires_grad}
    moved = hwio(leaves)
    grads = hwio({k: torch.zeros_like(v) if v.grad is None else v.grad
                  for k, v in leaves.items()})

    jm, jgrads, jparams = jax_step
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), v, err_msg=k, rtol=(
            LOSS_RTOL if k.endswith("loss") else 1e-5))
    assert_grads_close(grads, {k: jgrads[k] for k in grads})
    for k, g in grads.items():
        moved_t, moved_j = moved[k] - init[k], jparams[k] - init[k]
        off = np.abs(moved_t - moved_j)
        sig = np.abs(g) > SIG * np.abs(g).max()
        assert np.all(off[sig] <= UPDATE_TOL * params["lr"]), k
        assert np.sum(off[~sig] > 1e-4 * params["lr"]) <= \
            OTHER_SHARE * off.size, k
        assert np.any(moved_t) and np.any(moved_j) and np.any(g), k
    if train_net == "segmentation_bn":
        assert sum(k.endswith(("/running_mean", "/running_var"))
                   for k in grads) == 2 * 13
    final = hwio(weights)
    for k, v in init.items():
        if k not in grads:
            np.testing.assert_array_equal(final[k], v, err_msg=k)
