"""The checkpoint converters and the released artifacts' manifests against
mst_tpu's: from one torch state dict both packages write the same npz,
key for key, in dtype and value; the manifests are mst_tpu's tables and
cover the port's initialisers (--check-manifest); the CLI converts a .pt
written here, a pickled full U-Net module included.
"""

import numpy as np
import pytest
import torch

from mst_tpu.models import convert as jconvert
from mst_tpu.models import manifests as jmanifests
from mst_tpu_torch import io
from mst_tpu_torch.models import convert, manifests, segmentation, unet
from tests.test_convert import CFG, TorchUnet, TorchYNetContainer

# (family, train_net, position): the plain and MoSA Y-Net, the block and
# in-layer adapters (serial ones bring BN statistics, the state sidecar),
# the semantic adapter and Y-Net-Mod
YNET_CASES = [
    ("sdd_shortterm_ynet", "mosa_2", (0, 1, 2, 3, 4)),
    ("sdd_shortterm_ynet", "serial", (1, 2)),
    ("sdd_shortterm_ynet", "serialLayer", (0, 1, 2, 3, 4)),
    ("sdd_shortterm_ynet", "semantic_3x3", ()),
    ("ind_longterm_ynetmod", "mosa_2", ("scene", "motion", "fusion")),
]


def random_state_dict(manifest, seed=0):
    """torch tensors shaped by a manifest: f32 normals, int64 counters."""
    rng = np.random.default_rng(seed)
    return {k: (torch.tensor(rng.normal(size=s).astype(np.float32))
                if s != () else torch.tensor(int(rng.integers(1, 9))))
            for k, s in manifest.items()}


def assert_same_npz(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("family,train_net,position", YNET_CASES)
def test_ynet_conversion_equals_jax(family, train_net, position):
    """convert_torch_ynet's params and state: mst_tpu's, exactly."""
    fam = manifests.FAMILIES[family]
    sd = random_state_dict(manifests.ynet_manifest(
        fam["obs_len"], fam["pred_len"], fam["n_waypoints"],
        train_net=train_net, position=position, network=fam["network"],
        n_fusion=fam.get("n_fusion")))
    got = convert.convert_torch_ynet(sd, position)
    want = jconvert.convert_torch_ynet(sd, position)
    for g, w in zip(got, want):
        assert_same_npz(g, w)
    assert bool(got[1]) == ("serial" in train_net)


def test_ynet_container_conversion_equals_jax():
    """A torch Y-Net with the reference's module names (test_convert's
    container) converts as mst_tpu converts it, and loads into the port's
    tree strictly."""
    torch.manual_seed(0)
    sd = {k: v.detach() for k, v in
          TorchYNetContainer(CFG).state_dict().items()}
    got, got_state = convert.convert_torch_ynet(sd)
    want, want_state = jconvert.convert_torch_ynet(sd)
    assert_same_npz(got, want)
    assert got_state == want_state == {}
    tree = io.params_from_numpy(got)
    assert tree["goal_decoder"]["predictor"]["weight"].shape == \
        tuple(sd["goal_decoder.predictor.weight"].shape)


@pytest.mark.parametrize("source,activation", [
    ("shallow module", "softmax"), ("shallow module", "none"),
    ("resnet101 manifest", "softmax")])
def test_segmentation_conversion_equals_jax(source, activation):
    """convert_torch_segmentation: mst_tpu's npz exactly, the int
    '_meta/activation' included; the ResNet101-shaped dict (with
    num_batches_tracked, a 'model.' prefix and the classifier head smp
    drops) also through the strict manifest check."""
    if source == "shallow module":
        torch.manual_seed(1)
        sd = dict(TorchUnet((1, 1, 1, 1)).state_dict())
        strict = False
    else:
        sd = random_state_dict(manifests.smp_unet_resnet101_manifest())
        sd = {f"model.{k}": v for k, v in sd.items()}
        sd["model.encoder.fc.weight"] = torch.zeros(1000, 2048)
        strict = True
    got = convert.convert_torch_segmentation(sd, activation, strict)
    want = jconvert.convert_torch_segmentation(sd, activation, strict)
    assert_same_npz(got, want)
    assert int(got["_meta/activation"]) == (activation == "softmax")


def test_strict_check_refuses_what_mst_tpu_refuses():
    """A shallow U-Net is not smp's ResNet101: both strict converters
    refuse it with the same readable diff."""
    sd = dict(TorchUnet((1, 1, 1, 1)).state_dict())
    errors = []
    for conv in (convert, jconvert):
        with pytest.raises(ValueError, match="does not match the smp 0.1.0") \
                as e:
            conv.convert_torch_segmentation(sd, strict=True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_manifests_are_mst_tpus():
    """The port's manifest tables equal mst_tpu's: smp's U-Net at
    ResNet101 and shallow depth, and every family x variant's Y-Net."""
    assert manifests.smp_unet_resnet101_manifest() == \
        jmanifests.smp_unet_resnet101_manifest()
    assert manifests.smp_unet_resnet101_manifest(3, (1, 1, 1, 1)) == \
        jmanifests.smp_unet_resnet101_manifest(3, (1, 1, 1, 1))
    assert manifests.FAMILIES == jmanifests.FAMILIES
    for family, fam in manifests.FAMILIES.items():
        variants = (manifests.VARIANTS_FUSION if fam["network"] == "fusion"
                    else manifests.VARIANTS_ORIGINAL)
        assert variants == (jmanifests.VARIANTS_FUSION
                            if fam["network"] == "fusion"
                            else jmanifests.VARIANTS_ORIGINAL)
        for train_net, position in variants:
            args = (fam["obs_len"], fam["pred_len"], fam["n_waypoints"])
            kw = dict(train_net=train_net, position=position,
                      network=fam["network"], n_fusion=fam.get("n_fusion"))
            assert manifests.ynet_manifest(*args, **kw) == \
                jmanifests.ynet_manifest(*args, **kw), (family, train_net)


def test_check_manifest_covers_the_port(capsys):
    """--check-manifest: every manifest's zero state dict converts onto
    exactly the leaves (and shapes) of the port's unet_init and
    init_ynet."""
    assert manifests.check_all(verbose=False) == []
    convert.main(["--check-manifest"])
    out = capsys.readouterr().out
    assert "all manifests fully covered" in out
    assert out.count("OK") == 1 + 2 * 10 + 3 * 10


def test_cli_round_trip(tmp_path):
    """The CLI on .pt files written here: a pickled full ResNet101 U-Net
    module (torch.save of the module, as the reference ships its
    backbone) through the strict check, and a serial Y-Net state dict
    with --position; each npz equals mst_tpu's conversion of the same
    tensors, and the backbone npz loads as the port's backbone."""
    torch.manual_seed(2)
    module = TorchUnet(unet.RESNET101_LAYERS).eval()
    torch.save(module, tmp_path / "sdd_segmentation.pth")
    convert.main(["segmentation", str(tmp_path / "sdd_segmentation.pth"),
                  str(tmp_path / "sdd_segmentation")])
    got = read_npz(tmp_path / "sdd_segmentation.npz")
    assert_same_npz(got, jconvert.convert_torch_segmentation(
        module.state_dict(), "softmax", strict=True))
    tree = segmentation.load_params(tmp_path / "sdd_segmentation.npz", "cpu")
    assert tuple(len(tree["encoder"][f"layer{i}"]) for i in range(1, 5)) \
        == unet.RESNET101_LAYERS

    fam = manifests.FAMILIES["sdd_shortterm_ynet"]
    sd = random_state_dict(manifests.ynet_manifest(
        fam["obs_len"], fam["pred_len"], fam["n_waypoints"],
        train_net="serial", position=(1, 2)), seed=3)
    torch.save(sd, tmp_path / "serial.pt")
    convert.main(["ynet", str(tmp_path / "serial.pt"),
                  str(tmp_path / "serial.npz"), "--position", "1", "2"])
    want, want_state = jconvert.convert_torch_ynet(sd, ["1", "2"])
    assert_same_npz(read_npz(tmp_path / "serial.npz"), want)
    assert_same_npz(read_npz(tmp_path / "serial_state.npz"), want_state)
