"""ETH/UCY in the port against mst_tpu on the CPU: on a synthetic ETH world
(oracle.png class masks and <scene>_H.txt homographies, as
tests/test_eth_e2e.py builds one) the port's batches, homographies and
validation cut equal mst_tpu's; the eval step's ADE/FDE in world and in
pixel coordinates match mst_tpu's within 1e-5 relative on the same weights
and the waypoint draws mst_tpu made; hotel's x/y swap is applied; a
scaling homography scales the metrics; and the train and test CLIs run on
eth with and without --eth_world_coords.
"""

import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from mst_tpu.data.synthetic import make_synthetic_dataset
from mst_tpu.evaluator import metrics as jmetrics
from mst_tpu.models import ynet as jynet
from mst_tpu.train import steps as jsteps
from mst_tpu.train import trainer as jtrainer
from mst_tpu_torch import config, io
from mst_tpu_torch import test as test_cli
from mst_tpu_torch.data.tracks import Tracks
from mst_tpu_torch.evaluator import metrics
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.train import steps, trainer
from mst_tpu_torch.train.__main__ import main as train_main

TOTAL_LEN, OBS_LEN = 12, 4
SCENES = ["eth", "hotel", "students003", "uni_examples"]
# eth and hotel get a homography whose x and y scales differ, so that the
# swap shows; the others a plain scale
HOMOGRAPHIES = {"eth": [[0.05, 0, 1.0], [0, 0.02, -2.0], [0, 0, 1]],
                "hotel": [[0.03, 0.001, 0.5], [0.002, 0.06, 1.5],
                          [0, 0, 1]],
                "students003": np.diag([0.02, 0.02, 1.0]),
                "uni_examples": np.diag([0.04, 0.04, 1.0])}
SMALL = dict(obs_len=OBS_LEN, pred_len=TOTAL_LEN - OBS_LEN, waypoints=[7],
             n_semantic_classes=3, encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], resize_factor=0.5,
             n_goal=4, n_traj=1, batch_size=4, lr=3e-4, seed=1,
             dataset_name="eth", train_net="train", network="original",
             save_every_n=100, segmentation_model_fp=None, use_raw_data=False)
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for torch here: these small shapes gain nothing
    from more, and under pytest-xdist more threads than cores slow every
    worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eth_world(tmp_path_factory):
    """<root>/data/eth/images/<scene>/oracle.png (class ids 0-2),
    <root>/data/eth_ucy/<scene>_H.txt, and the tracks: 8 a scene."""
    root = tmp_path_factory.mktemp("eth_world")
    rng = np.random.default_rng(3)
    df, _ = make_synthetic_dataset(seed=3, n_scenes=len(SCENES), n_traj=8,
                                   total_len=TOTAL_LEN, img_hw=(128, 160))
    df["sceneId"] = df["sceneId"].map(
        {f"synth_{i}": s for i, s in enumerate(SCENES)})
    image_path = root / "data" / "eth" / "images"
    for scene in SCENES:
        d = image_path / scene
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "oracle.png"),
                    rng.integers(0, 3, size=(128, 160)).astype(np.uint8))
    homo = root / "data" / "eth_ucy"
    homo.mkdir(parents=True)
    for scene, mat in HOMOGRAPHIES.items():
        np.savetxt(homo / f"{scene}_H.txt", np.asarray(mat, np.float64))
    return root, str(image_path), df


def params_for(root, side="port", **over):
    p = dict(SMALL, data_dir=str(root / "data"),
             ckpt_path=str(root / side / "ckpts"), **over)
    if side == "jax":
        return p
    return config.get_params("sdd_shortterm_train.yaml",
                             dict(p, device="cpu"))


def test_batches_homographies_and_cut_match_jax(eth_world):
    """prepare_data on the oracle.png masks (one-hot classes), each scene's
    homography with the swap folded in for eth and hotel (also under an
    augmentation suffix), and the validation cut at batch size 10 (the
    first 30 // 10 = 3 scenes)."""
    root, image_path, df = eth_world
    params = params_for(root, batch_size=10)
    port = trainer.Experiment(params)
    jexp = jtrainer.Experiment(params_for(root, "jax", batch_size=10))
    got = port.prepare_data(Tracks.from_frame(df), image_path, "val")
    want = jexp.prepare_data(df, image_path, "val")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.scene_id == b.scene_id
        for f in ("image", "trajectories", "mask", "meta_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.image.shape[-1] == 3 and set(np.unique(a.image)) == {0, 1}
        np.testing.assert_array_equal(a.image.sum(-1)[:64, :80], 1)
    for scene in SCENES + ["hotel_rot90_fliplr", "uni_examples_rot180"]:
        np.testing.assert_array_equal(port._homography_for(scene),
                                      jexp._homography_for(scene))
    items = port._device_batches(got)
    for b, db in items:
        np.testing.assert_array_equal(db["homography"].numpy(),
                                      jexp._homography_for(b.scene_id))
    cut = port._validation_cut(got)
    jcut = jexp._setup_training(df, df, image_path, image_path,
                                np.random.default_rng(0))["val_batches"]
    assert [b.scene_id for b in cut] == [b.scene_id for b in jcut] == \
        SCENES[:3]
    # the cut is eth's: sdd validates on every scene
    sdd = trainer.Experiment(dict(params, dataset_name="sdd"))
    assert sdd._validation_cut(got) == got


def test_hotel_swap_is_applied(eth_world):
    """hotel's matrix takes (y, x): the port's homography is the file's
    with its first two columns swapped, and world coordinates through it
    equal image2world's (both packages'), which swaps the points; the
    plain scenes' matrices are the file's."""
    root, _, _ = eth_world
    port = trainer.Experiment(params_for(root))
    H = np.asarray(HOMOGRAPHIES["hotel"], np.float32)
    np.testing.assert_array_equal(port._homography_for("hotel"),
                                  H[:, [1, 0, 2]])
    np.testing.assert_array_equal(port._homography_for("students003"),
                                  np.diag([0.02, 0.02, 1.0]).astype(
                                      np.float32))
    pts = np.random.default_rng(0).uniform(0, 80, size=(3, 5, 2))
    for scene in ("hotel", "eth", "uni_examples"):
        want = jmetrics.image2world(pts, scene, HOMOGRAPHIES, 0.5)
        np.testing.assert_allclose(
            metrics.image2world(pts, scene, HOMOGRAPHIES, 0.5), want,
            rtol=0, atol=0)
        got = metrics.to_world(torch.tensor(pts, dtype=torch.float64),
                               torch.tensor(port._homography_for(scene),
                                            dtype=torch.float64), 0.5)
        # the port's matrix is f32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    swapped = metrics.image2world(pts[..., ::-1], "students003",
                                  {"students003": H}, 0.5)
    np.testing.assert_allclose(
        metrics.image2world(pts, "hotel", {"hotel": H}, 0.5), swapped)


@pytest.fixture(scope="module")
def eval_pair(eth_world):
    """The same weights and batch in both packages' eval steps (mst_tpu
    unpacked), hotel's homography in the batch, and mst_tpu's waypoint
    draws."""
    root, _, _ = eth_world
    params = params_for(root, eth_world_coords=True)
    mcfg = config.ynet_config(params)
    weights, state = init_ynet(torch.Generator().manual_seed(0), mcfg)
    jweights = io.unflatten(io.params_to_numpy(weights))
    hom = trainer.Experiment(params)._homography_for("hotel")
    rng = np.random.default_rng(4)
    b = {"semantic": np.eye(3, dtype=np.float32)[
            rng.integers(0, 3, size=(1, 64, 96))],
         "traj": rng.uniform(5, 60, size=(4, TOTAL_LEN, 2)).astype(
             np.float32),
         "mask": np.asarray([1, 1, 1, 0], np.float32),
         "homography": hom}
    jmcfg = jynet.YNetConfig(
        obs_len=OBS_LEN, pred_len=TOTAL_LEN - OBS_LEN, n_semantic_classes=3,
        encoder_channels=(8, 8, 16, 16, 16),
        decoder_channels=(16, 16, 16, 8, 8), waypoints=(7,))
    scfg = config.step_config(params)
    assert scfg.world_coords
    jscfg = jsteps.StepConfig(
        obs_len=OBS_LEN, pred_len=TOTAL_LEN - OBS_LEN, waypoints=(7,),
        template_size=scfg.template_size, kernlen=31, nsig=4.0,
        loss_scale=1000.0, resize_factor=0.5, temperature=1.0, n_goal=4,
        n_traj=1, packed_decode=False, world_coords=True)
    key = jax.random.PRNGKey(5)
    jes = jsteps.make_eval_step(jmcfg, jscfg)
    _, jwps = jes.forward(jweights, {}, b, key)
    want = {"world": jes(jweights, {}, b, key),
            "pixel": jsteps.make_eval_step(
                jmcfg, jscfg._replace(world_coords=False))(
                    jweights, {}, b, key)}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    return params, mcfg, weights, state, tb, np.asarray(jwps), want


def score(params, mcfg, weights, state, tb, wps, **scfg_over):
    step = steps.make_eval_step(mcfg, config.step_config(params)._replace(
        **scfg_over))
    feats, _ = step.forward(weights, state, tb,
                            torch.Generator().manual_seed(0))
    return step.decode_and_score(weights, feats, torch.tensor(wps),
                                 tb["traj"], tb["mask"], tb["homography"])


@pytest.mark.parametrize("space", ["world", "pixel"])
def test_metrics_match_jax(eval_pair, space):
    """Fed mst_tpu's waypoint draws, the port's min-over-K ADE and FDE
    (and their masked sums) within 1e-5 relative of mst_tpu's, in world
    coordinates through hotel's homography and in pixels."""
    params, mcfg, weights, state, tb, wps, want = eval_pair
    got = score(params, mcfg, weights, state, tb, wps,
                world_coords=space == "world")
    w = want[space]
    for k in ("ade", "fde", "ade_sum", "fde_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    # world metrics are a few units, pixels tens
    scale = float(got["ade_sum"]) / float(want["pixel"]["ade_sum"])
    assert (scale < 0.2) == (space == "world")


def test_scaling_homography_scales_metrics(eval_pair):
    """Doubling the homography's linear part doubles the world metrics
    (the eval really measures through it); the pixel metrics ignore it."""
    params, mcfg, weights, state, tb, wps, _ = eval_pair
    runs = {}
    for factor in (1.0, 2.0):
        hom = torch.diag(torch.tensor([0.03 * factor, 0.03 * factor, 1.0]))
        b = dict(tb, homography=hom)
        runs[factor] = {w: score(params, mcfg, weights, state, b, wps,
                                 world_coords=w) for w in (True, False)}
    for k in ("ade", "fde"):
        np.testing.assert_allclose(runs[2.0][True][k].numpy(),
                                   2 * runs[1.0][True][k].numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(runs[2.0][False][k].numpy(),
                                      runs[1.0][False][k].numpy())


def test_world_coords_need_the_homography(eval_pair):
    params, mcfg, weights, state, tb, wps, _ = eval_pair
    step = steps.make_eval_step(mcfg, config.step_config(params))
    feats, _ = step.forward(weights, state, tb,
                            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="homography"):
        step.decode_and_score(weights, feats, torch.tensor(wps), tb["traj"],
                              tb["mask"])


# ---------------------------------------------------------------------------
# the CLIs on eth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [True, False])
def test_eth_train_and_test_clis(eth_world, tmp_path, monkeypatch, capsys,
                                 world):
    """python -m mst_tpu_torch.train and .test on the eth world (pickles
    under <data_dir>/eth/<dataset_path>), with and without
    --eth_world_coords: finite metrics, world ones a few units, pixel ones
    tens, the test's rows reading the homographies."""
    root, _, df = eth_world
    monkeypatch.chdir(root)
    ids = df.metaId.unique()
    ddir = root / "data" / "eth" / "split"
    ddir.mkdir(exist_ok=True)
    for name, part in (("train", ids[:16]), ("val", ids[16:24]),
                       ("test", ids[24:])):
        df[df.metaId.isin(part)].to_pickle(ddir / f"{name}.pkl")
    cfg = {k: v for k, v in SMALL.items()
           if k not in ("batch_size", "lr", "seed", "train_net", "network")}
    cfg.update(kernlen=31, nsig=4, loss_scale=1000, temperature=1.0,
               use_TTST=False, rel_threshold=0.01, use_CWS=False,
               CWS_params=None, use_features_only=False, e_unfreeze=10000,
               data_dir="data")
    (tmp_path / "eth.yaml").write_text(yaml.safe_dump(cfg))
    common = ["--config_filename", str(tmp_path / "eth.yaml"),
              "--batch_size", "4", "--dataset_path", "split",
              "--load_data", "predefined", "--device", "cpu", "--seed", "1"]
    common += ["--eth_world_coords"] if world else []
    ckpt = str(tmp_path / "ckpts")
    train_main(config.get_parser(True).parse_args(
        common + ["--n_epoch", "1", "--train_net", "train", "--ckpt_path",
                  ckpt]))
    out = capsys.readouterr().out
    base = os.path.join(ckpt, "Seed_1__split__train__original.npz")
    assert os.path.exists(base)
    test_cli.main(config.get_parser(False).parse_args(
        common + ["--n_round", "2", "--pretrained_ckpt", base]))
    out += capsys.readouterr().out
    ades = [float(a) for a in re.findall(r"Test ADE: ([\d.eE+-]+)", out)]
    val = [float(a) for a in re.findall(r"Val \(Top-k\) ADE: ([\d.]+)", out)]
    assert len(ades) >= 3 and len(val) == 1
    assert all(np.isfinite(ades)) and np.isfinite(val).all()
    if world:
        assert all(0 < a < 10 for a in ades + val)
    else:
        assert all(a > 10 for a in ades + val)
