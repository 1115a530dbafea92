"""The port's data pipeline and config against mst_tpu on the CPU: the
synthetic tables, the scene-image preprocessing (numpy against cv2), the
augmentation, the scene batches, the dataset splits (the global np.random
stream included), the CLI flags and params, and the experiment-name codec.

The same numpy inputs go through both packages. mst_tpu's DataFrames
become the port's track tables through Tracks.from_frame.
"""

import argparse

import cv2
import numpy as np
import pandas as pd
import pytest

from mst_tpu import config as jconfig
from mst_tpu.data import images as jimages
from mst_tpu.data import scenes as jscenes
from mst_tpu.data import splits as jsplits
from mst_tpu.data import synthetic as jsynthetic
from mst_tpu_torch import config
from mst_tpu_torch.data import images, scenes, splits, synthetic
from mst_tpu_torch.data.tracks import Tracks, unique_in_order
from mst_tpu_torch.models import segmentation

COLUMNS = ("metaId", "sceneId", "frame", "x", "y")
TOTAL = 20


@pytest.fixture(scope="module")
def dataset():
    """mst_tpu's and the port's synthetic data from one seed: 3 scenes of
    12 tracks, 64 x 96 images."""
    kw = dict(seed=3, n_scenes=3, n_traj=12, total_len=TOTAL,
              img_hw=(64, 96))
    return jsynthetic.make_synthetic_dataset(**kw), \
        synthetic.make_synthetic_dataset(**kw)


def assert_table_equals_frame(tracks, df):
    assert len(tracks) == len(df)
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(tracks, c),
                                      np.asarray(df[c]), err_msg=c)


def test_synthetic_matches_jax(dataset):
    (df, jimgs), (tracks, imgs) = dataset
    assert_table_equals_frame(tracks, df)
    assert tracks.metaId.dtype == np.int64
    assert imgs.keys() == jimgs.keys()
    for k in imgs:
        np.testing.assert_array_equal(imgs[k], jimgs[k])


def test_table_from_frame_and_order(dataset):
    (df, _), (tracks, _) = dataset
    assert_table_equals_frame(Tracks.from_frame(df), df)
    shuffled = df.sample(frac=1.0, random_state=0)
    table = Tracks.from_frame(shuffled)
    np.testing.assert_array_equal(table.meta_ids(),
                                  shuffled.metaId.unique())
    assert list(table.scene_ids()) == list(shuffled.sceneId.unique())
    assert len(Tracks.from_frame(pd.DataFrame([]))) == 0
    assert len(unique_in_order(np.zeros(0))) == 0


# ---------------------------------------------------------------------------
# scene images
# ---------------------------------------------------------------------------

def random_images(rng, dtype, shapes):
    out = {}
    for i, shape in enumerate(shapes):
        if dtype == np.uint8:
            out[f"s_{i}"] = rng.integers(0, 256, size=shape, dtype=np.uint8)
        else:
            out[f"s_{i}"] = rng.uniform(0, 1, size=shape).astype(np.float32)
    return out


# raw scene shapes: divisible by 4, and not (the resize's edge cells)
SHAPES = [(192, 256, 3), (201, 263, 3), (131, 97, 3)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("factor", [0.25, 0.33])
def test_preprocess_scene_images_matches_cv2(rng, dtype, factor):
    """INTER_AREA, the zero pad and the normalisation. Exact at SDD's 0.25
    (a box mean) and, with the cv2 these tests run against, at inD's 0.33
    too (the overlap weights summed in cv2's order): tolerance 0 both."""
    raw = random_images(rng, dtype, SHAPES)
    want = jimages.preprocess_scene_images(raw, factor, 32, False, 3)
    got = images.preprocess_scene_images(raw, factor, 32, False, 3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("factor", [0.25, 0.33, 0.5])
def test_resize_matches_cv2_gray_and_four_channels(rng, factor):
    for shape in [(67, 101), (40, 52, 4)]:
        im = rng.integers(0, 256, size=shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            images.resize_area(im, factor),
            cv2.resize(im, (0, 0), fx=factor, fy=factor,
                       interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("factor", [0.25, 0.33])
def test_nearest_masks_match_jax(rng, factor):
    """Segmentation masks: NEAREST resize, pad, one-hot classes: exact."""
    masks = {f"m_{i}": rng.integers(0, 6, size=s[:2], dtype=np.uint8)
             for i, s in enumerate(SHAPES)}
    want = jimages.preprocess_scene_images(masks, factor, 32, True, 6)
    got = images.preprocess_scene_images(masks, factor, 32, True, 6)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resize_rejects_upscaling():
    """Upscaling is ported (test_upscaling_matches_cv2_and_jax); a factor
    that is not positive is still refused."""
    for factor in (0.0, -2.0):
        with pytest.raises(ValueError, match="factor"):
            images.resize_area(np.zeros((8, 8, 3), np.uint8), factor)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("factor", [1.5, 2, 3])
def test_upscaling_matches_cv2_and_jax(rng, dtype, factor):
    """INTER_AREA above a factor of 1 (OpenCV's bilinear emulation, the
    last row read twice and the last column clamped) against cv2.resize
    and mst_tpu's resize_images: exact, on uint8 and f32, gray, three
    and four channels, even and odd sizes."""
    raw = random_images(rng, dtype, [(67, 101, 3), (40, 52), (13, 9, 4)])
    want = jimages.resize_images(raw, factor)
    got = images.resize_images(raw, factor)
    for k, im in raw.items():
        cv = cv2.resize(im, (0, 0), fx=factor, fy=factor,
                        interpolation=cv2.INTER_AREA)
        assert got[k].dtype == cv.dtype and got[k].shape == cv.shape, k
        np.testing.assert_array_equal(got[k], cv, err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pad_matches_jax(rng):
    raw = random_images(rng, np.uint8, SHAPES)
    want = jimages.pad_images(raw, 32)
    got = images.pad_images(raw, 32)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rotation_matches_jax(dataset, k):
    (df, jimgs), (tracks, imgs) = dataset
    rows = df.sceneId == "synth_1"
    want_df, want_im = jimages.rot_df_image(df[rows], jimgs["synth_1"], k)
    got, got_im = images.rot_df_image(
        tracks.take(tracks.sceneId == "synth_1"), imgs["synth_1"], k)
    np.testing.assert_array_equal(got_im, want_im)
    np.testing.assert_allclose(got.x, want_df.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.y, want_df.y, rtol=0, atol=1e-5)


def test_flip_matches_jax(dataset):
    (df, jimgs), (tracks, imgs) = dataset
    want_df, want_im = jimages.fliplr_df_image(df, jimgs["synth_0"])
    got, got_im = images.fliplr_df_image(tracks, imgs["synth_0"])
    np.testing.assert_array_equal(got_im, want_im)
    np.testing.assert_allclose(got.x, want_df.x, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.y, want_df.y)


def test_augment_data_matches_jax(dataset):
    """The same coordinates (1e-5), scene ids and metaIds in the same
    order, and the same pseudo-scene images."""
    (df, jimgs), (tracks, imgs) = dataset
    want_df, want_imgs = jimages.augment_data(df, dict(jimgs))
    got, got_imgs = images.augment_data(tracks, dict(imgs))
    assert len(got) == len(want_df) == 8 * len(df)
    np.testing.assert_array_equal(got.sceneId, np.asarray(want_df.sceneId))
    np.testing.assert_array_equal(got.metaId, np.asarray(want_df.metaId))
    np.testing.assert_allclose(got.x, want_df.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.y, want_df.y, rtol=0, atol=1e-5)
    assert got_imgs.keys() == want_imgs.keys()
    for k in want_imgs:
        np.testing.assert_array_equal(got_imgs[k], want_imgs[k], err_msg=k)


# ---------------------------------------------------------------------------
# batches and splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch_size", [5, 12])
def test_scene_batches_match_jax(dataset, shuffle, batch_size):
    """Identical batches; with shuffle, both shuffles from one seed."""
    (df, jimgs), (tracks, _) = dataset
    kw = dict(total_len=TOTAL, batch_size=batch_size, resize_factor=0.25,
              shuffle=shuffle)
    want = jscenes.make_scene_batches(
        df, jimgs, rng=np.random.default_rng(7), **kw)
    got = scenes.make_scene_batches(
        tracks, jimgs, rng=np.random.default_rng(7), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.scene_id == w.scene_id and g.image is w.image
        np.testing.assert_array_equal(g.trajectories, w.trajectories)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.meta_ids, w.meta_ids)


def test_scene_batches_reject_ragged_tracks(dataset):
    (_, _), (tracks, imgs) = dataset
    with pytest.raises(ValueError, match="divisible"):
        scenes.split_trajectories_by_scene(tracks.take(slice(1, None)),
                                           TOTAL)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory, dataset):
    """The verify skill's on-disk splits: predefined train/val/test
    pickles, and two whole files for the sequential split."""
    (df, _), _ = dataset
    root = tmp_path_factory.mktemp("splits")
    ids = df.metaId.unique()
    df[df.metaId.isin(ids[:20])].to_pickle(root / "train.pkl")
    df[df.metaId.isin(ids[20:28])].to_pickle(root / "val.pkl")
    df[df.metaId.isin(ids[28:])].to_pickle(root / "test.pkl")
    df[df.sceneId != "synth_2"].to_pickle(root / "a.pkl")
    df[df.sceneId == "synth_2"].to_pickle(root / "b.pkl")
    return str(root)


SPLIT_CASES = [
    ("predefined", None, None, "train"),
    ("predefined", 2, None, "train"),
    ("sequential", None, [4, 3], "train"),
    ("sequential", 1.5, [4, 3], "train"),
    ("sequential", None, [0.25, 0.25], "eval"),
]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("load_data,n_train_batch,test_splits,mode",
                         SPLIT_CASES)
def test_prepare_dataset_matches_jax(pickles, load_data, n_train_batch,
                                     test_splits, mode, shuffle):
    """The same metaIds in the same order in each split, with and without
    --shuffle under one np.random.seed (both draw the global stream)."""
    files = ["a.pkl", "b.pkl"]
    args = (pickles, load_data, 4, n_train_batch, files, files, 0.2,
            test_splits, shuffle, False, mode)
    np.random.seed(5)
    want = jsplits.prepare_dataset(*args)
    after_jax = np.random.random()
    np.random.seed(5)
    got = splits.prepare_dataset(*args)
    assert np.random.random() == after_jax
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.meta_ids(), w.metaId.unique())
        assert_table_equals_frame(g, w)


@pytest.mark.parametrize("test_split,share", [(None, False), (6, False),
                                              (6, True), (0.3, True)])
def test_split_by_ratio_matches_jax(dataset, test_split, share):
    """Including the two-way split's swapped names (data_utils.py:806)."""
    (df, _), (tracks, _) = dataset
    np.random.seed(1)
    want = jsplits.dataset_split_by_ratio(df, 8, test_split, True, share)
    np.random.seed(1)
    got = splits.dataset_split_by_ratio(tracks, 8, test_split, True, share)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert_table_equals_frame(g, w)


# ---------------------------------------------------------------------------
# config: flags, params, names
# ---------------------------------------------------------------------------

def flag_table(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("is_train", [True, False])
def test_parser_matches_jax(is_train):
    """The same flags, defaults, choices, nargs and types, plus --device
    (default cuda)."""
    got = flag_table(config.get_parser(is_train))
    want = flag_table(jconfig.get_parser(is_train))
    assert got.pop("device") == ("cuda", ["cuda", "cpu"], None, None)
    assert got == want


PARAM_ARGS = [
    ["--config_filename", "sdd_shortterm_train.yaml"],
    ["--config_filename", "inD_longterm_eval.yaml", "--n_train_batch", "2",
     "--train_net", "mosa_2", "--position", "0", "1"],
    ["--config_filename", "sdd_longterm_train.yaml", "--n_train_batch",
     "1.5", "--fine_tune", "--steps", "3", "5"],
]


@pytest.mark.parametrize("argv", PARAM_ARGS)
def test_get_params_matches_jax(argv):
    """The same merged params (the per-dataset segmentation_model_fp and
    the n_train_batch int rule included), apart from --device."""
    jargs = jconfig.get_parser(True).parse_args(argv)
    args = config.get_parser(True).parse_args(argv)
    want = jconfig.get_params(jargs)
    got = config.get_params(args=args)
    assert got.pop("device") == "cuda"
    assert got == want
    assert type(got["n_train_batch"]) is type(want["n_train_batch"])
    assert vars(args)["n_train_batch"] == vars(jargs)["n_train_batch"]


def test_get_params_overrides_and_filename():
    over = dict(lr=0.5, n_semantic_classes=3)
    got = config.get_params("sdd_shortterm_eval.yaml", over)
    want = jconfig.get_params(config_filename="sdd_shortterm_eval.yaml",
                              overrides=over)
    assert got == want


def test_segmentation_rule(tmp_path):
    """segmentation_model_fp is set for sdd, but the backbone is present
    only when the file exists: then the model config is mst_tpu's (unet,
    16 channels under use_features_only), and a file that is no backbone
    npz raises where it is loaded."""
    params = config.get_params("sdd_shortterm_train.yaml",
                               {"use_features_only": True})
    assert params["segmentation_model_fp"].endswith("sdd_segmentation.npz")
    assert not config.has_backbone(params)
    assert config.ynet_config(params).n_semantic_classes == 6
    seg = tmp_path / "sdd_segmentation.npz"
    seg.write_bytes(b"")
    params["segmentation_model_fp"] = str(seg)
    mcfg = config.ynet_config(params)
    jmcfg = jconfig.ynet_config(params)
    assert (mcfg.segmentation, mcfg.n_semantic_classes) == \
        (jmcfg.segmentation, jmcfg.n_semantic_classes) == ("unet", 16)
    with pytest.raises(ValueError, match="not a backbone npz"):
        segmentation.load_params(str(seg), "cpu")


def name_args(**over):
    d = dict(seed=3, load_data="predefined", dataset_path="filter/avg_vel",
             train_files=["a.pkl", "b.pkl"], train_net="mosa_2",
             position=["0", "3"], n_train_batch=None, lr=0.0005,
             smooth_val=False, n_early_stop=300, n_epoch=100,
             augment=False, ynet_bias=False, network="original",
             n_fusion=None)
    d.update(over)
    return argparse.Namespace(**d)


NAME_CASES = [
    {}, dict(load_data="sequential"), dict(position=[]),
    dict(n_train_batch=2, smooth_val=True, n_early_stop=5, augment=True,
         ynet_bias=True),
    dict(n_train_batch=2.5, lr=3e-05), dict(network="embed"),
    dict(network="fusion", n_fusion=2), dict(train_net="train"),
]


@pytest.mark.parametrize("over", NAME_CASES)
def test_experiment_name_codec_matches_jax(over):
    args = name_args(**over)
    name = config.get_experiment_name(args, 17)
    assert name == jconfig.get_experiment_name(args, 17)
    path = f"ckpts/{name}.npz"
    assert config.get_position(path) == jconfig.get_position(path)
    assert config.get_position(path, False) == jconfig.get_position(path,
                                                                    False)
    if "TrN" in name:
        assert config.get_ckpt_name(path) == jconfig.get_ckpt_name(path)
    params = dict(pretrained_ckpt="ckpts/Seed_1__x__train__embed.npz")
    assert config.update_params_from_ckpt(path, params) == \
        jconfig.update_params_from_ckpt(path, params)


def test_update_params_from_sidecar_and_ckpt_names(tmp_path):
    path = tmp_path / "Seed_1__x__mosa_2__Pos_0__TrN_8__original.npz"
    (tmp_path / (path.name + ".json")).write_text('{"train_net": "mosa_4"}')
    assert config.update_params_from_ckpt(str(path), {}) == \
        jconfig.update_params_from_ckpt(str(path), {}) == \
        {"train_net": "mosa_4"}
    for args in [(["a.npz"], ["A"], None, None),
                 (None, None, "base.npz", [str(path), None])]:
        assert config.get_ckpts_and_names(*args) == \
            jconfig.get_ckpts_and_names(*args)
    with pytest.raises(ValueError, match="No checkpoint"):
        config.get_ckpts_and_names(None, None, None, None)


def test_image_and_data_path(tmp_path):
    (tmp_path / "sdd" / "raw" / "annotations").mkdir(parents=True)
    (tmp_path / "sdd" / "filter").mkdir()
    params = dict(data_dir=str(tmp_path), dataset_name="sdd",
                  dataset_path="filter")
    assert config.get_image_and_data_path(params) == \
        jconfig.get_image_and_data_path(params)
    with pytest.raises(FileNotFoundError, match="data dir"):
        config.get_image_and_data_path(dict(params, dataset_path="nope"))
    with pytest.raises(ValueError, match="Invalid"):
        config.get_image_and_data_path(dict(params, dataset_name="ucy"))
    # eth, which mst_tpu's CLIs do not reach: <data_dir>/eth/images beside
    # the dataset path, as inD's
    (tmp_path / "eth" / "images").mkdir(parents=True)
    (tmp_path / "eth" / "filter").mkdir()
    with pytest.raises(ValueError, match="Invalid"):
        jconfig.get_image_and_data_path(dict(params, dataset_name="eth"))
    assert config.get_image_and_data_path(dict(params, dataset_name="eth")) \
        == (str(tmp_path / "eth" / "images"), str(tmp_path / "eth" /
                                                   "filter"))
