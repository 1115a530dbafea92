"""The port's dataset builders against mst_tpu's on the CPU: the same
synthetic raw files (SDD's annotations.txt with lost rows and fragmented
tracks, inD's tracks and tracksMeta CSVs) go through both packages, and
every frame and pickle must be equal (pd.testing.assert_frame_equal): each
windowing stage, the windowed frame, the varf table, the neighbour
distances, the style-bucket pickles, the splits, the filters and the CLIs'
output trees. Also: the port's native windowing against its pandas chain,
a failed native build raising, and the port's loop reading the port's
pickles into the batches mst_tpu's loop makes of mst_tpu's.
"""

import os
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest

from mst_tpu.data import filter_dataset as jfilter_cli
from mst_tpu.data import generate_varf as jvarf_cli
from mst_tpu.data import ind as jind
from mst_tpu.data import scenes as jscenes
from mst_tpu.data import sdd as jsdd
from mst_tpu.data import split_dataset as jsplit_cli
from mst_tpu.data import splits as jsplits
from mst_tpu.data import trajectories as jT
from mst_tpu_torch import native
from mst_tpu_torch.data import filter_dataset as filter_cli
from mst_tpu_torch.data import generate_varf as varf_cli
from mst_tpu_torch.data import ind, scenes, sdd
from mst_tpu_torch.data import split_dataset as split_cli
from mst_tpu_torch.data import splits
from mst_tpu_torch.data import trajectories as T
from mst_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                          write_sdd_annotations)

STEP, WINDOW, OBS = 2, 8, 3  # the builders' --step/--window_size/--obs_len


def assert_frames_equal(got, want):
    """assert_frame_equal, with the object column 'dist' (arrays of
    distances, or inf) compared element by element."""
    if "dist" in want.columns:
        assert "dist" in got.columns
        for a, b in zip(got["dist"], want["dist"]):
            if isinstance(b, float):
                assert isinstance(a, float) and a == b
            else:
                np.testing.assert_array_equal(a, b)
        got, want = got.drop(columns="dist"), want.drop(columns="dist")
    pd.testing.assert_frame_equal(got, want)


def assert_trees_equal(got_root, want_root):
    """The same files under both roots; pickles equal as frames, other
    files byte for byte."""
    got = sorted(str(p.relative_to(got_root))
                 for p in pathlib.Path(got_root).rglob("*") if p.is_file())
    want = sorted(str(p.relative_to(want_root))
                  for p in pathlib.Path(want_root).rglob("*") if p.is_file())
    assert got == want
    for rel in want:
        a, b = pathlib.Path(got_root, rel), pathlib.Path(want_root, rel)
        if rel.endswith(".pkl"):
            assert_frames_equal(pd.read_pickle(a), pd.read_pickle(b))
        elif not rel.endswith(".csv") and "annotations" not in rel:
            assert a.read_bytes() == b.read_bytes(), rel


def sdd_tracks(seed=0, n_scenes=3, n_traj=12, total_len=24):
    """Three scenes of random walks: labels by metaId % 3, lost rows on the
    odd metaIds, and one even track of each scene 100 samples later than
    the others, so that it has no neighbours."""
    tracks, _ = make_synthetic_dataset(seed=seed, n_scenes=n_scenes,
                                       n_traj=n_traj, total_len=total_len,
                                       img_hw=(120, 160))
    names = {f"synth_{i}": s for i, s in
             enumerate(["alpha_0", "alpha_1", "beta_0"][:n_scenes])}
    late = tracks.metaId % n_traj == n_traj - 2
    return tracks.replace(
        sceneId=np.asarray([names[s] for s in tracks.sceneId], object),
        frame=tracks.frame + 100 * late)


@pytest.fixture(scope="module")
def sdd_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sdd") / "raw"
    # a lost row every 16 raw rows: fragments of 15 rows, 8 samples
    write_sdd_annotations(sdd_tracks(), str(root), step=STEP, lost_every=16)
    return str(root)


IND_COLS = ["trackLifetime", "heading", "width", "length", "xVelocity",
            "yVelocity", "xAcceleration", "yAcceleration", "lonVelocity",
            "latVelocity", "lonAcceleration", "latAcceleration"]


def write_ind(root, recordings, seed=0, n_tracks=3, n_frames=30):
    """inD's <rec>_tracks.csv and <rec>_tracksMeta.csv for each recording:
    random walks in meters (yCenter negative, as in the released files;
    one track enters the frame at its third point) with the classes of the
    builder's choices."""
    rng = np.random.default_rng(seed)
    classes = ["pedestrian", "car", "truck_bus", "bicycle"]
    os.makedirs(root, exist_ok=True)
    for r, rec in enumerate(recordings):
        rows = []
        for track in range(n_tracks):
            x, y = rng.uniform(5, 40), -rng.uniform(5, 30)
            for f in range(n_frames):
                x += rng.normal(0.3, 0.2)
                y += rng.normal(-0.2, 0.2)
                yc = -y if (track == 2 and f < 2) else y
                rows.append(dict(recordingId=int(rec), trackId=track,
                                 frame=f, xCenter=x, yCenter=yc,
                                 **{c: 0.0 for c in IND_COLS}))
        pd.DataFrame(rows).to_csv(os.path.join(root, f"{rec}_tracks.csv"),
                                  index=False)
        pd.DataFrame({"trackId": range(n_tracks),
                      "class": [classes[(r + t) % 4]
                                for t in range(n_tracks)]}).to_csv(
            os.path.join(root, f"{rec}_tracksMeta.csv"), index=False)


@pytest.fixture(scope="module")
def ind_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ind") / "data")
    write_ind(root, list(ind.REC2SCENE))
    return root


@pytest.fixture(scope="module")
def windowed(sdd_root):
    """mst_tpu's windowed SDD frame with the neighbour distances."""
    df = jsdd.load_and_window_sdd(sdd_root, STEP, WINDOW, WINDOW)
    out = df.groupby("sceneId", group_keys=True).apply(
        jT.compute_distance_with_neighbors)
    for scene in out.index.get_level_values("sceneId").unique():
        df.loc[out[scene].index, "dist"] = out[scene].values
    return df


# ---------------------------------------------------------------------------
# the stages and the windowed frames
# ---------------------------------------------------------------------------

def test_sdd_stages_equal_jax(sdd_root):
    """load_raw_sdd, then each stage of the chain on the previous stage's
    frame, then the builder's windowed frame (the native kernel in both)."""
    raw = sdd.load_raw_sdd(sdd_root)
    want = jsdd.load_raw_sdd(sdd_root)
    assert_frames_equal(raw, want)
    assert (raw.metaId.nunique(), raw.sceneId.nunique()) == (36, 3)
    stages = [(T.split_fragmented, jT.split_fragmented, ()),
              (T.downsample, jT.downsample, (STEP,)),
              (T.filter_short_trajectories, jT.filter_short_trajectories,
               (WINDOW,)),
              (T.sliding_window, jT.sliding_window, (WINDOW, 3))]
    df = want
    for port_fn, jax_fn, args in stages:
        got = port_fn(df, *args)
        df = jax_fn(df, *args)
        assert_frames_equal(got, df)
    # the lost rows split the odd tracks
    assert T.split_fragmented(want).metaId.nunique() > want.metaId.nunique()
    windowed = sdd.load_and_window_sdd(sdd_root, STEP, WINDOW, WINDOW)
    assert_frames_equal(windowed,
                        jsdd.load_and_window_sdd(sdd_root, STEP, WINDOW,
                                                 WINDOW))
    assert_frames_equal(windowed, T.window_chain(raw, STEP, WINDOW, WINDOW))
    assert windowed.groupby("metaId").size().eq(WINDOW).all()


def test_ind_stages_equal_jax(ind_root):
    """load_raw_ind and the windowed, scene-mapped, pixel-scaled frame."""
    recs = ["00", "01", "07", "18"]
    raw = ind.load_raw_ind(ind_root, recordings=recs)
    assert_frames_equal(raw, jind.load_raw_ind(ind_root, recordings=recs))
    got = ind.load_and_window_ind(4, 6, 6, path=ind_root, recordings=recs)
    want = jind.load_and_window_ind(4, 6, 6, path=ind_root, recordings=recs)
    assert_frames_equal(got, want)
    assert set(got.sceneId) == {"scene1", "scene2", "scene3"}
    chain = ind.to_pixels(T.window_chain(raw, 4, 6, 6,
                                         split_fragments=False))
    assert_frames_equal(got, chain)


def test_varf_table_and_distances_equal_jax(sdd_root, windowed):
    """compute_distance_with_neighbors' 'dist' column and the varf table
    over every statistic kind."""
    df = sdd.load_and_window_sdd(sdd_root, STEP, WINDOW, WINDOW)
    T.add_distance_column(df)
    assert_frames_equal(df, windowed)
    assert any(isinstance(d, float) for d in df["dist"])
    assert any(not isinstance(d, float) for d in df["dist"])
    varfs = ["avg_vel", "max_acc", "min_dist", "avg_den50", "abs+max_acc",
             "tot_vel"]
    assert_frames_equal(T.get_varf_table(df, varfs, OBS),
                        jT.get_varf_table(windowed, varfs, OBS))
    assert_frames_equal(T.add_range_column(df, "avg_vel", [(0, 2), (2, 9)],
                                           OBS),
                        jT.add_range_column(windowed, "avg_vel",
                                            [(0, 2), (2, 9)], OBS))


# ---------------------------------------------------------------------------
# the style-bucket pickles, splits and filters
# ---------------------------------------------------------------------------

LABELS = ["Biker", "Car", "Pedestrian"]


@pytest.mark.parametrize("builder,kwargs", [
    ("agent_type", dict(labels=LABELS)),
    ("agent_type", dict(labels=LABELS, same_group_size=True)),
    ("agent_type", dict(labels=["Biker", "Pedestrian"],
                        selected_scenes=["alpha_0", "beta_0"])),
    ("range", dict(varf="avg_vel", varf_ranges=[(0, 1.5), (1.5, 9)],
                   labels=LABELS)),
    ("range", dict(varf="avg_vel", varf_ranges=[(0, 1.5), (1.5, 9)],
                   labels=LABELS, same_group_size=True)),
    ("range", dict(varf=["avg_vel", "max_acc"],
                   varf_ranges=[[(0, 1.5), (1.5, 9)], [(-9, 0), (0, 9)]],
                   labels=LABELS)),
], ids=["agent", "agent-same", "agent-scenes", "range", "range-same",
        "range-two"])
def test_bucket_pickles_equal_jax(tmp_path, windowed, capsys, builder,
                                  kwargs):
    """create_dataset_by_agent_type and create_dataset_given_range, with
    same_group_size off and on: the same pickles and the same printed
    statistics."""
    outs = {}
    for side, mod in (("port", T), ("jax", jT)):
        out_dir = str(tmp_path / side)
        if builder == "agent_type":
            mod.create_dataset_by_agent_type(windowed.copy(),
                                             out_dir=out_dir, **kwargs)
        else:
            mod.create_dataset_given_range(windowed.copy(), out_dir=out_dir,
                                           obs_len=OBS, **kwargs)
        outs[side] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    n = len(list((tmp_path / "port").rglob("*.pkl")))
    assert n >= 2
    if kwargs.get("same_group_size"):
        sizes = {pd.read_pickle(p).metaId.nunique()
                 for p in (tmp_path / "port").rglob("*.pkl")}
        assert len(sizes) == 1


def test_splits_and_filters_equal_jax(tmp_path, windowed, capsys):
    """split_train_val_test_randomly, filter_dataset_by_varf,
    filter_by_varf_table, dataset_split_given_scenes and
    separate_data_label."""
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        windowed.to_pickle(d / "all.pkl")
        jT.get_varf_table(windowed, ["avg_vel"], OBS).to_pickle(
            d / "varf.pkl")
    for side, mod in (("port", splits), ("jax", jsplits)):
        d = str(tmp_path / side)
        mod.split_train_val_test_randomly(d, "all.pkl", 0.2, 3, seed=1)
        mod.filter_dataset_by_varf(f"{d}/all.pkl", f"{d}/fast.pkl",
                                   "avg_vel", 1.5, 9, OBS)
        mod.filter_by_varf_table(f"{d}/all.pkl", f"{d}/varf.pkl",
                                 lower_bound=1.0)
        mod.filter_by_varf_table(f"{d}/all.pkl", f"{d}/varf.pkl",
                                 upper_bound=2.0, out_path=f"{d}/slow.pkl")
    capsys.readouterr()
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    parts = [pd.read_pickle(tmp_path / "port" / "all" / f"{n}.pkl")
             for n in ("train", "val", "test")]
    assert [p.metaId.nunique() for p in parts] == [
        windowed.metaId.nunique() - 3 - int(0.2 * windowed.metaId.nunique()),
        int(0.2 * windowed.metaId.nunique()), 3]
    d = str(tmp_path / "port")
    assert_frames_equal(
        splits.dataset_split_given_scenes(d, ["all.pkl"], ["alpha_1"]),
        jsplits.dataset_split_given_scenes(d, ["all.pkl"], ["alpha_1"]))
    ranged = jT.add_range_column(windowed, "avg_vel", [(0, 1.5), (1.5, 9)],
                                 OBS).rename(
        columns={"avg_vel_range": "vel_range"}).dropna(subset="vel_range")
    for got, want in zip(splits.separate_data_label(ranged),
                         jsplits.separate_data_label(ranged), strict=True):
        assert_frames_equal(got, want)


# ---------------------------------------------------------------------------
# the CLIs, in scripts/sdd/preprocessing.sh's order, and inD's builder
# ---------------------------------------------------------------------------

SDD_FLOW = [
    ("sdd", ["--step", str(STEP), "--window_size", str(WINDOW), "--stride",
             str(WINDOW), "--obs_len", str(OBS)]),
    ("sdd", ["--reload", "--varf", "agent_type", "--labels", "Pedestrian",
             "Biker"]),
    ("sdd", ["--reload", "--varf", "agent_type", "--labels", "Biker",
             "--selected_scenes", "alpha_0", "beta_0"]),
    ("split_dataset", ["--data_dir",
                       "data/sdd/filter/shortterm/agent_type/alpha_0",
                       "--data_filename", "Biker.pkl", "--val_split", "2",
                       "--test_split", "0.2", "--seed", "1"]),
    ("sdd", ["--reload", "--varf", "agent_type", "--labels", "Pedestrian",
             "Biker", "Car", "--same_group_size", "--filter_data_dir",
             "data/sdd/filter/same"]),
    ("sdd", ["--reload", "--raw_data_dir",
             "data/sdd/filter/shortterm/agent_type", "--raw_data_filename",
             "Biker.pkl", "--varf", "avg_vel", "--labels", "Biker",
             "--obs_len", str(OBS)]),
    ("filter_dataset", ["--data_path",
                        "data/sdd/filter/shortterm/agent_type/Pedestrian.pkl",
                        "--varf_path", "data/sdd/raw/varf_8_12_2_5fps.pkl",
                        "--lower_bound", "0.2"]),
    ("filter_dataset", ["--data_path",
                        "data/sdd/filter/shortterm/agent_type/Biker.pkl",
                        "--varf", "max_acc", "--lower", "-1", "--upper", "1",
                        "--obs_len", str(OBS)]),
    ("split_dataset", ["--data_dir", "data/sdd/filter/shortterm/agent_type",
                       "--data_filename", "Pedestrian_filter.pkl"]),
    ("generate_varf", ["--raw_data_dir", "data/sdd/raw",
                       "--raw_data_filename", "data_8_12_2_5fps.pkl",
                       "--varf", "avg_vel", "max_acc", "--obs_len",
                       str(OBS)]),
    ("sdd", ["--raw_data_filename", "data_dist.pkl", "--step", str(STEP),
             "--window_size", str(WINDOW), "--stride", str(WINDOW),
             "--obs_len", str(OBS), "--varf", "min_dist", "--labels",
             "Pedestrian", "Biker", "--filter_data_dir",
             "data/sdd/filter/dist"]),
    ("ind", ["--raw_data_dir", "data/ind", "--additional_data_dir",
             "data/ind", "--step", "4", "--window_size", "6", "--stride",
             "6", "--obs_len", str(OBS), "--labels", "pedestrian", "car",
             "--selected_scenes", "scene1", "scene2", "--filter_data_dir",
             "data/ind/filter"]),
    ("ind", ["--reload", "--raw_data_dir", "data/ind",
             "--raw_data_filename", "data_5_30_1fps.pkl", "--varf",
             "avg_vel", "--labels", "pedestrian", "car", "truck_bus",
             "--obs_len", str(OBS), "--filter_data_dir", "data/ind/filter"]),
]
PORT_CLIS = {"sdd": sdd.main, "ind": ind.main, "split_dataset":
             split_cli.main, "filter_dataset": filter_cli.main,
             "generate_varf": varf_cli.main}
JAX_CLIS = {"sdd": jsdd.main, "ind": jind.main, "split_dataset":
            jsplit_cli.main, "filter_dataset": jfilter_cli.main,
            "generate_varf": jvarf_cli.main}


def test_cli_trees_equal_jax(tmp_path, monkeypatch, sdd_root, ind_root,
                             capsys):
    """The builder CLIs, run in the preprocessing script's order (build,
    agent-type buckets, scene buckets, a split, equal-size buckets, speed
    buckets of a bucket, both filters, a split of a filtered pickle, a varf
    table, a distance build) and inD's build and speed buckets, from the
    same raw files in two working directories: the same output trees."""
    import shutil

    for side in ("port", "jax"):
        shutil.copytree(sdd_root, tmp_path / side / "data/sdd/raw")
        shutil.copytree(ind_root, tmp_path / side / "data/ind")
    printed = {}
    for side, clis in (("port", PORT_CLIS), ("jax", JAX_CLIS)):
        monkeypatch.chdir(tmp_path / side)
        for name, argv in SDD_FLOW:
            if side == "port":
                clis[name](argv)
            else:
                monkeypatch.setattr(sys, "argv", [name, *argv])
                clis[name]()
        printed[side] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    out = tmp_path / "port" / "data"
    for rel in ("sdd/raw/data_8_12_2_5fps.pkl", "sdd/raw/varf_8_12_2_5fps.pkl",
                "sdd/filter/shortterm/agent_type/alpha_0/Biker/train.pkl",
                "sdd/filter/shortterm/agent_type/alpha_0__beta_0/Biker.pkl",
                "sdd/filter/shortterm/agent_type/Pedestrian_filter/test.pkl",
                "sdd/filter/shortterm/avg_vel/Biker/0.5_3.5.pkl",
                "sdd/filter/shortterm/agent_type/Biker_filter.pkl",
                "sdd/raw/df_varfs.pkl", "sdd/raw/data_dist.pkl",
                "ind/data_5_30_1fps.pkl",
                "ind/filter/agent_type/scene1__scene2/car.pkl",
                "ind/filter/avg_vel/car_pedestrian_truck_bus/1_3.pkl"):
        assert (out / rel).exists(), rel
    assert "dist" in pd.read_pickle(out / "sdd/raw/data_dist.pkl").columns


# ---------------------------------------------------------------------------
# the native kernel
# ---------------------------------------------------------------------------

def native_frame(rng, n_tracks=7, max_len=60, gap_prob=0.1):
    """tests/test_native.py's table: tracks with random frame gaps."""
    rows = []
    for m in range(n_tracks):
        f = 0
        for _ in range(rng.integers(5, max_len)):
            rows.append(dict(metaId=m, frame=f, x=rng.uniform(0, 100),
                             y=rng.uniform(0, 100), sceneId="s", label="P"))
            f += 1 + (rng.uniform() < gap_prob) * rng.integers(1, 4)
    return pd.DataFrame(rows)


@pytest.mark.parametrize("split,step,window,stride", [
    (True, 2, 5, 5), (True, 3, 4, 2), (False, 2, 5, 5), (True, 1, 8, 8),
])
def test_native_matches_pandas_chain(rng, split, step, window, stride):
    """The port's native windowing equals its pandas chain, frame for
    frame (tests/test_native.py's cases)."""
    df = native_frame(rng)
    got = native.load_and_window_native(df, step, window, stride,
                                        split_fragments=split)
    want = T.window_chain(df, step, window, stride, split_fragments=split)
    assert len(got) > 0
    assert_frames_equal(got, want)


def test_native_gather_xy(rng):
    x, y = rng.uniform(size=100), rng.uniform(size=100)
    idx = rng.integers(0, 100, size=(6, 10))
    np.testing.assert_array_equal(
        native.gather_xy(x, y, idx),
        np.stack([x[idx], y[idx]], axis=-1).astype(np.float32))


@pytest.mark.parametrize("call", [
    lambda: native.window_trajectories([0, 0], [0], 1, 2, 2),
    lambda: native.window_trajectories([0, 0], [0, 1], 0, 2, 2),
    lambda: native.window_trajectories([0, 0], [0, 1], 1, 2, 0),
    lambda: native.gather_xy(np.zeros(3), np.zeros(3), [[0, 3]]),
    lambda: native.gather_xy(np.zeros(3), np.zeros(2), [[0, 1]]),
], ids=["lengths", "step", "stride", "index", "xy"])
def test_native_rejects_bad_arguments(call):
    """Arguments the C++ would read past its buffers with (or divide by 0
    with) raise before any pointer is passed."""
    with pytest.raises(ValueError):
        call()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that does not exist, and one that fails, raise with what
    went wrong; nothing falls back to pandas."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.window_trajectories([0, 0], [0, 1], 1, 2, 2)
    fake = tmp_path / "failing-g++"
    fake.write_text("#!/bin/sh\necho 'error: broken toolchain' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="broken toolchain"):
        native.load_and_window_native(
            pd.DataFrame({"metaId": [0, 0], "frame": [0, 1]}), 1, 2, 2)
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the loop reads the builders' pickles
# ---------------------------------------------------------------------------

def test_loop_reads_port_pickles_as_jax(tmp_path, monkeypatch, sdd_root,
                                        capsys):
    """The port's sdd and split_dataset CLIs write train/val/test pickles;
    the port's loop (prepare_dataset, make_scene_batches) reads them into
    the batches mst_tpu's loop makes of mst_tpu's pickles."""
    import shutil

    flow = [("sdd", SDD_FLOW[0][1]),
            ("sdd", ["--reload", "--varf", "agent_type", "--labels",
                     "Pedestrian", "Biker", "Car"]),
            ("split_dataset", ["--data_dir",
                               "data/sdd/filter/shortterm/agent_type",
                               "--data_filename", "Pedestrian.pkl",
                               "--val_split", "2", "--test_split", "2"])]
    for side, clis in (("port", PORT_CLIS), ("jax", JAX_CLIS)):
        shutil.copytree(sdd_root, tmp_path / side / "data/sdd/raw")
        monkeypatch.chdir(tmp_path / side)
        for name, argv in flow:
            if side == "port":
                clis[name](argv)
            else:
                monkeypatch.setattr(sys, "argv", [name, *argv])
                clis[name]()
    capsys.readouterr()
    rel = "data/sdd/filter/shortterm/agent_type/Pedestrian"
    got = splits.prepare_dataset(str(tmp_path / "port" / rel), "predefined",
                                 4, None, None, None, None, None, False,
                                 False)
    want = jsplits.prepare_dataset(str(tmp_path / "jax" / rel), "predefined",
                                   4, None, None, None, None, None, False,
                                   False)
    rng = np.random.default_rng(0)
    images = {s: rng.uniform(size=(32, 48, 3)).astype(np.float32)
              for s in ("alpha_0", "alpha_1", "beta_0")}
    n = 0
    for tracks, df in zip(got, want, strict=True):
        ours = scenes.make_scene_batches(tracks, images, WINDOW, 4, 0.5,
                                         shuffle=True,
                                         rng=np.random.default_rng(1))
        theirs = jscenes.make_scene_batches(df, images, WINDOW, 4, 0.5,
                                            shuffle=True,
                                            rng=np.random.default_rng(1))
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert a.scene_id == b.scene_id
            for f in ("trajectories", "mask", "meta_ids", "image"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            n += int(a.mask.sum())
    assert n == sum(len(t.meta_ids()) for t in got)
