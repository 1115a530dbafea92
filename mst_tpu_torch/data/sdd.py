"""The SDD (Stanford Drone Dataset) builder (counterpart of
mst_tpu/data/sdd.py; reference utils/sdd_dataset.py).

Parse each scene's annotations.txt, take the bounding boxes' centres, drop
lost samples, assign global metaIds, window the tracks (the native kernel:
split fragments, downsample, filter short, sliding window) and write the
style-bucket pickles, per agent type or per variation-factor range.

    python -m mst_tpu_torch.data.sdd [--reload] [--varf ...] ...

with mst_tpu.data.sdd's flags and defaults.
"""

import argparse
import os

from mst_tpu_torch import native
from mst_tpu_torch.data.trajectories import (
    add_distance_column,
    create_dataset_by_agent_type,
    create_dataset_given_range,
    get_varf_table,
)

SDD_COLS = ["trackId", "xmin", "ymin", "xmax", "ymax", "frame", "lost",
            "occluded", "generated", "label"]


def load_raw_sdd(path):
    """annotations/<scene>/<videoN>/annotations.txt -> the trajectory
    frame (reference sdd_dataset.py:11-41)."""
    import pandas as pd

    data_path = os.path.join(path, "annotations")
    frames = []
    for scene_main in sorted(os.listdir(data_path)):
        scene_main_path = os.path.join(data_path, scene_main)
        for scene_sub in sorted(os.listdir(scene_main_path)):
            annot = os.path.join(scene_main_path, scene_sub,
                                 "annotations.txt")
            df = pd.read_csv(annot, header=0, names=SDD_COLS, delimiter=" ")
            df["x"] = (df["xmax"] + df["xmin"]) / 2
            df["y"] = (df["ymax"] + df["ymin"]) / 2
            df = df[df["lost"] == 0]
            df = df.drop(columns=["xmin", "xmax", "ymin", "ymax",
                                  "occluded", "generated", "lost"])
            df["sceneId"] = f"{scene_main}_{scene_sub.split('video')[1]}"
            frames.append(df)
    data = pd.concat(frames, ignore_index=True)
    key = data["sceneId"] + "_" + data["trackId"].astype(str).str.zfill(4)
    data["metaId"] = pd.factorize(key)[0]
    return data


def load_and_window_sdd(path, step, window_size, stride):
    """reference sdd_dataset.py:44-50, the windowing in the native kernel
    (trajectories.window_chain is its plain version)."""
    return native.load_and_window_native(load_raw_sdd(path), step,
                                         window_size, stride,
                                         split_fragments=True)


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--additional_data_dir", default="data/sdd/raw")
    parser.add_argument("--raw_data_dir", default="data/sdd/raw")
    parser.add_argument("--raw_data_filename", default="data_8_12_2_5fps.pkl")
    parser.add_argument("--filter_data_dir",
                        default="data/sdd/filter/shortterm")
    parser.add_argument("--reload", action="store_true")
    parser.add_argument("--statistic_only", action="store_true")
    parser.add_argument("--same_group_size", action="store_true",
                        help="scene-balanced subsample every style "
                             "bucket to the smallest bucket's size "
                             "(reduce_group_size)")
    parser.add_argument("--step", default=12, type=int)
    parser.add_argument("--window_size", default=20, type=int)
    parser.add_argument("--stride", default=20, type=int)
    parser.add_argument("--obs_len", default=8, type=int)
    parser.add_argument("--varf", default=None, nargs="+")
    parser.add_argument("--varf_ranges", default=[(0.5, 3.5), (4, 8)])
    parser.add_argument("--labels", default=["Pedestrian", "Biker"],
                        nargs="+")
    parser.add_argument("--selected_scenes", default=None, nargs="+")
    return parser


def build(args, load_and_window):
    """The builders' shared flow (mst_tpu/data/sdd.py:98-132,
    ind.py:124-152): window the raw data (or --reload its pickle), add the
    neighbour distances when a factor needs them, write the windowed pickle
    and its varf table, then the style buckets of --varf."""
    import pandas as pd

    if not args.reload:
        df = load_and_window()
        if args.varf is not None and any(
                "dist" in f or "den" in f for f in args.varf):
            add_distance_column(df)
        df.to_pickle(os.path.join(args.raw_data_dir, args.raw_data_filename))
        varf_table = get_varf_table(df, ["avg_vel", "max_acc"], args.obs_len)
        varf_table.to_pickle(os.path.join(
            args.additional_data_dir,
            args.raw_data_filename.replace("data", "varf")))
    else:
        df = pd.read_pickle(
            os.path.join(args.raw_data_dir, args.raw_data_filename))

    if args.varf is None:
        return
    if args.varf == ["agent_type"]:
        create_dataset_by_agent_type(
            df, args.labels, os.path.join(args.filter_data_dir,
                                          args.varf[0]),
            args.statistic_only, selected_scenes=args.selected_scenes,
            same_group_size=args.same_group_size)
    else:
        out_dir = os.path.join(args.filter_data_dir, "__".join(args.varf),
                               "_".join(args.labels))
        create_dataset_given_range(
            df, args.varf, args.varf_ranges, args.labels, out_dir,
            obs_len=args.obs_len, statistic_only=args.statistic_only,
            same_group_size=args.same_group_size)


def main(argv=None):
    args = get_parser().parse_args(argv)
    args.labels.sort()
    build(args, lambda: load_and_window_sdd(
        args.raw_data_dir, args.step, args.window_size, args.stride))


if __name__ == "__main__":
    main()
