"""The inD (intersection drone) builder (counterpart of mst_tpu/data/ind.py;
reference utils/inD_dataset.py).

Join the tracks and tracksMeta CSVs, attach the class labels, flip y, drop
points outside the frame, assign global metaIds, window the tracks (the
native kernel; inD tracks are continuous, so no fragment splitting), map
recordings to scenes and convert meters to pixels by orthoPxToMeter.

    python -m mst_tpu_torch.data.ind [--reload] [--varf ...] ...

with mst_tpu.data.ind's flags and defaults.
"""

import argparse
import os

import numpy as np

from mst_tpu_torch import native
from mst_tpu_torch.data.sdd import build

SCENE2REC = {
    1: ["00", "01", "02", "03", "04", "05", "06"],
    2: ["07", "08", "09", "10", "11", "12", "13", "14", "15", "16", "17"],
    3: ["18", "19", "20", "21", "22", "23", "24", "25", "26", "27", "28",
        "29"],
    4: ["30", "31", "32"],
}
REC2SCENE = {rec: f"scene{s}" for s, recs in SCENE2REC.items()
             for rec in recs}
_DROP_COLS = ["trackLifetime", "heading", "width", "length", "xVelocity",
              "yVelocity", "xAcceleration", "yAcceleration", "lonVelocity",
              "latVelocity", "lonAcceleration", "latAcceleration"]


def load_raw_ind(path="inD-dataset-v1.0/data", scenes=(1,), recordings=None):
    """reference inD_dataset.py:10-70."""
    import pandas as pd

    rec_to_load = []
    for scene in scenes:
        rec_to_load.extend(SCENE2REC[scene])
    if recordings is not None:
        rec_to_load = recordings
    frames = []
    for rec in rec_to_load:
        track = pd.read_csv(os.path.join(path, f"{rec}_tracks.csv"))
        track = track.drop(columns=[c for c in _DROP_COLS
                                    if c in track.columns])
        meta = pd.read_csv(os.path.join(path, f"{rec}_tracksMeta.csv"))
        label_by_track = meta.set_index("trackId")["class"]
        track["label"] = track["trackId"].map(label_by_track)
        track["rec&trackId"] = (
            track.recordingId.astype(str) + "_"
            + track.trackId.astype(str).str.zfill(6))
        track["sceneId"] = rec
        track["yCenter"] = -track["yCenter"]
        track = track[(track["yCenter"] >= 0) & (track["xCenter"] >= 0)]
        frames.append(track)
    data = pd.concat(frames, ignore_index=True)
    data["metaId"] = pd.factorize(data["rec&trackId"])[0]
    data = data.drop(columns=["rec&trackId", "recordingId"])
    data = data.rename(columns={"xCenter": "x", "yCenter": "y"})
    return data.reindex(columns=["trackId", "frame", "x", "y", "sceneId",
                                 "metaId", "label"])


def to_pixels(df):
    """Recording -> scene ('recId' keeps the recording) and meters ->
    pixels by each scene's orthoPxToMeter times 12 (reference
    inD_dataset.py:95-107)."""
    df["recId"] = df["sceneId"].copy()
    df["sceneId"] = df["recId"].map(REC2SCENE)
    scale = np.where(df.sceneId == "scene1", 0.0127 * 12, 0.00814 * 12)
    df["x"] = df["x"] / scale
    df["y"] = df["y"] / scale
    return df


def load_and_window_ind(step, window_size, stride, scenes=(1, 2, 3, 4),
                        path="inD-dataset-v1.0/data", recordings=None):
    """reference inD_dataset.py:73-107, the windowing in the native kernel
    without fragment splitting (trajectories.window_chain with
    split_fragments=False is its plain version)."""
    df = load_raw_ind(path=path, scenes=scenes, recordings=recordings)
    return to_pixels(native.load_and_window_native(
        df, step, window_size, stride, split_fragments=False))


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--additional_data_dir",
                        default="data/inD-dataset-v1.0/data")
    parser.add_argument("--raw_data_dir",
                        default="data/inD-dataset-v1.0/data")
    parser.add_argument("--raw_data_filename", default="data_5_30_1fps.pkl")
    parser.add_argument("--filter_data_dir",
                        default="data/inD-dataset-v1.0/filter/longterm")
    parser.add_argument("--reload", action="store_true")
    parser.add_argument("--statistic_only", action="store_true")
    parser.add_argument("--same_group_size", action="store_true",
                        help="scene-balanced subsample every style "
                             "bucket to the smallest bucket's size "
                             "(reduce_group_size)")
    parser.add_argument("--step", default=25, type=int)
    parser.add_argument("--window_size", default=35, type=int)
    parser.add_argument("--stride", default=35, type=int)
    parser.add_argument("--obs_len", default=5, type=int)
    parser.add_argument("--varf", default=["agent_type"], nargs="+")
    parser.add_argument("--varf_ranges", default=[(0.25, 0.7), (1, 3)])
    parser.add_argument("--labels", default=["pedestrian"], nargs="+",
                        choices=["truck_bus", "car", "pedestrian", "bicycle"])
    parser.add_argument("--selected_scenes", default=["scene1"], nargs="+")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    args.labels.sort()
    build(args, lambda: load_and_window_ind(
        args.step, args.window_size, args.stride, scenes=(1, 2, 3, 4),
        path=args.raw_data_dir))


if __name__ == "__main__":
    main()
