"""Offline trajectory tables: the builders' stages (counterpart of
mst_tpu/data/trajectories.py; reference utils/data_utils.py).

Downsampling, fragment splitting, short-trajectory filtering, sliding
windows (the plain version of the native windowing in
mst_tpu_torch/native), variation-factor statistics and the style-bucket
pickles. These are pandas functions that run once, offline, before any
device work; pandas is imported inside them, so the loop and the serving
path, which never import this module, do not need it. Each gives the frame
mst_tpu's gives (tests/test_torch_port_builders.py).
"""

import os
import pathlib

import numpy as np


# ---------------------------------------------------------------------------
# the windowing chain (reference data_utils.py:14-112)
# ---------------------------------------------------------------------------

def downsample(df, step: int):
    """Keep every step-th row per metaId (reference data_utils.py:23-33)."""
    pos = df.groupby("metaId").cumcount()
    return df[pos % step == 0]


def split_fragmented(df):
    """Split tracks at frame gaps (frame_{t+1} - frame_t != 1).

    reference data_utils.py:81-112: each gap starts a new metaId; ids are
    re-factorized in order of appearance.
    """
    import pandas as pd

    df = df.copy()
    diff = df.groupby("metaId")["frame"].diff().fillna(1.0)
    # fragment counter within each metaId: +1 at every gap row
    frag = (diff != 1.0).astype(np.int64)
    frag_idx = frag.groupby(df["metaId"]).cumsum()
    new_id = df["metaId"].astype(str) + "_" + frag_idx.astype(str)
    df["metaId"] = pd.factorize(new_id)[0]
    return df


def filter_short_trajectories(df, threshold: int):
    """Drop metaIds with fewer than threshold rows (data_utils.py:36-48)."""
    counts = df.groupby("metaId")["metaId"].transform("size")
    return df[counts >= threshold]


def sliding_window(df, window_size: int, stride: int):
    """Chunk each metaId into fixed windows (data_utils.py:51-78).

    Emits, per metaId, chunks [i*stride, i*stride + window_size) for
    i in range(n_chunk), re-factorizing metaIds over the chunks, in the
    reference's groupby(metaId).apply row order: by metaId appearance,
    then chunk, then position.
    """
    import pandas as pd

    pos = df.groupby("metaId").cumcount().to_numpy()
    sizes = df.groupby("metaId")["metaId"].transform("size").to_numpy()
    n_chunk = np.maximum((sizes - window_size) // stride + 1, 0)

    pieces = []
    max_chunks = int(n_chunk.max()) if len(n_chunk) else 0
    for i in range(max_chunks):
        start = i * stride
        sel = (pos >= start) & (pos < start + window_size) & (n_chunk > i)
        piece = df[sel].copy()
        piece["__chunk"] = i
        pieces.append(piece)
    if not pieces:
        return df.iloc[0:0].copy()
    out = pd.concat(pieces)
    meta_order = pd.factorize(df["metaId"])[0]
    order_map = pd.Series(meta_order, index=df.index)
    out["__meta_order"] = order_map.loc[out.index].to_numpy()
    out = out.sort_values(["__meta_order", "__chunk"], kind="stable")
    new_id = out["metaId"].astype(str) + "_" + out["__chunk"].astype(str)
    out["metaId"] = pd.factorize(new_id)[0]
    return out.drop(columns=["__chunk", "__meta_order"]).reset_index(
        drop=True)


def window_chain(df, step, window_size, stride, split_fragments=True):
    """The plain version of native.load_and_window_native: split_fragmented
    (SDD), downsample, filter_short_trajectories, sliding_window."""
    if split_fragments:
        df = split_fragmented(df)
    df = downsample(df, step=step)
    df = filter_short_trajectories(df, threshold=window_size)
    return sliding_window(df, window_size=window_size, stride=stride)


# ---------------------------------------------------------------------------
# variation-factor statistics (reference data_utils.py:279-356)
# ---------------------------------------------------------------------------

def _traj_stat(x, y, frame_step, varf, obs_len, dist_col=None):
    op, attr = varf.split("_")
    if not obs_len:
        obs_len = len(x)
    if attr == "vel":
        seq = np.hypot(x[:obs_len - 1] - x[1:obs_len],
                       y[:obs_len - 1] - y[1:obs_len]) / frame_step
    elif attr == "acc":
        vel = np.hypot(x[:obs_len - 1] - x[1:obs_len],
                       y[:obs_len - 1] - y[1:obs_len]) / frame_step
        seq = (vel[:obs_len - 2] - vel[1:obs_len - 1]) / frame_step
    elif attr == "dist":
        seq = np.array([d.min() if not isinstance(d, float) else np.inf
                        for d in dist_col[:obs_len]])
    elif attr.startswith("den"):
        radius = int(attr[3:])
        seq = np.array([
            (d[d < radius]).shape[0] if not isinstance(d, float) else 0
            for d in dist_col[:obs_len]])
    else:
        raise ValueError(f"Cannot compute {attr} statistic")

    if op == "max":
        return np.max(seq)
    if op == "avg":
        return np.mean(seq)
    if op == "min":
        return np.min(seq)
    if op == "abs+max":
        return np.max(np.abs(seq))
    if op in ("abs+avg", "abs+min"):  # the reference maps abs+min to mean
        return np.mean(np.abs(seq))
    if op == "tot":
        return np.sum(seq)
    raise ValueError(f"Cannot compute {op} operation")


def aggregate_per_varf_value(df, varf, obs_len):
    """Per-metaId scalar statistic (+label) (data_utils.py:293-356)."""
    import pandas as pd

    rows = []
    for meta_id, g in df.groupby("metaId", sort=True):
        labels = g["label"].unique()
        if len(labels) != 1:
            raise ValueError(f"metaId {meta_id} has labels {list(labels)}")
        steps = np.unique(np.diff(g["frame"].to_numpy()))
        if len(steps) != 1:
            raise ValueError(f"non-uniform frame step for metaId {meta_id}")
        dist_col = g["dist"].to_numpy() if "dist" in g else None
        stat = _traj_stat(g["x"].to_numpy(), g["y"].to_numpy(), steps[0],
                          varf, obs_len, dist_col)
        rows.append((meta_id, stat, labels[0]))
    return pd.DataFrame(rows, columns=["metaId", varf, "label"])


def get_varf_table(df, varf_list, obs_len):
    """data_utils.py:279-290."""
    df_varfs = (df.groupby(["metaId", "label", "sceneId"]).size()
                .reset_index()[["metaId", "label", "sceneId"]])
    df_varfs["scene"] = df_varfs.sceneId.str.split("_").str[0]
    for varf in varf_list:
        stats = aggregate_per_varf_value(df, varf, obs_len)
        df_varfs = df_varfs.merge(stats[["metaId", varf]], on="metaId")
    return df_varfs


def add_range_column(df, varf, varf_ranges, obs_len, inclusive="both"):
    """data_utils.py:359-364."""
    import pandas as pd

    stats = aggregate_per_varf_value(df, varf, obs_len)
    col = f"{varf}_range"
    stats[col] = pd.NA
    for lo, hi in varf_ranges:
        sel = stats[varf].between(lo, hi, inclusive=inclusive)
        stats.loc[sel, col] = f"{lo}_{hi}"
    return df.merge(stats[["metaId", col]], on="metaId")


def compute_distance_with_neighbors(df_scene, step=12):
    """The distances to co-temporal neighbours per row
    (data_utils.py:520-539): a Series aligned with df_scene.index whose
    entries are np.inf (no neighbour) or an array of distances."""
    import pandas as pd

    frames = df_scene["frame"].to_numpy()
    metas = df_scene["metaId"].to_numpy()
    xs = df_scene["x"].to_numpy()
    ys = df_scene["y"].to_numpy()
    out = []
    for i in range(len(df_scene)):
        fdiff = frames - frames[i]
        sel = (fdiff < step / 2) & (fdiff >= -step / 2) & (metas != metas[i])
        if not sel.any():
            out.append(np.inf)
        else:
            out.append(np.hypot(xs[sel] - xs[i], ys[sel] - ys[i]))
    return pd.Series(out, index=df_scene.index)


def add_distance_column(df):
    """The builders' 'dist' column: compute_distance_with_neighbors per
    scene, written into df in place (mst_tpu/data/sdd.py:105-108)."""
    out = df.groupby("sceneId", group_keys=True).apply(
        compute_distance_with_neighbors)
    for scene in out.index.get_level_values("sceneId").unique():
        df.loc[out[scene].index, "dist"] = out[scene].values
    return df


# ---------------------------------------------------------------------------
# style-bucket pickles (reference data_utils.py:367-517)
# ---------------------------------------------------------------------------

def convert_df_to_dict(df_gb):
    """Per-group {metaId, sceneId, label} lists, one entry per unique
    trajectory (reference data_utils.py:367-374)."""
    out = {}
    for name in df_gb.groups:
        g = df_gb.get_group(name)[
            ["metaId", "sceneId", "label"]].drop_duplicates()
        if g.metaId.nunique() != g.shape[0]:
            raise ValueError(f"group {name}: a metaId has two scenes or "
                             "labels")
        out[name] = g.to_dict("list")
    return out


def reduce_group_size(group, name, min_n):
    """Scene-balanced subsampling of one style group down to min_n
    trajectories (reference data_utils.py:468-517).

    1. Water-fill scene budgets: walk the unique per-scene counts in
       ascending order; scenes at or below the level where the running
       total first reaches min_n are kept whole, larger scenes are capped
       at the previous level, then the remainder is handed out one
       trajectory at a time over the capped scenes in scene order.
    2. Within each scene, labels are picked round-robin and, per label,
       the FIRST budgeted trajectories in group order are kept.

    -> a boolean mask over the group's trajectory lists.
    """
    print(f"Group {name}")
    scene_col = np.asarray(group["sceneId"])
    label_col = np.asarray(group["label"])
    scene_ids, scene_counts = np.unique(scene_col, return_counts=True)

    full = np.zeros(len(scene_ids), dtype=bool)  # scenes kept whole
    total, prev = 0, 0
    for level in np.unique(scene_counts):
        total += (scene_counts >= level).sum() * (level - prev)
        if total >= min_n:
            break
        full[scene_counts == level] = True
        prev = level
    budgets = np.where(full, scene_counts, prev).astype(np.int64)
    capped = np.where(~full)[0]
    while budgets.sum() < min_n and capped.size:
        for i in capped:
            budgets[i] += 1
            if budgets.sum() >= min_n:
                break

    keep = np.zeros(len(scene_col), dtype=bool)
    for s_idx, scene in enumerate(scene_ids):
        in_scene = scene_col == scene
        uniq_labels, counts_left = np.unique(label_col[in_scene],
                                             return_counts=True)
        take = np.zeros(len(uniq_labels), dtype=np.int64)
        chosen = 0
        while chosen < budgets[s_idx]:
            progressed = False
            for li in range(len(uniq_labels)):
                if counts_left[li] > 0:
                    take[li] += 1
                    counts_left[li] -= 1
                    chosen += 1
                    progressed = True
                    if chosen == budgets[s_idx]:
                        break
            if not progressed:  # budget exceeds the scene's population
                break
        for li, lab in enumerate(uniq_labels):
            idx = np.where(in_scene & (label_col == lab))[0][:take[li]]
            keep[idx] = True
    return keep


def _print_group_stats(df_label, df_gb):
    """Per-group trajectory-count statistics (reference
    data_utils.py:384-386, in its per-agent-type form for both builders,
    as mst_tpu prints them)."""
    import pandas as pd

    if not len(df_label):
        print("Statistics:\n", pd.Series(dtype=float))
        return
    n_total = (df_label.metaId == df_label.metaId.unique()[0]).sum()
    per_group = df_gb.count()["metaId"] / n_total
    print("Statistics:\n", per_group)
    print("# total:", per_group.sum())


def _equalize(df_label, df_gb):
    """same_group_size: every group subsampled to the smallest group's
    trajectory count, scene-balanced (reduce_group_size)."""
    groups = convert_df_to_dict(df_gb)
    if not groups:  # nothing to equalize
        return df_label
    min_n = min(len(g["metaId"]) for g in groups.values())
    kept = [np.asarray(g["metaId"])[reduce_group_size(g, name, min_n)]
            for name, g in groups.items()]
    return df_label[df_label.metaId.isin(np.concatenate(kept))]


def create_dataset_by_agent_type(df, labels, out_dir, statistic_only=False,
                                 selected_scenes=None,
                                 same_group_size=False):
    """One .pkl per agent label (data_utils.py:376-412); with
    selected_scenes, one per scene directory and one in the directory of
    the scenes joined by '__'."""
    import pandas as pd

    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    df_label = df[df.label.isin(labels)]
    df_gb = df_label.groupby("label", dropna=True)
    _print_group_stats(df_label, df_gb)
    if statistic_only:
        return
    if same_group_size:
        df_label = _equalize(df_label, df_gb)
    for agent, g in df_label.groupby("label", dropna=True):
        if selected_scenes is None:
            g.to_pickle(os.path.join(out_dir, f"{agent}.pkl"))
        else:
            df_scenes = []
            for scene_id in selected_scenes:
                d = os.path.join(out_dir, scene_id)
                pathlib.Path(d).mkdir(parents=True, exist_ok=True)
                g_scene = g[g.sceneId == scene_id]
                g_scene.to_pickle(os.path.join(d, f"{agent}.pkl"))
                df_scenes.append(g_scene)
            d = os.path.join(out_dir, "__".join(selected_scenes))
            pathlib.Path(d).mkdir(parents=True, exist_ok=True)
            pd.concat(df_scenes).to_pickle(os.path.join(d, f"{agent}.pkl"))


def create_dataset_given_range(df, varf, varf_ranges, labels, out_dir,
                               obs_len, statistic_only=False,
                               inclusive="both", same_group_size=False):
    """One .pkl per variation-factor range (data_utils.py:415-465); with
    several factors, one per combination of their ranges."""
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    df_label = df[df.label.isin(labels)]
    if isinstance(varf_ranges[0], (tuple, list)) and not isinstance(
            varf_ranges[0][0], (tuple, list)):
        v = varf[0] if isinstance(varf, (list, tuple)) else varf
        df_label = add_range_column(df_label, v, varf_ranges, obs_len,
                                    inclusive)
        col = f"{v}_range"
    else:
        for f, r in zip(varf, varf_ranges):
            df_label = add_range_column(df_label, f, r, obs_len, inclusive)
        col = "__".join(varf) + "_range"
        parts = [f + "_range" for f in varf]
        ok = df_label[parts].notna().all(axis=1)
        df_label.loc[ok, col] = df_label.loc[ok, parts].agg("__".join, axis=1)
    df_gb = df_label.groupby(col, dropna=True)
    _print_group_stats(df_label, df_gb)
    if statistic_only:
        return
    if same_group_size:
        df_label = _equalize(df_label, df_gb)
    for rng_name, g in df_label.groupby(col, dropna=True):
        g.to_pickle(os.path.join(out_dir, f"{rng_name}.pkl"))
