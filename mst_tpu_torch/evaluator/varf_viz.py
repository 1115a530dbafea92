"""Variation-factor distribution figures + long-tail filters (counterpart of
mst_tpu/evaluator/varf_viz.py).

The reference ships a family of data-statistics figures inside
utils/data_utils.py (plot_varf_histograms :542, plot_varf_hist_obs_and_complete
:555, plot_histogram :574, plot_histogram_overlay :586, plot_pairplot :605,
plot_jointplot :632, plot_scene_w_numeric :662) plus the 3-sigma long-tail
filters they share (filter_long_tail_arr/series/df :713-753). They visualize
the motion-style statistics (velocity/acceleration/distance tables from
get_varf_table) that motivate the style-transfer experiments. Same function
names, filenames and filter semantics here; figure styling via seaborn as in
the reference.

All inputs are varf tables (mst_tpu_torch.data.trajectories.get_varf_table):
one row per metaId with 'label', 'scene'/'sceneId' and one column per
variation factor.
"""

import os
import pathlib

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import seaborn as sns  # noqa: E402

# the reference's histogram families restrict 'Mixed' to these two labels
# (data_utils.py:546,605-610)
MIXED_LABELS = ("Pedestrian", "Biker")


# ---------------------------------------------------------------------------
# long-tail filters (reference data_utils.py:713-753)
# ---------------------------------------------------------------------------

def filter_long_tail_arr(arr, n=3):
    """Drop nan/inf, then zeros and values outside mean +- n*std.

    Returns (filtered_array, (mean, std, min, max, p_zero, p_filter)) with
    the stats rounded to 2 decimals; p_zero / p_filter are fractions of the
    ORIGINAL length (reference data_utils.py:713-729).
    """
    n_data = arr.shape[0]
    arr = arr[~np.isnan(arr) & (arr != np.inf)]
    if not arr.shape[0]:
        raise ValueError("stats array is empty")
    mean, std = np.round(np.mean(arr), 2), np.round(np.std(arr), 2)
    lo, hi = np.round(np.min(arr), 2), np.round(np.max(arr), 2)
    p_zero = np.round((arr == 0).sum() / n_data, 2)
    arr = arr[(arr < mean + n * std) & (arr > mean - n * std) & (arr != 0)]
    p_filter = np.round((n_data - arr.shape[0]) / n_data, 2)
    return arr, (mean, std, lo, hi, p_zero, p_filter)


def filter_long_tail_series(series, n=3):
    """Index of rows a long-tail filter would DROP (data_utils.py:731-742)."""
    full_index = series.index
    series = series[~series.isnull() & (series != np.inf)]
    if not series.shape[0]:
        raise ValueError("Series is empty")
    mean, std = np.round(series.mean(), 2), np.round(series.std(), 2)
    kept = series[(series < mean + n * std) & (series > mean - n * std)
                  & (series != 0)]
    return full_index.drop(kept.index)


def filter_long_tail_df(df_varfs, varf_list, n=3):
    """Drop rows long-tailed in ANY listed factor (data_utils.py:744-753).

    Returns (filtered_df, p_filter) with p_filter the dropped fraction
    rounded to 2 decimals.
    """
    import pandas as pd

    idx_out = pd.Index([])
    for varf in varf_list:
        idx_out = idx_out.append(filter_long_tail_series(df_varfs[varf]))
    idx_out = idx_out.unique()
    return df_varfs.drop(idx_out), round(len(idx_out) / df_varfs.shape[0], 2)


# ---------------------------------------------------------------------------
# figure families
# ---------------------------------------------------------------------------

def _save_current(fig, out_dir, filename):
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    path = os.path.join(out_dir, filename)
    # figure-LEVEL seaborn calls (pairplot/jointplot) draw on their own new
    # figure, not the caller's stub — save whatever is current, then close
    # both (the reference leaks the seaborn figure, data_utils.py:628-629)
    cur = plt.gcf()
    plt.savefig(path)
    plt.close(fig)
    if cur is not fig:
        plt.close(cur)
    return path


def _subset_by_label(df, label):
    """Mixed = Pedestrian+Biker, All = everything, else exact label
    (reference data_utils.py:606-611,634-639)."""
    if label == "Mixed":
        return df[df.label.isin(MIXED_LABELS)]
    if label == "All":
        return df
    return df[df.label == label]


def plot_histogram(data, title, out_dir, format="png"):
    """Long-tail-filtered histogram with KDE; the stats land in the title
    (reference data_utils.py:574-584)."""
    fig = plt.figure()
    data, (mean, std, lo, hi, p_zero, p_filter) = filter_long_tail_arr(data)
    sns.histplot(data, kde=True)
    plt.title(f"{title}, \nMean: {mean}, Std: {std}, Min: {lo}, Max: {hi}, "
              f"Zero: {p_zero}, Filter: {p_filter}")
    return _save_current(fig, out_dir, f"{title}.{format}")


def plot_histogram_overlay(data_obs, data_com, title, out_dir, format="png"):
    """Observed vs complete-horizon distributions overlaid
    (reference data_utils.py:586-602)."""
    import pandas as pd

    fig = plt.figure()
    frames = []
    for data, kind in ((data_obs, "observation"), (data_com, "complete")):
        data, _ = filter_long_tail_arr(data)
        d = pd.DataFrame(data[data != 0], columns=["value"])
        d["type"] = kind
        frames.append(d)
    cat = pd.concat(frames, axis=0).reset_index(drop=True)
    sns.histplot(data=cat, x="value", hue="type")
    plt.title(title)
    return _save_current(fig, out_dir, f"{title}.{format}")


def plot_varf_histograms(df_varf, out_dir):
    """One histogram per label (Pedestrian/Biker) + Mixed for the table's
    last column (reference data_utils.py:542-552)."""
    varf = df_varf.columns[-1]
    paths, stats_all = [], np.array([])
    for label, g in df_varf.groupby("label"):
        if label not in MIXED_LABELS:
            continue
        stats = g[varf].to_numpy()
        paths.append(plot_histogram(stats, f"{label}_{varf}", out_dir))
        stats_all = np.append(stats_all, stats)
    paths.append(plot_histogram(stats_all, f"Mixed_{varf}", out_dir))
    return paths


def plot_varf_hist_obs_and_complete(df_varf, out_dir):
    """Element-wise diff histograms + obs/complete overlays per label for a
    table whose last two columns are the observed- and complete-horizon
    statistic (reference data_utils.py:555-571)."""
    varf_obs, varf_com = df_varf.columns[-2], df_varf.columns[-1]
    paths = []
    all_obs, all_com = np.array([]), np.array([])
    for label, g in df_varf.groupby("label"):
        if label not in MIXED_LABELS:
            continue
        obs, com = g[varf_obs].to_numpy(), g[varf_com].to_numpy()
        paths.append(plot_histogram(
            obs - com, f"{label}_{varf_obs}_element_diff", out_dir))
        paths.append(plot_histogram_overlay(
            obs, com, f"{label}_{varf_obs}_distr_diff", out_dir))
        all_obs, all_com = np.append(all_obs, obs), np.append(all_com, com)
    paths.append(plot_histogram(
        all_obs - all_com, f"Mixed_{varf_obs}_element_diff", out_dir))
    paths.append(plot_histogram_overlay(
        all_obs, all_com, f"Mixed_{varf_obs}_distr_diff", out_dir))
    return paths


def plot_pairplot(df_varfs, varf_list, label, title, out_dir, kind="kde",
                  format="png"):
    """Pairwise factor relations colored by scene
    (reference data_utils.py:605-630)."""
    df_label = _subset_by_label(df_varfs, label)
    fig = plt.figure()
    filtered, p_filter = filter_long_tail_df(
        df_label[["metaId", "scene", "label"] + list(varf_list)], varf_list)
    sns.pairplot(data=filtered, hue="scene", vars=varf_list,
                 plot_kws=(dict(s=1) if kind == "scatter" else None),
                 diag_kind="hist", kind=kind)
    return _save_current(fig, out_dir,
                         f"{title}_{label}_{kind}_{p_filter}.{format}")


def plot_jointplot(df_varfs, varf_list, label, title, out_dir, hue,
                   kind="kde", format="png"):
    """Joint distribution per factor pair; falls back to scatter when the
    KDE is singular (reference data_utils.py:632-659 — which lets one
    singular pair downgrade every LATER pair to scatter; the fallback here
    is per-pair, as its docstring intends)."""
    df_label = _subset_by_label(df_varfs, label)
    paths = []
    for i, varf1 in enumerate(varf_list):
        for varf2 in varf_list[i + 1:]:
            fig = plt.figure()
            filtered, p_filter = filter_long_tail_df(
                df_label[["metaId", "scene", "label", varf1, varf2]],
                [varf1, varf2])
            pair_kind = kind
            try:
                sns.jointplot(data=filtered, x=varf1, y=varf2,
                              kind=pair_kind, hue=hue)
            except np.linalg.LinAlgError:
                pair_kind = "scatter"
                sns.jointplot(data=filtered, x=varf1, y=varf2,
                              kind=pair_kind, hue=hue)
            paths.append(_save_current(
                fig, out_dir,
                f"{title}_{hue}_{label}_{varf1}_{varf2}_{pair_kind}_"
                f"{p_filter}.{format}"))
    return paths


def plot_scene_w_numeric(df_varfs, varf, title, out_dir, format="png"):
    """Per-scene 4-row histogram grid (Pedestrian / Biker / both / all) with
    an all-scenes column; scene 'quad' excluded (reference
    data_utils.py:662-710)."""
    filtered, p_filter = filter_long_tail_df(
        df_varfs[["metaId", "scene", "label", varf]], [varf])
    filtered = filtered[filtered.scene != "quad"]
    scenes = filtered.scene.unique()
    n_scene = scenes.shape[0]
    fig, axs = plt.subplots(4, n_scene + 1,
                            figsize=(4 * (n_scene + 1), 16),
                            sharex=True, sharey=True)
    binwidth = filtered[varf].max() / 30

    def hist_rows(data, col):
        ped = data[data.label == "Pedestrian"]
        bik = data[data.label == "Biker"]
        mix = data[data.label.isin(MIXED_LABELS)]
        sns.histplot(data=ped, x=varf, ax=axs[0, col], stat="probability",
                     binwidth=binwidth)
        sns.histplot(data=bik, x=varf, ax=axs[1, col], stat="probability",
                     binwidth=binwidth)
        sns.histplot(data=mix, x=varf, ax=axs[2, col], hue="label",
                     stat="probability", hue_order=["Biker", "Pedestrian"],
                     binwidth=binwidth)
        sns.histplot(data=data, x=varf, ax=axs[3, col], stat="probability",
                     binwidth=binwidth)

    for c, scene in enumerate(scenes):
        axs[0, c].set_title(scene)
        hist_rows(filtered[filtered.scene == scene], c)
    axs[0, -1].set_title("All scenes")
    hist_rows(filtered, -1)
    for r, name in enumerate(["Pedestrian", "Biker", "Pedestrian + Biker",
                              "All agent types"]):
        axs[r, 0].set_ylabel(name)
    plt.tight_layout()
    return _save_current(
        fig, out_dir, f"{title}_scene_w_{varf}_{p_filter}_noquad.{format}")
