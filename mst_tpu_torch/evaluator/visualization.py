"""Plot library (counterpart of mst_tpu/evaluator/visualization.py, every
public function under its name and file names; reference
evaluator/visualization.py). Params trees may be the port's (tensors,
OIHW convs) or mst_tpu's (numpy, HWIO); kernels are drawn HWIO.

Covers the analysis figures the reference tooling produces: few-shot ADE
curves, trajectory/prediction overlays on scene images, goal-map heatmaps,
importance bars, training curves. Matplotlib with the Agg backend; every
function writes png files under out_dir and returns the figure paths.
"""

import os
import pathlib

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _save(fig, out_dir, name, fmt="png"):
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.{fmt}")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return path


def plot_fewshot_curves(df, out_dir, metric="ade",
                        x_col="n_train", hue_col="train_net",
                        title="few-shot adaptation"):
    """ADE/FDE vs number of adaptation samples, one line per strategy
    (reference visualization.py:34-81)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, g in df.groupby(hue_col):
        g = g.sort_values(x_col)
        agg = g.groupby(x_col)[metric].agg(["mean", "std"])
        ax.errorbar(agg.index, agg["mean"], yerr=agg["std"].fillna(0),
                    marker="o", capsize=3, label=str(name))
    ax.set_xlabel("# adaptation samples")
    ax.set_ylabel(metric.upper())
    ax.set_title(title)
    ax.legend()
    return _save(fig, out_dir, f"fewshot_{metric}")


def plot_trajectories_on_scene(image, trajectories, out_dir, name,
                               obs_len=None, preds=None, gt_color="C0",
                               pred_color="C3"):
    """Observed/GT trajectories (and optional predictions) over the scene
    image (reference plot_given_trajectories_scenes_overlay /
    plot_prediction, visualization.py:966-1151)."""
    fig, ax = plt.subplots(figsize=(7, 7))
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[-1] == 3:
        ax.imshow(img[..., ::-1] if img.dtype == np.uint8 else img)
    else:
        ax.imshow(img, cmap="gray")
    for i, traj in enumerate(np.asarray(trajectories)):
        ax.plot(traj[:, 0], traj[:, 1], "-", color=gt_color, lw=1.2,
                label="groundtruth" if i == 0 else None)
        if obs_len:
            ax.plot(traj[:obs_len, 0], traj[:obs_len, 1], "-", color="k",
                    lw=1.2, label="observed" if i == 0 else None)
        ax.scatter(traj[-1, 0], traj[-1, 1], s=12, color=gt_color)
    if preds is not None:
        for i, traj in enumerate(np.asarray(preds)):
            ax.plot(traj[:, 0], traj[:, 1], "--", color=pred_color, lw=1.2,
                    label="prediction" if i == 0 else None)
    ax.legend(loc="upper right")
    ax.set_axis_off()
    return _save(fig, out_dir, name)


def plot_goal_map(goal_map, out_dir, name, points=None):
    """Sigmoid goal-probability heatmap with optional sampled points
    (reference visualize_activation.py:66-106)."""
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(goal_map), cmap="viridis")
    if points is not None:
        pts = np.asarray(points).reshape(-1, 2)
        ax.scatter(pts[:, 0], pts[:, 1], s=10, c="r", marker="x")
    ax.set_axis_off()
    return _save(fig, out_dir, name)


def plot_importance(df, out_dir, name="importance", group_col="group",
                    metric="ade", baseline_group="none"):
    """Bar chart of metric change per swapped/zeroed parameter group
    (reference visualization.py:1386-1547)."""
    base = df[df[group_col] == baseline_group][metric]
    base = float(base.iloc[0]) if len(base) else 0.0
    rest = df[df[group_col] != baseline_group]
    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(rest)), 4))
    ax.bar(rest[group_col].astype(str), rest[metric] - base)
    ax.axhline(0, color="k", lw=0.8)
    ax.set_ylabel(f"Δ{metric.upper()} vs {baseline_group} ({base:.2f})")
    ax.tick_params(axis="x", rotation=75)
    return _save(fig, out_dir, name)


def plot_training_curves(val_ade, val_fde, out_dir, name="training_curve",
                         window=1):
    """Val metric curves, optionally moving-averaged (reference
    utils/extract_training_curve.py:33-120)."""
    fig, ax = plt.subplots(figsize=(6, 4))

    def smooth(xs):
        xs = np.asarray(xs, float)
        if window <= 1:
            return xs
        kernel = np.ones(window) / window
        return np.convolve(xs, kernel, mode="valid")

    ax.plot(smooth(val_ade), label="val ADE")
    ax.plot(smooth(val_fde), label="val FDE")
    ax.set_xlabel("epoch")
    ax.legend()
    return _save(fig, out_dir, name)


def plot_input_space(semantic, observed_map, out_dir, name="input_space"):
    """Tile the semantic channels + motion heatmap channels (reference
    plot_input_space, visualization.py:83+)."""
    sem = np.asarray(semantic)
    obs = np.asarray(observed_map)
    n = sem.shape[-1] + obs.shape[-1]
    cols = min(n, 6)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(sem.shape[-1]):
        axes[i].imshow(sem[..., i])
        axes[i].set_title(f"sem[{i}]", fontsize=7)
    for j in range(obs.shape[-1]):
        axes[sem.shape[-1] + j].imshow(obs[..., j])
        axes[sem.shape[-1] + j].set_title(f"obs[{j}]", fontsize=7)
    for ax in axes:
        ax.set_axis_off()
    return _save(fig, out_dir, name)


# ---------------------------------------------------------------------------
# few-shot results-directory reader (reference visualization.py:34-81)
# ---------------------------------------------------------------------------

def create_few_shot_plot(results_dir, out_dir, fontsize=14, fmt="png"):
    """ADE vs #batches from the csv tree the eval tooling writes:
    <results_dir>/<update_mode>/<seed>/<num>.csv. The zero-shot point
    comes from the reference's exact path construction
    (visualization.py:52-56): results_dir's second-to-last component
    replaced with 'None', then eval/<seed>/0.csv appended — so for
    results_dir = <exp>/<family> it reads <exp>/None/eval/<seed>/0.csv."""
    import pandas as pd

    ades = {}
    for update_mode in sorted(os.listdir(results_dir)):
        mode_dir = os.path.join(results_dir, update_mode)
        if not os.path.isdir(mode_dir):
            continue
        ades[update_mode] = {}
        for seed in os.listdir(mode_dir):
            seed_dir = os.path.join(mode_dir, seed)
            for num_file in os.listdir(seed_dir):
                if not num_file.endswith(".csv"):
                    continue
                num = int(num_file.split(".csv")[0])
                ade = float(pd.read_csv(
                    os.path.join(seed_dir, num_file)).values[0][0])
                ades[update_mode].setdefault(num, []).append(ade)
            # byte-for-byte the reference's zero-shot path construction
            # (visualization.py:52-56): replace results_dir's second-to-
            # last component with 'None' and append eval/<seed>/0.csv
            zero = results_dir.split("/")
            if len(zero) >= 2:
                zero[-2] = "None"
            zero_path = "/".join(zero + ["eval", seed, "0.csv"])
            if os.path.isfile(zero_path):
                ade = float(pd.read_csv(zero_path).values[0][0])
                ades[update_mode].setdefault(0, []).append(ade)

    fig, ax = plt.subplots(figsize=(6, 4))
    for mode, vals in ades.items():
        xs = sorted(vals)
        means = [np.mean(vals[x]) for x in xs]
        stds = [np.std(vals[x]) for x in xs]
        ax.errorbar(xs, means, yerr=stds, marker="o", capsize=3, label=mode)
    ax.set_xlabel("# Batches", fontsize=fontsize)
    ax.set_ylabel("ADE", fontsize=fontsize)
    ax.legend(fontsize=fontsize - 2)
    ax.xaxis.get_major_locator().set_params(integer=True)
    return _save(fig, out_dir, "result", fmt)


# ---------------------------------------------------------------------------
# feature space (reference visualization.py:612-896)
# ---------------------------------------------------------------------------

def _channel_grid(arr_hwc, axes_row):
    for c in range(arr_hwc.shape[-1]):
        axes_row[c].imshow(arr_hwc[..., c])
        axes_row[c].set_xticks([])
        axes_row[c].set_yticks([])
        axes_row[c].set_xlabel(f"channel_{c + 1}", fontsize=6)


def plot_feature_space(dict_features, out_dir="figures/feature_space",
                       show_diff=True, fmt="png", max_channels=16):
    """Per-sample feature maps, per checkpoint or as OODG-minus-tuned diffs.

    dict_features: {ckpt_name: {scene_id: {feature_name: (B,H,W,C) array,
    'metaId': list}}} — the capture_activations output contract
    (reference plot_feature_space, visualization.py:612-710; NHWC here).
    """
    paths = []
    ckpts = list(dict_features)
    first = dict_features[ckpts[0]]
    for scene_id, dict_scene in first.items():
        feature_names = [k for k in dict_scene if k != "metaId"]
        for i, meta_id in enumerate(dict_scene["metaId"]):
            for fname in feature_names:
                if show_diff and "OODG" in dict_features:
                    rows = {c: (dict_features["OODG"][scene_id][fname][i]
                                - dict_features[c][scene_id][fname][i])
                            for c in ckpts if c != "OODG"
                            and c in dict_features}
                    suffix = "_diff"
                else:
                    rows = {c: dict_features[c][scene_id][fname][i]
                            for c in ckpts}
                    suffix = ""
                if not rows:
                    continue
                n_ch = min(next(iter(rows.values())).shape[-1],
                           max_channels)
                fig, axes = plt.subplots(
                    len(rows), n_ch,
                    figsize=(1.6 * n_ch, 1.6 * len(rows)), squeeze=False)
                for k, (ckpt, arr) in enumerate(rows.items()):
                    _channel_grid(np.asarray(arr)[..., :n_ch], axes[k])
                    axes[k][0].set_ylabel(ckpt, fontsize=7)
                axes[0][n_ch // 2].set_title(
                    f"meta_id={meta_id}, scene_id={scene_id}, "
                    f"feature={fname}", fontsize=7)
                paths.append(_save(
                    fig, out_dir,
                    f"{meta_id}__{scene_id}__{fname}{suffix}", fmt))
    return paths


def plot_feature_space_diff_evolution(
        dict_features, out_dir="figures/feature_space_diff",
        encoder_only=False, diff_type="absolute", fmt="png"):
    """Layer-wise mean |OODG - tuned| feature difference, one line per
    tuned checkpoint (reference visualization.py:710-896). Also writes the
    per-layer table as csv. diff_type: absolute | relative."""
    import pandas as pd

    rows = []
    for ckpt in dict_features:
        if ckpt == "OODG" or "OODG" not in dict_features:
            continue
        for scene_id, dict_scene in dict_features["OODG"].items():
            feature_names = [k for k in dict_scene if k != "metaId"]
            if encoder_only:
                feature_names = [f for f in feature_names
                                 if "encoder" in f.lower()]
            for fname in feature_names:
                a = np.asarray(dict_scene[fname], dtype=np.float64)
                b = np.asarray(dict_features[ckpt][scene_id][fname],
                               dtype=np.float64)
                diff = np.abs(a - b)
                if diff_type == "relative":
                    diff = diff / (np.abs(a) + 1e-12)
                rows.append({"ckpt": f"diff_OODG_{ckpt}",
                             "scene_id": scene_id, "feature": fname,
                             "diff": float(diff.mean())})
    if not rows:
        raise ValueError(
            "feature-diff evolution needs an 'OODG' baseline plus at "
            f"least one tuned checkpoint; got {sorted(dict_features)}")
    df = pd.DataFrame(rows)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    csv_path = os.path.join(out_dir, f"diff_evolution_{diff_type}.csv")
    df.to_csv(csv_path, index=False)
    fig, ax = plt.subplots(figsize=(max(6, 0.6 * df.feature.nunique()), 4))
    for ckpt, g in df.groupby("ckpt"):
        agg = g.groupby("feature", sort=False)["diff"].mean()
        ax.plot(agg.index, agg.values, marker="o", label=ckpt)
    ax.set_ylabel(f"{diff_type} feature diff")
    ax.set_xlabel("Layers")
    ax.tick_params(axis="x", rotation=45)
    ax.legend()
    path = _save(fig, out_dir, f"diff_evolution_{diff_type}", fmt)
    return path, csv_path


def plot_decoder_overlay(image, dict_features,
                         out_dir="figures/decoder", fmt="png",
                         decoder_key="decoder", alpha=0.6):
    """Channel-mean decoder feature maps overlaid on the scene image
    (reference plot_decoder_overlay, visualization.py:1152-1204)."""
    paths = []
    img = np.asarray(image)
    for ckpt, dict_scene_all in dict_features.items():
        for scene_id, dict_scene in dict_scene_all.items():
            for fname, arr in dict_scene.items():
                if fname == "metaId" or decoder_key not in fname.lower():
                    continue
                fmap = np.asarray(arr)[0].mean(axis=-1)  # (h, w)
                fig, ax = plt.subplots(figsize=(6, 6))
                ax.imshow(img[..., ::-1]
                          if img.ndim == 3 and img.dtype == np.uint8
                          else img,
                          cmap=None if img.ndim == 3 else "gray")
                zoom_h = img.shape[0] / fmap.shape[0]
                zoom_w = img.shape[1] / fmap.shape[1]
                up = np.kron(fmap, np.ones((int(np.ceil(zoom_h)),
                                            int(np.ceil(zoom_w)))))
                ax.imshow(up[:img.shape[0], :img.shape[1]], cmap="hot",
                          alpha=alpha)
                ax.set_axis_off()
                ax.set_title(f"{ckpt} {fname}", fontsize=8)
                paths.append(_save(fig, out_dir,
                                   f"{ckpt}__{scene_id}__{fname}", fmt))
    return paths


# ---------------------------------------------------------------------------
# filters (reference visualization.py:1205-1385)
# ---------------------------------------------------------------------------

def _flat_numpy(params):
    """A params tree -> {'a/b/c': np.ndarray} in mst_tpu's layout: the
    port's tensors through io.params_to_numpy (conv weights OIHW ->
    HWIO), numpy leaves as they are."""
    from mst_tpu_torch import io

    flat = io.flatten(params)
    if any(hasattr(v, "detach") for v in flat.values()):
        return io.params_to_numpy(params)
    return {k: np.asarray(v) for k, v in flat.items()}


def _conv_kernels(params):
    """Yield (path, (kh, kw, cin, cout) kernel) for encoder/decoder convs."""
    for path, leaf in _flat_numpy(params).items():
        if not path.startswith(("encoder", "goal_decoder", "traj_decoder")):
            continue
        if path.endswith("weight") and np.ndim(leaf) == 4:
            yield path, np.asarray(leaf)


def plot_filters(params_dict, out_dir="figures/filters", fmt="png",
                 max_in=8, max_out=8):
    """Kernel-weight grids (in-channels x out-channels of each conv) per
    checkpoint (reference plot_filters, visualization.py:1205-1232).
    params_dict: {ckpt_name: params pytree}; kernels are HWIO."""
    paths = []
    for name, params in params_dict.items():
        for path, k in _conv_kernels(params):
            kh, kw, cin, cout = k.shape
            ni, no = min(cin, max_in), min(cout, max_out)
            vmin, vmax = float(k.min()), float(k.max())
            fig, axes = plt.subplots(ni, no, figsize=(no * 1.0, ni * 1.0),
                                     squeeze=False)
            for i in range(ni):
                for o in range(no):
                    im = axes[i][o].imshow(k[:, :, i, o], vmin=vmin,
                                           vmax=vmax)
                    axes[i][o].set_xticks([])
                    axes[i][o].set_yticks([])
            fig.colorbar(im, ax=axes[0][no - 1], shrink=0.8)
            axes[0][no // 2].set_title("Out channels", fontsize=7)
            axes[ni // 2][0].set_ylabel("In channels", fontsize=7)
            paths.append(_save(
                fig, out_dir, f"{name}__{path.replace('/', '.')}", fmt))
    return paths


def plot_filters_diff_evolution(params_dict,
                                out_dir="figures/filters_diff", fmt="png"):
    """Per-layer weight sum/avg and OODG-vs-tuned differences as line plots
    + csv (reference plot_filters_diff_evolution,
    visualization.py:1233-1385)."""
    import pandas as pd

    table = {}
    flats = {name: {k: v for k, v in _flat_numpy(p).items()
                    if not k.startswith("segmentation")}
             for name, p in params_dict.items()}
    for name, flat in flats.items():
        for pth, v in flat.items():
            table.setdefault(pth, {})[f"{name}__sum"] = float(v.sum())
            table[pth][f"{name}__avg"] = float(v.mean())
            if name != "OODG" and "OODG" in flats and pth in flats["OODG"]:
                base = flats["OODG"][pth]
                d = base - v
                table[pth][f"diff_OODG_{name}__absolute"] = float(d.sum())
                table[pth][f"diff_OODG_{name}__overall_relative"] = float(
                    d.sum() / (base.sum() + 1e-12))
    df = pd.DataFrame(table).T
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    csv_path = os.path.join(out_dir, "filters_diff.csv")
    df.to_csv(csv_path)

    weight_rows = df.index.str.endswith("weight")
    paths = [csv_path]
    for op in ("sum", "avg"):
        fig, ax = plt.subplots(
            figsize=(max(6, 0.25 * int(weight_rows.sum())), 4))
        for name in params_dict:
            col = f"{name}__{op}"
            if col in df.columns:
                ax.plot(range(int(weight_rows.sum())),
                        df.loc[weight_rows, col], "-", label=name)
        ax.axhline(0, color="gray", lw=0.5, alpha=0.4)
        ax.set_title("Filters")
        ax.set_ylabel("Value")
        ax.set_xlabel("Layers")
        ax.legend()
        paths.append(_save(fig, out_dir, f"filters__{op}__plot", fmt))
    return paths


# ---------------------------------------------------------------------------
# activations (reference plot_activation, visualization.py:258-575)
# ---------------------------------------------------------------------------

def plot_activation(acts, out_dir="figures/activation", fmt="png",
                    scene_img=None, reduce="mean", max_layers=None):
    """Channel-reduced activation map per captured layer, optionally next
    to the scene image (essence of reference plot_activation,
    visualization.py:258-575). acts: {layer_name: (B,H,W,C)}."""
    paths = []
    names = list(acts)[:max_layers] if max_layers else list(acts)
    for lname in names:
        a = np.asarray(acts[lname])[0]
        amap = a.mean(axis=-1) if reduce == "mean" else a.max(axis=-1)
        ncol = 2 if scene_img is not None else 1
        fig, axes = plt.subplots(1, ncol, figsize=(5 * ncol, 5),
                                 squeeze=False)
        col = 0
        if scene_img is not None:
            img = np.asarray(scene_img)
            axes[0][0].imshow(scene_img_from_input(img) if img.ndim == 3
                              else img)
            axes[0][0].set_title("scene")
            axes[0][0].set_axis_off()
            col = 1
        im = axes[0][col].imshow(amap, cmap="viridis")
        fig.colorbar(im, ax=axes[0][col], shrink=0.8)
        axes[0][col].set_title(f"{lname} ({reduce})", fontsize=8)
        axes[0][col].set_axis_off()
        paths.append(_save(fig, out_dir,
                           lname.replace("/", "."), fmt))
    return paths


# ---------------------------------------------------------------------------
# prediction overlays (reference visualization.py:897-1151)
# ---------------------------------------------------------------------------

def plot_obs_pred_trajs(image, dict_trajs, out_dir="figures/prediction",
                        name="prediction", obs_len=8, fmt="png"):
    """Observed (solid), groundtruth (dotted) and per-checkpoint predicted
    (dashed) trajectories on the scene (reference plot_obs_pred_trajs /
    plot_prediction, visualization.py:966-1039).
    dict_trajs: {'gt': (B,T,2), ckpt_name: (B,pred_len,2), ...}."""
    fig, ax = plt.subplots(figsize=(7, 7))
    img = np.asarray(image)
    ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
              else img, cmap=None if img.ndim == 3 else "gray")
    gt = np.asarray(dict_trajs["gt"])
    for i, t in enumerate(gt):
        ax.plot(t[:obs_len, 0], t[:obs_len, 1], "-", c="k", lw=1.4,
                label="observed" if i == 0 else None)
        ax.plot(t[obs_len - 1:, 0], t[obs_len - 1:, 1], ":", c="C0", lw=1.4,
                label="groundtruth" if i == 0 else None)
    for k, (ckpt, preds) in enumerate(
            (kk, vv) for kk, vv in dict_trajs.items() if kk != "gt"):
        preds = np.asarray(preds)
        for i, t in enumerate(preds):
            start = gt[i, obs_len - 1:obs_len] if i < len(gt) else t[:1]
            t = np.concatenate([start, t], axis=0)
            ax.plot(t[:, 0], t[:, 1], "--", c=f"C{k + 1}", lw=1.2,
                    label=ckpt if i == 0 else None)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    return _save(fig, out_dir, name, fmt)


def plot_multiple_predictions(image, gt, samples,
                              out_dir="figures/prediction",
                              name="multi_pred", obs_len=8, fmt="png"):
    """All K sampled trajectories for one agent, alpha-faded, best in
    color (reference plot_multiple_predictions,
    visualization.py:1040-1089). samples: (K, pred_len, 2)."""
    fig, ax = plt.subplots(figsize=(7, 7))
    img = np.asarray(image)
    ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
              else img, cmap=None if img.ndim == 3 else "gray")
    gt = np.asarray(gt)
    ax.plot(gt[:obs_len, 0], gt[:obs_len, 1], "-", c="k", lw=1.6,
            label="observed")
    ax.plot(gt[obs_len - 1:, 0], gt[obs_len - 1:, 1], ":", c="C0", lw=1.6,
            label="groundtruth")
    samples = np.asarray(samples)
    err = np.linalg.norm(samples - gt[None, obs_len:], axis=-1).mean(-1)
    best = int(err.argmin())
    for k, t in enumerate(samples):
        if k == best:
            continue
        ax.plot(t[:, 0], t[:, 1], "--", c="C3", lw=0.8, alpha=0.25)
    ax.plot(samples[best][:, 0], samples[best][:, 1], "--", c="C3", lw=1.6,
            label=f"best of {len(samples)}")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    return _save(fig, out_dir, name, fmt)


def plot_goal_map_with_samples(image, goal_map_sigmoid, samples_by_ckpt,
                               out_dir="figures/goal_map",
                               name="goal_samples", fmt="png"):
    """Sigmoid goal map over the scene with sampled goals per checkpoint
    (reference plot_goal_map_with_samples, visualization.py:1090-1151)."""
    fig, ax = plt.subplots(figsize=(7, 7))
    img = np.asarray(image)
    ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
              else img, cmap=None if img.ndim == 3 else "gray")
    ax.imshow(np.asarray(goal_map_sigmoid), cmap="hot", alpha=0.55)
    for k, (ckpt, pts) in enumerate(samples_by_ckpt.items()):
        pts = np.asarray(pts).reshape(-1, 2)
        ax.scatter(pts[:, 0], pts[:, 1], s=14, marker="x", c=f"C{k}",
                   label=ckpt)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    return _save(fig, out_dir, name, fmt)


def plot_trajectories_scenes_overlay(image, df_primary, df_secondary=None,
                                     out_dir="figures/scene_with_trajs",
                                     name="overlay", fmt="png"):
    """Dataset-level overlay of all trajectories of one (or two) agent
    categories on a scene (reference plot_trajectories_scenes_overlay,
    visualization.py:897-965). DataFrames need x/y/metaId columns."""
    fig, ax = plt.subplots(figsize=(7, 7))
    img = np.asarray(image)
    ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
              else img, cmap=None if img.ndim == 3 else "gray")
    for df, color, lbl in ((df_primary, "C3", "primary"),
                           (df_secondary, "C0", "secondary")):
        if df is None:
            continue
        for j, (_, g) in enumerate(df.groupby("metaId")):
            ax.plot(g["x"], g["y"], "-", c=color, lw=0.8, alpha=0.6,
                    label=lbl if j == 0 else None)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    return _save(fig, out_dir, name, fmt)


# ---------------------------------------------------------------------------
# saliency (reference visualization.py:1548-1626)
# ---------------------------------------------------------------------------

def scene_img_from_input(input_hwc):
    """BGR-normalized network input -> displayable RGB in [0, 1]
    (reference get_correct_scene_img, visualization.py:1548-1562; NHWC +
    the data pipeline's BGR quirk)."""
    x = np.asarray(input_hwc, dtype=np.float64)
    rgb = x[..., ::-1] if x.shape[-1] == 3 else x
    return (rgb - x.min()) / (x.max() - x.min() + 1e-12)


def plot_saliency_maps(input_img, grad_input, saliency_name, filename,
                       out_dir="figures/saliency_maps", fmt="png",
                       side_by_side=True, best_point=None):
    """Input-gradient saliency: positive grads summed over batch+channels,
    side-by-side with the scene and as a hot overlay (reference
    plot_saliency_maps, visualization.py:1565-1626). input_img (B,H,W,C)
    or (H,W,C); grad_input same shape, NHWC."""
    inp = np.asarray(input_img)
    if inp.ndim == 4:
        inp = inp[0]
    g = np.asarray(grad_input)
    if g.ndim == 3:
        g = g[None]
    grad_img = g.sum(axis=(0, -1))
    grad_img = np.where(grad_img < 0, 0.0, grad_img)
    scene = scene_img_from_input(inp)
    paths = []
    if side_by_side:
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        axes[0].imshow(scene)
        axes[0].set_title("original scene")
        im = axes[1].imshow(grad_img, cmap="gray_r")
        axes[1].set_title(saliency_name)
        if best_point is not None:
            axes[1].scatter(best_point[0], best_point[1], c="r", marker="*")
        fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.9)
        paths.append(_save(fig, out_dir, filename, fmt))
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(scene)
    im = ax.imshow(grad_img, cmap="hot", vmin=0, alpha=0.65)
    fig.colorbar(im, ax=ax, shrink=0.5)
    if best_point is not None:
        ax.scatter(best_point[0], best_point[1], c="r", s=6, marker="*")
    ax.set_title(saliency_name)
    paths.append(_save(fig, out_dir, f"{filename}__overlay", fmt))
    return paths


# ---------------------------------------------------------------------------
# plot_goal_output figure family (reference visualization.py:128-257,576-611)
# — the per-sample goal-decoder diff maps with hollow/thresholded colormaps
# that produced the reference's shipped docs/*.jpg figures.
# ---------------------------------------------------------------------------

def get_ordinary_cmap():
    """Blues_r-over-Oranges diverging map (reference
    visualization.py:576-582)."""
    import matplotlib as mpl
    top = mpl.colormaps["Blues_r"].resampled(128)
    bottom = mpl.colormaps["Oranges"].resampled(128)
    colors = np.vstack((top(np.linspace(0, 1, 128)),
                        bottom(np.linspace(0, 1, 128))))
    return mpl.colors.ListedColormap(colors, name="ordinary")


def get_hollow_cmap(threshold):
    """Diverging map whose middle |x| < threshold band is fully transparent
    and whose wings ramp alpha outward — overlays show only confident
    increase/decrease regions over the scene image (reference
    visualization.py:585-602)."""
    import matplotlib as mpl
    if not 0.0 <= threshold < 0.5:
        raise ValueError(
            f"inhance_threshold must be in [0, 0.5), got {threshold}: it is "
            "the half-width of the transparent middle band of a diverging "
            "colormap, so >= 0.5 leaves no colored wings")
    N = 256
    cut = int(N * threshold)
    n_color = N // 2 - cut
    decrease = mpl.colormaps["Blues_r"].resampled(n_color)
    increase = mpl.colormaps["Reds"].resampled(n_color)
    bottom = decrease(np.linspace(0, 0.7, n_color))
    # alpha ramps: strongest at the extremes, fading toward the hollow band
    ramp = np.arange(n_color * 0.15, n_color * 1.15) / (n_color * 1.3)
    bottom[:, -1] = ramp[:n_color][::-1]
    middle = np.array([[1.0, 1.0, 1.0, 0.0]]).repeat(N - n_color * 2, axis=0)
    top = increase(np.linspace(0.3, 1, n_color))
    top[:, -1] = ramp[:n_color]
    return mpl.colors.ListedColormap(np.vstack((bottom, middle, top)),
                                     name="hollow")


def adjust_cmap(cmap, threshold):
    """Carve a transparent band out of the middle of an existing cmap
    (reference visualization.py:605-611)."""
    import matplotlib as mpl
    N = 256
    colors = cmap(np.linspace(0, 1, N))
    colors[int(N / 2 - N * threshold): int(N / 2 + N * threshold), :] = \
        [1, 1, 1, 0]
    return mpl.colors.ListedColormap(colors)


def base_img_plot(ax, scene_img, semantic_img=None):
    """Scene background: grayscale semantic classes if a semantic map is
    given, else the raw image (reference visualization.py:113-126;
    semantic_img here is channels-LAST, our framework layout)."""
    if semantic_img is not None:
        semantic_class = np.asarray(semantic_img).argmax(axis=-1)
        img = np.ones(semantic_class.shape)
        img[semantic_class == 1] = 0.5
        img[semantic_class == 2] = 0.0
        im = ax.imshow(img, cmap="gray")
    else:
        im = ax.imshow(scene_img)
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    return im


def plot_goal_output(ckpts_hook_dict, index, df_test, images, resize_factor,
                     out_dir="figures/activation", fmt="png", obs_len=8,
                     display_scene_img=True, inhance_threshold=None,
                     window=None, white_bg=False, base_ckpt="OODG"):
    """Per-sample goal-decoder diff figures (reference
    visualization.py:128-257).

    For every (meta_id, scene_id) in `index` and every goal_decoder layer:
    channel-mean of (ckpt activation - base_ckpt activation), upsampled by
    1/resize_factor to raw-image scale, drawn over the scene image with a
    zero-centered TwoSlopeNorm and either the hollow (thresholded-
    transparent) or ordinary diverging cmap, plus observation/groundtruth
    overlays.

    Args:
      ckpts_hook_dict: {ckpt_name: {layer_name: (N, H, W, C) array}} —
        capture_activations output per checkpoint (channels-last; the
        reference's hooks are NCHW).
      index: list of (meta_id, scene_id), aligned with axis 0 of the
        activations.
      df_test: raw-pixel trajectory DataFrame (x, y, metaId columns).
      images: {scene_id: (H, W, 3) float image} at raw scale (the caller
        loads them; the reference re-reads reference.jpg/png from
        image_path and infers resize_factor from the path string).
      window: optional (x_center, y_center, x_range, ratio, layout) zoom.

    Returns the list of written figure paths.
    """
    import matplotlib as mpl

    first = next(iter(ckpts_hook_dict.values()))
    layer_names = [n for n in first if "goal_decoder" in n]
    paths = []
    for i, (meta_id, scene_id) in enumerate(index):
        for layer_name in layer_names:
            height, width = first[layer_name].shape[1:3]
            while height >= 10:
                height /= 2
                width /= 2
            new_out_dir = os.path.join(out_dir, f"{scene_id}__{meta_id}")
            pathlib.Path(new_out_dir).mkdir(parents=True, exist_ok=True)
            base_features = np.asarray(
                ckpts_hook_dict[base_ckpt][layer_name][i], np.float32)
            for ckpt_name, hook_dict in ckpts_hook_dict.items():
                if ckpt_name == base_ckpt:
                    continue
                features = np.asarray(hook_dict[layer_name][i], np.float32)
                scene_img = np.asarray(images[scene_id]).copy()
                black = np.zeros(scene_img.shape[:2] + (3,))
                if white_bg:
                    bg = scene_img.mean(axis=2) == 0.0
                    scene_img[bg] = 1.0
                    black[bg] = 1.0
                # channel-mean diff at raw-image scale (reference mean(0)
                # over the NCHW channel axis == our mean(-1) over NHWC)
                diff_single = (features - base_features).mean(axis=-1)
                import cv2
                diff_single = cv2.resize(
                    diff_single, (0, 0), fx=1 / resize_factor,
                    fy=1 / resize_factor, interpolation=cv2.INTER_AREA)
                diff_single = diff_single[:scene_img.shape[0],
                                          :scene_img.shape[1]]
                vmin, vmax = float(diff_single.min()), float(diff_single.max())
                df_meta = df_test[df_test.metaId == meta_id]
                if inhance_threshold is not None:
                    cmap_div = get_hollow_cmap(inhance_threshold)
                else:
                    cmap_div = get_ordinary_cmap()
                if display_scene_img:
                    fig, axes = plt.subplots(1, 2,
                                             figsize=(width * 2, height))
                    axes[0].imshow(scene_img)
                    ax = axes[1]
                    ax.imshow(scene_img)
                    lw, ms = 1, 3
                    if vmin >= 0:
                        vmin = -1e-5
                    if vmax <= 0:
                        vmax = 1e-5
                else:
                    fig, ax = plt.subplots(1, 1, figsize=(width, height))
                    ax.imshow(scene_img)
                    ax.imshow(black, cmap="Greys", alpha=0.4)
                    lw, ms = 2, 5
                    if vmin >= 0:
                        vmin = -1e-5
                    if vmax <= 0:
                        vmax = 1e-5
                ax.plot(df_meta.x.values[:obs_len],
                        df_meta.y.values[:obs_len], ".-", c="lightgreen",
                        linewidth=lw, markersize=ms, label="observation")
                ax.plot(df_meta.x.values[obs_len - 1:],
                        df_meta.y.values[obs_len - 1:], ".-", c="gold",
                        linewidth=lw, markersize=ms, label="groundtruth")
                divnorm = mpl.colors.TwoSlopeNorm(vcenter=0, vmin=vmin,
                                                  vmax=vmax)
                ax.imshow(diff_single, cmap=cmap_div, norm=divnorm)
                for a in fig.axes:
                    a.set_xticklabels([])
                    a.set_yticklabels([])
                    a.set_xticks([])
                    a.set_yticks([])
                if display_scene_img:
                    plt.legend()
                    plt.subplots_adjust(wspace=0.02, hspace=0.02,
                                        bottom=0.1, right=0.78, top=0.9)
                else:
                    leg = plt.legend(loc="upper left", fontsize=25)
                    for handle, c in zip(leg.legend_handles,
                                         ("mediumseagreen", "goldenrod")):
                        handle.set_color(c)
                    if window is not None:
                        x_c, y_c, x_range, ratio, layout = window
                        if layout == "portrait" and ratio < 1.0:
                            ratio = 1 / ratio
                        if layout == "landscape" and ratio > 1.0:
                            ratio = 1 / ratio
                        ax.set_xlim(x_c - x_range // 2, x_c + x_range // 2)
                        ax.set_ylim(y_c - x_range * ratio // 2,
                                    y_c + x_range * ratio // 2)
                        ax.invert_yaxis()
                out_name = f"{ckpt_name}__{layer_name}__diff_single"
                if display_scene_img:
                    out_name += "__scene"
                if inhance_threshold is not None:
                    out_name += f"__{inhance_threshold}"
                out_path = os.path.join(new_out_dir, f"{out_name}.{fmt}")
                fig.savefig(out_path, bbox_inches="tight")
                plt.close(fig)
                paths.append(out_path)
    return paths


def plot_given_trajectories_scenes_overlay(
        images, df, out_dir="figures/scene_with_trajs_given", fmt="png",
        label_colors=None):
    """Per-scene overlays of a given DataFrame's trajectories, colored by
    agent label (reference plot_given_trajectories_scenes_overlay,
    visualization.py:933-965). `images`: {sceneId: HWC image}; `df` needs
    x/y/metaId/sceneId and (optionally) label columns."""
    label_colors = label_colors or {"Pedestrian": "b", "Biker": "r"}
    paths = []
    for scene_id in df.sceneId.unique():
        img = np.asarray(images[scene_id])
        d = df[df.sceneId == scene_id]
        fig, ax = plt.subplots(
            figsize=(max(img.shape[1] / 100, 4), max(img.shape[0] / 100, 4)))
        ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
                  else img, cmap=None if img.ndim == 3 else "gray")
        labels = (d.label.unique() if "label" in d.columns else ["all"])
        for i, label in enumerate(labels):
            dl = d[d.label == label] if "label" in d.columns else d
            c = label_colors.get(label, f"C{i}")
            for _, traj in dl.groupby("metaId"):
                ax.plot(traj.x, traj.y, ".-", c=c, ms=4, alpha=0.4)
            ax.plot([], [], ".-", c=c, alpha=0.5, label=str(label))
        ax.set_title(f"scene: {scene_id}")
        ax.legend(loc="best")
        paths.append(_save(fig, out_dir, str(scene_id), fmt))
    return paths


def plot_prediction(images, ckpt_trajs_dict,
                    out_dir="figures/prediction", fmt="png", obs_len=8):
    """Per-agent figures overlaying each checkpoint's best predicted
    trajectory on the scene (reference plot_prediction,
    visualization.py:1004-1039). `images`: {sceneId: HWC image};
    `ckpt_trajs_dict`: {ckpt_name: {metaId, sceneId, groundtruth,
    prediction}} — the payload `Experiment.test(return_preds=True)`
    collects (trajectories in raw pixels)."""
    first = ckpt_trajs_dict[next(iter(ckpt_trajs_dict))]
    paths = []
    for i, meta_id in enumerate(np.asarray(first["metaId"]).reshape(-1)):
        scene_id = np.asarray(first["sceneId"]).reshape(-1)[i] \
            if "sceneId" in first else next(iter(images))
        img = np.asarray(images[scene_id])
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(img[..., ::-1] if img.ndim == 3 and img.dtype == np.uint8
                  else img, cmap=None if img.ndim == 3 else "gray")
        for j, (ckpt_name, trajs) in enumerate(ckpt_trajs_dict.items()):
            gt = np.asarray(trajs["groundtruth"][i])
            pred = np.asarray(trajs["prediction"][i])
            if j == 0:
                ax.plot(gt[:obs_len, 0], gt[:obs_len, 1], ".-", ms=4,
                        c="black")
                ax.plot(gt[obs_len - 1:, 0], gt[obs_len - 1:, 1], ".-",
                        ms=4, c="black", label="groundtruth")
            # connect the last observed point to the first predicted one
            px = np.insert(pred[:, 0], 0, gt[obs_len - 1, 0])
            py = np.insert(pred[:, 1], 0, gt[obs_len - 1, 1])
            ax.plot(px, py, ".-", ms=4, label=str(ckpt_name))
        ax.set_title(f"meta_id={meta_id}, scene_id={scene_id}")
        ax.legend(loc="best")
        paths.append(_save(fig, out_dir, f"{meta_id}__{scene_id}", fmt))
    return paths


def plot_per_importance_analysis(
        tuned_name, df, n_test, scene_id, depth, oodg_stats, tuned_stats,
        out_dir="figures/importance_analysis", fmt="png",
        plot_err_bar=False):
    """One importance-ablation bar figure per metric (reference
    plot_per_importance_analysis, visualization.py:1386-1459): per-layer
    ADE/FDE improvement over the pretrained baseline, with the tuned
    model's total improvement as a dashed line. depth -1 plots weight vs
    bias side by side; depth 1/2 plot one bar per layer group. `df` is
    indexed by layer with ade_diff/fde_diff (+_std) columns."""
    import pandas as pd

    ade_oodg, fde_oodg = oodg_stats[0], oodg_stats[1]
    ade_tuned, fde_tuned = tuned_stats[0], tuned_stats[1]
    diff = {"ade_diff": ade_oodg - ade_tuned, "fde_diff": fde_oodg - fde_tuned}
    paths = []
    for metric in ("ade_diff", "fde_diff"):
        width = max(df.shape[0] * 0.25 + 3, 4)
        if depth == -1:
            # weights and biases of the same layer as paired bars
            mask_w = df.index.str.contains("weight")
            mask_b = df.index.str.contains("bias")
            index = [n.replace(".weight", "").replace("__weight", "")
                     for n in df.index[mask_w]]
            data = pd.DataFrame(index=index)
            data["weight"] = df.loc[mask_w, metric].values
            if mask_b.sum() == mask_w.sum():
                data["bias"] = df.loc[mask_b, metric].values
            err = None
            if plot_err_bar and metric + "_std" in df.columns:
                err = pd.DataFrame(index=index)
                err["weight"] = df.loc[mask_w, metric + "_std"].values
                if "bias" in data.columns:
                    err["bias"] = df.loc[mask_b, metric + "_std"].values
            ax = data.plot(
                kind="bar", color={"weight": "tab:blue",
                                   "bias": "lightsteelblue"},
                figsize=(width / 1.7, 4), yerr=err, xlabel="Layers",
                ylabel=metric,
                title="Importance analysis"
                      + (f" ({scene_id})" if scene_id else ""))
        elif depth in (1, 2):
            d = df.sort_index()
            err = (d[[metric + "_std"]].rename(
                       columns={metric + "_std": metric})
                   if plot_err_bar and metric + "_std" in d.columns
                   else None)
            ax = d[[metric]].plot(
                kind="bar", yerr=err, figsize=(width / 1.3, 4),
                xlabel="Layers", ylabel=metric,
                title="Importance analysis"
                      + (f" ({scene_id})" if scene_id else ""))
        else:
            raise ValueError(f"No support for depth={depth}")
        ax.axhline(y=diff[metric], color="tab:red", linestyle="--",
                   linewidth=1, alpha=0.5,
                   label=f"diff_OODG_{tuned_name}")
        plt.xticks(rotation=45, ha="right")
        ax.legend(loc="upper right")
        name = f"{tuned_name}_{metric}__N{n_test}"
        if scene_id:
            name += f"__{scene_id}"
        if plot_err_bar:
            name += "__err"
        paths.append(_save(ax.get_figure(), out_dir, name, fmt))
    return paths


def plot_importance_analysis(in_dir, out_dir="figures/importance_analysis",
                             fmt="png", n_test=500, depth=-1,
                             tuned_names=("FT", "ET")):
    """Read an importance-run csv tree and produce the per-layer and
    per-scene ablation figures (reference plot_importance_analysis,
    visualization.py:1461-1547). Expects per-trajectory csvs named
    `OODG__N{n}.csv` (pretrained), `{FT|ET}__N{n}.csv` (tuned) and
    `{FT|ET}__N{n}__{layer}.csv` (tuned with one layer swapped back), each
    with ade/fde (+sceneId) columns — what
    `python -m mst_tpu_torch.evaluator.importance --per_traj_dir` writes and
    what the reference's analyze_importance runs produced."""
    import glob as globlib

    import pandas as pd

    df_oodg = pd.read_csv(os.path.join(in_dir, f"OODG__N{n_test}.csv"))
    oodg = (df_oodg.ade.mean(), df_oodg.fde.mean(),
            df_oodg.ade.std(), df_oodg.fde.std())
    paths = []
    for tuned_name in tuned_names:
        base_csv = os.path.join(in_dir, f"{tuned_name}__N{n_test}.csv")
        if not os.path.exists(base_csv):
            continue
        df_tuned = pd.read_csv(base_csv)
        tuned = (df_tuned.ade.mean(), df_tuned.fde.mean(),
                 df_tuned.ade.std(), df_tuned.fde.std())
        rows, samples = [], []
        for f in sorted(globlib.glob(
                os.path.join(in_dir, f"{tuned_name}__N{n_test}__*.csv"))):
            layer = os.path.basename(f).split("__")[-1].replace(".csv", "")
            d = pd.read_csv(f)
            d["layer"] = layer
            d["ade_diff"] = df_oodg.ade.values - d.ade.values
            d["fde_diff"] = df_oodg.fde.values - d.fde.values
            rows.append({"layer": layer,
                         "ade_diff": d.ade_diff.mean(),
                         "fde_diff": d.fde_diff.mean(),
                         "ade_diff_std": d.ade_diff.std(),
                         "fde_diff_std": d.fde_diff.std()})
            samples.append(d)
        if not rows:
            continue
        df_avg = pd.DataFrame(rows).sort_values("layer").set_index("layer")
        for err in (False, True):
            paths += plot_per_importance_analysis(
                tuned_name, df_avg, n_test, None, depth, oodg, tuned,
                out_dir, fmt, plot_err_bar=err)
        df_all = pd.concat(samples, ignore_index=True)
        if "sceneId" in df_all.columns:
            g = df_all.groupby(["sceneId", "layer"])[
                ["ade_diff", "fde_diff"]].agg(["mean", "std"])
            for scene_id in g.index.get_level_values(0).unique():
                d = pd.DataFrame({
                    "ade_diff": g.loc[scene_id][("ade_diff", "mean")],
                    "fde_diff": g.loc[scene_id][("fde_diff", "mean")],
                    "ade_diff_std": g.loc[scene_id][("ade_diff", "std")],
                    "fde_diff_std": g.loc[scene_id][("fde_diff", "std")],
                }).sort_index()
                for err in (False, True):
                    paths += plot_per_importance_analysis(
                        tuned_name, d, n_test, scene_id, depth, oodg,
                        tuned, os.path.join(out_dir, "scenes"), fmt,
                        plot_err_bar=err)
    return paths
