"""Training-curve extraction and plotting from stdout logs (counterpart of
mst_tpu/evaluator/curves.py; reference utils/extract_training_curve.py).

A multi-run .out log (several experiments appended by the bash grids) is
split into per-run messages; each run's epoch curve, stop epoch and final
test metrics are parsed, moving-averaged and plotted as labeled ADE/FDE
panels — the reference's extract_curve_seed / extract_curve_model workflow.
Run boundaries here are the 'Experiment <name> has started' banner
(train.py:29), the analog of the reference's params-dump split
(extract_training_curve.py:52).
"""

import argparse
import pathlib
import re

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from mst_tpu_torch.config import get_position  # noqa: E402
from mst_tpu_torch.evaluator.logs import _AVG_RE, extract_epoch_curve  # noqa: E402


def moving_average(x, window, mode="same", box_loc="middle"):
    """Reference moving_average (extract_training_curve.py:10-29):
    'middle' = centered box with shrinking windows at both edges,
    'history' = trailing box."""
    x = np.asarray(x, float)
    n = x.shape[0]
    if box_loc == "middle":
        data = np.convolve(x, np.ones(window), mode) / window
        adjust = window // 2
        for i in range(min(adjust, n)):
            data[i] = np.mean(data[:(i + adjust + 1)])
            data[n - i - 1] = np.mean(x[(n - i - adjust - 1):])
        return data
    if box_loc == "history":
        data = np.zeros(n)
        for i in range(min(window - 1, n)):
            data[i] = np.mean(x[:i + 1])
        for i in range(window - 1, n):
            data[i] = np.mean(x[(i - window + 1):(i + 1)])
        return data
    raise NotImplementedError(box_loc)


def split_runs(text):
    """Multi-run log -> list of per-run dicts with curve + metadata
    (reference extract_curve_seed metadata parse,
    extract_training_curve.py:52-68)."""
    runs = []
    for msg in re.split(r"Experiment ", text)[1:]:
        experiment = msg.split(" has started")[0]
        curve = extract_epoch_curve(msg)
        if curve.empty:
            continue
        early = re.search(r"Early stop at epoch ([\d]+)", msg)
        best = re.search(r"Best epoch at ([\d]+)", msg)
        if early is not None:
            stop_epoch = int(early.group(1))
        elif best is not None:
            stop_epoch = int(best.group(1))
        else:
            stop_epoch = int(curve.epoch.iloc[int(curve.val_ade.idxmin())])
        metric = re.search(_AVG_RE, msg)
        seed = re.search(r"Seed_(\d+)", experiment)
        tn = re.search(r"__([A-Za-z0-9_.\[\]]+?)__TrN", experiment)
        ntr = re.search(r"TrN_(\d+)", experiment)
        lr = re.search(r"lr_([\d.e-]+)", experiment)
        runs.append({
            "experiment": experiment,
            "curve": curve,
            "stop_epoch": min(stop_epoch, int(curve.epoch.iloc[-1])),
            "ade": round(float(metric.group(1)), 2) if metric else None,
            "fde": round(float(metric.group(2)), 2) if metric else None,
            "seed": int(seed.group(1)) if seed else None,
            "train_net": tn.group(1) if tn else None,
            "position": get_position(experiment, return_list=False),
            "n_train": int(ntr.group(1)) if ntr else None,
            "lr": lr.group(1) if lr else None,
        })
    return runs


def _run_label(run):
    name = run["train_net"] or run["experiment"][:24]
    pos = f"[{run['position']}]" if run.get("position") else ""
    ntr = f"({run['n_train']})" if run.get("n_train") is not None else ""
    lr = f"_{run['lr']}" if run.get("lr") else ""
    score = (f"_{run['ade']}/{run['fde']}"
             if run.get("ade") is not None else "")
    return f"TrS{run['seed']}_{name}{pos}{ntr}{lr}{score}"


def plot_curves(runs, out_path="figures/training_curve/curve.png",
                val_window=9, box_loc="middle", show_raw_val=False,
                show_train=False, start=0):
    """Labeled val-ADE/FDE panels, one line per run, best-epoch starred
    (reference extract_curve_seed / extract_curve_model,
    extract_training_curve.py:45-200)."""
    fig, axes = plt.subplots(1, 2, figsize=(13, 4))
    for run in runs:
        c = run["curve"]
        val_ade, val_fde = c.val_ade.to_numpy(), c.val_fde.to_numpy()
        if val_window and len(c) > 1:
            w = min(val_window, len(c))
            val_ade = moving_average(val_ade, w, box_loc=box_loc)
            val_fde = moving_average(val_fde, w, box_loc=box_loc)
        e = run["stop_epoch"]
        # stop_epoch is an EPOCH NUMBER; map it to the row index (resumed
        # logs start mid-run, so epoch != position)
        epochs = c.epoch.to_numpy()
        ei = int(np.clip(np.searchsorted(epochs, e), 0, len(epochs) - 1))
        for ax, smoothed, raw, train in (
                (axes[0], val_ade, c.val_ade, c.train_ade),
                (axes[1], val_fde, c.val_fde, c.train_fde)):
            p = ax.plot(c.epoch[start:], smoothed[start:], lw=1,
                        label=_run_label(run) if ax is axes[1] else None)
            color = p[-1].get_color()
            ax.scatter(epochs[ei], smoothed[ei], c=color, marker="*")
            if show_raw_val:
                ax.plot(c.epoch[start:], raw[start:], lw=0.5, alpha=0.5,
                        c=color)
            if show_train:
                ax.plot(c.epoch[start:], train[start:], ls="--", c=color)
    axes[0].set_ylabel("ADE")
    axes[1].set_ylabel("FDE")
    axes[1].legend(bbox_to_anchor=(1.04, 1), borderaxespad=0, fontsize=7)
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def extract_and_plot(log_paths, out_path, **kwargs):
    runs = []
    for path in log_paths:
        runs.extend(split_runs(pathlib.Path(path).read_text()))
    if not runs:
        raise ValueError(f"no training runs found in {log_paths}")
    return plot_curves(runs, out_path, **kwargs), runs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_paths", nargs="+", required=True)
    parser.add_argument("--out_path",
                        default="figures/training_curve/curve.png")
    parser.add_argument("--val_window", default=9, type=int)
    parser.add_argument("--box_loc", default="middle",
                        choices=["middle", "history"])
    parser.add_argument("--show_raw_val", action="store_true")
    parser.add_argument("--show_train", action="store_true")
    parser.add_argument("--start", default=0, type=int)
    args = parser.parse_args(argv)
    path, runs = extract_and_plot(
        args.log_paths, args.out_path, val_window=args.val_window,
        box_loc=args.box_loc, show_raw_val=args.show_raw_val,
        show_train=args.show_train, start=args.start)
    for run in runs:
        print(f"run={_run_label(run)} stop_epoch={run['stop_epoch']}")
    print(f"Saved {path}")


if __name__ == "__main__":
    main()
