"""Layer-importance ablations (counterpart of mst_tpu/evaluator/
importance.py; reference evaluator/analyze_importance.py and
analyze_lora_importance.py) as surgery on the parameter tree.

- swap-importance: for each parameter group (at a chosen path depth),
  replace the tuned value with the pretrained one (or vice versa),
  re-evaluate, and record the ADE/FDE change (reference
  analyze_importance.py:46-203, which swaps state-dict entries by name).
- LoRA-importance: zero out individual (or combinations of) lora_A/lora_B
  overlays and re-evaluate (reference analyze_lora_importance.py:40-115).

The flat keys are io.py's, mst_tpu's npz keys, so the groups and the
per-trajectory csv names are mst_tpu's. Every ablation is one
Experiment.test over one prepared batch list: the K = 20 eval, with both
serving kernels on the card.

CLI (--device cpu runs the plain versions on the CPU):

    python -m mst_tpu_torch.evaluator.importance --config_filename <yaml> \\
        --pretrained_ckpt <base.npz> --tuned_ckpt <delta.npz> \\
        --mode swap|lora ...
"""

import itertools
import pathlib

import numpy as np
import torch

from mst_tpu_torch import io
from mst_tpu_torch.evaluator.multickpts import as_tracks, metrics_frame
from mst_tpu_torch.utils.seeding import set_random_seeds


def group_paths(flat_params, depth):
    """Group flat param paths by their first `depth` components; depth=-1
    puts every leaf in its own group (reference depth semantics -1/1/2)."""
    groups = {}
    for path in flat_params:
        key = path if depth in (-1, None) else "/".join(
            path.split("/")[:depth])
        groups.setdefault(key, []).append(path)
    return groups


def swap_importance(model, df_test, image_path, pretrained_flat, tuned_flat,
                    depth=1, direction="tuned_to_pretrained", seed=1,
                    per_traj_dir=None, tag="FT"):
    """Evaluate the model once per swapped parameter group.

    pretrained_flat / tuned_flat: flat {key: np.ndarray} in mst_tpu's npz
    layout (io.load_checkpoint, io.params_to_numpy). Returns a DataFrame
    [group, n_param, ade, fde] plus baseline rows 'none' (tuned as-is) and
    'all' (fully swapped); the groups come in the order of the sorted
    flat keys, as mst_tpu's (its trees flatten sorted).

    per_traj_dir writes the per-trajectory csv tree the reference's
    analyze_importance runs produced (utils/write_files.py naming):
    `{tag}__N{n}.csv` for the tuned baseline, `OODG__N{n}.csv` for the
    fully-swapped (pretrained) one, `{tag}__N{n}__{group}.csv` per swap —
    the input format of visualization.plot_importance_analysis.
    """
    import pandas as pd

    tracks = as_tracks(df_test)
    rows = []
    # overlay onto the model's full tree so subtrees absent from the flat
    # checkpoints (the segmentation backbone, which converted/released
    # checkpoints exclude) survive every swap instead of being dropped
    template = model.model_params
    n_test = len(tracks.meta_ids())
    base_name, all_name = ((tag, "OODG")
                           if direction == "tuned_to_pretrained"
                           else ("OODG", tag))
    # one host image-prep + batch build serves every swap (only the
    # params change between evals)
    batches = model.prepare_data(tracks, image_path, "test")

    def run(flat, name, swapped_paths):
        model.model_params = io.overlay(template, io.params_from_numpy(flat))
        set_random_seeds(seed)
        ade, fde, metrics, _ = model.test(tracks, image_path,
                                          batches=batches)
        n = sum(int(np.asarray(flat[p]).size) for p in swapped_paths)
        rows.append({"group": name, "n_param": n, "ade": ade, "fde": fde})
        if per_traj_dir is not None:
            fname = {"none": f"{base_name}__N{n_test}.csv",
                     "all": f"{all_name}__N{n_test}.csv"}.get(
                name, f"{tag}__N{n_test}__{name.replace('/', '.')}.csv")
            pathlib.Path(per_traj_dir).mkdir(parents=True, exist_ok=True)
            pd.concat([metrics_frame(m) for m in metrics],
                      ignore_index=True).to_csv(
                pathlib.Path(per_traj_dir) / fname, index=False)

    base = dict(tuned_flat if direction == "tuned_to_pretrained"
                else pretrained_flat)
    # the groups in mst_tpu's order: its flat trees come from
    # jax.tree_util, each level's keys sorted
    base = {k: base[k] for k in io.jax_leaf_order(base)}
    other = (pretrained_flat if direction == "tuned_to_pretrained"
             else tuned_flat)
    run(base, "none", [])
    for group, paths in group_paths(base, depth).items():
        swapped = dict(base)
        changed = []
        for p in paths:
            if p in other:
                swapped[p] = other[p]
                changed.append(p)
        if changed:
            run(swapped, group, changed)
    all_paths = [p for p in other if p in base]
    run({**base, **other}, "all", all_paths)
    return pd.DataFrame(rows)


def lora_importance(model, df_test, image_path, max_combo=1, seed=1):
    """Zero selected LoRA overlays and re-evaluate.

    max_combo > 1 also ablates combinations of layers
    (reference analyze_lora_importance.py:84-108).
    """
    import pandas as pd

    tracks = as_tracks(df_test)
    flat = io.flatten(model.model_params)
    lora_layers = sorted({p.rsplit("/", 1)[0] for p in flat
                          if p.endswith("lora_B")})
    rows = []
    batches = model.prepare_data(tracks, image_path, "test")

    def run(zeroed_layers, name):
        patched = dict(flat)
        for layer in zeroed_layers:
            for suffix in ("lora_A", "lora_B"):
                key = f"{layer}/{suffix}"
                patched[key] = torch.zeros_like(flat[key])
        model.model_params = io.unflatten(patched)
        set_random_seeds(seed)
        ade, fde, _, _ = model.test(tracks, image_path, batches=batches)
        rows.append({"zeroed": name, "ade": ade, "fde": fde})

    run([], "none")
    for k in range(1, max_combo + 1):
        for combo in itertools.combinations(lora_layers, k):
            run(list(combo), "+".join(combo))
    run(lora_layers, "all")
    return pd.DataFrame(rows)


def main(argv=None):
    from mst_tpu_torch import config as config_lib
    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.evaluator.multickpts import load_test_split, restore

    parser = config_lib.get_parser(False)
    parser.add_argument("--mode", choices=["swap", "lora"], default="swap")
    parser.add_argument("--depth", default=1, type=int)
    parser.add_argument("--max_combo", default=1, type=int)
    parser.add_argument("--out_csv", default="csv/importance.csv")
    parser.add_argument("--per_traj_dir", default=None,
                        help="also write the reference-format "
                             "per-trajectory csv tree here (input of "
                             "visualization.plot_importance_analysis)")
    parser.add_argument("--tag", default="FT",
                        help="tuned-model tag in the csv tree (FT/ET)")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    set_random_seeds(args.seed)
    params = config_lib.get_params(args=args)
    image_path, tracks = load_test_split(args, params)

    model = restore(params, args.tuned_ckpt is not None,
                    args.pretrained_ckpt, args.tuned_ckpt)
    if args.mode == "swap":
        pretrained = io.load_checkpoint(args.pretrained_ckpt)
        tuned = io.params_to_numpy(model.model_params)
        df = swap_importance(model, tracks, image_path, pretrained, tuned,
                             depth=args.depth, seed=args.seed,
                             per_traj_dir=args.per_traj_dir, tag=args.tag)
    else:
        df = lora_importance(model, tracks, image_path,
                             max_combo=args.max_combo, seed=args.seed)
    pathlib.Path(args.out_csv).parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(args.out_csv, index=False)
    print(df)


if __name__ == "__main__":
    main()
