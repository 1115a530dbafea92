"""Multi-checkpoint comparator (counterpart of
mst_tpu/evaluator/multickpts.py; reference
evaluator/evaluate_multickpts.py).

Evaluate N checkpoints on the same focus subset, merge the per-metaId
ADE/FDE into one comparison csv (mst_tpu's columns and order), optionally
plot the predictions. The tables are the port's Tracks (a DataFrame is
taken too); each checkpoint's test() runs both serving kernels on the
card. CLI (--device cpu runs the plain versions on the CPU):

    python -m mst_tpu_torch.evaluator.multickpts --config_filename <yaml> \\
        --pretrained_ckpt <base.npz> --tuned_ckpts <delta.npz> ...
"""

import pathlib

import numpy as np

from mst_tpu_torch import config as config_lib
from mst_tpu_torch.data.tracks import Tracks, unique_in_order
from mst_tpu_torch.utils.seeding import set_random_seeds


def as_tracks(df):
    """A Tracks table, or a DataFrame of mst_tpu's columns -> Tracks."""
    return df if isinstance(df, Tracks) else Tracks.from_frame(df)


def get_meta_ids_focus(df=None, given_meta_ids=None, given_csv=None,
                       random_n=None):
    """reference utils/data_utils.py:914-942; df a Tracks or a
    DataFrame."""
    if given_meta_ids is not None:
        return ([given_meta_ids] if isinstance(given_meta_ids, int)
                else list(given_meta_ids))
    if given_csv and given_csv.get("path"):
        import pandas as pd

        col1, col2, op = given_csv["name"].split("__")
        result = pd.read_csv(given_csv["path"])
        diff = result[col1].values - result[col2].values
        if op == "abs_diff":
            diff = np.abs(diff)
        elif op != "diff":
            raise ValueError(f"Invalid op={op}")
        result["diff"] = diff
        return result.sort_values("diff", ascending=False).head(
            given_csv["n_limited"]).metaId.values
    ids = unique_in_order(np.asarray(df.metaId))
    if random_n is not None:
        ids = ids.copy()
        np.random.shuffle(ids)
        return ids[:random_n]
    return ids


def restore(params, is_separated, base_ckpt, separated_ckpt=None,
            images=None):
    """Alias of trainer.restore_model (reference utils/util.py:138-147),
    on params['device']."""
    from mst_tpu_torch.train.trainer import restore_model

    return restore_model(params, is_separated, base_ckpt, separated_ckpt,
                         images=images)


def metrics_frame(metrics):
    """test()'s metrics rows (numpy columns) -> mst_tpu's per-trajectory
    frame [metaId, sceneId, ade, fde]."""
    import pandas as pd

    return pd.DataFrame({c: metrics[c]
                         for c in ("metaId", "sceneId", "ade", "fde")})


def compare_checkpoints(params, df_test, image_path, ckpts, ckpts_name,
                        is_file_separated, n_round, seed=1, out_dir=None,
                        images=None):
    """Evaluate each checkpoint; return the merged per-metaId frame and
    each checkpoint's per-round predictions."""
    tracks = as_tracks(df_test)
    df_result = None
    trajs_by_ckpt = {}
    batches = None
    for i, (ckpt, name) in enumerate(zip(ckpts, ckpts_name)):
        print(f"====== Testing for {name} ======")
        p = dict(params, n_round=n_round, seed=seed)
        model = restore(p, is_file_separated[i],
                        ckpt if not is_file_separated[i] else ckpts[0],
                        None if not is_file_separated[i] else ckpt,
                        images=images)
        set_random_seeds(seed)
        if batches is None:
            # the host image prep + batch build depends only on the data
            # params (shared by every checkpoint), so the first model's
            # prepared batches serve all of them
            batches = model.prepare_data(tracks, image_path, "test")
        _, _, list_metrics, list_trajs = model.test(
            tracks, image_path, return_preds=True, batches=batches)
        frames = [metrics_frame(m) for m in list_metrics]
        merged = frames[0].copy()
        for r in range(1, n_round):
            merged[["ade", "fde"]] += frames[r][["ade", "fde"]]
        merged[["ade", "fde"]] /= n_round
        merged = merged.rename(
            {"ade": f"ade_{name}", "fde": f"fde_{name}"}, axis=1)
        df_result = merged if df_result is None else df_result.merge(
            merged, on=["metaId", "sceneId"])
        trajs_by_ckpt[name] = list_trajs
    if out_dir:
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
        csv_name = f"{'_'.join(ckpts_name)}__N" \
                   f"{len(tracks.meta_ids())}_R{n_round}"
        out = f"{out_dir}/{csv_name}.csv"
        df_result.to_csv(out, index=False)
        print(f"Saved {out}")
    return df_result, trajs_by_ckpt


def plot_prediction_overlays(df_result, trajs_by_ckpt, raw_images, params,
                             out_dir="figures/prediction"):
    """Per-scene observed/groundtruth/per-checkpoint prediction overlays on
    the RAW scene image (reference evaluate_multickpts.py:79-86 ->
    plot_prediction); trajectories are already in raw pixels."""
    from mst_tpu_torch.evaluator.visualization import plot_obs_pred_trajs

    per_ckpt = {}
    meta_ids = None
    gt = None
    for name, list_trajs in trajs_by_ckpt.items():
        t = list_trajs[0]  # round 0
        per_ckpt[name] = np.concatenate(t["prediction"])
        if meta_ids is None:
            meta_ids = np.concatenate(t["metaId"])
            gt = np.concatenate(t["groundtruth"])
    scene_of = dict(zip(df_result.metaId, df_result.sceneId))
    for scene in sorted({scene_of[m] for m in meta_ids if m in scene_of}):
        sel = np.array([scene_of.get(m) == scene for m in meta_ids])
        dict_trajs = {"gt": gt[sel]}
        dict_trajs.update({n: p[sel] for n, p in per_ckpt.items()})
        plot_obs_pred_trajs(raw_images[scene], dict_trajs, out_dir=out_dir,
                            name=f"{scene}__predictions",
                            obs_len=int(params["obs_len"]))


def load_test_split(args, params):
    """The CLI's test table: prepare_dataset's 'eval' split of the
    dataset the params name -> (image_path, tracks)."""
    from mst_tpu_torch.data.splits import prepare_dataset

    image_path, data_path = config_lib.get_image_and_data_path(params)
    _, _, tracks = prepare_dataset(
        data_path, args.load_data, args.batch_size, None, None,
        args.val_files, args.val_split, args.test_splits, args.shuffle,
        args.share_val_test, "eval")
    return image_path, tracks


def focus_tracks(tracks, focus):
    """The rows of the focus metaIds."""
    return tracks.take(np.isin(tracks.metaId, np.asarray(focus)))


def main(argv=None):
    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.data import images as images_lib
    from mst_tpu_torch.train.trainer import _IMAGE_FILES

    parser = config_lib.get_parser(False)
    parser.add_argument("--given_meta_ids", default=None, type=int,
                        nargs="+")
    parser.add_argument("--result_path", default=None, type=str)
    parser.add_argument("--result_name", default=None, type=str)
    parser.add_argument("--result_limited", default=None, type=int)
    parser.add_argument("--random_n", default=None, type=int)
    parser.add_argument("--viz", action="store_true")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    set_random_seeds(args.seed)
    params = config_lib.get_params(args=args)
    image_path, tracks = load_test_split(args, params)
    focus = get_meta_ids_focus(
        tracks,
        given_csv={"path": args.result_path, "name": args.result_name,
                   "n_limited": args.result_limited},
        given_meta_ids=args.given_meta_ids, random_n=args.random_n)
    tracks = focus_tracks(tracks, focus)

    ckpts, ckpts_name, is_sep = config_lib.get_ckpts_and_names(
        args.ckpts, args.ckpts_name, args.pretrained_ckpt, args.tuned_ckpts)
    folder = f"{args.seed}__{'_'.join(args.dataset_path.split('/'))}"
    # load + decode the scene images ONCE; every checkpoint's Experiment
    # takes them instead of re-reading them
    dataset_name = params["dataset_name"].lower()
    raw_images = images_lib.load_images(
        tracks.scene_ids(), image_path,
        _IMAGE_FILES.get(dataset_name, "reference.jpg"),
        params.get("use_raw_data", False), dataset_name == "eth")
    df_result, trajs_by_ckpt = compare_checkpoints(
        params, tracks, image_path, ckpts, ckpts_name, is_sep,
        args.n_round, args.seed, out_dir=f"csv/comparison/{folder}",
        images=raw_images)
    if args.viz:
        plot_prediction_overlays(df_result, trajs_by_ckpt, raw_images,
                                 params, out_dir=f"figures/prediction/"
                                                 f"{folder}")


if __name__ == "__main__":
    main()
