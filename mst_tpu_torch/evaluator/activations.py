"""Activation visualization / probe CLI (counterpart of
mst_tpu/evaluator/activations.py; reference
evaluator/visualize_activation.py).

The reference uses forward hooks; here `capture_activations` re-runs the
model's forward stages (the distance rasterizer, pred_features, pred_goal,
the waypoint pyramid and pred_traj) and returns every encoder feature and
both decoder output maps as numpy arrays, NHWC as mst_tpu's. The CLI plots
goal-map sigmoid differences between checkpoints for focus trajectories,
and with --saliency the input gradients of Experiment.forward_test.

    python -m mst_tpu_torch.evaluator.activations --config_filename <yaml> \\
        --ckpts a.npz b.npz --ckpts_name OODG FT ... [--device cpu]
"""

import numpy as np
import torch

from mst_tpu_torch import config as config_lib
from mst_tpu_torch.evaluator.multickpts import as_tracks
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.utils.seeding import set_random_seeds


@torch.no_grad()
def capture_activations(model, df_scene, image_path):
    """Run the probe forward and return a dict of named activations."""
    from mst_tpu_torch.ops.heatmap import rasterize_dist_nhwc
    from mst_tpu_torch.ops.pooling import avg_pool_pyramid

    tracks = as_tracks(df_scene)
    p = model.params
    scenes = tracks.scene_ids()
    if len(scenes) != 1:
        # same invariant as Experiment.forward_test: all trajectories are
        # rasterized into ONE scene's (H, W) against ONE semantic map;
        # mixing scenes silently pairs trajectories with the wrong image
        raise ValueError(
            f"capture_activations expects one scene, got "
            f"{sorted(scenes)}; filter df (e.g. "
            f"--given_meta_ids of a single scene) first")
    batches = model.prepare_data(tracks, image_path, "test",
                                 allow_bucketed=False)  # single-scene probe
    batch = batches[0]
    dev = model.device
    traj = torch.tensor(np.concatenate(
        [b.trajectories[b.mask.astype(bool)] for b in batches]), device=dev)
    semantic = model._semantic_for(
        batch.scene_id, torch.tensor(batch.image[None], device=dev), {})
    H, W = semantic.shape[1:3]
    semantic = ynet_lib.adapt_semantic(model.model_params, model.mcfg,
                                       semantic)
    scfg = config_lib.step_config(p)
    observed_map = rasterize_dist_nhwc(traj[:, :p["obs_len"]], H, W,
                                       scfg.template_size)
    semantic_b = semantic.expand(traj.shape[0], *semantic.shape[1:])
    feats, _ = ynet_lib.pred_features(model.model_params, model.model_state,
                                      model.mcfg, semantic_b, observed_map)
    goal_map = ynet_lib.pred_goal(model.model_params, feats)
    pyr = avg_pool_pyramid(goal_map[..., list(p["waypoints"])], len(feats))
    traj_map = ynet_lib.pred_traj(model.model_params, [
        torch.cat([f, w], dim=-1) for f, w in zip(feats, pyr)])

    def host(t):
        return t.float().cpu().numpy()

    acts = {f"encoder.stage{i}": host(f) for i, f in enumerate(feats)}
    acts["semantic"] = host(semantic)
    acts["observed_map"] = host(observed_map)
    acts["goal_decoder.predictor_output"] = host(goal_map)
    acts["traj_decoder.predictor_output"] = host(traj_map)
    acts["trajectory"] = host(traj)
    return acts


def goal_sigmoid_diff(acts_a, acts_b, temperature=1.0):
    """Sigmoid goal-map difference between two checkpoints
    (reference visualize_activation.py:66-106)."""
    def sig(x):
        return 1.0 / (1.0 + np.exp(-x / temperature))

    return (sig(acts_b["goal_decoder.predictor_output"])
            - sig(acts_a["goal_decoder.predictor_output"]))


def main(argv=None):
    from mst_tpu_torch import resolve_device
    from mst_tpu_torch.evaluator.multickpts import (focus_tracks,
                                                    get_meta_ids_focus,
                                                    load_test_split, restore)
    from mst_tpu_torch.evaluator.visualization import (plot_activation,
                                                       plot_goal_map,
                                                       plot_saliency_maps)

    parser = config_lib.get_parser(False)
    parser.add_argument("--given_meta_ids", default=None, type=int,
                        nargs="+")
    parser.add_argument("--random_n", default=None, type=int)
    parser.add_argument("--out_dir", default="figures/activation")
    parser.add_argument("--saliency", default=None, type=str, nargs="+",
                        choices=["scene", "semantic", "traj"],
                        help="also plot input-gradient saliency maps of the"
                             " probe loss wrt these inputs (reference"
                             " trainer.py:468-484 + plot_saliency_maps)")
    parser.add_argument("--plot_layer_activations", action="store_true",
                        help="per-layer channel-mean activation figures")
    parser.add_argument("--goal_output", action="store_true",
                        help="per-sample goal-decoder diff figures vs the"
                             " first checkpoint (reference plot_goal_output,"
                             " visualization.py:128-257)")
    parser.add_argument("--inhance_threshold", default=None, type=float,
                        help="hollow-cmap transparency threshold for"
                             " --goal_output")
    parser.add_argument("--white_bg", action="store_true")
    parser.add_argument("--no_scene_img", action="store_true",
                        help="--goal_output single-panel overlay variant")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    set_random_seeds(args.seed)
    params = config_lib.get_params(args=args)
    image_path, tracks = load_test_split(args, params)
    focus = get_meta_ids_focus(tracks, given_meta_ids=args.given_meta_ids,
                               random_n=args.random_n)
    tracks = focus_tracks(tracks, focus)
    if len(tracks.scene_ids()) > 1:
        # activations are captured against one scene image; keep the first
        # scene's trajectories (pass --given_meta_ids to pick another)
        scene = tracks.sceneId[0]
        print(f"Multiple scenes in focus set; restricting to '{scene}'")
        tracks = tracks.take(tracks.sceneId == scene)

    ckpts, ckpts_name, is_sep = config_lib.get_ckpts_and_names(
        args.ckpts, args.ckpts_name, args.pretrained_ckpt,
        args.tuned_ckpts)
    acts = {}
    for i, (ckpt, name) in enumerate(zip(ckpts, ckpts_name)):
        model = restore(params, is_sep[i],
                        ckpt if not is_sep[i] else ckpts[0],
                        None if not is_sep[i] else ckpt)
        acts[name] = capture_activations(model, tracks, image_path)
        gm = acts[name]["goal_decoder.predictor_output"]
        plot_goal_map(1 / (1 + np.exp(-gm[0, ..., -1])), args.out_dir,
                      f"{name}__goal_sigmoid")
        if args.plot_layer_activations:
            plot_activation(
                {k: v for k, v in acts[name].items()
                 if k.startswith(("encoder", "goal_decoder",
                                  "traj_decoder"))},
                out_dir=f"{args.out_dir}/{name}",
                scene_img=acts[name]["semantic"][0])
        if args.saliency:
            _, _, sem_in, grads = model.forward_test(
                tracks, image_path, set_input=tuple(args.saliency),
                decision="loss", input_grads=True)
            for inp_name, grad in grads.items():
                plot_saliency_maps(
                    sem_in.cpu().numpy(), grad.cpu().numpy(),
                    f"d(loss)/d({inp_name})", f"{name}__{inp_name}",
                    out_dir=f"{args.out_dir}/saliency")
    names = list(acts)
    if len(names) >= 2:
        diff = goal_sigmoid_diff(acts[names[0]], acts[names[1]],
                                 params.get("temperature", 1.0))
        plot_goal_map(diff[0, ..., -1], args.out_dir,
                      f"{names[0]}_vs_{names[1]}__goal_diff")
    if args.goal_output and len(names) >= 2:
        import pandas as pd

        from mst_tpu_torch.data import images as images_lib
        from mst_tpu_torch.evaluator.visualization import plot_goal_output

        scene = tracks.sceneId[0]
        dataset_name = params["dataset_name"].lower()
        raw = images_lib.load_images(
            [scene], image_path,
            "reference.png" if dataset_name == "ind" else "reference.jpg",
            params.get("use_raw_data", False))
        # cv2 loads BGR uint8; figures want RGB float
        images = {scene: raw[scene][..., ::-1].astype(np.float32) / 255.0}
        # activations are aligned with the table's row order (one row per
        # timestep, total_len rows per metaId)
        total_len = params["obs_len"] + params["pred_len"]
        meta_ids = tracks.metaId[::total_len]
        index = [(int(m), scene) for m in meta_ids]
        df_test = pd.DataFrame({"metaId": tracks.metaId, "x": tracks.x,
                                "y": tracks.y, "sceneId": tracks.sceneId})
        plot_goal_output(
            acts, index, df_test, images, params["resize_factor"],
            out_dir=args.out_dir, obs_len=params["obs_len"],
            display_scene_img=not args.no_scene_img,
            inhance_threshold=args.inhance_threshold,
            white_bg=args.white_bg, base_ckpt=names[0])


if __name__ == "__main__":
    main()
