"""The port's readers (mst_tpu_torch/evaluator/{visualization,curves}.py)
against mst_tpu's on the same inputs, on the CPU: every figure function
writes the same file names (its returned paths and the file tree under
its out_dir, relative to each package's own out_dir), the colour maps
and base image are mst_tpu's, and curves.split_runs / moving_average
return mst_tpu's values and frames. varf_viz and parity_stats are in
tests/test_torch_port_figures_stats.py. Nothing here reads a reference
checkout.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from mst_tpu.evaluator import curves as jcurves
from mst_tpu.evaluator import parity_stats as jparity
from mst_tpu.evaluator import varf_viz as jvarf
from mst_tpu.evaluator import visualization as jviz
from mst_tpu_torch.evaluator import curves, parity_stats, varf_viz
from mst_tpu_torch.evaluator import visualization as viz

RNG = np.random.default_rng(0)
IMG = RNG.uniform(size=(48, 64, 3)).astype(np.float32)
GT = np.cumsum(RNG.normal(size=(3, 12, 2)), 1) + 20
FEATS = {ckpt: {"scene": {
    "encoder_0": RNG.normal(size=(2, 16, 16, 4)).astype(np.float32),
    "goal_decoder_0": RNG.normal(size=(2, 8, 8, 4)).astype(np.float32),
    "metaId": [11, 22]}} for ckpt in ("OODG", "FT")}
KERNEL = RNG.normal(size=(3, 3, 4, 6)).astype(np.float32)
PARAMS = {"OODG": {"encoder": {"stages": {"0": {"conv0": {
    "weight": KERNEL, "bias": np.zeros(6, np.float32)}}}}},
    "FT": {"encoder": {"stages": {"0": {"conv0": {
        "weight": KERNEL + 0.1, "bias": np.ones(6, np.float32)}}}}}}
TRAJ_DF = pd.DataFrame({"x": RNG.uniform(0, 64, 40),
                        "y": RNG.uniform(0, 48, 40),
                        "metaId": np.repeat([1, 2], 20),
                        "sceneId": "scene_0",
                        "label": np.repeat(["Pedestrian", "Biker"], 20)})
HOOKS = {name: {"goal_decoder.predictor_output": RNG.normal(
    size=(2, 16, 24, 12)).astype(np.float32)} for name in ("OODG", "FT")}


def port_params():
    """PARAMS as the port holds them: tensors, convs OIHW."""
    return {name: {"encoder": {"stages": {"0": {"conv0": {
        "weight": torch.tensor(p["encoder"]["stages"]["0"]["conv0"][
            "weight"].transpose(3, 2, 0, 1)),
        "bias": torch.tensor(p["encoder"]["stages"]["0"]["conv0"]["bias"])
    }}}}} for name, p in PARAMS.items()}


def csv_tree(root):
    """An importance csv tree and a few-shot results tree under root."""
    imp = root / "imp"
    imp.mkdir()
    base = pd.DataFrame({"metaId": [1, 2, 3], "sceneId": ["a", "a", "b"],
                         "ade": [5.0, 6.0, 7.0], "fde": [9.0, 8.0, 7.0]})
    base.to_csv(imp / "OODG__N3.csv", index=False)
    (base.assign(ade=base.ade - 1)).to_csv(imp / "FT__N3.csv", index=False)
    for i, layer in enumerate(("encoder.stages.0.conv0.weight",
                               "encoder.stages.0.conv0.bias")):
        base.assign(ade=base.ade - 0.5 * i, fde=base.fde + i).to_csv(
            imp / f"FT__N3__{layer}.csv", index=False)
    res = root / "fewshot"
    for seed in ("1", "2"):
        for num, ade in ((10, 3.0), (20, 2.5)):
            d = res / "mosa_2" / seed
            d.mkdir(parents=True, exist_ok=True)
            pd.DataFrame({"ade": [ade + 0.1 * int(seed)]}).to_csv(
                d / f"{num}.csv", index=False)
    return imp, res


# (name, call(module, out_dir, inputs dir, is_port)) for every figure
# function of visualization.py
FIGURES = [
    ("plot_fewshot_curves", lambda m, o, d, p: m.plot_fewshot_curves(
        pd.DataFrame({"n_train": [10, 10, 30, 30], "train_net": ["mosa"] * 4,
                      "ade": [5.0, 5.5, 4.0, 4.2]}), o)),
    ("plot_trajectories_on_scene", lambda m, o, d, p:
     m.plot_trajectories_on_scene(IMG, GT, o, "scene", obs_len=4,
                                  preds=GT + 2)),
    ("plot_goal_map", lambda m, o, d, p: m.plot_goal_map(
        IMG[..., 0], o, "gm", points=[[4, 5], [10, 12]])),
    ("plot_importance", lambda m, o, d, p: m.plot_importance(
        pd.DataFrame({"group": ["none", "a", "b"],
                      "ade": [5.0, 6.0, 5.2]}), o)),
    ("plot_training_curves", lambda m, o, d, p: m.plot_training_curves(
        [5, 4, 3], [9, 8, 7], o)),
    ("plot_input_space", lambda m, o, d, p: m.plot_input_space(
        IMG, np.concatenate([IMG, IMG[..., :1]], -1), o)),
    ("create_few_shot_plot", lambda m, o, d, p: m.create_few_shot_plot(
        str(d / "fewshot"), o)),
    ("plot_feature_space", lambda m, o, d, p: m.plot_feature_space(
        FEATS, out_dir=o)),
    ("plot_feature_space_diff_evolution", lambda m, o, d, p:
     m.plot_feature_space_diff_evolution(FEATS, out_dir=o)),
    ("plot_decoder_overlay", lambda m, o, d, p: m.plot_decoder_overlay(
        IMG, FEATS, out_dir=o)),
    ("plot_filters", lambda m, o, d, p: m.plot_filters(
        port_params() if p else PARAMS, out_dir=o)),
    ("plot_filters_diff_evolution", lambda m, o, d, p:
     m.plot_filters_diff_evolution(port_params() if p else PARAMS,
                                   out_dir=o)),
    ("plot_activation", lambda m, o, d, p: m.plot_activation(
        {"encoder/0": FEATS["FT"]["scene"]["encoder_0"][:1]}, out_dir=o,
        scene_img=IMG)),
    ("plot_obs_pred_trajs", lambda m, o, d, p: m.plot_obs_pred_trajs(
        IMG, {"gt": GT, "FT": GT[:, 4:] + 1.0}, out_dir=o, obs_len=4)),
    ("plot_multiple_predictions", lambda m, o, d, p:
     m.plot_multiple_predictions(IMG, GT[0], GT[None, 0, 4:] + 1.0,
                                 out_dir=o, obs_len=4)),
    ("plot_goal_map_with_samples", lambda m, o, d, p:
     m.plot_goal_map_with_samples(IMG, IMG[..., 1],
                                  {"FT": GT[0, :4]}, out_dir=o)),
    ("plot_trajectories_scenes_overlay", lambda m, o, d, p:
     m.plot_trajectories_scenes_overlay(IMG, TRAJ_DF, TRAJ_DF, out_dir=o)),
    ("plot_saliency_maps", lambda m, o, d, p: m.plot_saliency_maps(
        IMG[None], IMG[None] - 0.5, "loss saliency", "sal", out_dir=o,
        best_point=(10, 12))),
    ("plot_goal_output", lambda m, o, d, p: m.plot_goal_output(
        HOOKS, [(1, "scene_0"), (2, "scene_0")], TRAJ_DF,
        {"scene_0": RNG.uniform(size=(64, 96, 3)).astype(np.float32)},
        0.25, out_dir=o, inhance_threshold=0.1)),
    ("plot_given_trajectories_scenes_overlay", lambda m, o, d, p:
     m.plot_given_trajectories_scenes_overlay({"scene_0": IMG}, TRAJ_DF,
                                              out_dir=o)),
    ("plot_prediction", lambda m, o, d, p: m.plot_prediction(
        {"scene_0": IMG}, {"FT": {"metaId": [1, 2],
                                  "sceneId": ["scene_0", "scene_0"],
                                  "groundtruth": GT[:2],
                                  "prediction": GT[:2, 4:] + 1}},
        out_dir=o, obs_len=4)),
    ("plot_per_importance_analysis", lambda m, o, d, p:
     m.plot_per_importance_analysis(
         "FT", pd.DataFrame({"ade_diff": [0.1, 0.2], "fde_diff": [0.3, 0.1]},
                            index=["l.weight", "l.bias"]), 3, "scene_0",
         -1, (5.0, 9.0), (4.0, 8.0), out_dir=o)),
    ("plot_importance_analysis", lambda m, o, d, p:
     m.plot_importance_analysis(str(d / "imp"), out_dir=o, n_test=3)),
]


def relative(paths, out):
    if isinstance(paths, str):
        paths = [paths]
    return [os.path.relpath(q, out) for q in paths]


def files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


@pytest.mark.parametrize("name", [n for n, _ in FIGURES])
def test_figure_file_names_match_jax(name, tmp_path):
    call = dict(FIGURES)[name]
    csv_tree(tmp_path)
    got_out, want_out = str(tmp_path / "port"), str(tmp_path / "jax")
    got = call(viz, got_out, tmp_path, True)
    want = call(jviz, want_out, tmp_path, False)
    if isinstance(want, tuple):  # (figure, csv)
        got, want = list(got), list(want)
    assert relative(got, got_out) == relative(want, want_out)
    assert files(got_out) == files(want_out) and files(want_out)


def test_public_functions_are_ported():
    for mod, jmod in ((viz, jviz), (curves, jcurves), (varf_viz, jvarf),
                      (parity_stats, jparity)):
        public = {n for n in dir(jmod) if callable(getattr(jmod, n))
                  and not n.startswith("_")
                  and getattr(getattr(jmod, n), "__module__", "")
                  == jmod.__name__}
        assert public and public <= set(dir(mod)), public - set(dir(mod))
    ported = {n for n, _ in FIGURES}
    figures = {n for n in dir(jviz) if n.startswith(("plot_", "create_"))}
    assert figures == ported, figures ^ ported


def test_cmaps_and_base_img_match_jax():
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    x = np.linspace(0, 1, 256)
    for got, want in ((viz.get_ordinary_cmap(), jviz.get_ordinary_cmap()),
                      (viz.get_hollow_cmap(0.2), jviz.get_hollow_cmap(0.2)),
                      (viz.adjust_cmap(mpl.colormaps["viridis"], 0.1),
                       jviz.adjust_cmap(mpl.colormaps["viridis"], 0.1))):
        np.testing.assert_array_equal(got(x), want(x))
    with pytest.raises(ValueError, match="inhance_threshold"):
        viz.get_hollow_cmap(0.5)
    sem = np.zeros((8, 10, 3), np.float32)
    sem[2, 2, 1] = sem[3, 3, 2] = 1.0
    arrays = []
    for m in (viz, jviz):
        fig, ax = plt.subplots()
        arrays.append(np.asarray(m.base_img_plot(ax, None, sem).get_array()))
        plt.close(fig)
    np.testing.assert_array_equal(*arrays)
    np.testing.assert_array_equal(viz.scene_img_from_input(IMG),
                                  jviz.scene_img_from_input(IMG))


LOG = "\n".join(
    [f"Experiment Seed_{s}__filter_synth__mosa_2__Pos_0_1__TrN_{n}__lr_"
     f"0.003 has started\n"
     + "\n".join(f"Epoch {e}: \tTrain (Top-1) ADE: {10 - 0.1 * e:.2f} "
                 f"FDE: {12 - 0.1 * e:.2f} \t\tVal (Top-k) ADE: "
                 f"{9 - 0.05 * e * s:.2f} FDE: {11 - 0.05 * e:.2f}"
                 for e in range(n // 2))
     + f"\nBest epoch at 3\nAverage performance (by 3): \nTest ADE: "
       f"{5.0 + s} \nTest FDE: {9.5 + s}" for s, n in ((1, 20), (2, 16))])


def test_curves_match_jax(tmp_path):
    got, want = curves.split_runs(LOG), jcurves.split_runs(LOG)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], pd.DataFrame):
                pd.testing.assert_frame_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    x = RNG.normal(size=17)
    for loc in ("middle", "history"):
        np.testing.assert_array_equal(curves.moving_average(x, 5, box_loc=loc),
                                      jcurves.moving_average(x, 5,
                                                             box_loc=loc))
    log = tmp_path / "t.out"
    log.write_text(LOG)
    p, _ = curves.extract_and_plot([str(log)], str(tmp_path / "p" / "c.png"),
                                   val_window=3, show_train=True)
    q, _ = jcurves.extract_and_plot([str(log)], str(tmp_path / "j" / "c.png"),
                                    val_window=3, show_train=True)
    assert os.path.basename(p) == os.path.basename(q) and os.path.exists(p)
    out = tmp_path / "cli" / "curve.png"
    curves.main(["--log_paths", str(log), "--out_path", str(out),
                 "--val_window", "3"])
    assert out.exists()
