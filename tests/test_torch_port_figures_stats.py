"""The port's varf_viz and parity_stats (mst_tpu_torch/evaluator/) against
mst_tpu's on the same inputs, on the CPU: the long-tail filters, every
varf figure's file names, on a varf table the port's builders make
(data/trajectories.get_varf_table); parity_stats.build_report's frames
and its CLI; and a worst-metric tie with a nan delta, which the port
breaks as mst_tpu's max() does, keeping the first operand (ROADMAP
Queue 3 #17, closed). Nothing here reads a reference checkout.
"""

import os

import numpy as np
import pandas as pd
import pytest

from mst_tpu.evaluator import parity_stats as jparity
from mst_tpu.evaluator import varf_viz as jvarf
from mst_tpu_torch.evaluator import parity_stats, varf_viz


def files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


def varf_table():
    """A varf table from the port's builders (data/trajectories.py)."""
    from mst_tpu_torch.data import trajectories

    rng = np.random.default_rng(1)
    rows = []
    for m in range(24):
        x0, y0 = rng.uniform(0, 100, 2)
        v = rng.uniform(0.5, 3) * (1 + (m % 2))
        for f in range(20):
            rows.append(dict(frame=f * 12, trackId=m, x=x0 + v * f,
                             y=y0 + 0.3 * v * f, sceneId=f"s{m % 3}_0",
                             metaId=m,
                             label=("Pedestrian", "Biker")[m % 2]))
    df = pd.DataFrame(rows)
    return trajectories.get_varf_table(df, ["avg_vel", "max_vel"], 8)


def test_varf_filters_match_jax():
    table = varf_table()
    arr = table.avg_vel.to_numpy()
    got, want = varf_viz.filter_long_tail_arr(arr), \
        jvarf.filter_long_tail_arr(arr)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    pd.testing.assert_index_equal(
        varf_viz.filter_long_tail_series(table.max_vel),
        jvarf.filter_long_tail_series(table.max_vel))
    g, w = (m.filter_long_tail_df(table, ["avg_vel", "max_vel"])
            for m in (varf_viz, jvarf))
    pd.testing.assert_frame_equal(g[0], w[0])
    assert g[1] == w[1]


def obs_table(t):
    return t.assign(avg_vel_obs=t.avg_vel * 0.9)[
        ["metaId", "label", "sceneId", "scene", "avg_vel_obs", "avg_vel"]]


VARF = ["avg_vel", "max_vel"]
# (name, call(module, table, out_dir)) for every figure of varf_viz.py
VARF_FIGURES = [
    ("plot_histogram", lambda m, t, o: m.plot_histogram(
        t.avg_vel.to_numpy(), "hist", o)),
    ("plot_histogram_overlay", lambda m, t, o: m.plot_histogram_overlay(
        t.avg_vel.to_numpy() * 0.9, t.avg_vel.to_numpy(), "overlay", o)),
    ("plot_varf_histograms", lambda m, t, o: m.plot_varf_histograms(t, o)),
    ("plot_varf_hist_obs_and_complete", lambda m, t, o:
     m.plot_varf_hist_obs_and_complete(obs_table(t), o)),
    ("plot_pairplot", lambda m, t, o: m.plot_pairplot(
        t, VARF, "All", "pair", o, kind="scatter")),
    ("plot_jointplot", lambda m, t, o: m.plot_jointplot(
        t, VARF, "Mixed", "joint", o, hue="label", kind="scatter")),
    ("plot_scene_w_numeric", lambda m, t, o: m.plot_scene_w_numeric(
        t, "avg_vel", "scenes", o)),
]


@pytest.mark.parametrize("name", [n for n, _ in VARF_FIGURES])
def test_varf_figure_file_names_match_jax(name, tmp_path):
    call, table = dict(VARF_FIGURES)[name], varf_table()
    call(varf_viz, table, str(tmp_path / "port"))
    call(jvarf, table, str(tmp_path / "jax"))
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert files(tmp_path / "jax")


def test_every_varf_figure_is_held():
    figures = {n for n in dir(jvarf) if n.startswith("plot_")}
    assert figures == {n for n, _ in VARF_FIGURES}


SUITES = {"a": (1.0, 1.01, 0.99), "b": (2.0, 2.2, 1.8)}


def parity_logs(root, rounds):
    root.mkdir()
    for suite, vals in rounds.items():
        text = "".join(f"Round {i}: \nTest ADE: {v} \nTest FDE: {2 * v} \n"
                       for i, v in enumerate(vals))
        mean = np.mean(vals)
        text += (f"\nAverage performance (by {len(vals)}): \nTest ADE: "
                 f"{mean} \nTest FDE: {2 * mean}\n")
        (root / f"{suite}.out").write_text(text)
    return root


def test_parity_report_matches_jax(tmp_path):
    logs = parity_logs(tmp_path / "logs", SUITES)
    ref = tmp_path / "ref.csv"
    pd.DataFrame({"suite": ["a", "b"], "ade": [1.0, 2.5],
                  "fde": [2.0, 4.0]}).to_csv(ref, index=False)
    for table in (None, str(ref)):
        got, want = parity_stats.build_report(logs, table), \
            jparity.build_report(logs, table)
        pd.testing.assert_frame_equal(got[0], want[0])
        assert got[1] == want[1]
    out = tmp_path / "rep.csv"
    assert parity_stats.main([str(logs), str(ref), "--out", str(out)]) == \
        jparity.main([str(logs), str(ref), "--out", str(tmp_path / "j.csv")])
    pd.testing.assert_frame_equal(pd.read_csv(out),
                                  pd.read_csv(tmp_path / "j.csv"))


def test_nan_tiebreak_is_the_kept_difference(tmp_path):
    """Both metrics 'inconclusive', the ADE delta nan (a 'nan' round), the
    FDE delta finite: the port ranks the two as mst_tpu does, so max()
    keeps its first operand and both report the ADE's nan CI; the
    reports are equal."""
    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "s.out").write_text(
        "Round 0: \nTest ADE: nan \nTest FDE: 2.0 \n"
        "Round 1: \nTest ADE: nan \nTest FDE: 2.6 \n"
        "\nAverage performance (by 2): \nTest ADE: nan \nTest FDE: 2.3\n")
    ref = tmp_path / "ref.csv"
    pd.DataFrame({"suite": ["s"], "ade": [1.0], "fde": [2.2]}).to_csv(
        ref, index=False)
    got, got_code = parity_stats.build_report(logs, str(ref))
    want, want_code = jparity.build_report(logs, str(ref))
    assert got.verdict[0] == want.verdict[0] == "inconclusive"
    assert np.isnan(want.ci_lo_pct[0]) and np.isnan(want.ade_delta_pct[0])
    assert np.isnan(got.ci_lo_pct[0]) and np.isnan(got.ci_hi_pct[0])
    assert got_code == want_code
    pd.testing.assert_frame_equal(got, want)
