"""Statistical decision rule for the reference-parity gate (counterpart of
mst_tpu/evaluator/parity_stats.py).

The parity protocol's estimator is stochastic by design: each suite
reports minADE/FDE over K=20 sampled goals averaged over n_round=3
re-seeded rounds (reference models/trainer.py:334-351), and the few-shot
tune suites additionally sweep 5 seeds whose spread includes genuine
training variance. A raw "point delta <= 1%" comparison (what
run_parity.sh did through round 4) cannot distinguish a real metric
regression from that noise, and says nothing when the delta is small but
the noise is large. This module replaces it with an explicit decision
rule:

1. **Spread estimation** (`suite_stats`): for a multi-run suite (seed
   grid), the standard error of the suite mean comes from the across-run
   spread (captures seed + training variance); for a single-run suite
   (generalize), it comes from the within-run round spread divided by
   sqrt(n_round) (the run metric IS the mean of the rounds).
2. **Equivalence test** (`equivalence`): TOST-style at level alpha on
   the *relative* delta (ours - ref)/ref. Parity is
   - ``equivalent``   when the (1 - 2*alpha) CI of the relative delta
     lies entirely inside [-margin, +margin] (both one-sided tests
     reject at alpha) — the <=1% claim is *shown*, not just unrefuted;
   - ``different``    when the CI lies entirely outside the margin on
     one side — a demonstrated regression (or improvement) beyond 1%;
   - ``inconclusive`` otherwise — the data cannot resolve 1% either
     way; the reported ``mdd_pct`` (minimal detectable delta, the
     smallest margin this spread COULD have shown at alpha) says how
     much more data is needed (SE shrinks ~ 1/sqrt(n_round * n_runs)).

When the reference table carries no spread columns (``ade_se``,
``fde_se``), the reference runs are assumed to have the same SE as ours:
both stacks execute the identical estimator on the identical suite, so
symmetric noise is the natural prior — and it is conservative against
false "equivalent" verdicts (it widens the delta CI vs assuming an exact
reference).

Exit codes (CLI): 0 = every suite equivalent, 1 = any suite different,
2 = no difference shown but >=1 suite inconclusive (underpowered — raise
n_round or add seeds; the printed mdd_pct quantifies by how much).
"""

import argparse
import math
import pathlib
import sys


from mst_tpu_torch.evaluator.logs import extract_runs_with_rounds

# one-sided z at alpha=0.05; t-quantiles for tiny df where it matters
_Z05 = 1.6448536269514722
_T05 = {1: 6.3138, 2: 2.9200, 3: 2.3534, 4: 2.1318, 5: 2.0150,
        6: 1.9432, 7: 1.8946, 8: 1.8595, 9: 1.8331, 10: 1.8125}


def _t05(df):
    """One-sided 95% t-quantile (z beyond df=10 — within 3% of t)."""
    if df <= 0:
        return float("inf")
    return _T05.get(df, _Z05)


def _mean_se(values):
    """(mean, SE of the mean, df) from i.i.d. samples."""
    n = len(values)
    mean = sum(values) / n
    if n < 2:
        return mean, float("nan"), 0
    var = sum((v - mean) ** 2 for v in values) / (n - 1)
    return mean, math.sqrt(var / n), n - 1


def suite_stats(text):
    """One suite log -> {n_runs, n_rounds, ade, fde, ade_se, fde_se, df}.

    Multi-run suites (tune grids): suite metric = mean over runs, SE from
    the across-run spread. Single-run suites (generalize): SE from the
    within-run round spread / sqrt(n_round).
    """
    runs = extract_runs_with_rounds(text)
    if not runs:
        return None
    n_runs = len(runs)
    n_rounds = sum(len(r["round_ade"]) for r in runs)
    if n_runs > 1:
        ade, ade_se, df = _mean_se([r["ade"] for r in runs])
        fde, fde_se, _ = _mean_se([r["fde"] for r in runs])
    else:
        rounds_a, rounds_f = runs[0]["round_ade"], runs[0]["round_fde"]
        if rounds_a:
            ade, ade_se, df = _mean_se(rounds_a)
            fde, fde_se, _ = _mean_se(rounds_f)
        else:
            # Average block without parseable Round lines: no spread
            # estimate — NaN SE makes the verdict 'inconclusive', never
            # a silent pass
            ade_se = fde_se = float("nan")
            df = 0
        # the reported metric is the round mean, so its SE is already
        # spread/sqrt(n_round) via _mean_se; keep the printed average
        # (identical up to float noise, but byte-honest to the log)
        ade, fde = runs[0]["ade"], runs[0]["fde"]
    return {"n_runs": n_runs, "n_rounds": n_rounds, "df": df,
            "ade": ade, "ade_se": ade_se, "fde": fde, "fde_se": fde_se}


def equivalence(ours, ours_se, ref, ref_se=None, df=10,
                margin_pct=1.0):
    """TOST equivalence on the relative delta; see module docstring.

    Returns {delta_pct, ci_lo_pct, ci_hi_pct, mdd_pct, verdict}.
    """
    if ref_se is None or (isinstance(ref_se, float)
                          and math.isnan(ref_se)):
        ref_se = ours_se  # symmetric-noise prior (same estimator)
    se_d = math.sqrt(ours_se ** 2 + ref_se ** 2)
    t = _t05(df)
    delta_pct = 100.0 * (ours - ref) / ref
    half_pct = 100.0 * t * se_d / ref
    lo, hi = delta_pct - half_pct, delta_pct + half_pct
    mdd_pct = half_pct  # smallest margin showable with this spread
    if math.isnan(se_d) or math.isinf(half_pct):
        verdict = "inconclusive"
    elif -margin_pct <= lo and hi <= margin_pct:
        verdict = "equivalent"
    elif lo > margin_pct or hi < -margin_pct:
        verdict = "different"
    else:
        verdict = "inconclusive"
    return {"delta_pct": delta_pct, "ci_lo_pct": lo, "ci_hi_pct": hi,
            "mdd_pct": mdd_pct, "verdict": verdict}


def build_report(log_dir, ref_table=None, margin_pct=1.0):
    """Scrape every *.out suite log -> (report df, exit code)."""
    import pandas as pd

    rows = []
    for log in sorted(pathlib.Path(log_dir).glob("*.out")):
        st = suite_stats(log.read_text())
        if st:
            rows.append({"suite": log.stem, **st})
    rep = pd.DataFrame(rows)
    code = 0
    if ref_table is not None and len(rep):
        ref = pd.read_csv(ref_table)
        rep = rep.merge(ref, on="suite", suffixes=("", "_ref"),
                        how="left")
        severity = {"different": 2, "inconclusive": 1, "equivalent": 0}
        verdicts = []
        for _, r in rep.iterrows():
            if pd.isna(r.get("ade_ref")):
                verdicts.append({"verdict": "no_ref"})
                continue
            va = equivalence(r.ade, r.ade_se, r.ade_ref,
                             r.get("ade_se_ref"), int(r.df), margin_pct)
            vf = equivalence(r.fde, r.fde_se, r.fde_ref,
                             r.get("fde_se_ref"), int(r.df), margin_pct)
            # the printed CI belongs to the metric that DRIVES the suite
            # verdict (worst severity, then larger delta), so a reader
            # sizing up an inconclusive suite sees the CI that caused it;
            # a nan delta compares neither greater nor less, so between
            # verdicts of one severity max() then keeps the first operand,
            # the ADE's, as mst_tpu's does
            worst = max((va, vf),
                        key=lambda v: (severity[v["verdict"]],
                                       abs(v["delta_pct"])))
            v = {"ade_delta_pct": va["delta_pct"],
                 "fde_delta_pct": vf["delta_pct"],
                 "ci_lo_pct": worst["ci_lo_pct"],
                 "ci_hi_pct": worst["ci_hi_pct"],
                 "mdd_pct": max(va["mdd_pct"], vf["mdd_pct"]),
                 "verdict": worst["verdict"]}
            verdicts.append(v)
        rep = pd.concat([rep, pd.DataFrame(verdicts, index=rep.index)],
                        axis=1)
        if (rep.verdict == "different").any():
            code = 1
        elif (rep.verdict != "equivalent").any():
            code = 2  # inconclusive OR missing from the reference table
    elif ref_table is not None:
        code = 2  # a gate that compared nothing must not pass
    return rep, code


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log_dir", help="directory of per-suite *.out logs")
    ap.add_argument("ref_table", nargs="?", default=None,
                    help="reference csv: suite,ade,fde[,ade_se,fde_se]")
    ap.add_argument("--margin_pct", type=float, default=1.0)
    ap.add_argument("--out", default="parity_report.csv")
    args = ap.parse_args(argv)
    rep, code = build_report(args.log_dir, args.ref_table,
                             args.margin_pct)
    rep.to_csv(args.out, index=False)
    with pd.option_context("display.width", 200,
                           "display.max_columns", 50):
        print(rep.to_string(index=False))
    print(f"wrote {args.out}")
    if args.ref_table:
        has_verdict = "verdict" in rep.columns and len(rep)
        n_bad = int((rep.verdict == "different").sum()) if has_verdict \
            else 0
        n_inc = int((rep.verdict == "inconclusive").sum()) if has_verdict \
            else 0
        n_noref = int((rep.verdict == "no_ref").sum()) if has_verdict \
            else 0
        if not has_verdict:
            print("PARITY INCONCLUSIVE: no suite logs were parsed — "
                  "nothing was compared")
        elif code == 1:
            print(f"PARITY FAIL: {n_bad} suites demonstrably exceed "
                  f"the {args.margin_pct}% margin")
        elif code == 2:
            detail = []
            if n_inc:
                detail.append(f"{n_inc} cannot resolve "
                              f"{args.margin_pct}% at this sample size "
                              f"(raise n_round / add seeds; see mdd_pct)")
            if n_noref:
                detail.append(f"{n_noref} have no matching row in the "
                              f"reference table (check suite names)")
            print("PARITY INCONCLUSIVE: " + "; ".join(detail))
        else:
            print(f"PARITY OK: every suite shown equivalent within "
                  f"{args.margin_pct}% (TOST, alpha=0.05)")
    return code


if __name__ == "__main__":
    sys.exit(main())
