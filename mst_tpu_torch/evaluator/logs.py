"""Structured metrics and the stdout-log scrapers (counterpart of
mst_tpu/evaluator/logs.py).

The reference records metrics by regex-scraping stdout logs
(utils/extract_log.py, utils/extract_training_curve.py,
evaluator/write_files.py). The port writes one JSON object a line
(MetricsLogger) beside the stdout, and keeps mst_tpu's scrapers with
mst_tpu's regexes: the port's CLIs print the same 'Experiment ... has
started', 'Epoch e:', 'Round N: / Test ADE:' and 'Average performance'
lines, so both packages' logs parse into the same frames. pandas is
imported by the functions that return a frame.
"""

import json
import pathlib
import re
import time


class MetricsLogger:
    """Append-only JSONL metrics sink (one dict per line)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, **kv):
        kv.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(kv, default=float) + "\n")

    def read(self):
        import pandas as pd

        with open(self.path) as f:
            return pd.DataFrame([json.loads(line) for line in f])


# ---------------------------------------------------------------------------
# stdout scraping (reference utils/extract_log.py)
# ---------------------------------------------------------------------------

_AVG_RE = (r"Average performance \(by [\d]+\): \nTest ADE: ([\d\.]+) \n"
           r"Test FDE: ([\d\.]+)")


def extract_test_metrics(text):
    """'Average performance' blocks -> DataFrame [ade, fde]
    (reference extract_log.py:44-71)."""
    import pandas as pd

    rows = [{"ade": float(a), "fde": float(f)}
            for a, f in re.findall(_AVG_RE, text)]
    return pd.DataFrame(rows)


# wider float pattern than the byte-compat _AVG_RE: the SE estimator must
# not silently drop rounds printed as 'nan'/'inf'/scientific notation — a
# non-finite value parses and propagates, turning the suite verdict
# 'inconclusive' downstream instead of corrupting the spread
_NUM = r"([-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|nan|inf))"
_ROUND_W_RE = rf"Round (\d+): \nTest ADE: {_NUM} \nTest FDE: {_NUM}"
_AVG_W_RE = (rf"Average performance \(by [\d]+\): \nTest ADE: {_NUM} \n"
             rf"Test FDE: {_NUM}")


def extract_runs_with_rounds(text):
    """Per-round metrics grouped into runs.

    The Experiment loop prints one 'Round i: / Test ADE/FDE' block per
    stochastic round (mst_tpu_torch/train/trainer.py's test(), byte-compatible with reference
    trainer.py:345) followed by ONE 'Average performance (by N)' block per
    run (reference trainer.py:348-351). Returns a list of runs, each
    {"ade": run-average ADE, "fde": ..., "round_ade": [per-round ADEs],
    "round_fde": [...]} — the raw material for the parity decision rule
    (parity_stats.py): the round spread estimates the protocol's own
    sampling noise.

    A 'Round 0' block with rounds already pending marks a run whose
    Average line never printed (killed/partial log): the stale rounds are
    dropped rather than leaked into the next run's spread.
    """
    runs, rounds = [], []
    pat = re.compile(f"(?:{_ROUND_W_RE})|(?:{_AVG_W_RE})")
    for m in pat.finditer(text):
        if m.group(1) is not None:  # a Round block
            if m.group(1) == "0" and rounds:
                rounds = []  # previous run died before its Average block
            rounds.append((float(m.group(2)), float(m.group(3))))
        else:  # an Average block closes the current run
            runs.append({
                "ade": float(m.group(4)), "fde": float(m.group(5)),
                "round_ade": [a for a, _ in rounds],
                "round_fde": [f for _, f in rounds]})
            rounds = []
    return runs


def extract_train_metrics(text):
    """Per-experiment summary rows from a train log
    (reference extract_log.py:8-41)."""
    import pandas as pd

    rows = []
    for msg in re.split(r"Experiment ", text)[1:]:
        experiment = msg.split(" has started")[0]
        n_param = re.search(
            r"The number of trainable parameters: ([\d]+)", msg)
        early = re.search(r"Early stop at epoch ([\d]+)", msg)
        metric = re.search(_AVG_RE, msg)
        rows.append({
            "experiment": experiment,
            "n_param": int(n_param.group(1)) if n_param else 0,
            "n_epoch": int(early.group(1)) if early else None,
            "ade": float(metric.group(1)) if metric else None,
            "fde": float(metric.group(2)) if metric else None,
        })
    return pd.DataFrame(rows)


def extract_epoch_curve(text):
    """'Epoch e: Train ... Val ...' lines -> per-epoch DataFrame
    (reference utils/extract_training_curve.py:10-32)."""
    import pandas as pd

    pat = (r"Epoch (\d+): \tTrain \(Top-1\) ADE: ([\d\.]+) "
           r"FDE: ([\d\.]+) \t\tVal \(Top-k\) ADE: ([\d\.]+) "
           r"FDE: ([\d\.]+)")
    rows = [{"epoch": int(e), "train_ade": float(ta), "train_fde": float(tf),
             "val_ade": float(va), "val_fde": float(vf)}
            for e, ta, tf, va, vf in re.findall(pat, text)]
    return pd.DataFrame(rows)


def extract_imp_msg(text):
    """Importance-run stdout -> DataFrame [seed, layer, ade, fde,
    tuned_ckpt, pretrained_ckpt] (reference utils/extract_log.py:74-97).

    Each importance run echoes its params dict (which contains
    'save_every_n') followed by interleaved 'Replacing <layer>' lines and
    'Average performance' blocks; runs are delimited by the params echo.
    mst_tpu_torch/evaluator/importance.py writes its csv directly, but this
    scraper lets old-style stdout logs be recovered the same way.
    """
    import pandas as pd

    rows = []
    for msg in re.split("save_every_n", text)[1:]:
        seed = re.search(r"'seed': (\d+),", msg)
        pretrained = re.search(r"'pretrained_ckpt': '(.*?)',", msg)
        tuned = re.search(r"'tuned_ckpts': \['(.*?)'\],", msg)
        layers = re.findall(r"Replacing (.*?)\n", msg)
        metrics = re.findall(_AVG_RE, msg)
        for layer, (ade, fde) in zip(layers, metrics):
            rows.append({
                "seed": int(seed.group(1)) if seed else None,
                "layer": layer,
                "ade": float(ade),
                "fde": float(fde),
                "tuned_ckpt": tuned.group(1) if tuned else None,
                "pretrained_ckpt": pretrained.group(1) if pretrained else None,
            })
    return pd.DataFrame(
        rows, columns=["seed", "layer", "ade", "fde", "tuned_ckpt",
                       "pretrained_ckpt"])


def write_csv(df, out_path):
    """reference evaluator/write_files.py:8-21."""
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out_path, index=False)
    return out_path
