"""Structured per-epoch metrics (counterpart of
mst_tpu/evaluator/logs.py:19-45): one JSON object a line, beside the
reference-compatible stdout."""

import json
import pathlib
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
