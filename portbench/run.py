"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is portbench/workloads/<cell>.json; it names its configuration
(portbench/configs/<name>.json) and its loop (portbench/loops/
<kind>.py), which builds the program on inputs made from the seed, warms
up every shape the cell uses, measures for --seconds and then decides
`correct` against the plain reference (portbench/reference/). With
--trace 0 the last line of standard output holds the cell's end-to-end
metrics of BENCHMARK.json; with --trace 1 its per-layer metrics, each
read by portbench/metrics/<name>.py from the traced window. Each number
compared is printed beside its limit as the last lines of standard
error, and under "checks" in the result line.

A run exits non-zero, printing no result, without a card (or with fewer
than the cell asks for), when the program is not beside it, and when jax,
jaxlib, flax or mst_tpu was loaded in the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import core  # noqa: E402


class Context:
    """What a loop is given: the cell, its run configuration, the
    run's arguments and the device's few operations."""

    def __init__(self, cell, cfg, seed, seconds, trace, device, t0):
        import torch

        self.torch = torch
        self.cell, self.cfg = cell, cfg
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)

    def memory_peak(self):
        if self.device == "cpu":
            return 0
        return int(self.torch.cuda.max_memory_allocated())

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])


def applies(metric, cell_name, reported):
    """Whether a metric of BENCHMARK.json is this cell's: named in its
    `workloads`, or, without that key, moving (or being) a metric the
    cell reports."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def measure(bench, cell_name, cell, config, seed, seconds, trace,
            device="cuda", t0=T0):
    """One run -> (the result line's dict, the checks {name: (value,
    limit)}). Raises core.RunError where no result may be printed."""
    import torch

    if device != "cpu":
        core.require_cards(torch, int(cell["chips"]))
        print(core.card_line(torch), file=sys.stderr)
        print("peaks: 67e12 FLOP/s f32 outside the tensor cores, 3.35e12 "
              "B/s HBM (H100 SXM data sheet, 700 W)", file=sys.stderr)
    ctx = Context(cell, core.run_config(config, cell), seed, seconds,
                  bool(trace), device, t0)
    result = core.load_module("loops", cell["loop"]).run(ctx)
    found = core.forbidden_modules()
    if found:
        raise core.RunError(f"the run loaded {', '.join(found)}")

    e2e = [m for m in bench["end_to_end"]
           if applies(m, cell_name, result["e2e"])]
    metrics = {}
    if not trace:
        for m in e2e:
            if m["name"] not in result["e2e"]:
                raise core.RunError(f"the cell's loop gave no {m['name']}")
            metrics[m["name"]] = {"value": result["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        names = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if not applies(m, cell_name, names):
                continue
            value = core.load_module("metrics", m["name"]).read(
                result["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = result["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": result["memory_peak_bytes"]}
    breakdown = None
    tr = result["record"].get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line, checks


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        core.set_environment()
        bench_path = core.CHECKOUT / "BENCHMARK.json"
        if not bench_path.is_file():
            raise core.RunError(f"no {bench_path}")
        with open(bench_path) as f:
            bench = json.load(f)
        cell = core.read_json("workloads", args.workload)
        config = core.read_json("configs", cell["config"])
        try:
            import mst_tpu_torch  # noqa: F401
        except ImportError as e:
            raise core.RunError(f"the program is not here: {e}") from e
        line, checks = measure(bench, args.workload, cell, config,
                               args.seed, args.seconds, args.trace)
    except core.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    core.print_checks(checks)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
