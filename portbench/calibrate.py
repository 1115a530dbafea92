"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 3 [--out FILE]

For each of --seeds, a run as run.py makes it (a short window, then the
comparison with the reference): the program's readings, the lower ones.
For each of --control-seeds, the control: the reference put in the
program's place one precision down (TF32 convolutions and matmuls), judged
by the same comparison, the upper ones; in a fine-tune cell also the
faults a training step can have, planted in the reference put in the
program's place: half of each batch left out with the mean taken over
the rest, the state returned unchanged, and the first gradient doubled.
Prints one JSON line of every reading, and writes it to --out.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import core  # noqa: E402
from portbench.run import Context  # noqa: E402


def tf32(torch, on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def control_serve(loop, result):
    served, sample = result["served"], result["sample"]
    return {"control": loop.readings(
        served, sample, loop.control_outputs(served, sample))}


def control_finetune(loop, result, torch):
    tuned, first = result["tuned"], result["first"]
    ref = loop.follow(tuned)
    tf32(torch, True)
    try:
        low = loop.follow(tuned)
    finally:
        tf32(torch, False)
    frozen = dict(first, change={k: torch.zeros_like(v)
                                 for k, v in first["change"].items()})
    doubled = dict(first, grads=[{k: 2 * v
                                  for k, v in first["grads"][0].items()}])
    return {"control": loop.readings(low, ref),
            "half_batch": loop.readings(loop.follow(tuned, "half_batch"),
                                          ref),
            "frozen": loop.readings(frozen, ref),
            "grad_doubled": loop.readings(doubled, ref)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    core.set_environment()
    import torch

    cell = core.read_json("workloads", args.workload)
    config = core.read_json("configs", cell["config"])
    core.require_cards(torch, int(cell["chips"]))
    print(core.card_line(torch), file=sys.stderr)
    loop = core.load_module("loops", cell["loop"])
    cfg = core.run_config(config, cell)
    out = {"workload": args.workload, "program": {}, "control": {}}
    for seed in list(args.seeds) + list(args.control_seeds):
        t = time.perf_counter()
        result = loop.run(Context(cell, cfg, seed, args.seconds, False,
                                    "cuda", t))
        if seed in args.seeds:
            out["program"][seed] = {k: v for k, (v, _) in
                                    result["checks"].items()}
        if seed in args.control_seeds:
            out["control"][seed] = (
                control_serve(loop, result) if cell["loop"] == "serve"
                else control_finetune(loop, result, torch))
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s "
              f"{json.dumps(out['program'].get(seed))} "
              f"{json.dumps(out['control'].get(seed))}", file=sys.stderr,
              flush=True)
        del result
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
