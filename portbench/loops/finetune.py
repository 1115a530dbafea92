"""The fine-tune loop: MoSA adaptation, a closed loop of Adam steps of
`train.steps.make_train_step` with `train.trainer.setup_training`'s Adam,
over a few-shot set cycled in seeded order, each step ending in a
synchronise.

`correct`: set-up builds the one training step with its model and
optimizer state, drives it from the seed through its first three steps
(three distinct batches, through the same call and feed as the window)
and keeps what they gave: each step's losses and top-1 metric sums, the
first gradient as Adam holds it after one step (its first moment over
1 - b1), and the trainable leaves after the third. The window goes on
with the same object. After it, the plain reference follows those three
steps from the same weights on the same batches, and four numbers are
compared: `loss_rel` (each step's three losses, relative), `metric_rel`
(the top-1 ADE/FDE sums, relative), `grad_gap` and `change_gap` (by the
worst leaf: the gap between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf; `change_gap` leaves out a leaf whose reference gradient stays
under a thousandth of the median leaf's over the three steps).
"""

import gc
import statistics
import time

import torch

from portbench import core, traffic
from portbench.reference import model
from portbench.reference import train as ref_train

OUTPUT_KEYS = ("loss", "goal_loss", "traj_loss", "ade_sum", "fde_sum")
LOSS_KEYS = OUTPUT_KEYS[:3]
FIRST_STEPS = 3


class Tuned:
    """The benchmark's inputs and the training step built on them."""

    def __init__(self, cell, cfg, seed, device):
        from mst_tpu_torch import io
        from mst_tpu_torch.config import step_config, ynet_config
        from mst_tpu_torch.train.steps import make_train_step
        from mst_tpu_torch.train.trainer import setup_training

        self.cell, self.cfg, self.device = cell, cfg, device
        self.net = model.Net.of(cfg)
        self.H, self.W = cell["height"], cell["width"]
        self.weights = traffic.weights(self.net, seed, device)
        params = core.program_params(cfg)
        self.tree = io.unflatten({k: v.clone()
                                  for k, v in self.weights.items()})
        self.optimizer = setup_training(self.tree, params,
                                        cell["n_batches"])["optimizer"]
        self.named = {k: v for k, v in io.flatten(self.tree).items()
                      if v.requires_grad}
        self.step_fn = make_train_step(ynet_config(params),
                                       step_config(params))
        self.state = {}
        self.batches = traffic.few_shot(seed, cell, cfg, device)
        self.order = traffic.batch_order(seed, cell["n_batches"],
                                         cell["max_steps"])

    def step(self, i):
        self.state, metrics = self.step_fn(self.tree, self.state,
                                           self.optimizer,
                                           self.batches[self.order[i]])
        return metrics

    def first_steps(self):
        """The first three steps -> what the reference is held to."""
        start = {k: v.detach().clone() for k, v in self.named.items()}
        outputs, grads = [], None
        for i in range(FIRST_STEPS):
            m = self.step(i)
            outputs.append({k: float(m[k]) for k in OUTPUT_KEYS})
            if i == 0:
                grads = {k: self.optimizer.state[p]["exp_avg"].clone()
                         / (1 - ref_train.B1) for k, p in self.named.items()}
        change = {k: v.detach() - start[k] for k, v in self.named.items()}
        return {"outputs": outputs, "grads": [grads], "change": change}

    def release(self):
        self.tree = self.optimizer = self.named = self.step_fn = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def follow(tuned, fault=None):
    """The reference's three steps on the same weights and batches;
    `fault` plants one of the faults a training step can have in the
    reference, for readings of what each number catches."""
    batches = [tuned.batches[tuned.order[i]] for i in range(FIRST_STEPS)]
    if fault == "half_batch":
        batches = [dict(b, mask=torch.cat([
            b["mask"][:len(b["mask"]) // 2],
            torch.zeros_like(b["mask"][len(b["mask"]) // 2:])]))
            for b in batches]
    return ref_train.follow(tuned.weights, tuned.net, tuned.cfg, batches,
                            float(tuned.cfg["lr"]), FIRST_STEPS)


def _rel(p, r):
    if r:
        return abs(p - r) / abs(r)
    return 0.0 if p == r else float("inf")


def _by_worst_leaf(prog, ref, keys):
    pn = {k: ref_train.norm(prog[k]) for k in keys}
    rn = {k: ref_train.norm(ref[k]) for k in keys}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in keys:
        den = max(rn[k], med)
        num = abs(pn[k] - rn[k])
        worst = max(worst, num / den if den > 0 else (
            0.0 if num == 0 else float("inf")))
    return worst


def readings(obs, ref):
    """The compared numbers of observed first steps against the
    reference's."""
    loss_rel = max(_rel(o[k], r[k]) for o, r in zip(obs["outputs"],
                                                    ref["outputs"])
                   for k in LOSS_KEYS)
    metric_rel = max(_rel(o[k], r[k]) for o, r in zip(obs["outputs"],
                                                      ref["outputs"])
                     for k in ("ade_sum", "fde_sum"))
    keys = sorted(ref["change"])
    grad_gap = _by_worst_leaf(obs["grads"][0], ref["grads"][0], keys)
    moved = {k: max(ref_train.norm(g[k]) for g in ref["grads"])
             for k in keys}
    floor = 1e-3 * statistics.median(moved.values())
    change_gap = _by_worst_leaf(obs["change"], ref["change"],
                                [k for k in keys if moved[k] >= floor])
    return {"loss_rel": loss_rel, "metric_rel": metric_rel,
            "grad_gap": grad_gap, "change_gap": change_gap}


def run(ctx):
    cell, cfg = ctx.cell, ctx.cfg
    t_built = time.perf_counter()
    tuned = Tuned(cell, cfg, ctx.seed, ctx.device)
    ctx.sync()
    t_warm = time.perf_counter()
    first = tuned.first_steps()  # also the warm-up: the one batch shape
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"setup: {t_built - ctx.t0:.2f} s to the loop, "
            f"{t_warm - t_built:.2f} s inputs and program, "
            f"{setup_s - (t_warm - ctx.t0):.2f} s the first {FIRST_STEPS} "
            "steps")

    n_prof = cell["profile_steps"]
    trace, profiled = None, 0
    t_start = time.perf_counter()
    i = FIRST_STEPS
    while True:
        if ctx.trace and i == FIRST_STEPS + 2:
            prof = ctx.profiler()
            prof.__enter__()
        tuned.step(i)
        ctx.sync()
        if trace is None and ctx.trace and i >= FIRST_STEPS + 2:
            profiled += 1
            if profiled == n_prof:
                prof.__exit__(None, None, None)
                trace = core.Trace(torch, prof)
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds and (
                not ctx.trace or trace is not None):
            break
        if i == cell["max_steps"]:
            raise core.RunError(f"the cell's {i} steps ran out before the "
                                "window closed")
    window_s = time.perf_counter() - t_start
    steps = i - FIRST_STEPS
    peak = ctx.memory_peak()
    tuned.release()

    values = readings(first, follow(tuned))
    limits = cell["check"]["limits"]
    record = {"net": tuned.net, "H": tuned.H,
              "W": tuned.W, "B": cell["batch_size"], "trace": trace,
              "profiled": profiled}
    return {
        "e2e": {"train_samples_per_s": steps * cell["batch_size"] / window_s,
                "setup_s": setup_s},
        "attempted": steps, "failed": 0,
        "checks": {k: (values[k], limits[k]) for k in values},
        "memory_peak_bytes": peak, "record": record, "tuned": tuned,
        "first": first}
