"""The serving loop: one client, closed loop. Each request is one scene
and its agents, with a style (the base weights or a registered MoSA
delta) and its own key; it blocks on the host copy of its K
trajectories. The window drives `serve.Predictor.predict`; a traced run
drives its two stages, `forward` then `decode`, each ending in a
synchronise, and logs how far the two stages' answer to one request lies
from `predict`'s (the program is not bit-reproducible from call to call:
two traced runs in twelve read a difference).

`correct`: after the window, a sample of the completed requests drawn
from the seed, the one with the most agents always in it, is judged by
the plain reference on the same weights, scene and key: `wp_off_share`,
the share (%) of the program's waypoints lying more than OFF_PX raw
pixels from the reference's own draws from its goal maps (a draw near a
bin's edge may flip on the last bit of a map, and a k-means centre or a
CWS draw then moves far, so the widest gap swings from run to run and
only the share separates sound runs from a lower precision);
`traj_gap_px`, the widest gap between the program's trajectories and
the reference's decode of the program's waypoints (raw pixels).
"""

import gc
import tempfile
import time

import numpy as np
import torch

from portbench import core, traffic
from portbench.reference import model, sampling

OFF_PX = 2.0
AMBIGUOUS_PX = 1e-4  # model px; the raw px round trip errs by 2 ulps, 6e-5


class Served:
    """The benchmark's inputs and the program built on them."""

    def __init__(self, cell, config, seed, device, tmp):
        from mst_tpu_torch.serve import Predictor

        self.cell, self.cfg, self.seed, self.device = cell, config, seed, device
        self.net = model.Net.of(config)
        self.H, self.W = cell["height"], cell["width"]
        self.K = int(config["n_goal"]) * int(config["n_traj"])
        self.rf = float(config["resize_factor"])
        self.weights = traffic.weights(self.net, seed, device)
        self.deltas = traffic.style_deltas(self.net, seed, cell["styles"],
                                           device)
        base = {k: v for k, v in self.weights.items() if "lora" not in k}
        traffic.write_npz(f"{tmp}/base.npz", base)
        self.program = Predictor(core.program_params(config),
                                 checkpoint=f"{tmp}/base.npz",
                                 device=device)
        for i, delta in enumerate(self.deltas):
            traffic.write_npz(f"{tmp}/style{i + 1}.npz", delta)
            self.program.add_style(f"style{i + 1}", f"{tmp}/style{i + 1}.npz")
        self.scenes = traffic.scene_maps(seed, cell["scenes"], self.H,
                                         self.W,
                                         int(config["n_semantic_classes"]),
                                         device)
        self.requests = traffic.requests(seed, cell, config)

    def predict(self, r):
        return self.program.predict(self.scenes[r["scene"]], r["observed"],
                                    key=r["key"], style=r["style"])

    def staged(self, r, spans):
        """forward, then decode, each timed to its synchronise."""
        sync = torch.cuda.synchronize if self.device != "cpu" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        feats, wps = self.program.forward(self.scenes[r["scene"]],
                                          r["observed"], key=r["key"],
                                          style=r["style"])
        sync()
        t1 = time.perf_counter()
        trajs = self.program.decode(feats, wps, style=r["style"])
        out = {"trajectories": trajs.cpu().numpy(),
               "waypoints": (wps / self.program.scfg.resize_factor)
               .cpu().numpy()}
        spans.append((t1 - t0, time.perf_counter() - t1))
        return out

    def release(self):
        self.program = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def ref_params(served, style):
    """The reference's weights of a request: the base, or the base with
    the style's LoRA factors."""
    base = {k: v for k, v in served.weights.items() if "lora" not in k}
    if style is None:
        return base
    return {**base, **served.deltas[int(style[len("style"):]) - 1]}


def model_space(waypoints, rf):
    """The program's raw-pixel waypoints back in model pixels, and where
    that is ambiguous: the decode reads a waypoint through its rounded
    pixel, and a raw coordinate within AMBIGUOUS_PX of a half pixel (in
    model pixels) does not say on which side the program's rounded."""
    w = waypoints.astype(np.float64) * np.float64(np.float32(rf))
    near = np.abs(w - np.floor(w) - 0.5) < AMBIGUOUS_PX
    return w.astype(np.float32), near


def ref_request(served, r, out=None):
    """The reference on one request -> (its own waypoint draws (K, B,
    n_wp, 2), the trajectories (K, B, pred_len, 2) it decodes from the
    program's waypoints `out['waypoints']`, or from its own draws without
    `out`), raw px. Where a program waypoint's rounding is ambiguous
    (model_space), its row is decoded both ways and the one nearer the
    program's trajectory kept."""
    params = ref_params(served, r["style"])
    dev = served.device
    obs = torch.tensor(r["observed"], device=dev)
    sem = served.scenes[r["scene"]].permute(0, 3, 1, 2).expand(
        obs.shape[0], -1, -1, -1)
    ts = int(4200 * served.rf)
    with torch.no_grad():
        feats = model.features(params, served.net, sem, obs, ts)
        goal = model.goal_logits(params, feats)
        key = sampling.Key(torch.tensor(r["key"], device=dev))
        wps = sampling.waypoint_samples(goal, obs, key, served.cfg)
        del goal
        if out is None:
            trajs = model.decode(params, feats, wps, ts,
                                 served.cell["check"]["chunk"])
            return ((wps / served.rf).cpu().numpy(),
                    (trajs / served.rf).cpu().numpy())
        w, near = model_space(out["waypoints"], served.rf)
        trajs = (model.decode(params, feats, torch.tensor(w, device=dev), ts,
                              served.cell["check"]["chunk"])
                 / served.rf).cpu().numpy()
        for k, b in np.argwhere(near.any(axis=(2, 3))):
            alt = np.where(near[k, b], np.floor(w[k, b])
                           + np.where(w[k, b] - np.floor(w[k, b]) < 0.5,
                                      0.75, 0.25), w[k, b])
            logits = model.traj_logits(
                params, [f[b:b + 1] for f in feats],
                torch.tensor(alt[None], dtype=torch.float32, device=dev), ts)
            other = (model.softargmax(logits)[0] / served.rf).cpu().numpy()
            want = out["trajectories"][k, b]
            if np.abs(other - want).max() < np.abs(trajs[k, b] - want).max():
                trajs[k, b] = other
    return (wps / served.rf).cpu().numpy(), trajs


def readings(served, sample, outputs):
    """The compared numbers over the sampled requests' outputs."""
    off = total = 0
    traj_gap = 0.0
    for i in sample:
        r = served.requests[i]
        out = outputs[i]
        ref_wps, ref_trajs = ref_request(served, r, out)
        dist = np.sqrt(((ref_wps - out["waypoints"]) ** 2).sum(-1))
        off += int((dist > OFF_PX).sum())
        total += dist.size
        traj_gap = max(traj_gap, float(
            np.abs(ref_trajs - out["trajectories"]).max()))
    return {"wp_off_share": 100.0 * off / total, "traj_gap_px": traj_gap}


def control_outputs(served, sample):
    """The reference put in the program's place, one precision down:
    TF32 convolutions and matmuls."""
    cudnn, mm = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 \
        = True
    try:
        out = {}
        for i in sample:
            wps, trajs = ref_request(served, served.requests[i])
            out[i] = {"waypoints": wps, "trajectories": trajs}
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = mm
    return out


def check_sample(seed, requests, n_done, n):
    """n completed requests drawn from the seed, the largest first."""
    agents = [len(requests[i]["observed"]) for i in range(n_done)]
    largest = int(np.argmax(agents))
    rest = [i for i in range(n_done) if i != largest]
    rng = np.random.default_rng(seed + 3)
    picked = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [largest] + sorted(int(i) for i in picked)


def run(ctx):
    cell, cfg, seed = ctx.cell, ctx.cfg, ctx.seed
    t_built = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        served = Served(cell, cfg, seed, ctx.device, tmp)
    ctx.sync()
    t_warm = time.perf_counter()
    reqs = served.requests
    sizes = sorted({len(r["observed"]) for r in reqs})
    first_of = {len(r["observed"]): r for r in reversed(reqs)}
    for b in sizes:  # each agent count once: every shape the window uses
        served.predict(first_of[b])
    if ctx.trace:
        a = served.predict(reqs[0])
        b = served.staged(reqs[0], [])
        gap = max(float(np.abs(a[k] - b[k]).max()) for k in a)
        ctx.log(f"split: forward then decode against predict on one "
                f"request: widest gap {gap!r} raw px")
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"setup: {t_built - ctx.t0:.2f} s to the loop, "
            f"{t_warm - t_built:.2f} s inputs and program, "
            f"{setup_s - (t_warm - ctx.t0):.2f} s warm-up of {len(sizes)} "
            "agent counts")

    outputs, latency, spans, syncs, profiled = {}, [], [], [], []
    trace = None
    n_prof = cell["profile_requests"]
    t_start = time.perf_counter()
    i = 0
    while True:
        r = reqs[i]
        t = time.perf_counter()
        if not ctx.trace:
            outputs[i] = served.predict(r)
        elif 2 <= i < 2 + n_prof:
            if i == 2:
                prof = ctx.profiler()
                prof.__enter__()
            outputs[i] = served.staged(r, [])
            profiled.append(len(r["observed"]))
            if i == 1 + n_prof:
                ctx.sync()
                prof.__exit__(None, None, None)
                trace = core.Trace(torch, prof)
        else:
            with core.count_syncs(torch, syncs):
                outputs[i] = served.staged(r, spans)
        latency.append(time.perf_counter() - t)
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds and (
                not ctx.trace or trace is not None):
            break
        if i == len(reqs):
            raise core.RunError(f"the cell's {len(reqs)} requests ran out "
                                "before the window closed")
    window_s = time.perf_counter() - t_start
    n_done = i
    agents = sum(len(reqs[j]["observed"]) for j in range(n_done))
    peak = ctx.memory_peak()
    served.release()

    sample = check_sample(seed, reqs, n_done, cell["check"]["requests"])
    values = readings(served, sample, outputs)
    limits = cell["check"]["limits"]
    checks = {k: (values[k], limits[k]) for k in values}
    record = {
        "net": served.net, "H": served.H, "W": served.W,
        "K": served.K, "trace": trace, "spans": spans, "syncs": syncs,
        "profiled": profiled}
    return {
        "e2e": {"agents_per_s": agents / window_s,
                "request_p90_ms": 1e3 * float(np.percentile(latency, 90)),
                "setup_s": setup_s},
        "attempted": n_done, "failed": 0, "checks": checks,
        "memory_peak_bytes": peak, "record": record, "served": served,
        "sample": sample}

