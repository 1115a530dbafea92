"""The ranks of a gloo world on the CPU for the port's mesh tests
(tests/test_torch_port_{mesh,ddp,ddp_jax,ddp_loop}.py).

    python -m tests.torch_port_ranks <dir> <mesh shape> <case>[,<case>...]

run from the repository's root with RANK, WORLD_SIZE, LOCAL_RANK and
LOCAL_WORLD_SIZE set (launch() sets them): each rank joins the world
through a FileStore in <dir>, builds the mesh of the shape ('replica',
'data' for two values), runs each case and pickles what it returns to
<dir>/<case>.<rank>.pkl. The cases' inputs and the world of one that the
tests hold them against are made here, from seeds, in the test process
and in every rank alike.
"""

import glob
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
OBS, PRED = 4, 8
SMALL = dict(obs_len=OBS, pred_len=PRED, waypoints=[3, 7],
             n_semantic_classes=3, encoder_channels=[8, 8, 16, 16, 16],
             decoder_channels=[16, 16, 16, 8, 8], n_goal=4, n_traj=2,
             CWS_params=dict(sigma_factor=6, ratio=2, rot=True),
             device="cpu", seed=1)
# B = 8 rows, the last 3 padding: over 2 ranks 4 and 1 valid rows, over 4
# ranks 2, 2, 1 and 0
MASK = [1, 1, 1, 1, 1, 0, 0, 0]
SGD_LR, N_STEPS = 1e-3, 2


def step_params(train_net="train", **over):
    from mst_tpu_torch.config import get_params

    position = {"serial": ["1", "2"]}.get(train_net, [])
    return get_params("sdd_shortterm_train.yaml", {
        **SMALL, "train_net": train_net, "position": position,
        "use_TTST": True, "use_CWS": True, **over})


def batch(seed=0):
    """A normal scene map and B = 8 tracks inside it (numpy)."""
    rng = np.random.default_rng(seed)
    return {"semantic": rng.normal(size=(1, H, W, 3)).astype(np.float32),
            "traj": rng.uniform(6, H - 6, size=(len(MASK), OBS + PRED, 2)
                                ).astype(np.float32),
            "mask": np.asarray(MASK, np.float32)}


def model(params):
    """The model of params with every leaf nonzero (random from seed 0,
    zero-initialised adapters made small and random, so no gradient is
    vacuous)."""
    from mst_tpu_torch import config
    from mst_tpu_torch.models.ynet import init_ynet

    weights, state = init_ynet(torch.Generator().manual_seed(0),
                               config.ynet_config(params))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for leaf in _leaves(weights):
            if leaf.is_floating_point() and not leaf.any():
                leaf.copy_(0.05 * torch.randn(leaf.shape, generator=gen))
    return weights, state


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def local_rows(b, mesh):
    """The rank's rows of a numpy batch, as tensors."""
    from mst_tpu_torch.parallel import hostdata, mesh as mesh_lib

    if mesh is None:
        return {k: torch.from_numpy(v) for k, v in b.items()}
    shards = mesh_lib.batch_shards(mesh)
    return hostdata.shard_batch_global(
        mesh, hostdata.take_local(b, shards.index, shards.count),
        len(b["mask"]))


def numpy_tree(tree):
    from mst_tpu_torch import io

    return {k: v.detach().numpy().copy() for k, v in io.flatten(tree).items()}


def train_steps(mesh, train_net="train", n_steps=N_STEPS):
    """n_steps SGD steps of the train step on the rank's rows -> each
    step's metrics, the summed gradients (p.grad) and the leaves after,
    and the model state."""
    from mst_tpu_torch import config, io
    from mst_tpu_torch.train import freeze, optim
    from mst_tpu_torch.train.steps import make_train_step

    params = step_params(train_net)
    weights, state = model(params)
    trainable = freeze.set_trainable(weights, train_net, params["position"])
    opt = optim.SGD(trainable, SGD_LR)
    step = make_train_step(config.ynet_config(params),
                           config.step_config(params), mesh)
    b = local_rows(batch(), mesh)
    named = {k: v for k, v in io.flatten(weights).items()
             if v.requires_grad}
    out = []
    for _ in range(n_steps):
        state, m = step(weights, state, opt, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {k: v.grad.numpy().copy()
                              for k, v in named.items()}})
    return {"steps": out, "weights": numpy_tree(weights),
            "state": numpy_tree(state)}


def eval_outputs(mesh, seed=3, waypoint_samples=None, collect_samples=False,
                 ttst=True):
    """One eval step with TTST and CWS on, on the rank's rows, drawing
    from a generator seeded `seed` -> its outputs (global on a mesh) and
    its forward's waypoint samples (the rank's rows). With
    waypoint_samples (the global batch's, numpy), the decode and score
    run on their rows instead of the forward's draws. collect_samples:
    the step's sample payload too (goal maps, waypoint samples); ttst
    False: CWS on sampled goals, without TTST."""
    from mst_tpu_torch import config
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.train.steps import make_eval_step

    params = step_params()
    weights, state = model(params)
    # the injected samples replace the forward's draws: no TTST to draw
    scfg = config.step_config(params,
                              use_ttst=ttst and waypoint_samples is None)
    step = make_eval_step(config.ynet_config(params), scfg, mesh,
                          collect_samples=collect_samples)
    b = local_rows(batch(), mesh)
    if waypoint_samples is None:
        out = step(weights, state, b, torch.Generator().manual_seed(seed))
        wps = step.forward(weights, state, b,
                           torch.Generator().manual_seed(seed))[1]
    else:
        feats, _ = step.forward(weights, state, b,
                                torch.Generator().manual_seed(seed))
        shards = mesh_lib.batch_shards(mesh)
        lo, hi = shards.rows(b["traj"].shape[0]) if shards else (0, None)
        wps = torch.from_numpy(waypoint_samples[:, lo:hi])
        out = step.global_outputs(step.decode_and_score(
            weights, feats, wps, b["traj"], b["mask"]))
    return {"wps": wps.numpy().copy(),
            **{k: v.numpy().copy() for k, v in out.items()}}


def case_train(mesh):
    return train_steps(mesh)


def case_serial(mesh):
    return train_steps(mesh, "serial")


def case_eval(mesh):
    return eval_outputs(mesh)


def case_samples(mesh):
    """The eval step with its sample payload (collect_samples), CWS on
    sampled goals."""
    return eval_outputs(mesh, collect_samples=True, ttst=False)


def case_injected_eval(mesh):
    """The eval step's decode and score on the waypoint samples that the
    test writes to <dir>/waypoint_samples.npy (waited for)."""
    path = os.path.join(OUT, "waypoint_samples.npy")
    wait_for(path)
    return eval_outputs(mesh, waypoint_samples=np.load(path))


def case_mesh(mesh):
    """What the rank's mesh, and every other mesh of its world, say of
    themselves: {shape: (axis names, ranks, shard index and count, batch
    shard count)}, and the backend."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    world = mesh.mesh.numel()
    out = {"backend": torch.distributed.get_backend()}
    for shape in ((world,), (1, world), (world, 1), (2, world // 2)):
        m = mesh_lib.mesh_from_shape(shape, None, "cpu")
        shards = mesh_lib.batch_shards(m)
        out[shape] = (tuple(m.mesh_dim_names), m.mesh.numpy().copy(),
                      (shards.index, shards.count),
                      mesh_lib.batch_shard_count(m))
    return out


def case_errors(mesh):
    """shard_batch_global's refusals on this world -> their messages."""
    from mst_tpu_torch.parallel import hostdata

    b = batch()
    msgs = []
    for rows, total in ((b, 7), ({k: v[:3] for k, v in b.items()}, 8)):
        try:
            hostdata.shard_batch_global(mesh, rows, total)
        except ValueError as e:
            msgs.append(str(e))
    return {"messages": msgs}


def case_checkpoint(mesh):
    """Save this rank's copy of a tree with torch.distributed.checkpoint
    into <dir>/ckpt2, restore it into a zeroed template -> both."""
    from mst_tpu_torch.train import sharded_ckpt

    tree = checkpoint_tree()
    sharded_ckpt.save_sharded(os.path.join(OUT, "ckpt2"), tree)
    template = checkpoint_tree(zero=True)
    sharded_ckpt.restore_sharded(os.path.join(OUT, "ckpt2"), template)
    return {"saved": numpy_tree(tree), "restored": numpy_tree(template)}


def case_restore_one(mesh):
    """Restore <dir>/ckpt1, which a world of one saved, into a zeroed
    template -> it."""
    from mst_tpu_torch.train import sharded_ckpt

    template = checkpoint_tree(zero=True)
    sharded_ckpt.restore_sharded(os.path.join(OUT, "ckpt1"), template)
    return {"restored": numpy_tree(template)}


# the CLI flows of tests/test_torch_port_ddp_loop.py, run from the
# directory above <dir> (its data and synth.yaml): a mosa_2 fine-tune
# through the train CLI, the same with --fused, a 2-run grid and a test
LOOP_ARGS = ["--config_filename", "synth.yaml", "--batch_size", "6",
             "--dataset_path", "filter/synth", "--load_data", "predefined",
             "--device", "cpu", "--fine_tune", "--train_net", "mosa_2",
             "--position", "0", "1", "--n_epoch", "2", "--n_train_batch",
             "2", "--lr", "0.01", "--pretrained_ckpt", "base.npz"]
GRID_ARGS = ["--seeds", "1", "2", "--lrs", "0.003"]


def loop_flows(prefix, mesh_args):
    """The train CLI (plain and --fused), the grid and the test CLI, each
    writing under <prefix>_<flow> -> {flow: stdout}, and the grid's
    summary."""
    import contextlib
    import io as text_io

    from mst_tpu_torch import config, grid
    from mst_tpu_torch import test as test_cli
    from mst_tpu_torch.train.__main__ import main as train_main

    out = {}
    for flow, extra in (("loop", []), ("fused", ["--fused"])):
        args = config.get_parser(True).parse_args(
            LOOP_ARGS + extra + mesh_args + [
                "--ckpt_path", f"{prefix}_{flow}", "--metrics_jsonl",
                f"{prefix}_{flow}/metrics.jsonl"])
        buf = text_io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_main(args)
        out[flow] = buf.getvalue()
    buf = text_io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["summary"] = grid.run_grid(grid.get_parser().parse_args(
            LOOP_ARGS + GRID_ARGS + mesh_args + [
                "--ckpt_path", f"{prefix}_grid", "--log_dir",
                f"{prefix}_grid/logs"]))
        tuned, = glob.glob(f"{prefix}_loop/*__original.npz")
        test_cli.main(config.get_parser(False).parse_args(
            LOOP_ARGS[:10] + mesh_args + [
                "--pretrained_ckpt", "base.npz", "--tuned_ckpt", tuned,
                "--n_round", "2"]))
    out["grid"] = buf.getvalue()
    return out


def case_loop(mesh):
    """loop_flows on this world's mesh, from the directory above <dir>."""
    os.chdir(os.path.dirname(OUT))
    return loop_flows("w2", ["--mesh_shape", str(mesh.mesh.numel())])


def checkpoint_tree(zero=False):
    """A training state's kinds of leaves: f32 weights, Adam moments, an
    int32 count."""
    gen = torch.Generator().manual_seed(7)
    tree = {"trainable": {"a/w": torch.randn(4, 3, generator=gen),
                          "b": torch.randn(5, generator=gen)},
            "opt": {"count": torch.tensor(3, dtype=torch.int32),
                    "mu": torch.randn(4, 3, generator=gen)}}
    if zero:
        for leaf in _leaves(tree):
            leaf.zero_()
    return tree


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}
OUT = None


def launch(out_dir, shape, cases, timeout=240):
    """Run `cases` on a world of prod(shape) ranks (processes) -> each
    case's list of what each rank returned."""
    return finish(start(out_dir, shape, cases), timeout)


def start(out_dir, shape, cases):
    """Start the ranks of launch() -> a handle for finish()."""
    world = int(np.prod(shape))
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_ranks", str(out_dir),
         ",".join(map(str, shape)), ",".join(cases)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return out_dir, cases, procs


def finish(handle, timeout=240):
    """Wait for the ranks of start() (each within `timeout` s) -> each
    case's list of what each rank returned."""
    out_dir, cases, procs = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    results = {}
    for case in cases:
        results[case] = []
        for r in range(len(procs)):
            with open(os.path.join(out_dir, f"{case}.{r}.pkl"), "rb") as f:
                results[case].append(pickle.load(f))
    return results


def wait_for(path, timeout=120):
    """Block until `path` exists (another process writes it whole, by a
    rename), failing after `timeout` s."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)


def main(out_dir, shape, cases):
    global OUT
    OUT = out_dir
    torch.set_num_threads(2)
    from mst_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.init_process_group(
        "cpu", init_method="file://" + os.path.join(out_dir, "store"))
    shape = [int(s) for s in shape.split(",")]
    mesh = mesh_lib.mesh_from_shape(
        shape, ["replica", "data"] if len(shape) == 2 else None, "cpu")
    rank = torch.distributed.get_rank()
    for case in cases.split(","):
        out = CASES[case](mesh)
        with open(os.path.join(out_dir, f"{case}.{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
