"""The ranks of a gloo world on the CPU for the port's mesh tests
(tests/test_torch_port_{mesh,ddp,ddp_jax,ddp_loop,spatial*}.py).

    python -m tests.torch_port_ranks <dir> <mesh shape> <case>[,<case>...]
        [<axes>]

run from the repository's root with RANK, WORLD_SIZE, LOCAL_RANK and
LOCAL_WORLD_SIZE set (launch() sets them): each rank joins the world
through a FileStore in <dir>, builds the mesh of the shape (axes
'replica,data' for two values unless <axes> names them, as 'data,space'
for the spatial mesh), runs each case and pickles what it returns to
<dir>/<case>.<rank>.pkl. The cases' inputs and the world of one that the
tests hold them against are made here, from seeds, in the test process
and in every rank alike.
"""

import glob
import json
import os
import pickle
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


def write_loop_world(root, img_hw=(64, 96), widths=None):
    """LOOP_ARGS' world under root, run from root: 2 synthetic scenes of
    10 tracks as jpgs (img_hw), predefined 14 / 3 / 3 pickles, synth.yaml
    (a 2-stage model, or `widths`' encoder and decoder channels; a
    checkpoint and a training state every epoch) and a full base
    checkpoint, base.npz."""
    import cv2
    import yaml

    from mst_tpu.data.synthetic import make_synthetic_dataset
    from mst_tpu_torch import config
    from mst_tpu_torch.train import trainer

    df, images = make_synthetic_dataset(seed=0, n_scenes=2, n_traj=10,
                                        total_len=20, img_hw=img_hw)
    for scene, im in images.items():
        name, idx = scene.split("_")
        d = root / "data/sdd/raw/annotations" / name / f"video{idx}"
        d.mkdir(parents=True)
        cv2.imwrite(str(d / "reference.jpg"), (im * 255).astype(np.uint8))
    ddir = root / "data/sdd/filter/synth"
    ddir.mkdir(parents=True)
    ids = df.metaId.unique()
    for split, part in (("train", ids[:14]), ("val", ids[14:17]),
                        ("test", ids[17:])):
        df[df.metaId.isin(part)].to_pickle(ddir / f"{split}.pkl")
    cfg = config.get_params("sdd_shortterm_train.yaml")
    cfg = {k: cfg[k] for k in ("resize_factor", "waypoints", "temperature",
                               "loss_scale", "kernlen", "nsig", "use_TTST",
                               "rel_threshold", "use_CWS", "obs_len",
                               "pred_len", "use_raw_data", "data_dir",
                               "dataset_name")}
    cfg.update(encoder_channels=[8, 8], decoder_channels=[8, 8],
               n_semantic_classes=3, n_goal=4, n_traj=1, save_every_n=1)
    cfg.update(widths or {})
    (root / "synth.yaml").write_text(yaml.safe_dump(cfg))
    trainer.Experiment(config.get_params(
        "synth.yaml", {"device": "cpu", "seed": 0})).save_params("base.npz")


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


# ---- the spatial ('data', 'space') mesh (tests/test_torch_port_spatial*)

def spatial_rows(b, mesh):
    """The rank's rows of a numpy batch and its H slab of the scene map
    (of the image, for a step that segments it), as tensors (the whole
    batch without a mesh), cut as Experiment cuts them: the rows by
    local_rows, the map by the rank's Slab.take."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    out = local_rows(b, mesh)
    slab = mesh_lib.space_slab(mesh, b["semantic"].shape[1])
    if slab is not None:
        out["semantic"] = slab.take(out["semantic"])
    return out


def spatial_batch(height, seed=0):
    """batch() at another scene height (W stays 64)."""
    rng = np.random.default_rng(seed)
    return {"semantic": rng.normal(size=(1, height, W, 3)).astype(
                np.float32),
            "traj": np.stack([rng.uniform(4, W - 4, size=(len(MASK),
                                                          OBS + PRED)),
                              rng.uniform(4, height - 4, size=(
                                  len(MASK), OBS + PRED))], -1).astype(
                np.float32),
            "mask": np.asarray(MASK, np.float32)}


# the eval cases: (params overrides, scene height)
SPATIAL_EVALS = {
    # sdd_shortterm with TTST: one waypoint, the goal
    "ttst": (dict(waypoints=[7], use_TTST=True, use_CWS=False), H),
    # a longterm setting: CWS on sampled goals, two waypoints
    "cws": (dict(use_TTST=False, use_CWS=True), H),
    # a height whose slabs go odd before the coarsest level at S = 2
    "odd": (dict(waypoints=[7], use_TTST=True, use_CWS=False), 32),
    # TTST with a shallow segmentation backbone in the step
    # (segment_in_step): each rank segments its slab of the scene
    "segment": (dict(waypoints=[7], use_TTST=True, use_CWS=False), H),
    # the same backbone under CWS (two waypoints), and TTST on a
    # cross-scene batch of two images (tests/test_torch_port_spatial_
    # backbone_steps.py)
    "segment_cws": (dict(use_TTST=False, use_CWS=True), H),
    "segment_cross": (dict(waypoints=[7], use_TTST=True, use_CWS=False), H),
}


def spatial_eval(mesh, name, collect_samples=False, waypoint_samples=None,
                 seed=3):
    """One eval step of SPATIAL_EVALS[name] on the rank's rows and slab
    (the whole batch without a mesh), drawing from a generator seeded
    `seed` -> its outputs (global), and the forward's waypoint samples
    (the rank's rows). waypoint_samples (the global batch's, numpy): the
    decode and score run on their rows instead of the forward's draws."""
    from mst_tpu_torch import config
    from mst_tpu_torch.models.unet import unet_init
    from mst_tpu_torch.parallel import mesh as mesh_lib
    from mst_tpu_torch.train.steps import make_eval_step

    over, height = SPATIAL_EVALS[name]
    segment = name.startswith("segment")
    params = step_params(**over)
    weights, state = model(params)
    if segment:
        weights["segmentation"] = unet_init(
            torch.Generator().manual_seed(2), n_classes=3,
            layers=(1, 1, 1, 1))
    step = make_eval_step(config.ynet_config(params), config.step_config(
        params, segment_in_step=segment), mesh,
        collect_samples=collect_samples)
    b = spatial_rows(cross_batch() if name.endswith("cross")
                     else spatial_batch(height), mesh)
    fwd = step.forward(weights, state, b, torch.Generator().manual_seed(
        seed))
    if waypoint_samples is None:
        out = step(weights, state, b, torch.Generator().manual_seed(seed))
        wps = fwd[1]
    else:
        shards = mesh_lib.batch_shards(mesh)
        lo, hi = shards.rows(b["traj"].shape[0]) if shards else (0, None)
        wps = torch.from_numpy(waypoint_samples[:, lo:hi])
        out = step.global_outputs(step.decode_and_score(
            weights, fwd[0], wps, b["traj"], b["mask"]))
    return {"wps": wps.numpy().copy(), "rows": fwd[0][0].shape[1],
            **{k: v.numpy().copy() for k, v in out.items()}}


def case_spatial_mesh(mesh):
    """What the rank's spatial mesh says of itself: axis names, ranks,
    its Shards, the batch shard count, its slab of a 64-row map, a Shards
    sum of ones (the 'data' ranks' count) and a row gather, and the
    refusal of a 62-row scene map."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    shards = mesh_lib.batch_shards(mesh)
    slab = mesh_lib.space_slab(mesh, H)
    ones = shards.all_reduce(torch.ones(3))
    try:  # a scene 2 rows short of the batch's
        mesh_lib.check_spatial_scene(mesh, "semantic",
                                     np.zeros((1, H - 2, W, 3)))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"names": tuple(mesh.mesh_dim_names), "refused": refused,
            "ranks": mesh.mesh.numpy().copy(),
            "shards": (shards.index, shards.count),
            "batch_shard_count": mesh_lib.batch_shard_count(mesh),
            "slab": (slab.index, slab.count, slab.lo, slab.hi),
            "sum": ones.numpy().copy(),
            "gathered": shards.gather_rows(torch.full(
                (2,), float(torch.distributed.get_rank()))).numpy().copy()}


def slab_ops(height=24, width=10, seed=5):
    """The ops of a spatial mesh's slab on one seeded input: {name:
    (fn(x, slab) on the slab, the whole-map op's rows of the slab)},
    each fn taking x (N, rows, W, C)."""
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.ops import heatmap, pooling

    gen = torch.Generator().manual_seed(seed)
    w3 = 0.3 * torch.randn(6, 5, 3, 3, generator=gen)
    w1 = 0.3 * torch.randn(6, 5, 1, 1, generator=gen)
    bias = torch.randn(6, generator=gen)
    lora = {"weight": w3, "bias": bias,
            "lora_A": torch.randn(2 * 3, 5 * 3, generator=gen),
            "lora_B": 0.1 * torch.randn(6 * 3, 2 * 3, generator=gen)}
    pts = torch.rand(3, 4, 2, generator=gen) * torch.tensor(
        [width, height])
    return {
        "conv3x3": lambda x, sl: layers.conv2d(x, w3, bias, sl),
        "conv1x1": lambda x, sl: layers.conv2d(x, w1, bias, sl),
        "lora3x3": lambda x, sl: layers.lora_conv_apply(lora, x, 2, sl),
        "upsample": lambda x, sl: pooling.upsample_bilinear_2x(x, sl),
        "max_pool": lambda x, sl: pooling.max_pool_2x2(x),
        "avg_pool": lambda x, sl: pooling.avg_pool_2x2(x),
        "dist": lambda x, sl: heatmap.rasterize_dist_nhwc(
            pts, x.shape[1], width, 100, 0 if sl is None else sl.lo),
        "gaussian": lambda x, sl: heatmap.rasterize_gaussian_nhwc(
            pts, x.shape[1], width, 7, 2.0, 0 if sl is None else sl.lo),
    }, torch.randn(2, height, width, 5, generator=gen)


def case_spatial_ops(mesh):
    """Each op of slab_ops on the rank's slab, its output gathered to the
    whole map -> {op: max |gathered - whole op|}."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    ops, x = slab_ops()
    slab = mesh_lib.space_slab(mesh, x.shape[1])
    out = {}
    for name, fn in ops.items():
        whole = fn(x, None)
        part = fn(slab.take(x), slab)
        got = mesh_lib.Slab(slab.index, slab.count, slab.group,
                            whole.shape[1]).gather(part)
        out[name] = float((got - whole).abs().max())
    return out


def case_spatial_partition(mesh):
    """The encoder and the goal decoder on the rank's slabs of a 64-row
    and a 32-row scene: {height: (the finest feature map's rows, each
    level's rows, the goal map's rows, the slabs' gathers)}."""
    from mst_tpu_torch import config
    from mst_tpu_torch.models import ynet
    from mst_tpu_torch.parallel import halo
    from mst_tpu_torch.parallel import mesh as mesh_lib

    params = step_params()
    weights, state = model(params)
    mcfg = config.ynet_config(params)
    gather, log = halo.gather, []

    def logged(x, index, count, group, dim=0):
        log.append(("gather", x.shape[dim] * count))
        return gather(x, index, count, group, dim)

    out = {}
    halo.gather = logged
    try:
        for height in (H, 32):
            slab = mesh_lib.space_slab(mesh, height)
            slabs = slab.levels(len(mcfg.encoder_channels) + 1)
            b = spatial_rows(spatial_batch(height), mesh)
            sem = b["semantic"].expand(b["traj"].shape[0], -1, -1, -1)
            obs = torch.rand(sem.shape[:3] + (OBS,))
            del log[:]
            feats, _ = ynet.pred_features(weights, state, mcfg, sem, obs,
                                          slabs=slabs)
            goal = ynet.pred_goal(weights, feats, slabs)
            out[height] = (feats[0].shape[1], [f.shape[1] for f in feats],
                           goal.shape[1], list(log))
    finally:
        halo.gather = gather
    return out


def case_spatial_ttst(mesh):
    return spatial_eval(mesh, "ttst")


def case_spatial_cws(mesh):
    return spatial_eval(mesh, "cws")


def case_spatial_odd(mesh):
    return spatial_eval(mesh, "odd")


def case_spatial_segment(mesh):
    return spatial_eval(mesh, "segment")


def case_spatial_samples(mesh):
    """The CWS eval with its sample payload (collect_samples)."""
    return spatial_eval(mesh, "cws", collect_samples=True)


def spatial_injected(mesh, name):
    """SPATIAL_EVALS[name]'s decode and score on the waypoint samples that
    the test writes to <dir>/waypoint_samples_<name>.npy (waited for)."""
    path = os.path.join(OUT, f"waypoint_samples_{name}.npy")
    wait_for(path)
    return spatial_eval(mesh, name, waypoint_samples=np.load(path))


def case_spatial_injected_ttst(mesh):
    return spatial_injected(mesh, "ttst")


def case_spatial_injected_cws(mesh):
    return spatial_injected(mesh, "cws")


SPATIAL_TEST_ARGS = LOOP_ARGS[:10] + ["--pretrained_ckpt", "base.npz",
                                      "--n_round", "2"]


def case_spatial_cli(mesh):
    """From the directory above <dir> (write_loop_world's): the test CLI
    on the spatial mesh -> its stdout, and each scene's image as its
    batches hold it (N, H, W, C) beside the image Experiment uploaded for
    them; then the train CLI, the same with --fused, and Experiment.train
    with --cross_scene_batching and --remat on the mesh
    (spatial_train_flows)."""
    import contextlib
    import io as text_io

    from mst_tpu_torch import config
    from mst_tpu_torch import test as test_cli
    from mst_tpu_torch.data import scenes
    from mst_tpu_torch.train import trainer

    os.chdir(os.path.dirname(OUT))
    mesh_args = ["--mesh_shape", *map(str, mesh.mesh.shape),
                 "--mesh_axes", "data", "space"]
    device_batches, uploads = trainer.Experiment._device_batches, {}

    def recorded(self, batches):
        out = device_batches(self, batches)
        for b, db in out:
            whole = b.image if isinstance(b, scenes.BucketedBatch) \
                else b.image[None]
            uploads.setdefault(str(b.scene_id), (
                np.asarray(whole).copy(), db["image"].numpy().copy()))
        return out

    buf = text_io.StringIO()
    trainer.Experiment._device_batches = recorded
    try:
        with contextlib.redirect_stdout(buf):
            test_cli.main(config.get_parser(False).parse_args(
                SPATIAL_TEST_ARGS + mesh_args))
    finally:
        trainer.Experiment._device_batches = device_batches
    return {"test": buf.getvalue(), "uploads": uploads,
            **spatial_train_flows("spatial", mesh_args, mesh)}


def spatial_train_flows(prefix, mesh_args, mesh=None):
    """From write_loop_world's directory: the train CLI (LOOP_ARGS' mosa_2
    fine-tune, 2 epochs), the same with --fused, and Experiment.train
    with --cross_scene_batching and --remat (1 epoch), each writing under
    <prefix>_<flow>, on mesh_args' mesh (none without) -> {flow: (its
    metrics log's records, the delta it saved)}."""
    import contextlib
    import io as text_io

    from mst_tpu_torch import config, io
    from mst_tpu_torch.data.splits import prepare_dataset
    from mst_tpu_torch.train import trainer
    from mst_tpu_torch.train.__main__ import main as train_main
    from mst_tpu_torch.utils.seeding import set_random_seeds

    def flow_args(flow, extra):
        return config.get_parser(True).parse_args(
            LOOP_ARGS + extra + mesh_args + [
                "--ckpt_path", f"{prefix}_{flow}", "--metrics_jsonl",
                f"{prefix}_{flow}/metrics.jsonl"])

    for flow, extra in (("train", []), ("fused", ["--fused"])):
        with contextlib.redirect_stdout(text_io.StringIO()):
            train_main(flow_args(flow, extra))
    args = flow_args("experiment", ["--cross_scene_batching", "--remat",
                                    "--n_epoch", "1"])
    params = config.get_params(args=args)
    image_path, data_path = config.get_image_and_data_path(params)
    set_random_seeds(args.seed)
    train, val, _ = prepare_dataset(
        data_path, args.load_data, args.batch_size, args.n_train_batch,
        args.train_files, args.val_files, args.val_split, args.test_splits,
        args.shuffle, args.share_val_test, "train", args.show_details)
    exp = trainer.Experiment(params, mesh=mesh)
    exp.load_params("base.npz")
    with contextlib.redirect_stdout(text_io.StringIO()):
        exp.train(train, val, image_path, image_path, "spatial_experiment")
    out = {}
    for flow in ("train", "fused", "experiment"):
        with open(f"{prefix}_{flow}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        delta, = glob.glob(f"{prefix}_{flow}/*__original.npz") or glob.glob(
            f"{prefix}_{flow}/spatial_experiment.npz")
        out[flow] = (records, dict(io.load_checkpoint(delta)))
    return out


# the backbone's loop world (tests/test_torch_port_spatial_backbone_steps.
# py): write_loop_world's with 256 x 384 scenes (64 x 96 after the
# config's resize), a 5-stage Y-Net (the backbone's maps divide by 32) and
# a shallow backbone of 3 classes at the config's segmentation_model_fp;
# the train CLI runs it in the step (segmentation_head), validation and
# the test CLI on the cached whole-scene maps
BACKBONE_LOOP_ARGS = [("segmentation_head" if a == "mosa_2" else a)
                      for a in LOOP_ARGS]


def write_backbone_world(root):
    """write_loop_world at the backbone's sizes under root, run from root,
    then the backbone file."""
    from mst_tpu_torch import config, io
    from mst_tpu_torch.models.unet import unet_init

    write_loop_world(root, (256, 384), {
        k: SMALL[k] for k in ("encoder_channels", "decoder_channels")})
    path = root / config.get_params("synth.yaml")["segmentation_model_fp"]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **io.params_to_numpy(unet_init(
        torch.Generator().manual_seed(2), n_classes=3, layers=(1, 1, 1,
                                                               1))))


def backbone_flows(prefix, mesh_args):
    """From write_backbone_world's directory: the train CLI (2 epochs of
    segmentation_head), the same with --fused (1 epoch), and the test CLI
    over the
    first run's delta, on mesh_args' mesh (none without) -> {flow: (its
    stdout, its metrics log's records, the delta it saved)}, the test's
    stdout, and each _device_batches call's uploads: [(in_step, cached,
    {scene: {key: array}})]."""
    import contextlib
    import io as text_io

    from mst_tpu_torch import config, io
    from mst_tpu_torch import test as test_cli
    from mst_tpu_torch.train import trainer
    from mst_tpu_torch.train.__main__ import main as train_main

    device_batches, uploads = trainer.Experiment._device_batches, []

    def recorded(self, batches, in_step=False, cached=True):
        items = device_batches(self, batches, in_step, cached)
        uploads.append((in_step, cached, {
            str(b.scene_id): {k: v.numpy().copy() for k, v in db.items()
                              if k in ("image", "raw_image")}
            for b, db in items}))
        return items

    out = {}
    trainer.Experiment._device_batches = recorded
    try:
        for flow, extra in (("train", []),
                            ("fused", ["--fused", "--n_epoch", "1"])):
            buf = text_io.StringIO()
            with contextlib.redirect_stdout(buf):
                train_main(config.get_parser(True).parse_args(
                    BACKBONE_LOOP_ARGS + extra + mesh_args + [
                        "--ckpt_path", f"{prefix}_{flow}", "--metrics_jsonl",
                        f"{prefix}_{flow}/metrics.jsonl"]))
            with open(f"{prefix}_{flow}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            delta, = glob.glob(f"{prefix}_{flow}/*__original.npz")
            out[flow] = (buf.getvalue(), records,
                         dict(io.load_checkpoint(delta)))
        buf = text_io.StringIO()
        with contextlib.redirect_stdout(buf):
            tuned, = glob.glob(f"{prefix}_train/*__original.npz")
            test_cli.main(config.get_parser(False).parse_args(
                BACKBONE_LOOP_ARGS[:10] + mesh_args + [
                    "--pretrained_ckpt", "base.npz", "--tuned_ckpt", tuned,
                    "--n_round", "2"]))
        out["test"] = buf.getvalue()
    finally:
        trainer.Experiment._device_batches = device_batches
    out["uploads"] = uploads
    return out


def case_spatial_backbone_cli(mesh):
    """backbone_flows on this world's spatial mesh, from the directory
    above <dir>."""
    os.chdir(os.path.dirname(OUT))
    return backbone_flows("w2", ["--mesh_shape", *map(str, mesh.mesh.shape),
                                 "--mesh_axes", "data", "space"])


# ---- training on the spatial mesh (tests/test_torch_port_spatial_grad.py,
# _train.py, _train_jax.py)

# the chain of ops on slabs: conv, pool, conv, pool, conv, bilinear x2,
# conv, bilinear x2, 1x1 conv; at 24 rows level 2 runs whole over 2
# ranks, levels 1-2 over 4; at 12 rows over 4 the slabs hold 3 rows, odd
CHAIN_W, CHAIN_N = 12, 4


def chain_inputs(height, seed=11):
    """The chain's input (N, height, W, 3), its target (N, height, W, 2)
    and weights, from a seed."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen)

    x = randn(CHAIN_N, height, CHAIN_W, 3)
    target = randn(CHAIN_N, height, CHAIN_W, 2)
    weights = {"w0": randn(6, 3, 3, 3, scale=0.3), "b0": randn(6),
               "w1": randn(8, 6, 3, 3, scale=0.3), "b1": randn(8),
               "w2": randn(8, 8, 3, 3, scale=0.3), "b2": randn(8),
               "w3": randn(6, 16, 3, 3, scale=0.3), "b3": randn(6),
               "w4": randn(2, 6, 1, 1, scale=0.3), "b4": randn(2)}
    return x, target, weights


def rank_block(t, mesh, slab):
    """This rank's rows (axis 0) and slab (axis 1) of a whole tensor."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    shards = mesh_lib.batch_shards(mesh)
    if shards is not None:
        t = t[slice(*shards.rows(t.shape[0] // shards.count))]
    return t if slab is None else slab.take(t).contiguous()


def spatial_chain(mesh, height):
    """The chain on this rank's rows and slab (the whole batch without a
    mesh), loss = sum(out * target) + 0.1 sum(out^2) over them ->
    {loss (the rank's share), each weight's gradient summed over the
    world, the input's gradient (the rank's block), each level's rows}."""
    import torch.nn.functional as F

    from mst_tpu_torch.models.layers import conv2d
    from mst_tpu_torch.ops import pooling
    from mst_tpu_torch.parallel import mesh as mesh_lib

    x, target, w = chain_inputs(height)
    slab = mesh_lib.space_slab(mesh, height)
    sl = [None] * 3 if slab is None else slab.levels(3)
    x = rank_block(x, mesh, slab).requires_grad_()
    target = rank_block(target, mesh, slab)
    for v in w.values():
        v.requires_grad_()
    y0 = F.relu(conv2d(x, w["w0"], w["b0"], sl[0]))
    y1 = F.relu(conv2d(pooling.pool_down(y0, pooling.max_pool_2x2, sl[0],
                                         sl[1]), w["w1"], w["b1"], sl[1]))
    y2 = conv2d(pooling.pool_down(y1, pooling.avg_pool_2x2, sl[1], sl[2]),
                w["w2"], w["b2"], sl[2])
    u1 = pooling.upsample_bilinear_2x(y2, sl[2], sl[1])
    u1 = F.relu(conv2d(torch.cat([u1, y1], -1), w["w3"], w["b3"], sl[1]))
    u0 = pooling.upsample_bilinear_2x(u1, sl[1], sl[0])
    out = conv2d(u0, w["w4"], w["b4"], sl[0])
    loss = (out * target).sum() + 0.1 * (out ** 2).sum()
    loss.backward()
    grads = [v.grad for v in w.values()]
    if mesh is not None:
        mesh_lib.sum_(grads)
    return {"loss": float(loss.detach()), "x_grad": x.grad.numpy().copy(),
            "grads": {k: g.numpy().copy() for k, g in zip(w, grads)},
            "rows": [t.shape[1] for t in (y0, y1, y2)]}


def case_spatial_chain(mesh):
    return {h: spatial_chain(mesh, h) for h in (24, 12)}


def spatial_bn(mesh, height=24):
    """A train-mode batch norm at a sliced level (the rank's slab) and at
    a level that runs whole (its slabs gathered), loss = sum(y * t) +
    0.1 sum(y^2) over the sliced output and sum(y2 * t2) over the whole
    output's slab rows -> {the rank's block of each output, each
    parameter's gradient summed over the world, the inputs' gradients,
    the moved running statistics}."""
    from mst_tpu_torch.models import layers
    from mst_tpu_torch.parallel import mesh as mesh_lib

    gen = torch.Generator().manual_seed(13)
    x, t, x2, t2 = (torch.randn(CHAIN_N, height, CHAIN_W, 5, generator=gen)
                    * 2 + 1 for _ in range(4))
    (p1, s1), (p2, s2) = layers.batchnorm_init(5), layers.batchnorm_init(5)
    for p in (p1, p2):
        with torch.no_grad():
            p["weight"].copy_(torch.rand(5, generator=gen) + 0.5)
            p["bias"].copy_(torch.randn(5, generator=gen))
            p["weight"].requires_grad_()
            p["bias"].requires_grad_()
    shards = mesh_lib.batch_shards(mesh)
    slab = mesh_lib.space_slab(mesh, height)
    x, t, x2, t2 = (rank_block(v, mesh, slab) for v in (x, t, x2, t2))
    x.requires_grad_()
    x2.requires_grad_()
    y, s1 = layers.batchnorm_apply(
        p1, s1, x, True if mesh is None else shards.spanning(slab))
    z = x2 if slab is None else slab.gather(x2)
    y2, s2 = layers.batchnorm_apply(p2, s2, z,
                                    True if mesh is None else shards)
    y2 = y2 if slab is None else slab.take(y2)
    loss = (y * t).sum() + 0.1 * (y ** 2).sum() + (y2 * t2).sum()
    loss.backward()
    grads = [p1["weight"].grad, p1["bias"].grad, p2["weight"].grad,
             p2["bias"].grad]
    if mesh is not None:
        mesh_lib.sum_(grads)
    return {"y": y.detach().numpy().copy(), "y2": y2.detach().numpy().copy(),
            "grads": [g.numpy().copy() for g in grads],
            "x_grad": x.grad.numpy().copy(), "x2_grad": x2.grad.numpy().copy(),
            "state": [numpy_tree(s1), numpy_tree(s2)]}


def case_spatial_bn(mesh):
    return spatial_bn(mesh)


ADAM_LR = 1e-3
# the train-step cases: (train_net, params overrides, steps); "cross" is
# a cross-scene batch of two scene maps; "segment" runs a shallow
# segmentation backbone in the step, its batch norms in train mode past
# e_unfreeze (segment_in_step, segment_train_mode), on the scene's slab
SPATIAL_TRAINS = {
    "mosa": ("mosa_2", dict(position=["0", "1", "2", "3", "4"]), 3),
    "serial": ("serial", {}, 1),
    "train": ("train", {}, 2),
    "remat": ("train", dict(remat=True), 1),
    "bf16": ("train", dict(compute_dtype="bfloat16"), 1),
    "cross": ("train", {}, 1),
    "segment": ("segmentation_head", {}, 1),
    # Y-Net-Mod's fusion encoder, parallel block adapters, the embed network
    "fusion": ("mosa_1", dict(network="fusion", n_fusion=2,
                              position=["scene", "motion", "fusion"]), 1),
    "parallel": ("parallel_1x1_3x3", dict(position=["0", "2"]), 1),
    "embed": ("train", dict(network="embed"), 1),
}


# the train-step cases of a shallow backbone in the step (segment_in_step;
# tests/test_torch_port_spatial_backbone_steps.py): (train_net, params
# overrides, steps, segment_train_mode)
BACKBONE_TRAINS = {
    "seg_head": ("segmentation_head", {}, 2, False),
    "seg_bn": ("segmentation_bn", {}, 2, False),
    "seg_train_mode": ("segmentation_head", {}, 2, True),
    "seg_remat": ("segmentation_head", dict(remat=True), 1, True),
    "seg_bf16": ("segmentation_head", dict(compute_dtype="bfloat16"), 2,
                 True),
    "seg_cross": ("segmentation_head", {}, 1, True),
    # without a state, as before e_unfreeze: the norms read their inline
    # running statistics, which are Adam's leaves (mst_tpu's mask)
    "seg_bn_stats": ("segmentation_bn", {}, 1, False),
}


# the backbone's train steps held against mst_tpu's spatial step
# (tests/test_torch_port_spatial_backbone_jax.py)
BACKBONE_JAX = {"jax_train_mode": ("segmentation_head", {}, 2, True)}


def cross_batch(seed=0):
    """spatial_batch() with a second scene map: a (2, H, W, 3) stack and
    each row's scene_idx."""
    b = spatial_batch(H, seed)
    rng = np.random.default_rng(seed + 1)
    b["semantic"] = np.concatenate([b["semantic"], rng.normal(
        size=b["semantic"].shape).astype(np.float32)])
    b["scene_idx"] = np.arange(len(MASK), dtype=np.int64) % 2
    return b


def train_setup(name):
    """SPATIAL_TRAINS[name], BACKBONE_TRAINS[name] or BACKBONE_JAX[name]
    -> (params, weights, state, train_net, steps, whether the backbone
    runs in the step, whether in train mode). The backbone cases' batch
    norms are moved off identity (weights U(0.5, 1.5), biases U(-0.3,
    0.3), running means U(-0.3, 0.3) and variances U(0.7, 1.5): a leaf
    held within a share of its max must not start at 0)."""
    from mst_tpu_torch import io
    from mst_tpu_torch.models.unet import extract_bn_stats, unet_init

    tables = {**BACKBONE_TRAINS, **BACKBONE_JAX}
    if name in tables:
        train_net, over, n_steps, train_mode = tables[name]
    else:
        train_net, over, n_steps = SPATIAL_TRAINS[name]
        train_mode = name == "segment"
    params = step_params(train_net, **over)
    weights, state = model(params)
    segment = name == "segment" or name in tables
    if segment:
        weights["segmentation"] = unet_init(
            torch.Generator().manual_seed(2), n_classes=3,
            layers=(1, 1, 1, 1))
    if name in tables:
        gen = torch.Generator().manual_seed(3)
        for k, v in io.flatten(weights["segmentation"]).items():
            if v.ndim == 1 and k.endswith("/weight"):
                v.uniform_(0.5, 1.5, generator=gen)
            elif v.ndim == 1 and k.endswith("/bias"):
                v.uniform_(-0.3, 0.3, generator=gen)
        gen = torch.Generator().manual_seed(4)
        for k, v in io.flatten(weights["segmentation"]).items():
            if k.endswith("/running_mean"):
                v.uniform_(-0.3, 0.3, generator=gen)
            elif k.endswith("/running_var"):
                v.uniform_(0.7, 1.5, generator=gen)
    if segment and name != "seg_bn_stats":
        state = {**state, "segmentation_bn": extract_bn_stats(
            weights["segmentation"])}
    return params, weights, state, train_net, n_steps, segment, train_mode


def spatial_train(mesh, name):
    """The Adam steps of train_setup(name) on the rank's rows and slab
    (the whole batch without a mesh) -> each step's metrics and summed
    gradients, the trainable leaves and the model state after."""
    from mst_tpu_torch import config, io
    from mst_tpu_torch.train import freeze, optim
    from mst_tpu_torch.train.steps import make_train_step

    params, weights, state, train_net, n_steps, segment, train_mode = \
        train_setup(name)
    freeze.set_trainable(weights, train_net, params["position"])
    named = {k: v for k, v in io.flatten(weights).items() if v.requires_grad}
    opt = optim.Adam(named.values(), ADAM_LR)
    step = make_train_step(config.ynet_config(params), config.step_config(
        params, segment_in_step=segment, segment_train_mode=train_mode),
        mesh)
    b = spatial_rows(cross_batch() if name.endswith("cross")
                     else spatial_batch(H), mesh)
    out = []
    for _ in range(n_steps):
        state, m = step(weights, state, opt, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {k: (torch.zeros_like(v) if v.grad is None
                                  else v.grad).numpy().copy()
                              for k, v in named.items()}})
    return {"steps": out, "leaves": {k: v.detach().numpy().copy()
                                     for k, v in named.items()},
            "state": numpy_tree(state)}


def case_spatial_train(mesh):
    return {name: spatial_train(mesh, name) for name in SPATIAL_TRAINS}


def case_spatial_backbone_steps(mesh):
    """The eval cases with the backbone in the step beyond
    tests/test_torch_port_spatial_eval.py's, and BACKBONE_TRAINS."""
    out = {name: spatial_eval(mesh, name)
           for name in ("segment_cws", "segment_cross")}
    out.update({name: spatial_train(mesh, name) for name in BACKBONE_TRAINS})
    return out


def case_spatial_backbone_jax(mesh):
    return {name: spatial_train(mesh, name) for name in BACKBONE_JAX}


def case_spatial_train_jax(mesh):
    """The cases tests/test_torch_port_spatial_train_jax.py holds against
    mst_tpu's spatial step."""
    return {name: spatial_train(mesh, name) for name in ("train", "cross")}


# ---- the segmentation backbone on slabs
# (tests/test_torch_port_spatial_backbone*.py)

# (1, 2): every level slices at 64 rows, layer4 runs whole at 96; (1, 4):
# every level slices at 128 rows, layer3-4 run whole at 96
BACKBONE_HEIGHTS = {2: (64, 96), 4: (128, 96)}
BACKBONE_W, BACKBONE_N = 96, 2  # two scenes' images, as a cross-scene stack


def backbone_inputs(height, dtype=torch.float32):
    """A shallow backbone (the U-Net's real widths, one block a stage,
    random from seed 2; 3 classes), its floating leaves but the running
    statistics needing gradients, a (2, height, 96, 3) image stack and a
    target of the output's shape, from seeds."""
    from mst_tpu_torch import io
    from mst_tpu_torch.models.unet import unet_init

    flat = io.flatten(unet_init(torch.Generator().manual_seed(2),
                                n_classes=3, layers=(1, 1, 1, 1)))
    flat = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in flat.items()}
    for k, v in flat.items():
        if v.is_floating_point() and not k.endswith(
                ("running_mean", "running_var")):
            v.requires_grad_()
    shape = (BACKBONE_N, height, BACKBONE_W, 3)
    image = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    target = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    return io.unflatten(flat), image.to(dtype), target.to(dtype)


def backbone_run(mesh, height, train, dtype=torch.float32):
    """The backbone on the rank's slab of backbone_inputs' image (the
    whole image without a mesh), loss = sum(out * target) over the slab
    -> {the output gathered to the whole map, each leaf's gradient summed
    over the world, the moved running statistics (train), the rows of
    each feature and of each conv's input on this rank}."""
    from mst_tpu_torch import io
    from mst_tpu_torch.models import unet
    from mst_tpu_torch.parallel import mesh as mesh_lib

    params, image, target = backbone_inputs(height, dtype)
    slab = mesh_lib.space_slab(mesh, height)
    if slab is not None:
        image, target = slab.take(image).contiguous(), slab.take(target)
    conv2d, rows = unet.conv2d, []

    def logged(x, weight, bias, stride, padding):
        rows.append((weight.shape[-1], stride, x.shape[2]))
        return conv2d(x, weight, bias, stride, padding)

    unet.conv2d = logged
    try:
        out = unet.unet_apply(params, image, train=train, slab=slab)
        bn, _ = unet.make_bn(None, False)
        feats = unet.encoder_apply(params["encoder"], image.detach(), None,
                                   bn, slab)
    finally:
        unet.conv2d = conv2d
    out, stats = out if train else (out, {})
    (out * target).sum().backward()
    leaves = {k: v for k, v in io.flatten(params).items()
              if v.requires_grad}
    grads = [v.grad for v in leaves.values()]
    if mesh is not None:
        mesh_lib.sum_(grads)
        out = slab.gather(out.detach())
    return {"out": out.detach().numpy().copy(),
            "grads": {k: g.numpy().copy() for k, g in zip(leaves, grads)},
            "stats": {k: v.numpy().copy()
                      for k, v in io.flatten(stats).items()},
            "feat_rows": [f.shape[2] for f in feats], "conv_rows": rows}


# each piece of item 2 on a slab: (kernel, stride, the input made >= 0)
BACKBONE_PIECES = {"stem": (7, 2), "max_pool": (3, 2), "stride2": (3, 2),
                   "downsample": (1, 2), "conv3x3": (3, 1)}
PIECE_HEIGHTS = (16, 24)  # S = 4: 4 and 6 rows a slab, the stem's halo 3


def backbone_piece(mesh, name, height):
    """BACKBONE_PIECES[name] on the rank's slab of a seeded (2, 5, height,
    12) NCHW channels_last input (the whole map without a mesh), loss =
    sum(out * target) -> {the output gathered, the input's gradient (the
    rank's rows), the weight's gradient summed over the world}. The
    max-pool takes a ReLU's output, as in the network."""
    from mst_tpu_torch.models import unet
    from mst_tpu_torch.parallel import mesh as mesh_lib

    k, stride = BACKBONE_PIECES[name]
    gen = torch.Generator().manual_seed(17)
    x = torch.randn(2, 5, height, 12, generator=gen).contiguous(
        memory_format=torch.channels_last)
    weight = (0.3 * torch.randn(6, 5, k, k, generator=gen)).requires_grad_()
    target = torch.randn(2, 6 if name != "max_pool" else 5, height // stride,
                         12 // stride, generator=gen)
    slab = mesh_lib.space_slab(mesh, height)
    out_slab = None if slab is None else slab.half() if stride == 2 else slab
    if slab is not None:
        x, target = slab.take(x, 2), out_slab.take(target, 2)
    x = x.detach().contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    if name == "max_pool":
        out = unet.max_pool(torch.relu(x), slab)
    else:  # the stem pads 3 on every side, the others SAME
        out = unet.conv({"weight": weight}, x, stride, slab,
                        pad=3 if name == "stem" else None)
    (out * target).sum().backward()
    grads = [weight.grad if weight.grad is not None
             else torch.zeros_like(weight)]
    if mesh is not None:
        mesh_lib.sum_(grads)
        out = out_slab.gather(out.detach().permute(0, 2, 3, 1)).permute(
            0, 3, 1, 2)
    return {"out": out.detach().numpy().copy(),
            "x_grad": x.grad.numpy().copy(),
            "w_grad": grads[0].numpy().copy()}


# the stride-2 3x3 conv (SAME: 0 rows above a slab and 1 below) on even
# and odd W (tests/test_torch_port_segmentation.py)
STRIDE2_SHAPES = ((16, 24), (16, 23))


def stride2_inputs(height, width):
    """A seeded (2, 16, height, width) NCHW map and a (32, 16, 3, 3)
    weight (numpy)."""
    rng = np.random.default_rng(6)
    return (rng.normal(size=(2, 16, height, width)).astype(np.float32),
            rng.normal(size=(32, 16, 3, 3)).astype(np.float32))


def case_stride2_same(mesh):
    """unet.conv at stride 2 on the rank's slab of each STRIDE2_SHAPES
    map, gathered to the whole map -> {(height, width): NCHW output}."""
    from mst_tpu_torch.models import unet
    from mst_tpu_torch.parallel import mesh as mesh_lib

    out = {}
    for height, width in STRIDE2_SHAPES:
        x, w = stride2_inputs(height, width)
        slab = mesh_lib.space_slab(mesh, height)
        x = slab.take(torch.tensor(x), 2).contiguous(
            memory_format=torch.channels_last)
        y = unet.conv({"weight": torch.tensor(w)}, x, 2, slab)
        out[height, width] = slab.half().gather(
            y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).numpy().copy()
    return out


def case_spatial_backbone(mesh):
    """backbone_run at this world's heights: eval and train mode in f32,
    train mode in float64; and each piece at PIECE_HEIGHTS."""
    from mst_tpu_torch.parallel import mesh as mesh_lib

    space = mesh_lib.axis_size(mesh, "space")
    out = {}
    for height in BACKBONE_HEIGHTS[space]:
        for mode, train, dtype in (("eval", False, torch.float32),
                                   ("train", True, torch.float32),
                                   ("train64", True, torch.float64)):
            out[height, mode] = backbone_run(mesh, height, train, dtype)
    for name in BACKBONE_PIECES:
        for height in PIECE_HEIGHTS:
            out[name, height] = backbone_piece(mesh, name, height)
    return out


LOUD_BYTES = 1 << 18  # four times a pipe's buffer


def case_loud(mesh):
    """LOUD_BYTES to stdout and to stderr, then a collective: a rank that
    blocked in write() would stop the other in the barrier."""
    sys.stdout.write("o" * LOUD_BYTES)
    sys.stdout.flush()
    sys.stderr.write("e" * LOUD_BYTES)
    sys.stderr.flush()
    torch.distributed.barrier()
    return torch.distributed.get_rank()


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


def launch(out_dir, shape, cases, timeout=240, axes=None, threads=2):
    """Run `cases` on a world of prod(shape) ranks (processes) -> each
    case's list of what each rank returned. axes: the mesh's axis names
    (default: 'data', or 'replica', 'data'); threads: each rank's
    (OMP_NUM_THREADS, torch.set_num_threads)."""
    return finish(start(out_dir, shape, cases, axes, threads, timeout))


def start(out_dir, shape, cases, axes=None, threads=2, timeout=240):
    """Start the ranks of launch() -> a handle for finish(), which waits
    for them `timeout` s. Each rank's stdout and stderr go to files under
    <out_dir>/ranks (chip_smoke.launch_ranks), so a rank that prints much
    cannot block in write() while the others wait for it in a
    collective."""
    import chip_smoke

    world = int(np.prod(shape))
    os.makedirs(out_dir, exist_ok=True)
    env = dict(OMP_NUM_THREADS=str(threads),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    wait = chip_smoke.launch_ranks(
        world, [sys.executable, "-m", "tests.torch_port_ranks", str(out_dir),
                ",".join(map(str, shape)), ",".join(cases)]
        + ([",".join(axes)] if axes else []), timeout,
        os.path.join(str(out_dir), "ranks"), env)
    return out_dir, cases, world, wait


def finish(handle):
    """Wait for the ranks of start() (a failure, or a rank past the limit,
    shows every rank's output) -> each case's list of what each rank
    returned."""
    out_dir, cases, world, wait = handle
    wait()
    results = {}
    for case in cases:
        results[case] = []
        for r in range(world):
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


def main(out_dir, shape, cases, axes=None):
    import chip_smoke

    chip_smoke.arm_rank_dumps()
    global OUT
    OUT = out_dir
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    from mst_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.init_process_group(
        "cpu", init_method="file://" + os.path.join(out_dir, "store"))
    shape = [int(s) for s in shape.split(",")]
    if axes is None:
        axes = "replica,data" if len(shape) == 2 else None
    mesh = mesh_lib.mesh_from_shape(
        shape, None if axes is None else axes.split(","), "cpu")
    rank = torch.distributed.get_rank()
    for case in cases.split(","):
        out = CASES[case](mesh)
        with open(os.path.join(out_dir, f"{case}.{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
