"""Train, eval and predict steps (counterpart of mst_tpu/train/steps.py:51-104,
106-315, 322-772; reference utils/train_epoch.py:44-126 and
utils/evaluate.py:37-315).

PyTorch runs eagerly, so a step is a plain function. Eval: forward with
goal and waypoint sampling (optionally TTST or CWS), then the K waypoint-
conditioned trajectory decodes in chunks of eval_k_chunk, then the
min-over-K metrics. Train: one few-shot fine-tune step, forward, masked
BCE, backward into the trainable leaves and an optimizer step (see
make_train_step). The decode is always the unpacked math; the JAX
package's space-to-depth packing is a TPU layout and has no counterpart.
Random draws come from one torch.Generator on the step's device, or, in
the eval and predict forward, from a key (ops/sampling.Key): an int64
(2,) tensor, which is how the exported forward program takes its draws.

Mixed precision (StepConfig.compute_dtype = torch.bfloat16) follows
mst_tpu's explicit casts, not torch.autocast (whose per-op lists would
round at other places than the reference): each step runs on a compute
copy of the parameters (_compute_params: every floating leaf cast, so the
gradients flow back into the f32 leaves that Adam holds with its f32
moments; integer leaves and the model state stay as they are), and
_prepare_inputs casts the scene map, the observed maps and the waypoint
pyramids. f32 stays where mst_tpu keeps it: the rasterizers (cast after),
the logits before BCE, the goal logits before the sigmoid, sampling, TTST
and CWS, and every soft-argmax's statistics. Where a bf16 activation
meets an f32 batch-norm statistic (a serial adapter, or the backbone with
adapted statistics, in eval mode), the result is f32 as JAX promotes it,
and the next conv raises as lax.conv_general_dilated does. Two places
differ from mst_tpu's bf16 rounding by design: the decode tail's fused
kernel takes the bf16 activations and weight and sums in f32
(mst_tpu's fused Pallas kernel does the same; its default unpacked path
rounds the logits to bf16 first), and a serial adapter's train-mode batch
norm takes its batch statistics in f32 (layers.global_batch_norm), where
mst_tpu rounds them to bf16.

On a data-parallel mesh (parallel/mesh.py) a rank holds rows [lo, hi) of
the global batch and the scene maps whole, and the steps compute what one
process computes on the whole batch, as jit does over a sharded batch:
the masked BCE divides each rank's sum by the global count and the
gradients are summed over the ranks after the backward; the serial
adapters' train-mode batch norms take the global batch's statistics; the
metric sums are summed and the eval step's per-row outputs gathered in
global row order, on every rank; and each row's eval draws are the ones
it draws in one process (sampling.Rows). The segmentation backbone runs
on the scene images, which every rank of such a mesh holds whole: its
train-mode statistics are the image's, the same on every rank, with no
reduction (the batch's rows share the image).

On a spatial ('data', 'space') mesh the eval step splits the scene maps'
H over 'space' as well (mesh.Slab): a rank holds its 'data' block of rows
and rows [s H / S, (s + 1) H / S) of every scene map and every finest
activation, the encoder and both decoders run on the slabs
(models/ynet.py), the waypoint channels of the goal logits are gathered
to whole H, and TTST, CWS and the samplers run on them whole and
unchanged on every rank; the trajectory decode ends in the partial
variant of the fused kernel, whose statistics the 'space' ranks merge
(ops/kernels/online_stats.merge_ranks). The train step splits the
same way: each rank computes its share of the global loss (its rows, its
slab of the maps and of their ground truth), the gradients flow back
through the halo exchanges and gathers (parallel/halo.py) and are summed
over every rank of the world, the batch norms take the statistics of
the ranks that hold their level's batch (models/ynet.py), and the top-1
metrics merge the 'space' ranks' partial statistics of the rows kernel.
With segment_in_step, batch['semantic'] holds the rank's slab of the
preprocessed image, and the backbone runs on it (models/unet.py: each
level on its slab, halos exchanged, down to the first level that runs
whole on every 'space' rank); its train-mode batch norms take the
image's statistics over the 'space' ranks at a sliced level and on the
rank at a whole one, the same on every 'data' rank (they hold the same
image). No rank segments the whole image in a step.
"""

import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from mst_tpu_torch import io
from mst_tpu_torch.evaluator.metrics import (ade_fde_per_sample,
                                             ade_fde_per_sample_world)
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.models.unet import unet_apply
from mst_tpu_torch.ops.heatmap import (rasterize_dist_nhwc,
                                       rasterize_gaussian_nhwc)
from mst_tpu_torch.ops.kernels.fused_predict import (
    fused_predictor_softargmax, fused_predictor_softargmax_partial)
from mst_tpu_torch.ops.kernels.online_stats import merge_ranks
from mst_tpu_torch.ops.kernels.softargmax_rows import \
    softargmax2d_rows_partial
from mst_tpu_torch.ops.kmeans import batched_kmeans
from mst_tpu_torch.ops.pooling import avg_pool_pyramid
from mst_tpu_torch.ops.sampling import Key, Rows, sample_heatmap
from mst_tpu_torch.ops.softargmax import (softargmax2d_auto,
                                          softargmax_on_prob_map)
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.parallel.mesh import batch_shards
from mst_tpu_torch.train.losses import bce_with_logits
from mst_tpu_torch.utils.profiling import span


LOSS_KEYS = ("loss", "goal_loss", "traj_loss")


class CWSParams(NamedTuple):
    """CWS prior settings (config key CWS_params; reference
    evaluate.py:177-181)."""
    sigma_factor: float
    ratio: float
    rot: bool


class StepConfig(NamedTuple):
    """Static settings of the train, eval and predict steps."""
    obs_len: int
    pred_len: int
    waypoints: tuple
    template_size: int  # int(4200 * resize_factor), reference trainer.py:61
    resize_factor: float
    temperature: float
    n_goal: int
    n_traj: int
    use_ttst: bool = False
    rel_threshold: float = 0.01
    use_cws: bool = False
    cws_params: Any = None
    eval_k_chunk: int = 0  # 0 -> all K at once
    kernlen: int = 31  # the gt Gaussian's window (train step)
    nsig: float = 4.0  # and its sigma
    loss_scale: float = 1000.0
    swap_semantic: bool = False  # swap semantic channels 1 and 2
    # the backbone inside the step: 'semantic' is then the preprocessed
    # image (the segmentation_* strategies, e_unfreeze, a model directory
    # exported with segment_in_step); otherwise it is the segmented map
    segment_in_step: bool = False
    # past e_unfreeze: the train step runs the backbone's batch norms on
    # the batch's statistics and moves state['segmentation_bn']
    segment_train_mode: bool = False
    use_features_only: bool = False  # the backbone's 16 decoder channels
    # ETH/UCY (--eth_world_coords): the metrics in world coordinates, through
    # the batch's per-scene 'homography' (3, 3) with the eth/hotel x/y swap
    # folded in (the trainer's _homography_for)
    world_coords: bool = False
    # the convs' dtype: torch.float32 or torch.bfloat16 (see the module
    # docstring for what stays f32)
    compute_dtype: Any = torch.float32
    # recompute the encoder's and the two map decoders' activations in the
    # train step's backward instead of holding them (--remat)
    remat: bool = False


def swap_pavement_terrain(semantic_img):
    """Swap semantic channels 1 and 2 of an NHWC map (a copy of
    mst_tpu/data/images.py:90-94; reference image_utils.py:165-173)."""
    perm = list(range(semantic_img.shape[-1]))
    perm[1], perm[2] = perm[2], perm[1]
    return take(semantic_img, perm, -1)


def take(x, indices, dim):
    """x's entries `indices` (a list of ints) along dim, as x[..., indices]
    gives them, from views: indexing with a list would upload the list,
    which a CUDA graph cannot capture."""
    return torch.stack([x.select(dim, i) for i in indices], dim)


def _compute_params(params, scfg):
    """The parameter tree in the compute dtype: every floating leaf cast
    (a differentiable copy), integer leaves as they are
    (mst_tpu/train/steps.py:106-122). f32 is the identity: the tree
    itself."""
    if scfg.compute_dtype == torch.float32:
        return params
    return ynet_lib.tree_map(
        lambda t: t.to(scfg.compute_dtype) if t.is_floating_point() else t,
        params)


def _prepare_inputs(mcfg, scfg, params, semantic, traj, train=False,
                    seg_bn_state=None, scene_idx=None, slab=None):
    """semantic (N, H, W, C) with N 1, B or S, and traj (B, T, 2) ->
    (semantic through the semantic adapter, swapped if asked, as B maps;
    observed distance maps (B, H, W, obs_len); the backbone's batch-norm
    updates)
    (mst_tpu/train/steps.py:125-175), both maps in the compute dtype;
    params must be the compute copy (_compute_params). scene_idx (B,)
    marks a cross-scene batch: semantic is a stack of S scene maps and row
    b takes map scene_idx[b], gathered after the backbone and the adapter
    ran once on the S maps. With segment_in_step, semantic is the
    preprocessed image and the backbone runs here first, with the
    statistics of seg_bn_state where given; differentiably (the
    segmentation_* strategies train its leaves), and in a train step past
    e_unfreeze (segment_train_mode) on the batch's statistics, whose
    running-statistic updates are returned (else {}). Each output goes
    through its embedding on the embed network. slab (a mesh.Slab):
    semantic holds the slab's rows of the scene maps (of the image when
    the backbone runs here, on the slab: unet.unet_apply), and both
    outputs are the slab's rows."""
    B = traj.shape[0]
    semantic = semantic.to(scfg.compute_dtype)
    seg_updates = {}
    if scfg.segment_in_step and "segmentation" in params:
        if scfg.segment_train_mode and train:
            semantic, seg_updates = unet_apply(
                params["segmentation"], semantic, scfg.use_features_only,
                bn_state=seg_bn_state, train=True, slab=slab)
        else:
            semantic = unet_apply(params["segmentation"], semantic,
                                  scfg.use_features_only,
                                  bn_state=seg_bn_state, slab=slab)
    H, W = semantic.shape[-3], semantic.shape[-2]
    semantic = ynet_lib.adapt_semantic(params, mcfg, semantic, slab)
    if scfg.swap_semantic:
        semantic = swap_pavement_terrain(semantic)
    if scene_idx is not None:
        semantic = semantic[scene_idx]
    elif semantic.shape[0] != B:
        semantic = semantic.expand(B, *semantic.shape[1:])
    observed_map = rasterize_dist_nhwc(
        traj[:, :scfg.obs_len], H, W, scfg.template_size,
        0 if slab is None else slab.lo).to(scfg.compute_dtype)
    if mcfg.network == "embed":
        semantic = ynet_lib.scene_embedding(params, semantic, slab)
        observed_map = ynet_lib.motion_embedding(params, observed_map, slab)
    return semantic, observed_map, seg_updates


def slab_levels(mesh, n_levels, rows):
    """Each of n_levels pyramid levels' mesh.Slab (mesh.Slab.levels) of
    maps of which this rank holds `rows` rows; None off a spatial
    mesh."""
    if not mesh_lib.is_spatial(mesh):
        return None
    height = rows * mesh_lib.axis_size(mesh, "space")
    return mesh_lib.space_slab(mesh, height).levels(n_levels)


def make_train_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig, mesh=None):
    """The few-shot fine-tune step (mst_tpu make_train_step, unpacked).

    train_step(params, state, optimizer, batch) -> (new state, metrics).
    params is the nested tree; its trainable leaves have requires_grad and
    are the optimizer's parameters (freeze.set_trainable; an optim.Adam or
    optim.SGD, whose learning rate follows its device-side count), and
    the step updates them in place: zero the gradients in place,
    backward, optimizer.step(). No host value is read, and every buffer
    the step writes exists after its first call, so train/fused.py
    captures it in a CUDA graph. state is the
    model state (init_ynet's); the encoder runs in train mode, so the
    batch norms normalise with the batch's statistics and the new state
    holds their moved running statistics; with segment_in_step the
    backbone runs first (_prepare_inputs), and with segment_train_mode
    its moved statistics are the new state's 'segmentation_bn'. This
    replaces the JAX
    signature's functional (trainable, frozen, state, opt_state)
    threading. batch: 'semantic' (1 or B, H, W, C), 'traj' (B, obs_len +
    pred_len, 2) model-space pixels, 'mask' (B,), and for a cross-scene
    batch 'scene_idx' (B,) into a (S, H, W, C) 'semantic'. metrics:
    'loss', 'goal_loss', 'traj_loss' (each x loss_scale), and the masked
    top-1 'ade_sum', 'fde_sum' and 'n', as 0-d tensors detached from the
    graph.

    The forward runs on the compute copy of the parameters
    (_compute_params); BCE takes the logits in f32. The trajectory
    decoder runs in the split form on the ground-truth waypoint pyramid;
    its logits are the 1x1 predictor as an einsum plus the bias (BCE
    needs them, so the fused kernel has no place here). With remat, the
    encoder and the two map decoders run under torch.utils.checkpoint
    (non-reentrant), as jax.checkpoint wraps them
    (mst_tpu/train/steps.py:260-264): their inner activations are
    recomputed in the backward. The metrics' soft-argmax runs on
    contiguous (B, P, H, W) copies of the detached compute-dtype maps
    through softargmax2d_auto: two rows-kernel launches a step on the
    card, the plain version on the CPU.

    mesh: a data-parallel DeviceMesh (parallel/mesh.py) whose rank holds
    its rows of the global batch; the step then computes the global
    batch's step (the module docstring): the gradients are summed over
    the ranks between the backward and the optimizer's step, and the
    losses and metric sums are the global batch's on every rank.

    On a spatial ('data', 'space') mesh (mst_tpu/train/steps.py:179-320
    under GSPMD) batch['semantic'] holds the rank's H slab of the scene
    maps (of the image with segment_in_step: the backbone runs on the
    slab, and each rank's backward gives its leaves the share of its
    slab's loss, which the world's sum completes; its train-mode
    statistics are the image's, over the 'space' ranks); the ground-truth
    maps are rasterized on
    the slab's rows, the encoder and both decoders run on each level's
    slab (mesh.Slab.levels), the BCE divides each rank's sum by the whole
    maps' count, the gradients are summed over the world, and the
    metrics' soft-argmax is the rows kernel's partial variant on the
    slab, merged over 'space' (two launches a step on each rank). With
    remat the recomputed forward runs its halo collectives again, in the
    backward, in the same order on every rank.

    A step is the span 'train.step' (utils/profiling.py), and its forward
    (inputs, encoder, decoders, both losses), backward and optimizer
    (with the mesh's gradient sum) the spans 'train.forward',
    'train.backward' and 'train.optimizer'; the functional form opens
    none.
    """
    waypoints = list(scfg.waypoints)
    n_levels = len(mcfg.encoder_channels) + 1
    dtype = scfg.compute_dtype
    shards = batch_shards(mesh)
    spatial = mesh_lib.is_spatial(mesh)
    # train-mode batch norms take the global batch's statistics (on the
    # spatial mesh the 'data' ranks' at a whole level, the world's at a
    # sliced one: ynet._serial_apply)
    bn_batch = shards if shards is not None and (
        shards.count > 1 or spatial) else True

    def encode(params, state, semantic, observed_map, slabs):
        return ynet_lib.pred_features(params, state, mcfg, semantic,
                                      observed_map, train=bn_batch,
                                      slabs=slabs)

    def decode_maps(params, features, wp_pyramid, slabs):
        goal_map = ynet_lib.pred_goal(params, features, slabs)
        x, w, b = ynet_lib.make_shared_pred_traj(
            params, features, len(waypoints), slabs)(wp_pyramid)
        return goal_map, torch.einsum("bhwc,cp->bhwp", x, w) + b

    if scfg.remat:
        encode = functools.partial(checkpoint, encode, use_reentrant=False)
        decode_maps = functools.partial(checkpoint, decode_maps,
                                        use_reentrant=False)

    def forward_on(params, state, batch):
        """-> (goal_loss, traj_loss, goal logits, traj logits, new state,
        the finest level's slab or None); the maps are (B, H, W,
        pred_len) in the compute dtype (the slab's rows)."""
        params = _compute_params(params, scfg)
        traj, mask = batch["traj"], batch["mask"]
        slabs = slab_levels(mesh, n_levels, batch["semantic"].shape[-3])
        slab = None if slabs is None else slabs[0]
        semantic, observed_map, seg_updates = _prepare_inputs(
            mcfg, scfg, params, batch["semantic"], traj, train=True,
            seg_bn_state=state.get("segmentation_bn"),
            scene_idx=batch.get("scene_idx"), slab=slab)
        H, W = semantic.shape[-3], semantic.shape[-2]
        row0 = 0 if slab is None else slab.lo
        gt_future = traj[:, scfg.obs_len:]
        gt_future_map = rasterize_gaussian_nhwc(gt_future, H, W,
                                                scfg.kernlen, scfg.nsig, row0)
        gt_waypoint_map = rasterize_dist_nhwc(take(gt_future, waypoints, 1),
                                              H, W, scfg.template_size, row0)
        wp_pyramid = avg_pool_pyramid(gt_waypoint_map.to(dtype), n_levels,
                                      slabs)
        features, new_state = encode(params, state, semantic, observed_map,
                                     slabs)
        if seg_updates:
            new_state = {**new_state, "segmentation_bn": seg_updates}
        goal_map, traj_map = decode_maps(params, features, wp_pyramid, slabs)
        space = 1 if slab is None else slab.count
        goal_loss = bce_with_logits(goal_map.float(), gt_future_map,
                                    mask, shards, space) * scfg.loss_scale
        traj_loss = bce_with_logits(traj_map.float(), gt_future_map,
                                    mask, shards, space) * scfg.loss_scale
        return goal_loss, traj_loss, goal_map, traj_map, new_state, slab

    def soft_argmax(maps, slab):
        """(B, P, H, W) logits -> (B, P, 2): the rows kernel on the whole
        maps, or its partial variant on the slab's rows merged over the
        'space' ranks."""
        if slab is None:
            return softargmax2d_auto(maps)
        return merge_ranks(softargmax2d_rows_partial(maps, slab.lo), slab)

    @torch.no_grad()
    def top1_metrics(goal_map, traj_map, traj, mask, slab=None):
        """Top-1 soft-argmax ADE/FDE (train_epoch.py:117-126)."""
        gt_future = traj[:, scfg.obs_len:]
        traj_pts = soft_argmax(traj_map.detach().permute(
            0, 3, 1, 2).contiguous(), slab)  # (B, P, 2)
        goal_pts = soft_argmax(goal_map.detach()[..., -1:].permute(
            0, 3, 1, 2).contiguous(), slab)
        rf = scfg.resize_factor
        ade = torch.sqrt((((gt_future - traj_pts) / rf) ** 2).sum(-1)).mean(-1)
        fde = torch.sqrt((((gt_future[:, -1:] - goal_pts[:, -1:]) / rf) ** 2)
                         .sum(-1)).mean(-1)
        return {"ade_sum": (ade * mask).sum(), "fde_sum": (fde * mask).sum(),
                "n": mask.sum()}

    def global_metrics(metrics, slab=None):
        """On a mesh, each metric (a rank's part of the global loss, or
        its rows' sum) summed over the ranks, in one collective. On the
        spatial mesh it is a sum over the world, the losses being each
        rank's share, and the 'space' ranks other than the first add no
        metric sum: theirs are the same merged points' again."""
        if shards is None:
            return metrics
        if slab is None:
            values = shards.all_reduce(torch.stack(list(metrics.values())))
        else:
            keep = float(slab.index == 0)
            values = torch.stack([v if k in LOSS_KEYS else v * keep
                                  for k, v in metrics.items()])
            mesh_lib.sum_([values])
        return dict(zip(metrics, values.unbind()))

    def train_step(params, state, optimizer, batch):
        with span("train.step"):
            optimizer.zero_grad()
            with span("train.forward"):
                goal_loss, traj_loss, goal_map, traj_map, new_state, slab = \
                    forward_on(params, state, batch)
                loss = goal_loss + traj_loss
            with span("train.backward"):
                if loss.requires_grad:  # else no leaf trains: the step
                    loss.backward()     # updates nothing, as mst_tpu's
            with span("train.optimizer"):
                if shards is not None:  # over the world: every rank's share
                    mesh_lib.sum_([p.grad for p in optimizer.params
                                   if p.grad is not None])
                optimizer.step()
            metrics = top1_metrics(goal_map, traj_map, batch["traj"],
                                   batch["mask"], slab)
            return new_state, global_metrics({
                "loss": loss.detach(), "goal_loss": goal_loss.detach(),
                "traj_loss": traj_loss.detach(), **metrics}, slab)

    def loss_and_maps(trainable, frozen, state, batch):
        goal_loss, traj_loss, goal_map, traj_map, new_state, _ = forward_on(
            io.unflatten({**frozen, **trainable}), state, batch)
        return goal_loss + traj_loss, (goal_loss, traj_loss, goal_map,
                                       traj_map, new_state)

    def functional_step(trainable, frozen, state, opt_state, update, batch):
        """The same step with parameters in and out, for torch.func.vmap
        (the grid): trainable and frozen are {path: tensor} of the tree's
        leaves, update an optim.Functional's update ->
        (trainable, state, opt_state, metrics); the gradients come from
        torch.func.grad_and_value. It takes no mesh: the grid splits its
        runs over the ranks and steps each on its whole batch."""
        if shards is not None:
            raise ValueError("the functional step takes no mesh: the grid "
                             "splits its runs over the ranks instead")
        grads, (loss, (goal_loss, traj_loss, goal_map, traj_map,
                       new_state)) = torch.func.grad_and_value(
            loss_and_maps, has_aux=True)(trainable, frozen, state, batch)
        trainable, opt_state = update(trainable, grads, opt_state)
        metrics = top1_metrics(goal_map, traj_map, batch["traj"],
                               batch["mask"])
        return trainable, new_state, opt_state, {
            "loss": loss, "goal_loss": goal_loss, "traj_loss": traj_loss,
            **metrics}

    def forward(params, state, batch):
        """-> (goal_loss, traj_loss, goal logits, traj logits, new
        state)."""
        return forward_on(params, state, batch)[:5]

    train_step.forward = forward
    train_step.functional = functional_step
    return train_step


def draw_source(generator):
    """The eval forward's draws: a key tensor (int64 (2,)) becomes a Key;
    a torch.Generator, Draws or Key is used as it is."""
    if isinstance(generator, torch.Tensor):
        return Key(generator)
    return generator


def _ttst_goals(generator, pred_waypoint_map, wp_sigmoid_hw, scfg):
    """Test-Time Sampling Trick (evaluate.py:134-161): 10k samples of the
    goal map -> per-person k-means to n_goal - 1 centres, behind the
    soft-argmax goal point. pred_waypoint_map (B, H, W, n_wp) logits,
    wp_sigmoid_hw (B, n_wp, H, W) -> (K, B, 1, 2)."""
    goal_samples = sample_heatmap(
        wp_sigmoid_hw[:, -1], 10000, rel_threshold=scfg.rel_threshold,
        replacement=True, generator=generator)  # (B, 10000, 2)
    _, centers = batched_kmeans(goal_samples, scfg.n_goal - 1, tol=1e-3,
                                generator=generator)  # (B, K-1, 2)
    sam = softargmax2d_auto(pred_waypoint_map[..., -1].contiguous())  # (B,2)
    goals = torch.cat([sam[:, None, None, :], centers[:, :, None, :]],
                      dim=1)  # (B, K, 1, 2)
    return goals.transpose(0, 1)


def make_eval_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig, mesh=None,
                   collect_samples: bool = False):
    """The multi-goal eval step.

    eval_step(params, state, batch, generator) -> dict of per-trajectory
    min-over-K 'ade', 'fde' (B,), 'best_traj' (B, pred_len, 2) raw pixels,
    and the masked sums. state is the model state, read in eval mode (the
    batch norms' running statistics). batch: 'semantic' (1 or B, H, W, C),
    'traj' (B, obs_len + pred_len, 2) model-space pixels, 'mask' (B,),
    with world_coords the scene's 'homography' (3, 3), and for a
    cross-scene batch 'scene_idx' (B,) into a (S, H, W, C) 'semantic'.

    generator: the draws, from a torch.Generator, a sampling.Draws, or a
    key (an int64 (2,) tensor, or a sampling.Key), from which the forward
    reads no host value, so that torch.export records it.

    The parts are exposed: eval_step.forward -> (features, waypoint
    samples (K, B, n_wp, 2)); eval_step.prepredictor -> the decode tail's
    inputs; eval_step.decode_trajs -> (K, B, pred_len, 2) model-space
    trajectories; eval_step.decode_and_score; eval_step.global_outputs
    (the mesh's reduction of decode_and_score's outputs). Only forward
    takes the state: the decoders hold no batch norm (as in mst_tpu).

    mesh: a data-parallel DeviceMesh whose rank holds its rows of the
    global batch: the forward then draws each row's noise as one process
    draws it (sampling.Rows over the generator), and eval_step returns the
    global batch's outputs on every rank: 'ade', 'fde', 'mask' and
    'best_traj' gathered in global row order, the sums summed over the
    ranks.

    On a spatial ('data', 'space') mesh the rows are the rank's 'data'
    block and batch['semantic'] holds the rank's H slab of the scene maps
    (of the image when the step runs the backbone, segment_in_step: it
    segments the slab, models/unet.py); the outputs are the same global
    ones on every rank (the module docstring).

    collect_samples: eval_step also returns the visualization payload
    (mst_tpu/train/steps.py:341-356, 595-603; reference evaluate.py:75-80,
    240-245): 'goal_map', the f32 goal logits (B, H, W, pred_len) NHWC,
    'goal_sigmoid_map' = sigmoid(goal_map / temperature), and
    'waypoint_samples' (B, n_wp, K, 2), gathered like 'best_traj' on a
    mesh; eval_step.forward then returns the goal logits third. Off, the
    step and its parts are what they are without it.

    Spans (utils/profiling.py): the forward is 'forward', its model part
    (inputs, encoder, goal decoder, the sigmoid) 'forward.model' and its
    sampling (TTST's draws and k-means or the plain draws, CWS)
    'forward.sampling'.
    """
    n_wp = len(scfg.waypoints)
    waypoints = list(scfg.waypoints)
    n_levels = len(mcfg.encoder_channels) + 1
    shards = batch_shards(mesh)

    def slabs_of(rows):
        return slab_levels(mesh, n_levels, rows)

    def goal_maps(params, state, batch):
        """The model's part of the forward -> (features, the f32 goal
        logits (B, H, W, pred), their waypoint channels (B, H, W, n_wp)
        and those channels' sigmoid (B, n_wp, H, W) for the samplers)."""
        params = _compute_params(params, scfg)
        slabs = slabs_of(batch["semantic"].shape[-3])
        semantic, observed_map, _ = _prepare_inputs(
            mcfg, scfg, params, batch["semantic"], batch["traj"],
            seg_bn_state=state.get("segmentation_bn"),
            scene_idx=batch.get("scene_idx"),
            slab=None if slabs is None else slabs[0])
        features, _ = ynet_lib.pred_features(params, state, mcfg, semantic,
                                             observed_map, slabs=slabs)
        # the goal logits in f32: sigmoid, sampling, TTST and CWS stay f32
        pred_goal_map = ynet_lib.pred_goal(
            params, features, slabs).float()  # (B, H, W, pred)
        if slabs is not None and collect_samples:
            pred_goal_map = slabs[0].gather(pred_goal_map)  # for the payload
        pred_waypoint_map = take(pred_goal_map, waypoints, -1)  # (B,H,W,n_wp)
        if slabs is not None and not collect_samples:
            # the samplers, TTST and CWS run on the whole channels
            pred_waypoint_map = slabs[0].gather(pred_waypoint_map)
        pred_wp_sigmoid = torch.sigmoid(pred_waypoint_map / scfg.temperature)
        # (B, n_wp, H, W) for the samplers
        return (features, pred_goal_map, pred_waypoint_map,
                pred_wp_sigmoid.permute(0, 3, 1, 2))

    def sample_waypoints(generator, traj, pred_waypoint_map, wp_sigmoid_hw):
        """The sampling layer's part -> waypoint samples (K, B, n_wp, 2):
        the goals (TTST's draws and k-means, or plain draws), then the
        other waypoints (CWS, or plain draws)."""
        generator = draw_source(generator)
        if shards is not None:  # this rank's rows of the global draws
            n = traj.shape[0]
            generator = Rows(generator, *shards.rows(n), n * shards.count)
        if scfg.use_ttst:
            goal_samples = _ttst_goals(generator, pred_waypoint_map,
                                       wp_sigmoid_hw, scfg)  # (K_e,B,1,2)
        else:
            gs = sample_heatmap(wp_sigmoid_hw[:, -1:], scfg.n_goal,
                                generator=generator)  # (B, 1, n_goal, 2)
            goal_samples = gs.permute(2, 0, 1, 3)  # (n_goal, B, 1, 2)

        if scfg.use_cws and n_wp > 1:
            return _cws(generator, goal_samples, traj, wp_sigmoid_hw, scfg)
        if n_wp > 1:
            ws = sample_heatmap(wp_sigmoid_hw[:, :-1],
                                scfg.n_goal * scfg.n_traj,
                                generator=generator)  # (B, n_wp-1, K, 2)
            ws = ws.permute(2, 0, 1, 3)  # (K, B, n_wp-1, 2)
            goal_rep = goal_samples.repeat(scfg.n_traj, 1, 1, 1)
            return torch.cat([ws, goal_rep], dim=2)
        return goal_samples  # (K, B, 1, 2)

    def forward(params, state, batch, generator):
        with span("forward"):
            with span("forward.model"):
                features, pred_goal_map, pred_waypoint_map, wp_sigmoid_hw = \
                    goal_maps(params, state, batch)
            with span("forward.sampling"):
                waypoint_samples = sample_waypoints(
                    generator, batch["traj"], pred_waypoint_map,
                    wp_sigmoid_hw)
        if collect_samples:
            return features, waypoint_samples, pred_goal_map
        return features, waypoint_samples

    def prepredictor(params, features):
        """-> inputs(chunk): waypoint samples (Kc, B, n_wp, 2) -> the
        trajectory decoder's 1x1 predictor input (Kc*B, H, W, C) with its
        (C, pred_len) weight and (pred_len,) bias, all in the compute
        dtype, the encoder terms hoisted once for all chunks. On a spatial
        mesh the input is the rank's slab of rows."""
        H, W = features[0].shape[1], features[0].shape[2]
        slabs = slabs_of(features[0].shape[1])
        row0 = 0 if slabs is None else slabs[0].lo
        decode = ynet_lib.make_shared_pred_traj(
            _compute_params(params, scfg), features, n_wp, slabs)

        def inputs(chunk):
            Kc, B = chunk.shape[0], chunk.shape[1]
            flat = chunk.reshape(Kc * B, n_wp, 2)
            wmap = rasterize_dist_nhwc(flat, H, W, scfg.template_size, row0)
            return decode(avg_pool_pyramid(wmap.to(scfg.compute_dtype),
                                           len(features), slabs))
        return inputs

    def decode_trajs(params, features, waypoint_samples):
        """All K decodes against the shared encoder features ->
        (K, B, pred_len, 2) model-space trajectories. The tail (1x1
        predictor + soft-argmax) is the fused kernel: the logits never
        reach memory. On a spatial mesh it is the kernel's partial
        variant on the rank's slab, whose statistics the 'space' ranks
        merge (merge_ranks)."""
        inputs = prepredictor(params, features)
        slabs = slabs_of(features[0].shape[1])

        def decode_chunk(chunk):
            if slabs is None:
                pts = fused_predictor_softargmax(*inputs(chunk))
            else:
                pts = merge_ranks(fused_predictor_softargmax_partial(
                    *inputs(chunk), slabs[0].lo), slabs[0])
            return pts.reshape(chunk.shape[0], chunk.shape[1],
                               scfg.pred_len, 2)

        K = waypoint_samples.shape[0]
        kc = scfg.eval_k_chunk or K
        if K % kc != 0:
            raise ValueError(
                f"eval_k_chunk={kc} must divide K={K} (n_goal*n_traj); "
                "pick a divisor or 0 for all-at-once")
        return torch.cat([decode_chunk(c)
                          for c in waypoint_samples.split(kc)])

    def decode_and_score(params, features, waypoint_samples, traj, mask,
                         homography=None):
        """K decodes + the min-over-K metrics (evaluate.py:248-291), in
        world coordinates through `homography` when world_coords
        (mst_tpu/train/steps.py:523-544), else in raw pixels."""
        trajs = decode_trajs(params, features, waypoint_samples)
        gt_future = traj[:, scfg.obs_len:]
        if scfg.world_coords:
            if homography is None:
                raise ValueError("world_coords needs the batch's "
                                 "'homography'")
            ade_k, fde_k = ade_fde_per_sample_world(
                gt_future, trajs, waypoint_samples[:, :, -1],
                scfg.resize_factor, homography)
        else:
            ade_k, fde_k = ade_fde_per_sample(gt_future, trajs,
                                              waypoint_samples[:, :, -1],
                                              scfg.resize_factor)
        ade, best_idx = ade_k.min(dim=0)
        fde = fde_k.amin(dim=0)
        best_traj = trajs[best_idx, torch.arange(trajs.shape[1],
                                                 device=trajs.device)]
        return {"ade": ade, "fde": fde, "mask": mask,
                "ade_sum": (ade * mask).sum(), "fde_sum": (fde * mask).sum(),
                "n": mask.sum(),
                "best_traj": best_traj / scfg.resize_factor}

    def global_outputs(out):
        """decode_and_score's outputs on this rank's rows -> the global
        batch's (themselves without a mesh), reduced over the 'data'
        ranks of a spatial mesh (Shards' group)."""
        if shards is None:
            return out
        sums = shards.all_reduce(torch.stack(
            [out["ade_sum"], out["fde_sum"], out["n"]]))
        rows = {k: shards.gather_rows(out[k])
                for k in ("ade", "fde", "mask", "best_traj")}
        return dict(rows, ade_sum=sums[0], fde_sum=sums[1], n=sums[2])

    @torch.no_grad()
    def eval_step(params, state, batch, generator):
        fwd = forward(params, state, batch, generator)
        features, waypoint_samples = fwd[0], fwd[1]
        out = global_outputs(decode_and_score(
            params, features, waypoint_samples, batch["traj"],
            batch["mask"], batch.get("homography")))
        if collect_samples:
            goal_map = fwd[2]
            payload = {
                "goal_map": goal_map,
                "goal_sigmoid_map": torch.sigmoid(goal_map
                                                  / scfg.temperature),
                # (K, B, n_wp, 2) -> (B, n_wp, K, 2), evaluate.py:243-245
                "waypoint_samples": waypoint_samples.permute(1, 2, 0, 3)}
            if shards is not None:
                payload = {k: shards.gather_rows(v.contiguous())
                           for k, v in payload.items()}
            out.update(payload)
        return out

    eval_step.forward = torch.no_grad()(forward)
    eval_step.prepredictor = prepredictor
    eval_step.decode_trajs = torch.no_grad()(decode_trajs)
    eval_step.decode_and_score = torch.no_grad()(decode_and_score)
    eval_step.global_outputs = global_outputs
    return eval_step


def make_predict_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig):
    """Serving predict: no ground truth; all K trajectories in raw pixels.

    predict(params, state, semantic, observed, key) -> dict
      trajectories (K, B, pred_len, 2) and waypoints (K, B, n_wp, 2), raw px.
    observed is (B, obs_len, 2) in model-space pixels (raw * resize_factor);
    key: the draws, as eval_step's generator. predict.forward and
    predict.decode_trajs are the two stages, which serve.export_model
    exports as forward.pt2 and decode.pt2.
    """
    es = make_eval_step(mcfg, scfg)

    def forward(params, state, semantic, observed, key):
        # the forward only reads the first obs_len rows of traj
        return es.forward(params, state,
                          {"semantic": semantic, "traj": observed}, key)

    def predict(params, state, semantic, observed, key):
        features, waypoint_samples = forward(params, state, semantic,
                                             observed, key)
        trajs = es.decode_trajs(params, features, waypoint_samples)
        return {"trajectories": trajs / scfg.resize_factor,
                "waypoints": waypoint_samples / scfg.resize_factor}

    predict.forward = forward
    predict.decode_trajs = es.decode_trajs
    return predict


def cws_gaussian_prior(mean, dist, sigma_factor, ratio, rot, H, W):
    """Oriented Gaussian prior, batched over leading dims (reference
    evaluate.py:9-34): axes linspace(0, H, H), covariance
    R diag((|d|+5)/sf/ratio, (|d|+5)/sf)^2 R^T with R the heading rotation
    (optionally pre-rotated 90 degrees). mean/dist (..., 2), sigma_factor
    (...,) -> (..., H, W) maps normalised to sum 1."""
    dev = mean.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) * (H / (H - 1))
    xs = torch.arange(W, dtype=torch.float32, device=dev) * (W / (W - 1))
    ax = ys - mean[..., 1][..., None]  # (..., H)
    ay = xs - mean[..., 0][..., None]  # (..., W)
    radians = torch.atan2(dist[..., 0], dist[..., 1])
    cr, sr = torch.cos(radians), torch.sin(radians)
    R = torch.stack([torch.stack([cr, sr], -1),
                     torch.stack([-sr, cr], -1)], -2)  # (..., 2, 2)
    if rot:  # [[0, -1], [1, 0]] @ R, with no host-made constant
        R = torch.stack([-R[..., 1, :], R[..., 0, :]], -2)
    dist_norm = torch.sqrt((dist ** 2).sum(-1)) + 5.0
    conv = torch.zeros(R.shape, device=dev)
    conv[..., 0, 0] = (dist_norm / sigma_factor / ratio) ** 2
    conv[..., 1, 1] = (dist_norm / sigma_factor) ** 2
    T = torch.einsum("...ij,...jl,...ml->...im", R, conv, R)
    Tinv = torch.linalg.inv(T)
    gx = ay[..., None, :]  # (..., 1, W) x offsets
    gy = ax[..., :, None]  # (..., H, 1) y offsets
    q = (Tinv[..., 0, 0][..., None, None] * gx * gx
         + (Tinv[..., 0, 1] + Tinv[..., 1, 0])[..., None, None] * gx * gy
         + Tinv[..., 1, 1][..., None, None] * gy * gy)
    kern = torch.exp(-0.5 * q)
    return kern / kern.sum(dim=(-2, -1), keepdim=True)


def _cws(generator, goal_samples, traj, wp_sigmoid_hw, scfg: StepConfig):
    """Conditional Waypoint Sampling (evaluate.py:172-226), batched over
    (K, B). goal_samples (K_e, B, 1, 2), wp_sigmoid_hw (B, n_wp, H, W)
    -> (K_e * n_traj, B, n_wp, 2)."""
    n_wp = len(scfg.waypoints)
    cws = scfg.cws_params
    H, W = wp_sigmoid_hw.shape[-2], wp_sigmoid_hw.shape[-1]
    goals = goal_samples.repeat(scfg.n_traj, 1, 1, 1)[:, :, 0]  # (K, B, 2)
    K = goals.shape[0]
    last_observed = traj[:, scfg.obs_len - 1]  # (B, 2)
    k_idx = torch.arange(K, device=goals.device)
    traj_idx = torch.div(k_idx, scfg.n_goal,
                         rounding_mode="floor").to(torch.float32)
    first = (traj_idx == 0)[:, None, None]  # first-goal group
    sf = float(cws.sigma_factor) - traj_idx[:, None]  # (K, 1)

    wp_list = [goals[:, :, None]]  # goal first; built back to front
    samples = goals
    for wnum in reversed(range(n_wp - 1)):
        distance = last_observed[None] - samples  # (K, B, 2)
        gauss_mean = samples + distance * (1.0 / (wnum + 2))
        prior = cws_gaussian_prior(gauss_mean, distance,
                                   sf.expand(gauss_mean.shape[:2]),
                                   float(cws.ratio), bool(cws.rot), H, W)
        wmap = wp_sigmoid_hw[:, wnum][None] * prior  # (K, B, H, W)
        wmap = wmap / wmap.sum(dim=(-2, -1), keepdim=True)
        # first-goal group: soft-argmax; the others: a thresholded sample
        sam_pts = softargmax_on_prob_map(wmap)
        sampled = sample_heatmap(wmap, 1, rel_threshold=0.05,
                                 replacement=False, generator=generator,
                                 batch_dim=1)[:, :, 0]
        samples = torch.where(first, sam_pts, sampled)
        wp_list.append(samples[:, :, None])
    return torch.cat(wp_list[::-1], dim=2)
