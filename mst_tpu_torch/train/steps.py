"""Train, eval and predict steps (counterpart of mst_tpu/train/steps.py:51-104,
179-315, 322-772; reference utils/train_epoch.py:44-126 and
utils/evaluate.py:37-315).

PyTorch runs eagerly, so a step is a plain function. Eval: forward with
goal and waypoint sampling (optionally TTST or CWS), then the K waypoint-
conditioned trajectory decodes in chunks of eval_k_chunk, then the
min-over-K metrics. Train: one few-shot fine-tune step, forward, masked
BCE, backward into the trainable leaves and an optimizer step (see
make_train_step). The decode is always the unpacked math; the JAX
package's space-to-depth packing is a TPU layout and has no counterpart.
Random draws come from one torch.Generator on the step's device.
"""

from typing import Any, NamedTuple

import torch

from mst_tpu_torch.evaluator.metrics import ade_fde_per_sample
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.ops.heatmap import (rasterize_dist_nhwc,
                                       rasterize_gaussian_nhwc)
from mst_tpu_torch.ops.kernels.fused_predict import \
    fused_predictor_softargmax
from mst_tpu_torch.ops.kmeans import batched_kmeans
from mst_tpu_torch.ops.pooling import avg_pool_pyramid
from mst_tpu_torch.ops.sampling import sample_heatmap
from mst_tpu_torch.ops.softargmax import (softargmax2d_auto,
                                          softargmax_on_prob_map)
from mst_tpu_torch.train.losses import bce_with_logits


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


def swap_pavement_terrain(semantic_img):
    """Swap semantic channels 1 and 2 of an NHWC map (a copy of
    mst_tpu/data/images.py:90-94; reference image_utils.py:165-173)."""
    perm = list(range(semantic_img.shape[-1]))
    perm[1], perm[2] = perm[2], perm[1]
    return semantic_img[..., perm]


def _prepare_inputs(mcfg, scfg, params, semantic, traj):
    """semantic (1 or B, H, W, C) + traj (B, T, 2) -> (semantic through
    the semantic adapter, swapped if asked, broadcast to B; observed
    distance maps (B, H, W, obs_len)), each through its embedding on the
    embed network (mst_tpu/train/steps.py:157-175)."""
    B = traj.shape[0]
    H, W = semantic.shape[-3], semantic.shape[-2]
    semantic = ynet_lib.adapt_semantic(params, mcfg,
                                       semantic.to(torch.float32))
    if scfg.swap_semantic:
        semantic = swap_pavement_terrain(semantic)
    if semantic.shape[0] != B:
        semantic = semantic.expand(B, *semantic.shape[1:])
    observed_map = rasterize_dist_nhwc(traj[:, :scfg.obs_len], H, W,
                                       scfg.template_size)
    if mcfg.network == "embed":
        semantic = ynet_lib.scene_embedding(params, semantic)
        observed_map = ynet_lib.motion_embedding(params, observed_map)
    return semantic, observed_map


def make_train_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig):
    """The few-shot fine-tune step (mst_tpu make_train_step, unpacked).

    train_step(params, state, optimizer, scheduler, batch) -> (new state,
    metrics). params is the nested tree; its trainable leaves have
    requires_grad and are the optimizer's parameters
    (freeze.set_trainable), and the step updates them in place: zero the
    gradients, backward, optimizer.step(), scheduler.step(). state is the
    model state (init_ynet's); the encoder runs in train mode, so the
    batch norms normalise with the batch's statistics and the new state
    holds their moved running statistics. This replaces the JAX
    signature's functional (trainable, frozen, state, opt_state)
    threading. batch: 'semantic' (1 or B, H, W, C), 'traj' (B, obs_len +
    pred_len, 2) model-space pixels, 'mask' (B,). metrics: 'loss',
    'goal_loss', 'traj_loss' (each x loss_scale), and the masked top-1
    'ade_sum', 'fde_sum' and 'n', as 0-d tensors detached from the
    graph.

    The trajectory decoder runs in the split form on the ground-truth
    waypoint pyramid; its logits are the 1x1 predictor as an einsum plus
    the bias (BCE needs them, so the fused kernel has no place here). The
    metrics' soft-argmax runs on contiguous (B, P, H, W) copies of the
    detached maps through softargmax2d_auto: two rows-kernel launches a
    step on the card, the plain version on the CPU.
    """
    waypoints = list(scfg.waypoints)
    n_levels = len(mcfg.encoder_channels) + 1

    def forward(params, state, batch):
        """-> (goal_loss, traj_loss, goal logits, traj logits, new state);
        the maps are (B, H, W, pred_len)."""
        traj, mask = batch["traj"], batch["mask"]
        H, W = batch["semantic"].shape[-3], batch["semantic"].shape[-2]
        semantic, observed_map = _prepare_inputs(mcfg, scfg, params,
                                                 batch["semantic"], traj)
        gt_future = traj[:, scfg.obs_len:]
        gt_future_map = rasterize_gaussian_nhwc(gt_future, H, W,
                                                scfg.kernlen, scfg.nsig)
        gt_waypoint_map = rasterize_dist_nhwc(gt_future[:, waypoints], H, W,
                                              scfg.template_size)
        wp_pyramid = avg_pool_pyramid(gt_waypoint_map, n_levels)
        features, new_state = ynet_lib.pred_features(
            params, state, mcfg, semantic, observed_map, train=True)
        goal_map = ynet_lib.pred_goal(params, features)
        x, w, b = ynet_lib.make_shared_pred_traj(
            params, features, len(waypoints))(wp_pyramid)
        traj_map = torch.einsum("bhwc,cp->bhwp", x, w) + b
        goal_loss = bce_with_logits(goal_map, gt_future_map,
                                    mask) * scfg.loss_scale
        traj_loss = bce_with_logits(traj_map, gt_future_map,
                                    mask) * scfg.loss_scale
        return goal_loss, traj_loss, goal_map, traj_map, new_state

    @torch.no_grad()
    def top1_metrics(goal_map, traj_map, traj, mask):
        """Top-1 soft-argmax ADE/FDE (train_epoch.py:117-126)."""
        gt_future = traj[:, scfg.obs_len:]
        traj_pts = softargmax2d_auto(
            traj_map.detach().permute(0, 3, 1, 2).contiguous())  # (B, P, 2)
        goal_pts = softargmax2d_auto(
            goal_map.detach()[..., -1:].permute(0, 3, 1, 2).contiguous())
        rf = scfg.resize_factor
        ade = torch.sqrt((((gt_future - traj_pts) / rf) ** 2).sum(-1)).mean(-1)
        fde = torch.sqrt((((gt_future[:, -1:] - goal_pts[:, -1:]) / rf) ** 2)
                         .sum(-1)).mean(-1)
        return {"ade_sum": (ade * mask).sum(), "fde_sum": (fde * mask).sum(),
                "n": mask.sum()}

    def train_step(params, state, optimizer, scheduler, batch):
        optimizer.zero_grad(set_to_none=True)
        goal_loss, traj_loss, goal_map, traj_map, new_state = forward(
            params, state, batch)
        loss = goal_loss + traj_loss
        loss.backward()
        optimizer.step()
        scheduler.step()
        metrics = top1_metrics(goal_map, traj_map, batch["traj"],
                               batch["mask"])
        return new_state, {"loss": loss.detach(),
                           "goal_loss": goal_loss.detach(),
                           "traj_loss": traj_loss.detach(), **metrics}

    train_step.forward = forward
    return train_step


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


def make_eval_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig):
    """The multi-goal eval step.

    eval_step(params, state, batch, generator) -> dict of per-trajectory
    min-over-K 'ade', 'fde' (B,), 'best_traj' (B, pred_len, 2) raw pixels,
    and the masked sums. state is the model state, read in eval mode (the
    batch norms' running statistics). batch: 'semantic' (1 or B, H, W, C),
    'traj' (B, obs_len + pred_len, 2) model-space pixels, 'mask' (B,).

    The parts are exposed: eval_step.forward -> (features, waypoint
    samples (K, B, n_wp, 2)); eval_step.prepredictor -> the decode tail's
    inputs; eval_step.decode_trajs -> (K, B, pred_len, 2) model-space
    trajectories; eval_step.decode_and_score. Only forward takes the
    state: the decoders hold no batch norm (as in mst_tpu).
    """
    n_wp = len(scfg.waypoints)
    waypoints = list(scfg.waypoints)

    def forward(params, state, batch, generator):
        traj = batch["traj"]
        semantic, observed_map = _prepare_inputs(mcfg, scfg, params,
                                                 batch["semantic"], traj)
        features, _ = ynet_lib.pred_features(params, state, mcfg, semantic,
                                             observed_map)
        pred_goal_map = ynet_lib.pred_goal(params, features)  # (B,H,W,pred)
        pred_waypoint_map = pred_goal_map[..., waypoints]  # (B,H,W,n_wp)
        pred_wp_sigmoid = torch.sigmoid(pred_waypoint_map / scfg.temperature)
        # (B, n_wp, H, W) for the samplers
        wp_sigmoid_hw = pred_wp_sigmoid.permute(0, 3, 1, 2)

        if scfg.use_ttst:
            goal_samples = _ttst_goals(generator, pred_waypoint_map,
                                       wp_sigmoid_hw, scfg)  # (K_e,B,1,2)
        else:
            gs = sample_heatmap(wp_sigmoid_hw[:, -1:], scfg.n_goal,
                                generator=generator)  # (B, 1, n_goal, 2)
            goal_samples = gs.permute(2, 0, 1, 3)  # (n_goal, B, 1, 2)

        if scfg.use_cws and n_wp > 1:
            waypoint_samples = _cws(generator, goal_samples, traj,
                                    wp_sigmoid_hw, scfg)
        elif n_wp > 1:
            ws = sample_heatmap(wp_sigmoid_hw[:, :-1],
                                scfg.n_goal * scfg.n_traj,
                                generator=generator)  # (B, n_wp-1, K, 2)
            ws = ws.permute(2, 0, 1, 3)  # (K, B, n_wp-1, 2)
            goal_rep = goal_samples.repeat(scfg.n_traj, 1, 1, 1)
            waypoint_samples = torch.cat([ws, goal_rep], dim=2)
        else:
            waypoint_samples = goal_samples  # (K, B, 1, 2)
        return features, waypoint_samples

    def prepredictor(params, features):
        """-> inputs(chunk): waypoint samples (Kc, B, n_wp, 2) -> the
        trajectory decoder's 1x1 predictor input (Kc*B, H, W, C) with its
        (C, pred_len) weight and (pred_len,) bias, the encoder terms
        hoisted once for all chunks."""
        H, W = features[0].shape[1], features[0].shape[2]
        decode = ynet_lib.make_shared_pred_traj(params, features, n_wp)

        def inputs(chunk):
            Kc, B = chunk.shape[0], chunk.shape[1]
            flat = chunk.reshape(Kc * B, n_wp, 2)
            wmap = rasterize_dist_nhwc(flat, H, W, scfg.template_size)
            return decode(avg_pool_pyramid(wmap, len(features)))
        return inputs

    def decode_trajs(params, features, waypoint_samples):
        """All K decodes against the shared encoder features ->
        (K, B, pred_len, 2) model-space trajectories. The tail (1x1
        predictor + soft-argmax) is the fused kernel: the logits never
        reach memory."""
        inputs = prepredictor(params, features)

        def decode_chunk(chunk):
            pts = fused_predictor_softargmax(*inputs(chunk))
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

    def decode_and_score(params, features, waypoint_samples, traj, mask):
        """K decodes + the min-over-K metrics (evaluate.py:248-291)."""
        trajs = decode_trajs(params, features, waypoint_samples)
        gt_future = traj[:, scfg.obs_len:]
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

    @torch.no_grad()
    def eval_step(params, state, batch, generator):
        features, waypoint_samples = forward(params, state, batch,
                                             generator)
        return decode_and_score(params, features, waypoint_samples,
                                batch["traj"], batch["mask"])

    eval_step.forward = torch.no_grad()(forward)
    eval_step.prepredictor = prepredictor
    eval_step.decode_trajs = torch.no_grad()(decode_trajs)
    eval_step.decode_and_score = torch.no_grad()(decode_and_score)
    return eval_step


def make_predict_step(mcfg: ynet_lib.YNetConfig, scfg: StepConfig):
    """Serving predict: no ground truth; all K trajectories in raw pixels.

    predict(params, state, semantic, observed, generator) -> dict
      trajectories (K, B, pred_len, 2) and waypoints (K, B, n_wp, 2), raw px.
    observed is (B, obs_len, 2) in model-space pixels (raw * resize_factor).
    predict.forward and predict.decode_trajs are the two stages.
    """
    es = make_eval_step(mcfg, scfg)

    def forward(params, state, semantic, observed, generator):
        # the forward only reads the first obs_len rows of traj
        return es.forward(params, state,
                          {"semantic": semantic, "traj": observed}, generator)

    def predict(params, state, semantic, observed, generator):
        features, waypoint_samples = forward(params, state, semantic,
                                             observed, generator)
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
    if rot:
        rot90 = torch.tensor([[0.0, -1.0], [1.0, 0.0]], device=dev)
        R = torch.einsum("ij,...jl->...il", rot90, R)
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
                                 replacement=False,
                                 generator=generator)[:, :, 0]
        samples = torch.where(first, sam_pts, sampled)
        wp_list.append(samples[:, :, None])
    return torch.cat(wp_list[::-1], dim=2)
