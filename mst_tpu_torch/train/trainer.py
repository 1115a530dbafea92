"""The Experiment loop: data, training with validation, checkpoint policy and
the multi-round test (counterpart of mst_tpu/train/trainer.py:62-1060,
1186-1198; reference models/trainer.py:45-614).

setup_training marks the strategy's leaves trainable and builds Adam with
the fine-tune schedule; save_params writes the JAX package's npz (flat
'/'-joined keys, conv weights HWIO) and its JSON metadata sidecar, so a
checkpoint saved here loads in mst_tpu and in serve.Predictor.add_style.

Experiment keeps mst_tpu's policy: the per-epoch batch shuffle, the NaN
guard, smooth-val with its lagging snapshot window, best tracking and the
best-weights save when not fine-tuning, save_every_n saves, the fine-tune
early stop and the roll back to the best snapshot. Not ported: the fused
multi-epoch program, --resume, cross-scene batching, device meshes, eth,
and forward_test (config.check_loop_ported raises on the flags).

The segmentation backbone (when its file exists) turns each scene's
image into its semantic map once a pass and a cache (_semantic_for):
one cache for the train epochs before e_unfreeze, one across validation
epochs while the backbone cannot change, one across the test's rounds.
The segmentation_* strategies run it inside the train step from the
first epoch, and from epoch e_unfreeze every train step runs it with its
batch norms on the batch's statistics, whose running statistics move in
the state's 'segmentation_bn' (mst_tpu/train/trainer.py:181-200,
697-735).

The model state (the serial adapters' batch-norm running statistics) is
self.model_state: the train steps thread it, it is assigned once an epoch
before validation, validation and test read it in eval mode, and the roll
back to the best snapshot restores the trainable leaves only, as mst_tpu's
does (trainer.py:745-781).

Randomness. Weights come from init_ynet with a torch.Generator seeded
from `seed`; the train batches are shuffled by np.random.default_rng(seed)
in mst_tpu's order of draws. Eval batch i of stream s (validation epoch e:
s = e; test round e: s = 10_000 + e) draws from a torch.Generator on the
device seeded with eval_seed(seed, s, i), so two Experiments with the same
seed and weights score bit-identically on one device (the --init_check
contract); the streams are the port's own, not JAX's.
"""

import collections
import json
import math
import os
import time

import numpy as np
import torch

from mst_tpu_torch import config as config_lib
from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.data import images as images_lib
from mst_tpu_torch.data import scenes as scenes_lib
from mst_tpu_torch.evaluator.logs import MetricsLogger
from mst_tpu_torch.models import segmentation as seg_lib
from mst_tpu_torch.models.unet import extract_bn_stats
from mst_tpu_torch.models.ynet import init_ynet
from mst_tpu_torch.train import freeze
from mst_tpu_torch.train.steps import make_eval_step, make_train_step
from mst_tpu_torch.utils.profiling import ThroughputMeter

# the metadata sidecar's keys (trainer.py:107-110)
METADATA_KEYS = ("train_net", "position", "network", "n_fusion", "seed",
                 "lr", "n_train_batch", "ynet_bias")
_IMAGE_FILES = {"sdd": "reference.jpg", "ind-dataset-v1.0": "reference.png"}
TEST_STREAM = 10_000  # test round e draws from stream TEST_STREAM + e


def setup_training(model_params, params_dict, steps_per_epoch: int):
    """Freeze split, Adam and its schedule for model_params (in place:
    requires_grad is set on every leaf).

    The schedule follows trainer.py:457-467: with fine_tune and steps,
    the LR is multiplied by lr_decay_ratio (default 0.1) from optimizer
    step m * steps_per_epoch on, for each distinct milestone m (optax's
    piecewise_constant_schedule takes a dict, so a repeated milestone
    decays once; MultiStepLR would decay twice). Otherwise the LR is
    constant. Step the scheduler once an optimizer step. On a CUDA device
    the f32 path is pinned (resolve_device).

    -> dict of trainable (the leaves), n_trainable, optimizer, scheduler.
    """
    leaf = next(iter(io.flatten(model_params).values()))
    resolve_device(leaf.device)
    trainable = freeze.set_trainable(
        model_params, params_dict.get("train_net", "train"),
        params_dict.get("position", ()), params_dict.get("ynet_bias", False),
        params_dict.get("network"))
    optimizer = torch.optim.Adam(trainable, lr=float(params_dict["lr"]))
    milestones = []
    if params_dict.get("fine_tune") and params_dict.get("steps"):
        spe = max(int(steps_per_epoch), 1)
        milestones = sorted({int(m) * spe for m in params_dict["steps"]})
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=milestones,
        gamma=float(params_dict.get("lr_decay_ratio", 0.1)))
    return dict(trainable=trainable,
                n_trainable=sum(p.numel() for p in trainable),
                optimizer=optimizer, scheduler=scheduler)


def save_params(path, model_params, params_dict):
    """The whole model but the segmentation backbone for 'train'/'all',
    else the strategy's trainable leaves only (a delta: the leaves
    setup_training marked requires_grad, the backbone's too under a
    segmentation_* strategy), as mst_tpu's Experiment.save_params writes
    it (trainer.py:88-101, checkpoints.py:78-101): np.savez of the flat
    JAX layout at path, and the metadata at path + '.json'."""
    train_net = params_dict.get("train_net", "train")
    flat = io.flatten(model_params)
    if train_net in ("all", "train"):
        flat = {k: v for k, v in flat.items()
                if not k.startswith("segmentation")}
    else:
        flat = {k: v for k, v in flat.items() if v.requires_grad}
        if not flat:
            raise ValueError(f"train_net={train_net!r}: no leaf requires "
                             "grad; call setup_training first")
    arrays = io.params_to_numpy(flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    with open(str(path) + ".json", "w") as f:
        json.dump({k: params_dict.get(k) for k in METADATA_KEYS}, f,
                  indent=1, default=str)


def eval_seed(seed: int, stream: int, i: int) -> int:
    """The generator seed of eval batch i of stream `stream`: the first
    64-bit word numpy's SeedSequence derives from (seed, stream, i)."""
    return int(np.random.SeedSequence([seed, stream, i]).generate_state(
        1, np.uint64)[0])


class Experiment:
    """The train/test facade (mst_tpu's Experiment) over the port's steps.

    params: the flat params dict (config.get_params); images: optional
    {sceneId: raw HWC image} used in place of reading image files; device:
    'cuda' (the default, which must exist) or 'cpu', else params['device'].
    """

    def __init__(self, params: dict, images=None, device=None):
        self.params = dict(params)
        config_lib.check_loop_ported(self.params)
        self.device = resolve_device(device or self.params.get("device"))
        self.mcfg = config_lib.ynet_config(self.params)
        self.division_factor = 2 ** len(self.params["encoder_channels"])
        self.seed = int(self.params.get("seed", 1))
        self._images_override = images
        self.model_params, self.model_state = init_ynet(
            torch.Generator().manual_seed(self.seed), self.mcfg, self.device)
        if self.mcfg.segmentation:
            self.model_params["segmentation"] = seg_lib.load_params(
                self.params["segmentation_model_fp"], self.device)
        self.n_segmented = 0  # scene maps the backbone made (_semantic_for)
        self.val_ADE, self.val_FDE = [], []
        self.eval_ADE, self.eval_FDE = [], []
        self.epoch_log = []  # one record an epoch (see train)
        self.best_epoch = None  # train's best epoch
        self.n_shrinks = 0  # eval_k_chunk steps down the shrink ladder took

    # -- checkpoints (reference trainer.py:586-614) --------------------------
    def load_params(self, path):
        """Overlay a checkpoint, non-strict (unknown keys are skipped)."""
        self.model_params = io.overlay(
            self.model_params, io.params_from_numpy(io.load_checkpoint(path)))

    def save_params(self, path):
        """The whole model for 'train'/'all', else the strategy's trainable
        leaves (see save_params)."""
        p = self.params
        freeze.set_trainable(self.model_params, p.get("train_net", "train"),
                             p.get("position", ()), p.get("ynet_bias", False),
                             p.get("network"))
        save_params(path, self.model_params, p)

    def load_separated_params(self, pretrained_path, tuned_path):
        self.model_params = io.load_separated(self.model_params,
                                              pretrained_path, tuned_path)

    # -- data ---------------------------------------------------------------
    def prepare_data(self, tracks, image_path, mode, augment=False, rng=None):
        """A track table and its scenes' images -> SceneBatches
        (trainer.py:122-179): load the images (or take them from `images`),
        optionally augment, resize, pad and normalise, then batch per scene;
        'train' shuffles with rng."""
        p = self.params
        scenes = tracks.scene_ids()
        if self._images_override is not None:
            raw = {k: np.asarray(v) for k, v in self._images_override.items()
                   if k in set(scenes)}
        else:
            raw = images_lib.load_images(
                scenes, image_path,
                _IMAGE_FILES.get(p["dataset_name"].lower(), "reference.jpg"),
                p.get("use_raw_data", False))
        if augment:
            tracks, raw = images_lib.augment_data(tracks, raw)
        images = images_lib.preprocess_scene_images(
            raw, p["resize_factor"], self.division_factor, False,
            p["n_semantic_classes"])
        return scenes_lib.make_scene_batches(
            tracks, images, p["obs_len"] + p["pred_len"],
            int(p["batch_size"]), p["resize_factor"],
            shuffle=(mode == "train"), rng=rng)

    def _device_batches(self, batches):
        """[(batch, its device batch)], each scene's preprocessed image
        (1, H, W, C) uploaded once as 'image'; _with_semantic adds the
        semantic map."""
        images = {}
        out = []
        for b in batches:
            if b.scene_id not in images:
                images[b.scene_id] = torch.tensor(b.image[None],
                                                  device=self.device)
            out.append((b, {
                "image": images[b.scene_id],
                "traj": torch.tensor(b.trajectories, device=self.device),
                "mask": torch.tensor(b.mask, device=self.device)}))
        return out

    def _segment_in_step(self):
        """The backbone runs inside every train step when a
        segmentation_* strategy trains its leaves (trainer.py:181-189)."""
        return "segmentation" in self.model_params and str(
            self.params.get("train_net", "")).startswith("segmentation")

    def _e_unfreeze(self):
        """The epoch from which the train step runs the backbone with its
        batch norms in train mode (reference train_epoch.py:27-48), or
        None: no backbone, or e_unfreeze >= n_epoch (10000 in every
        shipped config; trainer.py:191-200)."""
        e = int(self.params.get("e_unfreeze", 10000))
        if "segmentation" not in self.model_params or \
                e >= int(self.params.get("n_epoch", 0)):
            return None
        return e

    def _semantic_for(self, scene_id, image, cache, raw=False):
        """The scene's semantic map: the image itself when raw (the
        backbone then runs in the step), else cache[scene_id], made on a
        miss by the backbone (with the state's adapted 'segmentation_bn'
        statistics once e_unfreeze has made them), or the image for the
        identity backbone (trainer.py:229-290)."""
        if raw:
            return image
        if scene_id not in cache:
            if "segmentation" in self.model_params:
                with torch.no_grad():
                    sem = seg_lib.apply(
                        self.model_params["segmentation"], image,
                        self.mcfg.use_features_only,
                        bn_state=self.model_state.get("segmentation_bn"))
                self.n_segmented += 1
                source = "segmentation backbone output"
            else:
                sem = image
                source = ("scene image (identity backbone: plain RGB "
                          "scenes have 3)")
            if sem.shape[-1] != self.mcfg.n_semantic_classes:
                raise ValueError(
                    f"semantic map for scene {scene_id!r} has "
                    f"{sem.shape[-1]} channels but the model expects "
                    f"n_semantic_classes={self.mcfg.n_semantic_classes} "
                    f"(source: {source})")
            cache[scene_id] = sem
        return cache[scene_id]

    def _with_semantic(self, items, cache, raw=False):
        """items with each device batch's 'semantic' (_semantic_for)."""
        return [(b, {"semantic": self._semantic_for(b.scene_id, db["image"],
                                                    cache, raw),
                     "traj": db["traj"], "mask": db["mask"]})
                for b, db in items]

    # -- evaluation (reference trainer.py:295-352) ---------------------------
    def _eval_step(self, eval_k_chunk=None, for_validation=False):
        over = {} if eval_k_chunk is None else {"eval_k_chunk": eval_k_chunk}
        return make_eval_step(self.mcfg, config_lib.step_config(
            self.params, for_validation, **over))

    def _eval_shrinker(self, make_step):
        """The out-of-memory ladder of the K-sample decode (trainer.py:
        288-310): -> (state, shrink); state['step'] is the current eval step
        and shrink() rebuilds it at the next smaller divisor of K = n_goal *
        n_traj as eval_k_chunk (None when there is none). The chunked decode
        gives the same trajectories, so a shrink costs only speed."""
        K = int(self.params["n_goal"]) * int(self.params["n_traj"])
        state = {"kc": int(self.params.get("eval_k_chunk", 0)) or K,
                 "step": make_step(None)}

        def shrink():
            for kc in range(state["kc"] - 1, 0, -1):
                if K % kc == 0:
                    state["kc"] = kc
                    print(f"[eval] device memory exhausted; retrying with "
                          f"eval_k_chunk={kc} (K={K})", flush=True)
                    self.n_shrinks += 1
                    state["step"] = make_step(kc)
                    return state["step"]
            return None

        return state, shrink

    def _evaluate(self, items, eval_step, stream, shrink,
                  collect_preds=False):
        """items: [(batch, device batch)] -> (ADE, FDE, metrics rows, trajs)
        over the real rows (trainer.py:891-1017). Batch i draws from its
        own generator (eval_seed(seed, stream, i)); on
        torch.cuda.OutOfMemoryError the batch is retried, with the same
        draws, one rung down the shrink ladder. The metrics rows are numpy
        columns metaId, sceneId, ade, fde."""
        ade_sum = fde_sum = n_sum = 0.0
        rows = {"metaId": [], "sceneId": [], "ade": [], "fde": []}
        trajs = ({"prediction": [], "metaId": [], "groundtruth": []}
                 if collect_preds else None)
        for i, (batch, db) in enumerate(items):
            while True:
                gen = torch.Generator(device=self.device).manual_seed(
                    eval_seed(self.seed, stream, i))
                try:
                    out = eval_step(self.model_params, self.model_state, db,
                                    gen)
                    # one device-to-host copy for the metrics
                    mask, ade, fde = torch.stack(
                        [out["mask"], out["ade"], out["fde"]]).cpu().numpy()
                    break
                except torch.cuda.OutOfMemoryError:
                    eval_step = shrink()
                    if eval_step is None:
                        raise
            m = mask.astype(bool)
            ade, fde = ade[m], fde[m]
            ade_sum += ade.sum()
            fde_sum += fde.sum()
            n_sum += m.sum()
            rows["metaId"].append(batch.meta_ids[m])
            rows["sceneId"].append(np.full(int(m.sum()), batch.scene_id,
                                           object))
            rows["ade"].append(ade)
            rows["fde"].append(fde)
            if collect_preds:
                trajs["prediction"].append(out["best_traj"].cpu().numpy()[m])
                trajs["metaId"].append(batch.meta_ids[m])
                # raw-pixel ground truth (evaluate.py:281-283)
                trajs["groundtruth"].append(
                    batch.trajectories[m] / self.params["resize_factor"])
        metrics = {k: np.concatenate(v) if v else np.zeros(0)
                   for k, v in rows.items()}
        return (ade_sum / max(n_sum, 1), fde_sum / max(n_sum, 1), metrics,
                trajs)

    def test(self, tracks, image_path, return_preds=False, batches=None):
        """Multi-round stochastic eval (trainer.py:1019-1060): n_round
        rounds over the same batches, round e from stream 10_000 + e ->
        (average ADE, average FDE, each round's metrics rows, each round's
        predictions or None). batches: optionally the prepared
        SceneBatches."""
        p = self.params
        if batches is None:
            batches = self.prepare_data(tracks, image_path, "test")
        es_state, es_shrink = self._eval_shrinker(self._eval_step)
        self.eval_ADE, self.eval_FDE = [], []
        list_metrics, list_trajs = [], []
        print("TTST setting:", p.get("use_TTST", False))
        items = self._device_batches(batches)
        # the backbone is fixed during the test: one scene -> semantic map
        # cache serves every round (trainer.py:1038-1045)
        seg_cache = {}
        for e in range(int(p.get("n_round", 1))):
            ade, fde, metrics, trajs = self._evaluate(
                self._with_semantic(items, seg_cache), es_state["step"],
                TEST_STREAM + e, es_shrink, collect_preds=return_preds)
            list_metrics.append(metrics)
            list_trajs.append(trajs)
            print(f"Round {e}: \nTest ADE: {ade} \nTest FDE: {fde}")
            self.eval_ADE.append(ade)
            self.eval_FDE.append(fde)
        avg_ade = sum(self.eval_ADE) / len(self.eval_ADE)
        avg_fde = sum(self.eval_FDE) / len(self.eval_FDE)
        print(f"\nAverage performance (by {p.get('n_round', 1)}): "
              f"\nTest ADE: {avg_ade} \nTest FDE: {avg_fde}")
        return avg_ade, avg_fde, list_metrics, list_trajs

    # -- train (reference trainer.py:80-293) --------------------------------
    def train(self, train_tracks, val_tracks, train_image_path,
              val_image_path, experiment_name):
        """Train n_epoch epochs with per-epoch validation (TTST off) and
        mst_tpu's checkpoint policy (trainer.py:474-789) -> (val ADEs, val
        FDEs). Writes <ckpt_path>/<experiment_name>.npz at the end, plus
        _weights.npz on each new best when not fine-tuning and __epoch_<e>
        .npz every save_every_n epochs. Each epoch's record (the JSONL
        line, also appended to self.epoch_log) adds n_steps, the host
        seconds of its steps (ending in the epoch's one metrics read) and
        of its validation; self.prepare_seconds is the data preparation
        and upload before the first epoch."""
        p = self.params
        t0 = time.time()
        t_prep = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        train_items = self._device_batches(self.prepare_data(
            train_tracks, train_image_path, "train",
            augment=p.get("augment", False), rng=rng))
        val_items = self._device_batches(
            self.prepare_data(val_tracks, val_image_path, "val"))
        self.prepare_seconds = time.perf_counter() - t_prep

        setup = setup_training(self.model_params, p, len(train_items))
        print(f"The number of trainable parameters: "
              f"{setup['n_trainable']:d}")
        optimizer, scheduler = setup["optimizer"], setup["scheduler"]
        trainable = {k: v for k, v in io.flatten(self.model_params).items()
                     if v.requires_grad}
        fine_tune = bool(p.get("fine_tune", False))
        segment_in_step = self._segment_in_step()
        train_step = make_train_step(self.mcfg, config_lib.step_config(
            p, segment_in_step=segment_in_step))
        ves_state, ves_shrink = self._eval_shrinker(
            lambda kc: self._eval_step(kc, for_validation=True))
        e_unfreeze = self._e_unfreeze()
        unfreeze_step = None  # made at the boundary
        # one train cache for the run: it serves only while the backbone is
        # frozen in eval mode (the in-step epochs bypass it); one
        # validation cache across epochs only while the backbone cannot
        # change (trainer.py:697-735, 497-503)
        seg_cache = {}
        val_seg_cache = ({} if not segment_in_step and e_unfreeze is None
                         else None)

        best_val_ade = float("inf")
        best_epoch = 0
        best_snapshot = None
        self.val_ADE, self.val_FDE = [], []
        self.epoch_log = []
        window_size = int(p.get("window_size", 9))
        smooth_val = bool(p.get("smooth_val", False))
        half_window = window_size // 2 + 1
        snapshots = collections.deque()
        n_early_stop = int(p.get("n_early_stop", 300))
        metrics_log = (MetricsLogger(p["metrics_jsonl"])
                       if p.get("metrics_jsonl") else None)
        meter = ThroughputMeter()
        n_batches = len(train_items)
        state = self.model_state

        def finish_epoch(e, losses, ade_sum, fde_sum, n_sum, val_ade,
                         val_fde, snapshot, timing):
            """NaN guard, stdout/JSONL metrics, smooth-val selection, best
            tracking, periodic saves, early stop (trainer.py:557-637).
            -> True to stop training."""
            nonlocal best_val_ade, best_epoch, best_snapshot
            if not np.isfinite(losses).all():
                bi = int(np.flatnonzero(~np.isfinite(losses))[0])
                raise FloatingPointError(
                    f"non-finite loss {losses[bi]} at epoch {e}, "
                    f"scene-batch {bi} (lr={p['lr']}, "
                    f"loss_scale={p.get('loss_scale')}); inspect the "
                    f"input data or lower --lr")
            loss_sum = float(losses.sum())
            meter.update(n_sum, n_batches)
            train_ade = ade_sum / max(n_sum, 1)
            train_fde = fde_sum / max(n_sum, 1)
            self.val_ADE.append(val_ade)
            self.val_FDE.append(val_fde)
            print(f"Epoch {e}: \tTrain (Top-1) ADE: {train_ade:.2f} "
                  f"FDE: {train_fde:.2f} \t\tVal (Top-k) ADE: {val_ade:.2f} "
                  f"FDE: {val_fde:.2f}")
            record = dict(epoch=e, train_ade=train_ade, train_fde=train_fde,
                          val_ade=val_ade, val_fde=val_fde,
                          loss=loss_sum / max(n_batches, 1),
                          **meter.rates(), **timing)
            self.epoch_log.append(record)
            if metrics_log is not None:
                metrics_log.log(**record)

            # smooth-val checkpoint selection (trainer.py:248-267)
            if smooth_val:
                if len(snapshots) == half_window:
                    current = snapshots.popleft()
                else:
                    current = None
                snapshots.append(snapshot)
                if e < window_size:
                    sel_ade = best_val_ade + 1
                else:
                    sel_ade = sum(self.val_ADE[-window_size:]) / window_size
            else:
                current = snapshot
                sel_ade = val_ade

            if sel_ade < best_val_ade and current is not None:
                best_val_ade = sel_ade
                best_epoch = e - half_window + 1 if smooth_val else e
                best_snapshot = current
                if not fine_tune:
                    config_lib.ensure_dir(p["ckpt_path"])
                    self.save_params(
                        f'{p["ckpt_path"]}/{experiment_name}_weights.npz')

            if (e + 1) % int(p.get("save_every_n", 10)) == 0:
                config_lib.ensure_dir(p["ckpt_path"])
                self.save_params(
                    f'{p["ckpt_path"]}/{experiment_name}__epoch_{e}.npz')

            # early stop on clear overfitting (trainer.py:279-281)
            if fine_tune and self.val_ADE and \
                    best_val_ade < min(self.val_ADE[-n_early_stop:]):
                print(f"Early stop at epoch {e}")
                return True
            return False

        for e in range(int(p["n_epoch"])):
            # from e_unfreeze the backbone runs inside the step with its
            # batch norms on the batch's statistics; their running
            # statistics start from the inline ones and adapt in
            # state['segmentation_bn']
            in_unfreeze = e_unfreeze is not None and e >= e_unfreeze
            if in_unfreeze and unfreeze_step is None:
                unfreeze_step = make_train_step(
                    self.mcfg, config_lib.step_config(
                        p, segment_in_step=True, segment_train_mode=True))
                if "segmentation_bn" not in state:
                    state = {**state, "segmentation_bn": extract_bn_stats(
                        self.model_params["segmentation"])}
            step = unfreeze_step if in_unfreeze else train_step
            raw = segment_in_step or in_unfreeze
            # the scene-batch order is reshuffled every epoch, like the
            # reference's DataLoader(shuffle=True) (trainer.py:574-576)
            t_steps = time.perf_counter()
            rng.shuffle(train_items)
            step_metrics = []
            for b, db in train_items:
                db = {"semantic": self._semantic_for(
                          b.scene_id, db["image"], seg_cache, raw),
                      "traj": db["traj"], "mask": db["mask"]}
                state, m = step(self.model_params, state, optimizer,
                                scheduler, db)
                step_metrics.append(m)
                # the metrics stay on the device: one host read an epoch,
                # and a NaN check every 100 steps (trainer.py:742-759)
                if len(step_metrics) % 100 == 0 and not math.isfinite(
                        float(m["loss"])):
                    break
            stats = torch.stack([torch.stack(
                [m["loss"], m["ade_sum"], m["fde_sum"], m["n"]])
                for m in step_metrics]).cpu().numpy()
            t_val = time.perf_counter()
            self.model_state = state
            val_ade, val_fde, _, _ = self._evaluate(
                self._with_semantic(val_items, {} if val_seg_cache is None
                                    else val_seg_cache),
                ves_state["step"], e, ves_shrink)
            timing = dict(n_steps=len(step_metrics),
                          steps_seconds=t_val - t_steps,
                          val_seconds=time.perf_counter() - t_val)
            snapshot = {k: v.detach().clone() for k, v in trainable.items()}
            if finish_epoch(e, stats[:, 0], float(sum(stats[:, 1])),
                            float(sum(stats[:, 2])), float(sum(stats[:, 3])),
                            val_ade, val_fde, snapshot, timing):
                break

        print(f"Best epoch at {best_epoch}")
        self.best_epoch = best_epoch
        if best_epoch != 0 and best_snapshot is not None:
            with torch.no_grad():
                for k, v in best_snapshot.items():
                    trainable[k].copy_(v)
        config_lib.ensure_dir(p["ckpt_path"])
        self.save_params(f'{p["ckpt_path"]}/{experiment_name}.npz')
        rates = meter.rates()
        print(f"train wall-clock: {time.time() - t0:.1f}s "
              f"({rates['traj_per_sec']:.1f} traj/s, "
              f"{rates['batches_per_sec']:.1f} scene-batches/s)")
        return self.val_ADE, self.val_FDE


def restore_model(params, is_separated, base_ckpt, separated_ckpt=None,
                  images=None, device=None):
    """A whole checkpoint, or a base + delta pair (reference
    utils/util.py:138-147; mst_tpu/train/trainer.py:1186-1198)."""
    if not is_separated:
        model = Experiment(params, images=images, device=device)
        model.load_params(base_ckpt)
    else:
        updated = config_lib.update_params_from_ckpt(separated_ckpt, params)
        model = Experiment(updated, images=images, device=device)
        model.load_separated_params(base_ckpt, separated_ckpt)
    return model
