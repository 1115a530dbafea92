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
early stop and the roll back to the best snapshot. Every save_every_n
epochs it also writes the training state that --resume restores
(save_training_state, in mst_tpu's file layout, so a run that either
package started resumes in the other). The eth dataset reads its scenes'
oracle.png class masks, attaches each scene's homography to its batches
(for --eth_world_coords) and validates on the reference's cut of scenes.
With --cross_scene_batching the train and test batches fill across the
scenes that share a padded image shape (data/scenes.py
make_bucketed_batches; validation and eth stay per scene), and each
group's stack of scene maps is uploaded and segmented once. forward_test
is the single-scene probe forward with optional input noise and input
gradients. --compute_dtype and --remat reach the steps through
config.step_config. With --fused, an eligible run trains in chunks of
epochs replayed as CUDA graphs on the card (train/fused.py), through the
same per-epoch bookkeeping; an ineligible one falls back to the loop with
mst_tpu's printed reason.

On a data-parallel mesh (--mesh_shape N, or R D with --mesh_axes replica
data; parallel/mesh.py) every rank builds the same global batches from
the same seed, with batch_size rounded up to a multiple of the ranks, and
keeps its block of rows (parallel/hostdata.py); the steps reduce over the
ranks (train/steps.py), so every rank holds the same weights, losses and
validation rows, and takes the same decisions. Rank 0 alone writes the
checkpoints, _weights.npz, the metrics log and the training state, each
followed by a barrier; every rank reads a state to resume. On the
spatial ('data', 'space') mesh the batch size rounds up by 'data' alone,
each rank holds its slab of every scene map's H, or of a cross-scene
group's stack (out of the step, the backbone, where there is one,
segments the whole scene and the slab is cut from its map, as mst_tpu
segments it on one device; in the step it runs on the slab of the
image, models/unet.py), and train() (with --fused too),
its validation and test() run the spatial steps (mst_tpu/train/
trainer.py:150-158, mst_tpu/train/fused.py:110-125).

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
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from mst_tpu_torch import config as config_lib
from mst_tpu_torch import io, resolve_device
from mst_tpu_torch.data import images as images_lib
from mst_tpu_torch.data import scenes as scenes_lib
from mst_tpu_torch.evaluator.logs import MetricsLogger
from mst_tpu_torch.models import segmentation as seg_lib
from mst_tpu_torch.models import ynet as ynet_lib
from mst_tpu_torch.models.unet import extract_bn_stats
from mst_tpu_torch.ops.heatmap import (rasterize_dist_nhwc,
                                       rasterize_gaussian_nhwc)
from mst_tpu_torch.ops.pooling import avg_pool_pyramid
from mst_tpu_torch.parallel import hostdata
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.train import freeze, optim
from mst_tpu_torch.train import fused as fused_lib
from mst_tpu_torch.train.losses import bce_with_logits
from mst_tpu_torch.train.steps import make_eval_step, make_train_step
from mst_tpu_torch.utils.profiling import ThroughputMeter

# the metadata sidecar's keys (trainer.py:107-110)
METADATA_KEYS = ("train_net", "position", "network", "n_fusion", "seed",
                 "lr", "n_train_batch", "ynet_bias")
_IMAGE_FILES = {"sdd": "reference.jpg", "ind-dataset-v1.0": "reference.png",
                "eth": "oracle.png"}
TEST_STREAM = 10_000  # test round e draws from stream TEST_STREAM + e
FORWARD_TEST_STREAM = 777  # forward_test's noise, when none is injected
# the eth/hotel homographies take (y, x): their swap (reference
# image_utils.py:151-153) as a column permutation of the matrix
_XY_SWAP = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float32)


def setup_training(model_params, params_dict, steps_per_epoch: int):
    """Freeze split, Adam and its schedule for model_params (in place:
    requires_grad is set on every leaf).

    The schedule follows trainer.py:457-467: with fine_tune and steps,
    the LR is multiplied by lr_decay_ratio (default 0.1) from optimizer
    step m * steps_per_epoch on, for each distinct milestone m (optax's
    piecewise_constant_schedule takes a dict, so a repeated milestone
    decays once). Otherwise the LR is constant. The optimizer
    (optim.Adam) keeps its step count and LR on the device and steps its
    schedule itself. On a CUDA device the f32 path is pinned
    (resolve_device).

    -> dict of trainable (the leaves), n_trainable, optimizer.
    """
    leaf = next(iter(io.flatten(model_params).values()))
    resolve_device(leaf.device)
    trainable = freeze.set_trainable(
        model_params, params_dict.get("train_net", "train"),
        params_dict.get("position", ()), params_dict.get("ynet_bias", False),
        params_dict.get("network"))
    milestones = []
    if params_dict.get("fine_tune") and params_dict.get("steps"):
        spe = max(int(steps_per_epoch), 1)
        milestones = [int(m) * spe for m in params_dict["steps"]]
    optimizer = optim.Adam(
        trainable, float(params_dict["lr"]), milestones,
        float(params_dict.get("lr_decay_ratio", 0.1)), device=leaf.device)
    return dict(trainable=trainable,
                n_trainable=sum(p.numel() for p in trainable),
                optimizer=optimizer)


def save_params(path, model_params, params_dict):
    """The whole model but the segmentation backbone for 'train'/'all',
    else the strategy's trainable leaves only (a delta: the leaves
    setup_training marked requires_grad, the backbone's too under a
    segmentation_* strategy), as mst_tpu's Experiment.save_params writes
    it (trainer.py:88-101, checkpoints.py:78-101): np.savez of the flat
    JAX layout at path, and the metadata at path + '.json'."""
    write_checkpoint(path, *checkpoint_arrays(model_params, params_dict))


def checkpoint_arrays(model_params, params_dict, allow_empty=False):
    """What save_params writes -> (the flat numpy arrays, the metadata).
    allow_empty: a strategy whose selection holds no leaf (mosa_1 on 0-4
    of the fusion network, whose convs are keyed scene/motion/fusion)
    gives an empty delta, as mst_tpu's save does; else that raises, as a
    sign that setup_training was not called."""
    train_net = params_dict.get("train_net", "train")
    flat = io.flatten(model_params)
    if train_net in ("all", "train"):
        flat = {k: v for k, v in flat.items()
                if not k.startswith("segmentation")}
    else:
        flat = {k: v for k, v in flat.items() if v.requires_grad}
        if not flat and not allow_empty:
            raise ValueError(f"train_net={train_net!r}: no leaf requires "
                             "grad; call setup_training first")
    return io.params_to_numpy(flat), {k: params_dict.get(k)
                                      for k in METADATA_KEYS}


def write_checkpoint(path, arrays, metadata):
    """checkpoint_arrays' output as save_params writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    with open(str(path) + ".json", "w") as f:
        json.dump(metadata, f, indent=1, default=str)


def eval_seed(seed: int, stream: int, i: int) -> int:
    """The generator seed of eval batch i of stream `stream`: the first
    64-bit word numpy's SeedSequence derives from (seed, stream, i)."""
    return int(np.random.SeedSequence([seed, stream, i]).generate_state(
        1, np.uint64)[0])


def masked_means(batch_rows):
    """[(mask, ade, fde) numpy rows of each eval batch] -> (ADE, FDE) over
    the masked rows, summed batch by batch: the validation of the loop and
    of --fused reduce their rows here, the same way."""
    ade_sum = fde_sum = n_sum = 0.0
    for mask, ade, fde in batch_rows:
        m = mask.astype(bool)
        ade_sum += ade[m].sum()
        fde_sum += fde[m].sum()
        n_sum += m.sum()
    return ade_sum / max(n_sum, 1), fde_sum / max(n_sum, 1)


class Experiment:
    """The train/test facade (mst_tpu's Experiment) over the port's steps.

    params: the flat params dict (config.get_params); images: optional
    {sceneId: raw HWC image} used in place of reading image files; device:
    'cuda' (the default, which must exist) or 'cpu', else params['device'];
    mesh: a data-parallel DeviceMesh (parallel/mesh.py), else the one
    params' mesh_shape and mesh_axes make (none without them).
    """

    def __init__(self, params: dict, images=None, device=None, mesh=None):
        self.params = dict(params)
        config_lib.check_loop_ported(self.params)
        self.device = resolve_device(device or self.params.get("device"))
        if mesh is None:
            mesh = mesh_lib.mesh_from_shape(self.params.get("mesh_shape"),
                                            self.params.get("mesh_axes"),
                                            self.device)
        self.mesh = mesh
        self.shards = mesh_lib.batch_shards(mesh)
        self.mcfg = config_lib.ynet_config(self.params)
        self.division_factor = 2 ** len(self.params["encoder_channels"])
        self.seed = int(self.params.get("seed", 1))
        self._images_override = images
        self.model_params, self.model_state = ynet_lib.init_ynet(
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
        self._homo_cache = {}  # eth: scene -> homography (_homography_for)

    # -- checkpoints (reference trainer.py:586-614) --------------------------
    def load_params(self, path):
        """Overlay a checkpoint, non-strict (unknown keys are skipped)."""
        self.model_params = io.overlay(
            self.model_params, io.params_from_numpy(io.load_checkpoint(path)))

    def save_params(self, path):
        """The whole model for 'train'/'all', else the strategy's trainable
        leaves (see save_params)."""
        write_checkpoint(path, *self.checkpoint())

    def checkpoint(self):
        """What save_params writes -> (arrays, metadata)."""
        p = self.params
        freeze.set_trainable(self.model_params, p.get("train_net", "train"),
                             p.get("position", ()), p.get("ynet_bias", False),
                             p.get("network"))
        return checkpoint_arrays(self.model_params, p, allow_empty=True)

    def _written(self, write, *args):
        """write(*args) on rank 0 of the mesh alone (always without one),
        then a barrier, after which every rank finds the file."""
        if self.mesh is None or dist.get_rank() == 0:
            write(*args)
        if self.mesh is not None:
            dist.barrier()

    def load_separated_params(self, pretrained_path, tuned_path):
        self.model_params = io.load_separated(self.model_params,
                                              pretrained_path, tuned_path)

    # -- data ---------------------------------------------------------------
    def prepare_data(self, tracks, image_path, mode, augment=False, rng=None,
                     allow_bucketed=True):
        """A track table and its scenes' images -> SceneBatches
        (trainer.py:122-179): load the images (or take them from `images`),
        optionally augment, resize, pad and normalise, then batch per scene;
        'train' shuffles with rng. With --cross_scene_batching, 'train' and
        'test' give BucketedBatches instead, except on eth (its homography
        is a scene's) or when allow_bucketed is False (trainer.py:
        160-176). On a mesh the batch size rounds up to a multiple of the
        ranks of its batch axes (trainer.py:150-159; 'data' alone on a
        spatial mesh, trainer.py:151-156), so every batch splits over
        them."""
        p = self.params
        batch_size = int(p["batch_size"])
        if self.mesh is not None:
            n = self.shards.count
            batch_size = -(-batch_size // n) * n
        scenes = tracks.scene_ids()
        seg_mask = self._is_eth()  # oracle.png: class ids, one-hot
        if self._images_override is not None:
            raw = {k: np.asarray(v) for k, v in self._images_override.items()
                   if k in set(scenes)}
        else:
            raw = images_lib.load_images(
                scenes, image_path,
                _IMAGE_FILES.get(p["dataset_name"].lower(), "reference.jpg"),
                p.get("use_raw_data", False), seg_mask)
        if augment:
            tracks, raw = images_lib.augment_data(tracks, raw)
        images = images_lib.preprocess_scene_images(
            raw, p["resize_factor"], self.division_factor, seg_mask,
            p["n_semantic_classes"])
        if (allow_bucketed and mode in ("train", "test")
                and p.get("cross_scene_batching") and not seg_mask):
            return scenes_lib.make_bucketed_batches(
                tracks, images, p["obs_len"] + p["pred_len"],
                batch_size, p["resize_factor"],
                shuffle=(mode == "train"), rng=rng,
                max_scenes_per_batch=int(p.get("max_scenes_per_batch", 8)))
        return scenes_lib.make_scene_batches(
            tracks, images, p["obs_len"] + p["pred_len"],
            batch_size, p["resize_factor"],
            shuffle=(mode == "train"), rng=rng)

    def _is_eth(self):
        return self.params["dataset_name"].lower() == "eth"

    def _homography_for(self, scene_id):
        """The ETH/UCY scene's homography (reference trainer.py:550-557),
        read once from <data_dir>/eth_ucy/<scene>_H.txt: the scene id
        without its augmentation suffixes (a scene name may hold '_', as
        uni_examples does), and for eth and hotel the x/y swap folded in
        as a column permutation, so one matrix serves every scene
        (mst_tpu/train/trainer.py:203-222)."""
        scene = re.sub(r"(_rot90|_rot180|_rot270|_fliplr)+$", "", scene_id)
        if scene not in self._homo_cache:
            mat = np.loadtxt(os.path.join(
                self.params.get("data_dir", "data"), "eth_ucy",
                f"{scene}_H.txt")).astype(np.float32)
            if scene in ("eth", "hotel"):
                mat = mat @ _XY_SWAP
            self._homo_cache[scene] = mat
        return self._homo_cache[scene]

    def _device_batches(self, batches, in_step=False, cached=True):
        """[(batch, its device batch)], each scene's preprocessed image
        (1, H, W, C), or a cross-scene group's stack (S, H, W, C), uploaded
        once, with a cross-scene batch's 'scene_idx' and on eth the
        scene's homography; _with_semantic adds the semantic map. 'image'
        is what the semantic map is made from (_semantic_for: the cached
        path, `cached`), 'raw_image' what a step that runs the backbone
        takes (`in_step`). The per-row arrays are this rank's rows on a
        mesh (every row without one; hostdata.take_local and
        shard_batch_global). On a spatial mesh an image whose height does
        not divide the 'space' ranks raises (mesh.check_spatial_scene),
        and a rank uploads its slab of the image, but the whole image
        where the backbone segments it out of the step: without a
        backbone 'image' is the slab (the semantic map is the image);
        with one, 'image' is the whole image when `cached`, and
        'raw_image' the slab (a view of the whole image when both are
        uploaded)."""
        images, homographies = {}, {}
        index, count = ((self.shards.index, self.shards.count)
                        if self.mesh is not None else (0, 1))
        backbone = "segmentation" in self.model_params
        out = []
        for b in batches:
            bucketed = isinstance(b, scenes_lib.BucketedBatch)
            if b.scene_id not in images:
                image = torch.as_tensor(b.image if bucketed
                                        else b.image[None])
                mesh_lib.check_spatial_scene(self.mesh, "image", image)
                slab = mesh_lib.space_slab(self.mesh, image.shape[1])
                up = {}
                if slab is not None and not backbone:
                    image = slab.take(image)  # the semantic map is the image
                if slab is None or not backbone or cached:
                    up["image"] = image.to(self.device, copy=True)
                if backbone and in_step:
                    up["raw_image"] = (
                        up["image"] if slab is None
                        else slab.take(up["image"]) if cached
                        else slab.take(image).to(self.device, copy=True))
                images[b.scene_id] = up
                if self._is_eth():
                    homographies[b.scene_id] = torch.tensor(
                        self._homography_for(b.scene_id),
                        device=self.device)
            host = {"traj": b.trajectories, "mask": b.mask}
            if bucketed:
                host["scene_idx"] = np.asarray(b.scene_idx, np.int64)
            rows = hostdata.shard_batch_global(
                self.mesh, hostdata.take_local(host, index, count),
                len(b.mask))
            db = {k: v.to(self.device, copy=True) for k, v in rows.items()}
            db.update(images[b.scene_id])
            if self._is_eth():
                db["homography"] = homographies[b.scene_id]
            out.append((b, db))
        return out

    def _validation_cut(self, batches):
        """On eth, the batches of the first 30 // batch_size scenes (at
        least one): the reference breaks out of its validation once
        batch_size * n_scenes exceeds 30 (evaluate.py:104-107;
        mst_tpu/train/trainer.py:437-450). Elsewhere all of them."""
        if not self._is_eth():
            return batches
        n_scenes = max(1, 30 // max(int(self.params["batch_size"]), 1))
        seen, keep = [], []
        for b in batches:
            if b.scene_id not in seen:
                if len(seen) == n_scenes:
                    break
                seen.append(b.scene_id)
            keep.append(b)
        return keep

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

    def _semantic_for(self, scene_id, image, cache):
        """The scene's semantic map: cache[scene_id], made on a miss by the
        backbone (with the state's adapted 'segmentation_bn' statistics
        once e_unfreeze has made them), or the image for the identity
        backbone (trainer.py:229-290). A cross-scene group's scene_id is
        its scene-ids tuple and its image the (S, H, W, C) stack, so the
        stack segments once; n_segmented counts scene maps. On a spatial
        mesh the backbone segments the whole scene and the cache keeps
        the rank's slab of its map."""
        if scene_id not in cache:
            if "segmentation" in self.model_params:
                with torch.no_grad():
                    sem = seg_lib.apply(
                        self.model_params["segmentation"], image,
                        self.mcfg.use_features_only,
                        bn_state=self.model_state.get("segmentation_bn"))
                self.n_segmented += image.shape[0]
                slab = mesh_lib.space_slab(self.mesh, sem.shape[1])
                if slab is not None:
                    sem = slab.take(sem)
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

    def _with_semantic(self, items, cache):
        """items with each device batch's 'semantic' (_semantic_for)."""
        return [(b, self._step_batch(b, db, cache)) for b, db in items]

    def _step_batch(self, b, db, cache, raw=False):
        """A step's batch: 'semantic' (_semantic_for; with raw the device
        batch's 'raw_image', for a step that runs the backbone), 'traj',
        'mask', and 'scene_idx' and 'homography' where the device batch
        has them."""
        semantic = db["raw_image"] if raw else self._semantic_for(
            b.scene_id, db["image"], cache)
        out = {"semantic": semantic, "traj": db["traj"], "mask": db["mask"]}
        for key in ("scene_idx", "homography"):
            if key in db:
                out[key] = db[key]
        return out

    # -- evaluation (reference trainer.py:295-352) ---------------------------
    def _eval_step(self, eval_k_chunk=None, for_validation=False,
                   collect_samples=False):
        over = {} if eval_k_chunk is None else {"eval_k_chunk": eval_k_chunk}
        scfg = config_lib.step_config(self.params, for_validation, **over)
        if collect_samples:
            return make_eval_step(self.mcfg, scfg, self.mesh,
                                  collect_samples=True)
        return make_eval_step(self.mcfg, scfg, self.mesh)

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
                  collect_preds=False, collect_samples=False):
        """items: [(batch, device batch)] -> (ADE, FDE, metrics rows, trajs)
        over the real rows (trainer.py:891-1017), the global batch's on a
        mesh (the eval step gathers them). Batch i draws from its
        own generator (eval_seed(seed, stream, i)); on
        torch.cuda.OutOfMemoryError the batch is retried, with the same
        draws, one rung down the shrink ladder. The metrics rows are numpy
        columns metaId, sceneId (each row's own in a cross-scene batch),
        ade, fde. collect_samples (with collect_preds) adds each batch's
        goal_map, goal_sigmoid_map and waypoint_sample rows to trajs, each
        copied to the host as its batch is consumed."""
        batch_rows = []
        rows = {"metaId": [], "sceneId": [], "ade": [], "fde": []}
        trajs = ({"prediction": [], "metaId": [], "groundtruth": []}
                 if collect_preds else None)
        if collect_preds and collect_samples:
            # reference evaluate.py:75-80 visualization payload
            trajs.update(goal_map=[], goal_sigmoid_map=[],
                         waypoint_sample=[])
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
            batch_rows.append((mask, ade, fde))
            m = mask.astype(bool)
            ade, fde = ade[m], fde[m]
            rows["metaId"].append(batch.meta_ids[m])
            if isinstance(batch, scenes_lib.BucketedBatch):
                rows["sceneId"].append(np.asarray(
                    batch.scene_ids, object)[batch.scene_idx][m])
            else:
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
                if collect_samples:
                    for key in ("goal_map", "goal_sigmoid_map"):
                        trajs[key].append(out[key].cpu().numpy()[m])
                    trajs["waypoint_sample"].append(
                        out["waypoint_samples"].cpu().numpy()[m])
            del out  # the next batch runs without this one's maps
        metrics = {k: np.concatenate(v) if v else np.zeros(0)
                   for k, v in rows.items()}
        return masked_means(batch_rows) + (metrics, trajs)

    def test(self, tracks, image_path, return_preds=False,
             return_samples=False, batches=None):
        """Multi-round stochastic eval (trainer.py:1019-1060): n_round
        rounds over the same batches, round e from stream 10_000 + e ->
        (average ADE, average FDE, each round's metrics rows, each round's
        predictions or None). return_samples adds the goal maps and the
        waypoint samples to the predictions (and implies return_preds).
        batches: optionally the prepared SceneBatches."""
        p = self.params
        if batches is None:
            batches = self.prepare_data(tracks, image_path, "test")
        es_state, es_shrink = self._eval_shrinker(
            lambda kc: self._eval_step(kc, collect_samples=return_samples))
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
                TEST_STREAM + e, es_shrink,
                collect_preds=return_preds or return_samples,
                collect_samples=return_samples)
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

    # -- probe forward (trainer.py:1063-1183) -------------------------------
    def forward_test(self, tracks, image_path, set_input=(),
                     noisy_std_frac=None, decision="loss", input_grads=False,
                     noise=None, generator=None):
        """The single-scene probe forward in eval mode, with optional input
        noise (mst_tpu's Experiment.forward_test; reference
        trainer.py:354-516).

        All of the scene's trajectories go through the model at once, on
        the scene's per-scene batches (cross-scene batching never applies);
        more than one scene raises. With noisy_std_frac, each input named
        in set_input ('traj': the observed distance maps; 'semantic': the
        semantic map after the semantic adapter) gets noisy_std_frac x its
        value range times standard normal noise: noise['traj'] /
        noise['semantic'] where given (tensors of the input's shape), else
        drawn from `generator` (else a generator on the device seeded from
        the experiment's seed and stream FORWARD_TEST_STREAM), 'traj'
        first. The trajectory decoder reads the predicted goal map's
        waypoint pyramid. decision 'loss' -> (goal_loss, traj_loss,
        semantic), 'map' -> (goal logits, trajectory logits, semantic), the
        maps (B, H, W, pred_len), semantic the (1, H, W, C) post-adapter
        map without noise; with input_grads a dict of d(goal_loss +
        traj_loss)/d(input) for each input named in set_input ('scene': the
        preprocessed image before the backbone) follows, through one
        torch.autograd.grad."""
        if decision not in ("loss", "map"):
            raise ValueError(f"No support for decision={decision}")
        p = self.params
        batches = self.prepare_data(tracks, image_path, "test",
                                    allow_bucketed=False)
        scene_ids = {b.scene_id for b in batches}
        if len(scene_ids) != 1:
            raise ValueError(f"Received {len(scene_ids)} scenes, expected 1")
        dev = self.device
        traj = torch.tensor(np.concatenate(
            [b.trajectories[b.mask.astype(bool)] for b in batches]),
            device=dev)
        scene_img = torch.tensor(batches[0].image[None], device=dev)
        H, W = scene_img.shape[1:3]
        scfg = config_lib.step_config(p)
        observed_map = rasterize_dist_nhwc(traj[:, :scfg.obs_len], H, W,
                                           scfg.template_size)
        gt_map = rasterize_gaussian_nhwc(traj[:, scfg.obs_len:], H, W,
                                         scfg.kernlen, scfg.nsig)
        noise = dict(noise or {})
        noisy = set(set_input) if noisy_std_frac is not None else set()
        if noisy and generator is None:
            generator = torch.Generator(device=dev).manual_seed(
                eval_seed(self.seed, FORWARD_TEST_STREAM, 0))

        def draw(name, shape):
            z = noise.get(name)
            if z is None:
                z = torch.randn(shape, generator=generator, device=dev)
            elif not isinstance(z, torch.Tensor):  # a copy: z may be
                z = torch.from_numpy(np.array(z, np.float32))  # read-only
            return z.to(device=dev, dtype=torch.float32)

        if "traj" in noisy:
            observed_map = observed_map + noisy_std_frac * (
                observed_map.max() - observed_map.min()) * draw(
                    "traj", observed_map.shape)
        sem_noise = (draw("semantic", (1, H, W, self.mcfg.n_semantic_classes))
                     if "semantic" in noisy else None)
        want = set(set_input) if input_grads else set()
        with torch.enable_grad() if want else torch.no_grad():
            scene = scene_img.requires_grad_("scene" in want)
            semantic_in = ynet_lib.adapt_semantic(
                self.model_params, self.mcfg, seg_lib.apply(
                    self.model_params.get("segmentation"), scene,
                    self.mcfg.use_features_only,
                    bn_state=self.model_state.get("segmentation_bn")))
            if "semantic" in want and not semantic_in.requires_grad:
                semantic_in = semantic_in.detach().requires_grad_()
            obs_map = observed_map.requires_grad_("traj" in want)
            semantic = semantic_in
            if sem_noise is not None:
                semantic = semantic + noisy_std_frac * (
                    semantic.max() - semantic.min()) * sem_noise
            features, _ = ynet_lib.pred_features(
                self.model_params, self.model_state, self.mcfg,
                semantic.expand(traj.shape[0], *semantic.shape[1:]),
                obs_map)
            goal_map = ynet_lib.pred_goal(self.model_params, features)
            goal_loss = bce_with_logits(goal_map, gt_map) * p["loss_scale"]
            pyramid = avg_pool_pyramid(goal_map[..., list(scfg.waypoints)],
                                       len(features))
            traj_map = ynet_lib.pred_traj(self.model_params, [
                torch.cat([f, w], dim=-1) for f, w in zip(features, pyramid)])
            traj_loss = bce_with_logits(traj_map, gt_map) * p["loss_scale"]
            grads = {}
            if want:
                inputs = {"scene": scene, "semantic": semantic_in,
                          "traj": obs_map}
                names = [n for n in inputs if n in want]
                grads = dict(zip(names, torch.autograd.grad(
                    goal_loss + traj_loss, [inputs[n] for n in names])))
        if decision == "loss":
            out = (goal_loss.detach(), traj_loss.detach(),
                   semantic_in.detach())
        else:
            out = (goal_map.detach(), traj_map.detach(),
                   semantic_in.detach())
        return out + (grads,) if input_grads else out

    # -- train (reference trainer.py:80-293) --------------------------------
    def _setup_training(self, train_tracks, val_tracks, train_image_path,
                        val_image_path, rng):
        """The run's setup that train() and the grid (mst_tpu_torch.grid)
        share (mst_tpu's Experiment._setup_training): the train batches
        (shuffled and augmented with rng) and the validation cut on the
        device, the freeze split and Adam -> dict of train_items and
        val_items ([(batch, device batch)]), optimizer and trainable
        ({path: leaf}). self.prepare_seconds is the data preparation and
        upload."""
        p = self.params
        t_prep = time.perf_counter()
        # the train steps take the raw image where they run the backbone
        # (a segmentation_* strategy, or from e_unfreeze), the segmented
        # map before e_unfreeze; validation always the segmented map
        e_unfreeze = self._e_unfreeze()
        in_step = self._segment_in_step() or e_unfreeze is not None
        train_items = self._device_batches(self.prepare_data(
            train_tracks, train_image_path, "train",
            augment=p.get("augment", False), rng=rng), in_step=in_step,
            cached=not self._segment_in_step() and e_unfreeze != 0)
        val_items = self._device_batches(self._validation_cut(
            self.prepare_data(val_tracks, val_image_path, "val")))
        self.prepare_seconds = time.perf_counter() - t_prep
        setup = setup_training(self.model_params, p, len(train_items))
        print(f"The number of trainable parameters: "
              f"{setup['n_trainable']:d}")
        trainable = {k: v for k, v in io.flatten(self.model_params).items()
                     if v.requires_grad}
        return dict(train_items=train_items, val_items=val_items,
                    optimizer=setup["optimizer"], trainable=trainable)

    def _fused_pack(self, train_items, val_items):
        """mst_tpu's eligibility gates and packing for --fused
        (trainer.py:375-395) -> (train pack, val pack, None), or (None,
        None, reason): the run is one program only when the backbone stays
        out of the step (no segmentation_* strategy, no e_unfreeze), its
        ranks share one host, and both splits are non-empty per-scene
        batches of one (H, W)."""
        if self._segment_in_step():
            return None, None, "segmentation runs inside the train step"
        if self._e_unfreeze() is not None:
            return None, None, "e_unfreeze switches programs mid-training"
        if self.mesh is not None and mesh_lib.host_count() > 1:
            return None, None, "multi-host runs feed per-host shards"
        images = {b.scene_id: db["image"] for b, db in train_items + val_items}
        cache = {}

        def semantic(b):
            return self._semantic_for(b.scene_id, images[b.scene_id],
                                      cache).cpu().numpy()

        hom = self._homography_for if self._is_eth() else None
        tr = fused_lib.pack_batches([b for b, _ in train_items], semantic,
                                    hom)
        va = fused_lib.pack_batches([b for b, _ in val_items], semantic, hom)
        if tr is None or va is None:
            return None, None, ("scene batches span multiple (H, W) shape "
                                "buckets, are cross-scene bucketed, or a "
                                "split is empty")
        return tr, va, None

    def _make_fused(self, train_items, val_items, optimizer, trainable):
        """The --fused chunk runner (train/fused.FusedEpochs) and its chunk
        size, or (None, None, reason) when the run is not eligible
        (_fused_pack)."""
        tr, va, why = self._fused_pack(train_items, val_items)
        if tr is None:
            return None, None, why
        p = self.params
        runner = fused_lib.FusedEpochs(
            self.mcfg, config_lib.step_config(p),
            config_lib.step_config(p, for_validation=True), optimizer,
            lambda e, i: eval_seed(self.seed, e, i),
            fused_lib.stage_data(*tr, self.device, self.shards),
            fused_lib.stage_data(*va, self.device, self.shards), trainable,
            self.mesh)
        save_every_n = int(p.get("save_every_n", 10))
        chunk = fused_lib.chunk_size(save_every_n)
        if chunk < min(save_every_n, fused_lib.MAX_CHUNK) and chunk <= 2:
            print(f"--fused: save_every_n={save_every_n} has no divisor <= "
                  f"{fused_lib.MAX_CHUNK}; running {chunk}-epoch chunks — "
                  f"pick a rounder save_every_n to fuse more epochs")
        return runner, chunk, None

    def train(self, train_tracks, val_tracks, train_image_path,
              val_image_path, experiment_name):
        """Train n_epoch epochs with per-epoch validation (TTST off) and
        mst_tpu's checkpoint policy (trainer.py:474-789) -> (val ADEs, val
        FDEs). Writes <ckpt_path>/<experiment_name>.npz at the end, plus
        _weights.npz on each new best when not fine-tuning, and every
        save_every_n epochs __epoch_<e>.npz and the training state
        __train_state.npz (save_training_state), which --resume restores
        before the first epoch. Each epoch's record (the JSONL
        line, also appended to self.epoch_log) adds n_steps, the host
        seconds of its steps (ending in the epoch's one metrics read) and
        of its validation; self.prepare_seconds is the data preparation
        and upload before the first epoch. On a mesh every rank runs it,
        with its rows and, on the spatial mesh, its slab of every map."""
        p = self.params
        t0 = time.time()
        rng = np.random.default_rng(self.seed)
        setup = self._setup_training(train_tracks, val_tracks,
                                     train_image_path, val_image_path, rng)
        train_items, val_items = setup["train_items"], setup["val_items"]
        optimizer, trainable = setup["optimizer"], setup["trainable"]
        fine_tune = bool(p.get("fine_tune", False))
        segment_in_step = self._segment_in_step()
        # every rank starts from rank 0's weights and state
        mesh_lib.replicate_tree(self.mesh, {"params": self.model_params,
                                            "state": self.model_state})
        train_step = make_train_step(self.mcfg, config_lib.step_config(
            p, segment_in_step=segment_in_step), self.mesh)
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
                       if p.get("metrics_jsonl") and (
                           self.mesh is None or dist.get_rank() == 0)
                       else None)
        meter = ThroughputMeter()
        n_batches = len(train_items)
        state = self.model_state

        # --resume: the trainable leaves, Adam, the epoch, the model state,
        # the val history, the best snapshot and smooth-val's window, then
        # the per-epoch shuffles fast-forwarded, so the run goes on as an
        # uninterrupted one would (trainer.py:524-553)
        start_epoch = 0
        train_state_path = os.path.join(
            p["ckpt_path"], f"{experiment_name}__train_state.npz")
        if p.get("resume") and os.path.exists(train_state_path):
            start_epoch, extras = self.restore_training_state(
                train_state_path, trainable, optimizer)
            if extras["model_state"] is not None:
                state = extras["model_state"]
                self.model_state = state
            self.val_ADE = extras["val_ADE"]
            self.val_FDE = extras["val_FDE"]
            if extras["best_val_ade"] is not None:
                best_val_ade = float(extras["best_val_ade"])
            best_epoch = int(extras["best_epoch"] or 0)
            best_snapshot = extras["best_snapshot"]
            snapshots = collections.deque(extras["snapshots"])
            for _ in range(start_epoch):
                rng.shuffle(train_items)
            print(f"Resumed training state at epoch {start_epoch} "
                  f"from {train_state_path}")

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
                    self._written(
                        self.save_params,
                        f'{p["ckpt_path"]}/{experiment_name}_weights.npz')

            if (e + 1) % int(p.get("save_every_n", 10)) == 0:
                self._written(
                    self.save_params,
                    f'{p["ckpt_path"]}/{experiment_name}__epoch_{e}.npz')
                self._written(lambda: self.save_training_state(
                    train_state_path, trainable, optimizer, e + 1,
                    val_history=self.val_ADE, model_state=state,
                    val_fde_history=self.val_FDE,
                    best_snapshot=best_snapshot, best_val_ade=best_val_ade,
                    best_epoch=best_epoch,
                    snapshots=snapshots if smooth_val else None))

            # early stop on clear overfitting (trainer.py:279-281)
            if fine_tune and self.val_ADE and \
                    best_val_ade < min(self.val_ADE[-n_early_stop:]):
                print(f"Early stop at epoch {e}")
                return True
            return False

        def fused_chunk(e0, c):
            """Epochs e0..e0 + c - 1 through the fused runner, then each
            through finish_epoch with its leaves and state in place (for
            its saves, and the roll back to the stop epoch) -> True to
            stop training."""
            nonlocal state
            perms = np.empty((c, n_batches), np.int64)
            for j in range(c):
                # the loop's per-epoch shuffle, as positions in the pack
                rng.shuffle(train_items)
                perms[j] = [packed[id(b)] for b, _ in train_items]
            t_chunk = time.perf_counter()
            state, ys = fused_runner(self.model_params, state, perms,
                                     range(e0, e0 + c))
            timing = dict(n_steps=n_batches, epoch_seconds=(
                time.perf_counter() - t_chunk) / c)
            for j in range(c):
                stats, state = ys["stats"][j], ys["state"][j]
                with torch.no_grad():
                    for k, v in ys["snapshot"][j].items():
                        trainable[k].copy_(v)
                self.model_state = state
                if finish_epoch(e0 + j, stats[:, 0], float(sum(stats[:, 1])),
                                float(sum(stats[:, 2])),
                                float(sum(stats[:, 3])),
                                *masked_means(ys["val"][j]),
                                ys["snapshot"][j], timing):
                    return True
            return False

        # --fused: chunks of epochs as CUDA-graph replays with one host read
        # a chunk (train/fused.py), through the same finish_epoch
        fused_runner = None
        if p.get("fused"):
            fused_runner, chunk, why = self._make_fused(
                train_items, val_items, optimizer, trainable)
            if fused_runner is None:
                print(f"--fused unavailable ({why}); using the epoch loop")
        self.fused_runner = fused_runner
        n_epoch = int(p["n_epoch"])
        if fused_runner is not None:
            packed = {id(b): k for k, (b, _) in enumerate(train_items)}
            for e0 in range(start_epoch, n_epoch, chunk):
                if fused_chunk(e0, min(chunk, n_epoch - e0)):
                    break
        for e in range(start_epoch, n_epoch) if fused_runner is None else ():
            # from e_unfreeze the backbone runs inside the step with its
            # batch norms on the batch's statistics; their running
            # statistics start from the inline ones and adapt in
            # state['segmentation_bn']
            in_unfreeze = e_unfreeze is not None and e >= e_unfreeze
            if in_unfreeze and unfreeze_step is None:
                unfreeze_step = make_train_step(
                    self.mcfg, config_lib.step_config(
                        p, segment_in_step=True, segment_train_mode=True),
                    self.mesh)
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
                db = self._step_batch(b, db, seg_cache, raw)
                state, m = step(self.model_params, state, optimizer, db)
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
        self._written(self.save_params,
                      f'{p["ckpt_path"]}/{experiment_name}.npz')
        rates = meter.rates()
        print(f"train wall-clock: {time.time() - t0:.1f}s "
              f"({rates['traj_per_sec']:.1f} traj/s, "
              f"{rates['batches_per_sec']:.1f} scene-batches/s)")
        return self.val_ADE, self.val_FDE

    # -- the training state (--resume; mst_tpu/train/trainer.py:791-888) ----
    def save_training_state(self, path, trainable, optimizer, epoch,
                            val_history=None, model_state=None,
                            val_fde_history=None, best_snapshot=None,
                            best_val_ade=None, best_epoch=None,
                            snapshots=None):
        """Everything a resume needs, in mst_tpu's file, key for key: at
        path an npz of 'trainable/<leaf>' (the trainable leaves, {path:
        parameter}), 'opt/<i>' (optax.adam's leaves, io.adam_state_to_numpy),
        'state/<leaf>' (the model state), 'best/<leaf>' (the best
        snapshot) and 'snap/<i>/<leaf>' (smooth-val's window), all in the
        JAX layout; at path + '.json' the checkpoint metadata with the
        epoch, the val histories, has_best, n_snapshots, best_val_ade (when
        finite) and best_epoch."""
        snapshots = list(snapshots) if snapshots else []
        flat = {f"trainable/{k}": v
                for k, v in io.params_to_numpy(trainable).items()}
        for i, leaf in enumerate(io.adam_state_to_numpy(trainable,
                                                        optimizer)):
            flat[f"opt/{i}"] = leaf
        if model_state:
            flat.update({f"state/{k}": v for k, v in
                         io.state_to_numpy(model_state).items()})
        if best_snapshot is not None:
            flat.update({f"best/{k}": v for k, v in
                         io.params_to_numpy(best_snapshot).items()})
        for i, snap in enumerate(snapshots):
            flat.update({f"snap/{i}/{k}": v for k, v in
                         io.params_to_numpy(snap).items()})
        meta = {**{k: self.params.get(k) for k in METADATA_KEYS},
                "epoch": epoch,
                "val_ADE": list(map(float, val_history or [])),
                "val_FDE": list(map(float, val_fde_history or [])),
                "has_best": best_snapshot is not None,
                "n_snapshots": len(snapshots)}
        if best_val_ade is not None and np.isfinite(best_val_ade):
            meta["best_val_ade"] = float(best_val_ade)
        if best_epoch is not None:
            meta["best_epoch"] = int(best_epoch)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **flat)
        with open(str(path) + ".json", "w") as f:
            json.dump(meta, f, default=str)

    def restore_training_state(self, path, trainable, optimizer):
        """The inverse, onto the trainable leaves ({path: parameter},
        overwritten in place where the file has them) and the optimizer's
        count and moments (io.adam_state_from_numpy) -> (epoch, extras):
        extras
        holds the model state (or None), the best snapshot ({path:
        tensor}, or None), smooth-val's window (a list of those), the val
        histories, best_val_ade (or None) and best_epoch. A file that
        either package wrote restores in the other."""
        flat = io.load_checkpoint(path)
        with open(str(path) + ".json") as f:
            meta = json.load(f)

        def part(prefix):
            """The file's trainable leaves under prefix, as {path: tensor}
            on the device in the port's layout (others are skipped, as
            mst_tpu's non-strict overlay skips them)."""
            sub = {k[len(prefix):]: v for k, v in flat.items()
                   if k.startswith(prefix) and k[len(prefix):] in trainable}
            return io.flatten(io.params_from_numpy(sub, self.device)) \
                if sub else {}

        with torch.no_grad():
            for k, v in part("trainable/").items():
                if tuple(v.shape) != tuple(trainable[k].shape):
                    raise ValueError(
                        f"'{k}': shape {tuple(v.shape)} in {path}, the leaf "
                        f"is {tuple(trainable[k].shape)}")
                trainable[k].copy_(v)
        n_opt = sum(1 for k in flat if k.startswith("opt/"))
        io.adam_state_from_numpy([flat[f"opt/{i}"] for i in range(n_opt)],
                                 trainable, optimizer)
        extras = {"val_ADE": list(meta.get("val_ADE", [])),
                  "val_FDE": list(meta.get("val_FDE", [])),
                  "best_val_ade": meta.get("best_val_ade"),
                  "best_epoch": meta.get("best_epoch", 0),
                  "model_state": None, "best_snapshot": None,
                  "snapshots": []}
        state = {k[len("state/"):]: v for k, v in flat.items()
                 if k.startswith("state/")}
        if state:
            extras["model_state"] = io.state_from_numpy(state, self.device)
        if meta.get("has_best"):
            extras["best_snapshot"] = part("best/")
        extras["snapshots"] = [part(f"snap/{i}/")
                               for i in range(int(meta.get("n_snapshots",
                                                           0)))]
        return int(meta["epoch"]), extras


def restore_model(params, is_separated, base_ckpt, separated_ckpt=None,
                  images=None, device=None, mesh=None):
    """A whole checkpoint, or a base + delta pair (reference
    utils/util.py:138-147; mst_tpu/train/trainer.py:1186-1198), on `mesh`
    (else the one params make)."""
    if not is_separated:
        model = Experiment(params, images=images, device=device, mesh=mesh)
        model.load_params(base_ckpt)
    else:
        updated = config_lib.update_params_from_ckpt(separated_ckpt, params)
        model = Experiment(updated, images=images, device=device, mesh=mesh)
        model.load_separated_params(base_ckpt, separated_ckpt)
    return model
