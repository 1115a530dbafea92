"""Scene-grouped, fixed-size batches (counterpart of
mst_tpu/data/scenes.py:19-93; reference utils/dataloader.py:8-50).

Trajectories are grouped per scene; each scene's are cut into chunks of
batch_size, the last padded with zeros and masked, so every batch of a
scene has one shape. With --cross_scene_batching the rows of scenes that
share a padded image shape fill the batches together
(make_bucketed_batches, mst_tpu/data/scenes.py:104-214): each batch
carries its group's stack of scene images and each row's slot in it.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from mst_tpu_torch.data.tracks import Tracks


@dataclasses.dataclass
class SceneBatch:
    scene_id: str
    image: np.ndarray  # (H, W, C) preprocessed scene image
    trajectories: np.ndarray  # (B, total_len, 2) resized pixel coords
    mask: np.ndarray  # (B,) float32, 1.0 = real trajectory
    meta_ids: np.ndarray  # (B,) int64, -1 = padding


def split_trajectories_by_scene(tracks: Tracks, total_len: int):
    """sceneId (sorted) -> ((n_traj, total_len, 2) float32 array, metaIds),
    rows in table order within a scene (dataloader.py:30-39)."""
    out = {}
    for scene_id in sorted(set(tracks.sceneId)):
        rows = tracks.sceneId == scene_id
        xy = np.stack([tracks.x[rows], tracks.y[rows]], 1).astype(np.float32)
        if len(xy) % total_len:
            raise ValueError(f"scene {scene_id}: {len(xy)} rows not "
                             f"divisible by {total_len}")
        out[scene_id] = (xy.reshape(-1, total_len, 2),
                         tracks.metaId[rows][::total_len])
    return out


def make_scene_batches(
    tracks: Tracks,
    images: Dict[str, np.ndarray],
    total_len: int,
    batch_size: int,
    resize_factor: float,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[SceneBatch]:
    """Per scene, chunks of batch_size trajectories scaled by resize_factor
    to image pixels (dataloader.py:19). With shuffle, one generator shuffles
    the scene order and then each scene's trajectories, in mst_tpu's
    order of draws."""
    per_scene = split_trajectories_by_scene(tracks, total_len)
    scene_ids = list(per_scene)
    if shuffle and rng is None:
        rng = np.random.default_rng()  # one generator for both shuffles
    if shuffle:
        rng.shuffle(scene_ids)

    batches = []
    for scene_id in scene_ids:
        trajs, metas = per_scene[scene_id]
        trajs = trajs * resize_factor
        if shuffle:
            perm = rng.permutation(len(trajs))
            trajs, metas = trajs[perm], metas[perm]
        for chunk, meta_chunk, mask in _chunks(batch_size, trajs, metas):
            batches.append(SceneBatch(scene_id, images[scene_id], chunk,
                                      mask, meta_chunk))
    return batches


def _chunks(batch_size, trajs, metas, *more):
    """Rows cut into chunks of batch_size, the last padded (trajectories
    and `more` with 0, metaIds with -1) -> [(trajs, metas int64, *more,
    mask)], mask 1.0 on the real rows."""
    out = []
    for start in range(0, len(trajs), batch_size):
        cols = [c[start:start + batch_size] for c in (trajs, metas, *more)]
        n, pad = len(cols[0]), batch_size - len(cols[0])
        cols = [np.concatenate([c, np.full((pad,) + c.shape[1:], fill,
                                           c.dtype)]) if pad else c
                for c, fill in zip(cols, (0, -1) + (0,) * len(more))]
        cols[1] = cols[1].astype(np.int64)
        mask = np.zeros(batch_size, np.float32)
        mask[:n] = 1.0
        out.append((*cols, mask))
    return out


@dataclasses.dataclass
class BucketedBatch:
    """A batch whose rows may come from several scenes that share one
    padded (H, W): the stack of the group's <= max_scenes_per_batch scene
    images, and each row's slot in it."""
    scene_ids: tuple  # (S,) the group's scene ids, in slot order
    images: np.ndarray  # (S, H, W, C) preprocessed scene images
    scene_idx: np.ndarray  # (B,) int32: row -> slot
    trajectories: np.ndarray  # (B, total_len, 2) resized pixel coords
    mask: np.ndarray  # (B,) float32, 1.0 = real trajectory
    meta_ids: np.ndarray  # (B,) int64, -1 = padding

    @property
    def scene_id(self):
        """The scene-ids tuple: it keys the semantic cache, so a group's
        stack segments once."""
        return self.scene_ids

    @property
    def image(self):
        return self.images


def make_bucketed_batches(
    tracks: Tracks,
    images: Dict[str, np.ndarray],
    total_len: int,
    batch_size: int,
    resize_factor: float,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    max_scenes_per_batch: int = 8,
) -> List[BucketedBatch]:
    """Cross-scene batches: the scenes are bucketed by padded image shape,
    each bucket cut into groups of <= max_scenes_per_batch scenes in
    sorted order, and each group's rows (scaled by resize_factor) fill
    batch_size batches, only the group's last one padded. Every batch of a
    group carries the same stack. With shuffle, one generator shuffles the
    bucket keys, then each bucket's scenes, then each group's rows: the
    draws of mst_tpu's make_bucketed_batches in its order, so a seeded run
    gives its batches."""
    per_scene = split_trajectories_by_scene(tracks, total_len)
    if shuffle and rng is None:
        rng = np.random.default_rng()
    buckets: Dict[tuple, List[str]] = {}
    for scene_id in per_scene:
        buckets.setdefault(images[scene_id].shape, []).append(scene_id)
    bucket_keys = sorted(buckets, key=str)
    if shuffle:
        rng.shuffle(bucket_keys)
    batches = []
    for shape in bucket_keys:
        bucket_scenes = sorted(buckets[shape])
        if shuffle:
            rng.shuffle(bucket_scenes)
        for g0 in range(0, len(bucket_scenes), max_scenes_per_batch):
            scene_ids = tuple(bucket_scenes[g0:g0 + max_scenes_per_batch])
            stack = np.stack([images[s] for s in scene_ids])
            trajs = np.concatenate([per_scene[s][0] * resize_factor
                                    for s in scene_ids])
            metas = np.concatenate([per_scene[s][1] for s in scene_ids])
            idx = np.concatenate([np.full(len(per_scene[s][0]), slot,
                                          np.int32)
                                  for slot, s in enumerate(scene_ids)])
            if shuffle:
                perm = rng.permutation(len(trajs))
                trajs, metas, idx = trajs[perm], metas[perm], idx[perm]
            for chunk, meta_chunk, idx_chunk, mask in _chunks(
                    batch_size, trajs, metas, idx):
                batches.append(BucketedBatch(scene_ids, stack, idx_chunk,
                                             chunk, mask, meta_chunk))
    return batches
