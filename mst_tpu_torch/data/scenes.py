"""Scene-grouped, fixed-size batches (counterpart of
mst_tpu/data/scenes.py:19-93; reference utils/dataloader.py:8-50).

Trajectories are grouped per scene; each scene's are cut into chunks of
batch_size, the last padded with zeros and masked, so every batch of a
scene has one shape. Cross-scene batching (mst_tpu's
make_bucketed_batches, --cross_scene_batching) is not ported.
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
        img = images[scene_id]
        for start in range(0, len(trajs), batch_size):
            chunk = trajs[start:start + batch_size]
            meta_chunk = metas[start:start + batch_size]
            b = len(chunk)
            if b < batch_size:
                pad = batch_size - b
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, total_len, 2), np.float32)])
                meta_chunk = np.concatenate(
                    [meta_chunk, -np.ones(pad, np.int64)])
            mask = np.zeros(batch_size, np.float32)
            mask[:b] = 1.0
            batches.append(SceneBatch(scene_id, img, chunk, mask,
                                      meta_chunk.astype(np.int64)))
    return batches
