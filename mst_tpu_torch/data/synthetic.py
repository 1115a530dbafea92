"""Synthetic scenes (counterpart of mst_tpu/data/synthetic.py:13-47): random
RGB-like images and smooth random-walk tracks, drawn from one numpy
generator in mst_tpu's order, so a seed gives mst_tpu's rows.
"""

import numpy as np

from mst_tpu_torch.data.tracks import Tracks


def make_synthetic_scene(rng, scene_id="synth_0", n_traj=16, total_len=20,
                         img_hw=(240, 320), speed=6.0):
    """n_traj walks of total_len frames inside an img_hw image -> Tracks
    with metaId = the walk's index."""
    H, W = img_hw
    xy = np.zeros((n_traj, total_len, 2))
    for t in range(n_traj):
        start = np.array([rng.uniform(0.2, 0.8) * W,
                          rng.uniform(0.2, 0.8) * H])
        heading = rng.uniform(0, 2 * np.pi)
        pos = start.copy()
        for f in range(total_len):
            heading += rng.normal(0, 0.15)
            pos = pos + speed * np.array([np.cos(heading), np.sin(heading)])
            pos[0] = np.clip(pos[0], 8, W - 8)
            pos[1] = np.clip(pos[1], 8, H - 8)
            xy[t, f] = pos
    return Tracks(
        metaId=np.repeat(np.arange(n_traj), total_len),
        sceneId=np.full(n_traj * total_len, scene_id, object),
        frame=np.tile(np.arange(total_len), n_traj),
        x=xy[..., 0].ravel(), y=xy[..., 1].ravel())


def make_synthetic_dataset(seed=0, n_scenes=2, n_traj=16, total_len=20,
                           img_hw=(240, 320), n_channels=3):
    """-> (Tracks, {sceneId: float32 HWC image in [0, 1)})."""
    rng = np.random.default_rng(seed)
    tables, images = [], {}
    meta_offset = 0
    for s in range(n_scenes):
        scene_id = f"synth_{s}"
        tracks = make_synthetic_scene(rng, scene_id, n_traj, total_len,
                                      img_hw)
        tracks = tracks.replace(metaId=tracks.metaId + meta_offset)
        meta_offset = tracks.metaId.max() + 1
        tables.append(tracks)
        images[scene_id] = rng.uniform(
            0, 1, size=(*img_hw, n_channels)).astype(np.float32)
    return Tracks.concat(tables), images
