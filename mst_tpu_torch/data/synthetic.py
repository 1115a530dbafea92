"""Synthetic scenes (counterpart of mst_tpu/data/synthetic.py:13-47): random
RGB-like images and smooth random-walk tracks, drawn from one numpy
generator in mst_tpu's order, so a seed gives mst_tpu's rows; and
write_sdd_annotations, which writes tracks in SDD's raw annotation format
for the builders (data/sdd.py).
"""

import os

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


SDD_LABELS = ("Pedestrian", "Biker", "Car")


def write_sdd_annotations(tracks, root, step=1, labels=SDD_LABELS,
                          half_box=2.0, lost_every=0):
    """Tracks -> SDD's raw layout, root/annotations/<name>/video<i>/
    annotations.txt for scene '<name>_<i>' (what data.sdd.load_raw_sdd
    reads). Each track's samples are `step` raw frames apart, with the
    frames between interpolated linearly, so a builder that downsamples by
    `step` gets the samples back; its bounding box is centred on the point
    (half width half_box) and its label is labels[metaId % len(labels)].
    With lost_every k > 0, every k-th raw row of each odd metaId is marked
    lost, which the builder drops, splitting that track into fragments.
    Each file starts with a header row, which the loader's header=0
    consumes (the released files have none, so there it drops their first
    row, as the reference's does). -> the number of rows written."""
    n = 0
    for scene in tracks.scene_ids():
        t = tracks.take(tracks.sceneId == scene)
        name, idx = scene.rsplit("_", 1)
        d = os.path.join(root, "annotations", name, f"video{idx}")
        os.makedirs(d, exist_ok=True)
        rows = [" ".join(("trackId", "xmin", "ymin", "xmax", "ymax",
                          "frame", "lost", "occluded", "generated",
                          "label"))]
        for track, meta in enumerate(np.unique(t.metaId)):
            sel = t.metaId == meta
            xy = np.stack([t.x[sel], t.y[sel]], axis=1)
            f0 = int(t.frame[sel][0]) * step
            label = labels[int(meta) % len(labels)]
            frac = (np.arange(step) / step)[None, :, None]
            dense = (xy[:-1, None] + (xy[1:] - xy[:-1])[:, None] * frac
                     ).reshape(-1, 2)
            dense = np.concatenate([dense, xy[-1:]])
            for j, (x, y) in enumerate(dense):
                lost = int(lost_every > 0 and meta % 2 == 1
                           and j % lost_every == lost_every - 1)
                rows.append(f"{track} {x - half_box:.4f} {y - half_box:.4f} "
                            f"{x + half_box:.4f} {y + half_box:.4f} "
                            f"{f0 + j} {lost} 0 0 \"{label}\"")
        with open(os.path.join(d, "annotations.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        n += len(rows) - 1
    return n
