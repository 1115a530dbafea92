"""Scene images: load, resize, pad, normalise, and the augmentation
(counterpart of mst_tpu/data/images.py:22-175; reference
utils/image_utils.py:66-107 and utils/data_utils.py:115-263).

Everything after decoding a file is numpy, so the loop runs where OpenCV is
not installed; cv2 is imported only inside `load_images`. The resizes
follow OpenCV's own arithmetic (imgproc/src/resize.cpp):
- INTER_AREA at an integer inverse factor (SDD's 0.25) is a box mean, on
  uint8 an integer sum times the float 1/area rounded half to even (at
  factor 0.5, half up), so it matches cv2 exactly; on f32 at 0.5, cv2's
  vector path sums in another order (within one rounding);
- INTER_AREA at another factor (inD's 0.33) weights each source pixel by
  its overlap with the output cell (computeResizeAreaTab), summed in f32 in
  OpenCV's order;
- INTER_AREA above a factor of 1 is OpenCV's bilinear emulation of it
  (the linear path's area mode: _linear_table), exact on uint8 and f32;
- INTER_NEAREST takes source index floor(i / factor), clamped.
Channel order is cv2's BGR throughout, as in the JAX package.
"""

import math
import os

import numpy as np

from mst_tpu_torch.data.tracks import Tracks

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
DBL_EPSILON = np.finfo(np.float64).eps


def scene_image_path(image_path, scene, image_file, use_raw_data=False):
    """reference data_utils.py:248-263."""
    if use_raw_data:
        scene_name, scene_idx = scene.split("_")
        return os.path.join(image_path, scene_name, f"video{scene_idx}",
                            image_file)
    return os.path.join(image_path, scene, image_file)


def load_images(scenes, image_path, image_file="reference.jpg",
                use_raw_data=False, seg_mask=False):
    """sceneId -> the decoded image (uint8 HWC BGR, or HW for a mask)."""
    import cv2

    images = {}
    for scene in scenes:
        p = scene_image_path(image_path, scene, image_file, use_raw_data)
        im = cv2.imread(p, 0) if seg_mask else cv2.imread(p)
        if im is None:
            raise FileNotFoundError(p)
        images[scene] = im
    return images


def _out_size(n, factor):
    """OpenCV's saturate_cast<int>(n * factor): rounded half to even."""
    return int(np.rint(n * factor))


def _saturate(v, dtype):
    if dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v.astype(dtype)


def _area_fast(im, s, dh, dw):
    """INTER_AREA at the integer inverse factor s (resizeAreaFast_): each
    full s x s block summed in row-major order (an int sum for uint8; in
    f32, four terms at a time, for float) times the float 1/(s s); blocks
    cut by the image's edge average what they hold."""
    H, W = im.shape[:2]
    area = s * s
    scale = np.float32(1.0 / area)
    x = im.reshape(H, W, -1)
    C = x.shape[2]
    out = np.zeros((dh, dw, C), np.float32)
    hf, wf = min(H // s, dh), W // s
    blocks = x[:hf * s, :wf * s].reshape(hf, s, wf, s, C).transpose(
        0, 2, 4, 1, 3).reshape(hf, wf, C, area)
    if im.dtype == np.uint8 and s == 2:
        # the 2 x 2 vector path rounds half up: (sum + 2) >> 2
        out[:hf, :wf] = (blocks.astype(np.int64).sum(-1) + 2) >> 2
        total = None
    elif im.dtype == np.uint8:
        total = blocks.astype(np.int64).sum(-1).astype(np.float32)
    else:
        b = blocks.astype(np.float32)
        total = np.zeros(b.shape[:-1], np.float32)
        k = 0
        while k <= area - 4:
            total = total + (((b[..., k] + b[..., k + 1]) + b[..., k + 2])
                             + b[..., k + 3])
            k += 4
        for k in range(k, area):
            total = total + b[..., k]
    if total is not None:
        out[:hf, :wf] = total * scale
    for dy in range(dh):
        for dx in range(dw):
            if dy < hf and dx < wf:
                continue
            cell = x[dy * s:dy * s + s, dx * s:dx * s + s]
            n = cell.shape[0] * cell.shape[1]
            if im.dtype == np.uint8:
                total = cell.astype(np.int64).sum((0, 1)).astype(np.float32)
            else:
                total = np.zeros(C, np.float32)
                for v in cell.reshape(n, C).astype(np.float32):
                    total = total + v
            out[dy, dx] = total / np.float32(n)
    return _saturate(out, im.dtype).reshape((dh, dw) + im.shape[2:])


def _area_table(n_src, n_dst, scale):
    """computeResizeAreaTab: for each output cell, its source indices and
    f32 weights (overlap / cell width), padded with weight 0 to one
    length."""
    cells = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        cell = []
        if s1 - f1 > 1e-3:
            cell.append((s1 - 1, (s1 - f1) / width))
        cell += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            cell.append((s2, min(min(f2 - s2, 1.0), width) / width))
        cells.append(cell)
    L = max(len(c) for c in cells)
    idx = np.zeros((n_dst, L), np.int64)
    alpha = np.zeros((n_dst, L), np.float32)
    for d, cell in enumerate(cells):
        for j, (s, a) in enumerate(cell):
            idx[d, j], alpha[d, j] = s, a
    return idx, alpha


def _area_general(im, scale, dh, dw):
    """INTER_AREA at a non-integer inverse factor (ResizeArea_Invoker):
    each source row's weighted sums along x in f32, then the weighted sum
    of those rows along y, each in the table's order."""
    H, W = im.shape[:2]
    x = im.reshape(H, W, -1).astype(np.float32)
    xi, xa = _area_table(W, dw, scale)
    yi, ya = _area_table(H, dh, scale)
    rows = np.zeros((H, dw, x.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        rows = rows + x[:, xi[:, j]] * xa[None, :, j, None]
    out = rows[yi[:, 0]] * ya[:, 0, None, None]
    for j in range(1, yi.shape[1]):
        out = out + rows[yi[:, j]] * ya[:, j, None, None]
    return _saturate(out, im.dtype).reshape((dh, dw) + im.shape[2:])


def _linear_table(n_src, n_dst, factor, clamp):
    """The area mode of cv::resize's linear path (upscaling INTER_AREA):
    for output index d the source index s = floor(d / factor) and the
    weight f = (d + 1) - (s + 1) factor in f32, 0 where not positive,
    else taken mod 1; -> (the indices s and s + 1, clipped to the axis,
    and the weights 1 - f and f, on uint8 as Q11 integers). clamp (the x
    axis): from the last source pixel on, s stays there with f = 0; the y
    axis keeps f and reads the last row twice."""
    idx = np.zeros((n_dst, 2), np.int64)
    w = np.zeros((n_dst, 2), np.float32)
    for d in range(n_dst):
        s = math.floor(d / factor)
        f = np.float32((d + 1) - (s + 1) * factor)
        f = np.float32(0) if f <= 0 else f - np.float32(math.floor(f))
        if clamp and s >= n_src - 1:
            s, f = n_src - 1, np.float32(0)
        idx[d] = s, min(s + 1, n_src - 1)
        w[d] = np.float32(1) - f, f
    return idx, w


def _area_up(im, factor, dh, dw):
    """INTER_AREA at a factor above 1, which OpenCV runs as a bilinear
    resize with _linear_table's weights (HResizeLinear, then
    VResizeLinear): on uint8 in fixed point (Q11 weights, the rows' sums
    shifted as its VResizeLinear for uchar does), on f32 each sum a0 s0
    + a1 s1."""
    H, W = im.shape[:2]
    x = im.reshape(H, W, -1)
    xi, xa = _linear_table(W, dw, factor, clamp=True)
    yi, ya = _linear_table(H, dh, factor, clamp=False)
    if im.dtype == np.uint8:
        xa, ya = (np.rint(a * np.float32(2048)).astype(np.int64)
                  for a in (xa, ya))
        x = x.astype(np.int64)
        rows = (x[:, xi[:, 0]] * xa[None, :, 0, None]
                + x[:, xi[:, 1]] * xa[None, :, 1, None])
        out = ((((ya[:, 0, None, None] * (rows[yi[:, 0]] >> 4)) >> 16)
                + ((ya[:, 1, None, None] * (rows[yi[:, 1]] >> 4)) >> 16)
                + 2) >> 2).astype(np.uint8)
    else:
        x = x.astype(np.float32)
        rows = (x[:, xi[:, 0]] * xa[None, :, 0, None]
                + x[:, xi[:, 1]] * xa[None, :, 1, None])
        out = _saturate(rows[yi[:, 0]] * ya[:, 0, None, None]
                        + rows[yi[:, 1]] * ya[:, 1, None, None], im.dtype)
    return out.reshape((dh, dw) + im.shape[2:])


def resize_area(im, factor):
    """cv2.resize(im, (0, 0), fx=factor, fy=factor,
    interpolation=cv2.INTER_AREA) for a factor > 0: the area mean when
    downscaling, OpenCV's bilinear emulation (_area_up) above 1."""
    if not factor > 0:
        raise ValueError(
            f"resize factor {factor}: INTER_AREA needs a factor > 0")
    H, W = im.shape[:2]
    dh, dw = _out_size(H, factor), _out_size(W, factor)
    if factor > 1:
        return _area_up(im, factor, dh, dw)
    scale = 1.0 / factor
    s = int(round(scale))
    if abs(scale - s) < DBL_EPSILON:
        return _area_fast(im, s, dh, dw)
    return _area_general(im, scale, dh, dw)


def resize_nearest(im, factor):
    """cv2.resize(..., interpolation=cv2.INTER_NEAREST)."""
    H, W = im.shape[:2]
    dh, dw = _out_size(H, factor), _out_size(W, factor)
    inv = 1.0 / factor
    ys = np.minimum(np.floor(np.arange(dh) * inv).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(dw) * inv).astype(np.int64), W - 1)
    return im[ys][:, xs]


def resize_images(images, factor, seg_mask=False):
    """reference image_utils.py:85-92 (INTER_AREA / NEAREST for masks)."""
    resize = resize_nearest if seg_mask else resize_area
    return {k: resize(im, factor) for k, im in images.items()}


def pad_images(images, division_factor=32):
    """Bottom/right zero pad to a multiple (image_utils.py:95-107)."""
    out = {}
    for k, im in images.items():
        H, W = im.shape[:2]
        Hn = int(np.ceil(H / division_factor) * division_factor)
        Wn = int(np.ceil(W / division_factor) * division_factor)
        pad = [(0, Hn - H), (0, Wn - W)] + [(0, 0)] * (im.ndim - 2)
        out[k] = np.pad(im, pad)
    return out


def normalize_for_segmentation(images, seg_mask=False, classes=6):
    """imagenet normalisation, or one-hot classes for masks
    (image_utils.py:66-82) -> float32 HWC arrays."""
    out = {}
    for k, im in images.items():
        if seg_mask:
            im = np.stack([(im == v) for v in range(classes)], axis=-1)
            im = im.astype(np.float32)
        else:
            im = im.astype(np.float32)
            if im.max() > 1:
                im = im / 255.0
            im = (im - IMAGENET_MEAN) / IMAGENET_STD
        out[k] = np.ascontiguousarray(im, np.float32)
    return out


def preprocess_scene_images(images, resize_factor, division_factor=32,
                            seg_mask=False, classes=6):
    images = resize_images(images, resize_factor, seg_mask)
    images = pad_images(images, division_factor)
    return normalize_for_segmentation(images, seg_mask, classes)


# ---------------------------------------------------------------------------
# augmentation (reference data_utils.py:115-233)
# ---------------------------------------------------------------------------

def rot_df_image(tracks, image, k=1):
    """Rotate the image and the coordinates counter-clockwise by k x 90
    degrees (data_utils.py:115-144)."""
    y0, x0 = image.shape[:2]
    xy = np.stack([tracks.x - x0 / 2, tracks.y - y0 / 2], axis=1)
    c, s = np.cos(-k * np.pi / 2), np.sin(-k * np.pi / 2)
    xy = xy @ np.array([[c, s], [-s, c]])
    image = np.ascontiguousarray(np.rot90(image, k % 4))
    y0, x0 = image.shape[:2]
    return tracks.replace(x=xy[:, 0] + x0 / 2, y=xy[:, 1] + y0 / 2), image


def fliplr_df_image(tracks, image):
    """Horizontal flip of the image and the coordinates
    (data_utils.py:147-173)."""
    x0 = image.shape[1]
    return (tracks.replace(x=x0 / 2 - (tracks.x - x0 / 2)),
            np.ascontiguousarray(image[:, ::-1]))


def augment_data(tracks, images):
    """Pseudo-scenes rotated by 90, 180 and 270 degrees, then every scene
    flipped (data_utils.py:176-233): the table in mst_tpu's row order, with
    its metaId offsets, and `images` extended in place."""
    k2rot = {1: "_rot90", 2: "_rot180", 3: "_rot270"}
    pieces = [tracks]
    meta_max = tracks.metaId.max()
    for k in (1, 2, 3):
        k_pieces = []
        for scene in tracks.scene_ids():
            rot, im_rot = rot_df_image(tracks.take(tracks.sceneId == scene),
                                       images[scene], k)
            new_scene = scene + k2rot[k]
            images[new_scene] = im_rot
            k_pieces.append(rot.replace(
                sceneId=np.full(len(rot), new_scene, object),
                metaId=rot.metaId + meta_max + 1))
        pieces.extend(k_pieces)
        if k_pieces:
            meta_max = max(p.metaId.max() for p in k_pieces)
    data = Tracks.concat(pieces)

    meta_max = data.metaId.max()
    flip_pieces = [data]
    for scene in data.scene_ids():
        flip, im_flip = fliplr_df_image(data.take(data.sceneId == scene),
                                        images[scene])
        flip_pieces.append(flip.replace(sceneId=flip.sceneId + "_fliplr",
                                        metaId=flip.metaId + meta_max + 1))
        images[scene + "_fliplr"] = im_flip
    return Tracks.concat(flip_pieces), images
