"""The segmentation backbone's weights and call (counterpart of
mst_tpu/models/segmentation.py).

The reference loads a pickled smp module (models/ynet.py:495-507); here
the backbone is models/unet.py with its weights as data: the npz that
`python -m mst_tpu_torch.models.convert segmentation` (or mst_tpu's
converter, which writes the same file) makes from the released .pth. No
file means the identity backbone (ynet.py:507): the scene image is the
semantic map. A file that exists but holds no backbone raises; there is
no fallback to the identity.
"""

import os

import torch

from mst_tpu_torch import io
from mst_tpu_torch.models.unet import unet_apply

_SUBTREES = ("encoder", "decoder", "segmentation_head")


def load_params(path, device="cuda"):
    """The backbone npz at path -> its parameter tree on device, or None
    when path is None or names no file. The npz is a converter's output,
    or a file whose 'segmentation/' leaves are the backbone (a model
    directory's params.npz). Integer leaves ('_meta/activation') become
    int32, as mst_tpu's device-resident tree holds them, so an export
    writes mst_tpu's npz."""
    if path is None or not os.path.exists(path):
        return None
    try:
        flat = io.load_checkpoint(path)
    except Exception as e:
        raise ValueError(f"segmentation_model_fp={str(path)!r} exists but "
                         f"is not a backbone npz: {e}") from e
    if any(k.startswith("segmentation/") for k in flat):
        flat = {k[len("segmentation/"):]: v for k, v in flat.items()
                if k.startswith("segmentation/")}
    tree = io.params_from_numpy(flat, device) if flat else {}
    missing = [s for s in _SUBTREES if not isinstance(tree.get(s), dict)]
    if missing:
        raise ValueError(f"segmentation_model_fp={str(path)!r} exists but "
                         f"is not a backbone npz: it has no {missing} "
                         "subtree")
    meta = tree.get("_meta", {})
    for k, v in meta.items():
        meta[k] = v.to(torch.int32)
    return tree


def apply(params, image, use_features_only=False, bn_state=None,
          train=False, slab=None):
    """(B, H, W, 3) preprocessed image -> (B, H, W, n_classes) class map
    (16 decoder channels when use_features_only); the identity when params
    is None. train returns (out, the batch norms' running-statistic
    updates), as unet.unet_apply does; slab (a mesh.Slab): image and the
    output hold the slab's rows (unet.unet_apply)."""
    if params is None:
        return (image, {}) if train else image
    return unet_apply(params, image, use_features_only, bn_state=bn_state,
                      train=train, slab=slab)
