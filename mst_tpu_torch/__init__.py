"""PyTorch/CUDA port of mst_tpu for one NVIDIA Hopper card.

The JAX package `mst_tpu` is the reference; this package imports nothing
of it (nor of jax). Entry points run on `cuda` unless the caller passes
`device="cpu"` explicitly; without a card they raise instead of falling
back to the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means `cuda`, which must exist. On a CUDA device the f32 path is
    pinned to full f32: TF32 is turned off for cuDNN convolutions and for
    matmuls (cuDNN convolutions default to TF32, which keeps ~3 decimal
    digits and would not match the f32 reference).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mst_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
