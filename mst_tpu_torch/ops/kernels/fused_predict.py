"""Fused 1x1 predictor + soft-argmax: a CUDA C++ kernel for Hopper
(csrc/fused_predict.cu), and its plain version.

Replaces the TPU kernel mst_tpu/ops/pallas/fused_predict.py (`_fused_rows`
-> `pl.pallas_call` of `_kernel`), in its unpacked form: pre-predictor
activations x (R, H, W, C) times the predictor's (C, P) weight plus bias,
then the soft-argmax of each of the P logit maps -> (R, P, 2). The kernel
never writes the (R, H, W, P) logits to device memory.

Bound on an H100: bytes, reading x once (3.46 GB at the eval decode's
R = 160, 352 x 480, C = 32: ~1.03 ms at 3.35 TB/s); the 2*C*P flops per
pixel stay far under the f32 rate. The design notes are in the source.
"""

import ctypes

import torch

from mst_tpu_torch.ops.kernels import _build
from mst_tpu_torch.ops.softargmax import softargmax2d_nhwc

MAX_CHANNELS = 32      # P; pred_len is 12 or 30 in the shipped configs
PIX_PER_CHUNK = 2048   # pixels of one row per pass-1 block (256 threads)


def fused_predictor_softargmax_plain(x, weight, bias, eps: float = 1e-6):
    """The plain version: x (R, H, W, C) @ weight (C, P) + bias (P), then
    softargmax2d_nhwc -> (R, P, 2)."""
    logits = torch.einsum("rhwc,cp->rhwp", x, weight) + bias
    return softargmax2d_nhwc(logits, eps)


def _library():
    lib = _build.load("fused_predict")
    fn = lib.fused_predict_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_predictor_softargmax(x, weight, bias, eps: float = 1e-6):
    """(R, H, W, C) activations, (C, P) weight, (P,) bias -> (R, P, 2).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, which needs f32 everywhere and x contiguous in NHWC order (the
    NHWC view of a channels_last NCHW tensor); anything else raises.
    """
    if x.device.type == "cpu":
        return fused_predictor_softargmax_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_predictor_softargmax: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            "fused_predictor_softargmax needs x (R, H, W, C) contiguous in "
            f"NHWC order; got shape {tuple(x.shape)}, strides {x.stride()}")
    R, H, W, C = x.shape
    P = weight.shape[-1]
    for name, t, shape in (("x", x, (R, H, W, C)), ("weight", weight, (C, P)),
                           ("bias", bias, (P,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"fused_predictor_softargmax: {name} must be a contiguous "
                f"f32 tensor of shape {shape} on {x.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= P <= MAX_CHANNELS:
        raise ValueError(f"fused_predictor_softargmax: P={P} outside "
                         f"[1, {MAX_CHANNELS}]")
    HW = H * W
    n_chunks = (HW + PIX_PER_CHUNK - 1) // PIX_PER_CHUNK
    part = torch.empty((R, n_chunks, P, 4), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((R, P, 2), dtype=torch.float32, device=x.device)
    vec4 = int(C % 4 == 0 and x.data_ptr() % 16 == 0)
    launch = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                     part.data_ptr(), out.data_ptr(), R, HW, W, C, P,
                     PIX_PER_CHUNK, n_chunks, vec4, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_predict kernel launch failed: "
                           f"cudaError_t {err}")
    fused_predictor_softargmax.launches += 1
    return out


fused_predictor_softargmax.launches = 0
