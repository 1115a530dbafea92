"""SAME 3x3 stride-1 convs, bf16 NHWC x HWIO -> bf16: two CUDA C++ kernels
for Hopper (csrc/conv3x3.cu, on the wgmma/TMA building blocks of
csrc/conv_wgmma.cuh) and their plain version.

`conv3x3_taps` replaces the TPU kernel benchmarks/pallas_conv_probe.py:59
`pallas_conv3x3` (nine K=C products per tile, one per tap, A read from the
tile staged once with its halo) and `conv3x3_im2col` replaces :111
`pallas_conv3x3_v2` (one K=9C contraction per tile, each im2col K block
brought by TMA). Both work on 16 x 16 pixel tiles in a persistent grid and
stream the weight by TMA in its K-major re-layout (`kmajor_weight`); TMA
zero-fills the SAME halo, so x is not padded in device memory and any H
and W work.

Bound on an H100 at the probe's shape ((160, 176, 240, 128) x (3, 3, 128,
128)): operations, 1.993e12 FLOP = 2.02 ms at 989 TFLOP/s dense bf16 (the
3.46 GB moved take 1.03 ms). The design notes are in the sources.
"""

import ctypes

import torch
import torch.nn.functional as F

from mst_tpu_torch.ops.kernels import _build

CHANNELS_OUT = 128        # Co the kernels compute
CHANNEL_MULTIPLE = 32     # C % 32 == 0
MAX_CHANNELS = 128        # C
K_BLOCK = 64              # K rows of one weight block the kernels stream
PLAIN_CHUNK = 16          # images per step of the plain version
TILE = 16                 # the kernels' tiles are TILE x TILE pixels


def conv3x3_sum(x, w):
    """SAME 3x3 conv summed in float64: (B, H, W, C) x (3, 3, C, Co) ->
    f64 (B, H, W, Co), the nine taps' products added into one buffer (no
    im2col, which at the probe's shape would take 31 GB in f32).

    The kernels sum in f32; float64 makes the plain versions' one rounding
    the correctly rounded one, so that a comparison on the card measures
    the kernel's own accumulation error and not the sum of two.
    """
    _, H, W, _ = x.shape
    xp = F.pad(x.to(torch.float64), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.float64)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + H, dx:dx + W, :] @ wf[dy, dx]
            acc = term if acc is None else acc.add_(term)
    return acc


def conv3x3_plain(x, w):
    """The plain version: the sum rounded once to x's dtype (as the kernels
    round their f32 accumulators to bf16), PLAIN_CHUNK images at a time."""
    out = torch.empty(x.shape[:3] + (w.shape[3],), dtype=x.dtype,
                      device=x.device)
    for i in range(0, x.shape[0], PLAIN_CHUNK):
        out[i:i + PLAIN_CHUNK] = conv3x3_sum(x[i:i + PLAIN_CHUNK],
                                             w).to(x.dtype)
    return out


def kmajor_weight(w):
    """HWIO (3, 3, C, Co) -> the kernels' K-major (Co, 9 Cp) weight: row
    co, column tap * Cp + ci with tap = 3 dy + dx, Cp = C rounded up to
    K_BLOCK, zero where ci >= C (so each K block lies in one tap)."""
    C, Co = w.shape[2], w.shape[3]
    cp = -(-C // K_BLOCK) * K_BLOCK
    wk = w.new_zeros((Co, 9, cp))
    wk[:, :, :C] = w.reshape(9, C, Co).permute(2, 0, 1)
    return wk.reshape(Co, 9 * cp)


def l2_weight_bytes(B, H, W, C):
    """Weight bytes both kernels read from L2 in one call: every tile of
    TILE x TILE pixels streams the whole K-major weight once."""
    tiles = B * -(-H // TILE) * -(-W // TILE)
    return tiles * 9 * -(-C // K_BLOCK) * K_BLOCK * CHANNELS_OUT * 2


def check_bf16(fn_name, **tensors):
    """Raise unless every named tensor is a contiguous, 16-byte aligned
    bf16 CUDA tensor on the first one's device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if (t.device != dev or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"{fn_name}: {name} must be a contiguous, 16-byte aligned "
                f"bf16 tensor on {dev}; got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()} on {t.device}")


def check_channels(fn_name, C):
    if C % CHANNEL_MULTIPLE or not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"{fn_name}: C={C} must be a multiple of "
                         f"{CHANNEL_MULTIPLE} in [{CHANNEL_MULTIPLE}, "
                         f"{MAX_CHANNELS}]")


def _launch(symbol, fn_name, x, w):
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{fn_name}: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    if tuple(w.shape) != (3, 3, C, CHANNELS_OUT):
        raise ValueError(f"{fn_name}: w must be (3, 3, {C}, {CHANNELS_OUT}),"
                         f" got {tuple(w.shape)}")
    check_channels(fn_name, C)
    check_bf16(fn_name, x=x, w=w)
    wk = kmajor_weight(w)
    out = torch.empty((B, H, W, CHANNELS_OUT), dtype=torch.bfloat16,
                      device=x.device)
    fn = getattr(_build.load("conv3x3"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wk.data_ptr(), out.data_ptr(), B, H, W, C,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: error {err} "
                           "(a cudaError_t; 999: no cuTensorMapEncodeTiled; "
                           "1000 + CUresult: a refused tensor map)")
    return out


def conv3x3_taps(x, w):
    """(B, H, W, C) NHWC x (3, 3, C, 128) HWIO -> (B, H, W, 128), SAME.

    A CPU tensor takes the plain version. A CUDA tensor launches the taps
    kernel, which needs contiguous bf16 x and w with C % 32 == 0, C <= 128;
    anything else raises. Any B, H and W.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    out = _launch("conv3x3_taps_launch", "conv3x3_taps", x, w)
    conv3x3_taps.launches += 1
    return out


def conv3x3_im2col(x, w):
    """The same conv as conv3x3_taps, through the im2col kernel."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    out = _launch("conv3x3_im2col_launch", "conv3x3_im2col", x, w)
    conv3x3_im2col.launches += 1
    return out


conv3x3_taps.launches = 0
conv3x3_im2col.launches = 0
