"""The finest decoder level as one computation: conv3x3 + bias + ReLU
(C -> 128), conv3x3 + bias + ReLU (128 -> 128), the 1x1 predictor
(128 -> 4P) and the packed online soft-argmax -> (KB, 2, P). Two CUDA C++
kernels for Hopper (csrc/decoder_chain.cu, on csrc/conv_tile.cuh) and their
plain version.

`chain_plane` replaces the TPU kernel benchmarks/pallas_chain_probe.py:233
`pallas_chain`: stage A writes its plane to a scratch buffer in device
memory, a group of images at a time sized to stay in L2, and a second
kernel reads it back with halos. `chain_stream` replaces :199
`pallas_chain_v2`: each block recomputes its stage-A halo in shared memory,
so no intermediate leaves the SM. Both write per-(image, tile) partial
statistics that a merge launch unifies (unify_packed_stats).

Bound on an H100 at the probe's shape (KB 160, 176 x 240, C 64, P 12):
operations, 3.073e12 FLOP = 3.11 ms at 989 TFLOP/s dense bf16 (the 0.87 GB
moved take 0.26 ms). The design notes are in the source.
"""

import ctypes

import torch

from mst_tpu_torch.ops.kernels import _build
from mst_tpu_torch.ops.kernels.conv3x3 import (CHANNELS_OUT, check_bf16,
                                               check_channels, conv3x3_sum)
from mst_tpu_torch.ops.softargmax import unify_packed_stats

MAX_PACKED = 64            # 4P, the predictor's columns
PLAIN_CHUNK = 8            # images per step of the plain version
L2_PLANE_BYTES = 40 << 20  # chain_plane's scratch planes: inside the 50 MB L2
EPS = 1e-6                 # the soft-argmax's 1 / (s + EPS), as the TPU chain


def chain_map_plain(x, wa, ba, wb, bb, wpred, bpred):
    """The chain's f32 logits map (KB, Hp, Wp, 4P): both convs round to
    x's dtype after bias and ReLU, as the kernels do; the logits are f32.
    Sums are taken in float64 (see conv3x3_sum)."""
    a = torch.relu(conv3x3_sum(x, wa) + ba).to(x.dtype)
    b = torch.relu(conv3x3_sum(a, wb) + bb).to(x.dtype)
    return (b.to(torch.float64) @ wpred.to(torch.float64) + bpred).to(
        torch.float32)


def chain_plain(x, wa, ba, wb, bb, wpred, bpred, n_pred: int):
    """The plain version -> (KB, 2, P): the logits map, each packed
    channel's (m, s, sx, sy) over packed columns j and rows i, then
    unify_packed_stats; PLAIN_CHUNK images at a time."""
    out = []
    for i in range(0, x.shape[0], PLAIN_CHUNK):
        logits = chain_map_plain(x[i:i + PLAIN_CHUNK], wa, ba, wb, bb, wpred,
                                 bpred)
        _, Hp, Wp, _ = logits.shape
        m = logits.amax(dim=(1, 2))
        e = torch.exp(logits - m[:, None, None, :])
        jw = torch.arange(Wp, dtype=torch.float32, device=x.device)
        ih = torch.arange(Hp, dtype=torch.float32, device=x.device)
        X, Y = unify_packed_stats(
            m, e.sum(dim=(1, 2)), torch.einsum("bhwc,w->bc", e, jw),
            torch.einsum("bhwc,h->bc", e, ih), n_pred, EPS)
        out.append(torch.stack([X, Y], 1))
    return torch.cat(out)


def _library():
    lib = _build.load("decoder_chain")
    if lib.chain_plane_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_plane_launch.argtypes = [ptr] * 10 + [i32] * 6 + [
            ctypes.c_float, ptr]
        lib.chain_stream_launch.argtypes = [ptr] * 9 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.chain_plane_launch.restype = ctypes.c_int
        lib.chain_stream_launch.restype = ctypes.c_int
        lib.decoder_chain_tiles.argtypes = [i32, i32]
        lib.decoder_chain_tiles.restype = ctypes.c_int
    return lib


def _checked(fn_name, x, wa, ba, wb, bb, wpred, bpred, n_pred):
    """Validate the operands of a kernel launch; -> (KB, Hp, Wp, C), the
    (KB, tiles, 4P, 4) partials and the (KB, 2, P) output."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{fn_name}: x must be (KB, Hp, Wp, C), got "
                         f"{tuple(x.shape)}")
    KB, Hp, Wp, C = x.shape
    n4 = 4 * n_pred
    ca = CHANNELS_OUT
    check_channels(fn_name, C)
    if not 0 < n4 <= MAX_PACKED:
        raise ValueError(f"{fn_name}: 4P={n4} outside [4, {MAX_PACKED}]")
    for name, t, shape in (("wa", wa, (3, 3, C, ca)),
                           ("wb", wb, (3, 3, ca, ca)),
                           ("wpred", wpred, (ca, n4))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn_name}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    check_bf16(fn_name, x=x, wa=wa, wb=wb, wpred=wpred)
    for name, t, n in (("ba", ba, ca), ("bb", bb, ca), ("bpred", bpred, n4)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(
                f"{fn_name}: {name} must be a contiguous f32 tensor of shape "
                f"({n},) on {x.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    tiles = _library().decoder_chain_tiles(Hp, Wp)
    part = torch.empty((KB, tiles, n4, 4), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((KB, 2, n_pred), dtype=torch.float32, device=x.device)
    return (KB, Hp, Wp, C), part, out


def _raise_on(fn_name, err):
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError_t "
                           f"{err}")


def chain_plane(x, wa, ba, wb, bb, wpred, bpred, n_pred: int):
    """x (KB, Hp, Wp, C) NHWC, wa (3, 3, C, 128), wb (3, 3, 128, 128),
    wpred (128, 4P), ba/bb (128,), bpred (4P,) -> (KB, 2, P): (X, Y).

    A CPU tensor takes the plain version. A CUDA tensor launches the plane
    kernels: bf16 x and weights, f32 biases, all contiguous, C % 32 == 0,
    C <= 128, 4P <= 64; anything else raises.
    """
    if x.device.type == "cpu":
        return chain_plain(x, wa, ba, wb, bb, wpred, bpred, n_pred)
    (KB, Hp, Wp, C), part, out = _checked("chain_plane", x, wa, ba, wb, bb,
                                          wpred, bpred, n_pred)
    plane_bytes = Hp * Wp * CHANNELS_OUT * 2
    group = max(1, min(KB, L2_PLANE_BYTES // plane_bytes))
    plane = torch.empty((group, Hp, Wp, CHANNELS_OUT), dtype=torch.bfloat16,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().chain_plane_launch(
            x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(),
            bb.data_ptr(), wpred.data_ptr(), bpred.data_ptr(),
            plane.data_ptr(), part.data_ptr(), out.data_ptr(), KB, Hp, Wp, C,
            n_pred, group, EPS, stream)
    _raise_on("chain_plane", err)
    chain_plane.launches += 1
    return out


def chain_stream(x, wa, ba, wb, bb, wpred, bpred, n_pred: int):
    """The same chain as chain_plane, through the streamed kernel."""
    if x.device.type == "cpu":
        return chain_plain(x, wa, ba, wb, bb, wpred, bpred, n_pred)
    (KB, Hp, Wp, C), part, out = _checked("chain_stream", x, wa, ba, wb, bb,
                                          wpred, bpred, n_pred)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().chain_stream_launch(
            x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(),
            bb.data_ptr(), wpred.data_ptr(), bpred.data_ptr(),
            part.data_ptr(), out.data_ptr(), KB, Hp, Wp, C, n_pred, EPS,
            stream)
    _raise_on("chain_stream", err)
    chain_stream.launches += 1
    return out


chain_plane.launches = 0
chain_stream.launches = 0
