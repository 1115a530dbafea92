"""Fused 1x1 predictor + soft-argmax: a CUDA C++ kernel for Hopper
(csrc/fused_predict.cu), and its plain version.

Replaces the TPU kernel mst_tpu/ops/pallas/fused_predict.py (`_fused_rows`
-> `pl.pallas_call` of `_kernel`), in its unpacked form: pre-predictor
activations x (R, H, W, C) times the predictor's (C, P) weight plus bias,
then the soft-argmax of each of the P logit maps -> (R, P, 2). The kernel
never writes the (R, H, W, P) logits to device memory.

Bound on an H100: bytes, reading x once (3.46 GB at the eval decode's
R = 160, 352 x 480, C = 32: 1.03 ms at 3.35 TB/s); the 2*C*P flops a pixel
stay under the f32 rate at P = 12. The kernel streams x through a ring of
TMA (C = 32) or bulk copies in a persistent grid and merges each row's
blocks in the same launch; the design notes are in the source. `fused_work`, `stage_pixels`,
`group_width` and `pixels_per_thread` mirror its work split, and `fused_split_reference` runs
that split with the kernel's merge arithmetic on the CPU.
"""

import ctypes
import threading

import torch

from mst_tpu_torch.ops.kernels import _build
from mst_tpu_torch.ops.kernels import online_stats as ost
from mst_tpu_torch.ops.softargmax import softargmax2d_nhwc

MAX_CHANNELS = 32      # P; pred_len is 12 or 30 in the shipped configs
MAX_IN_CHANNELS = 128  # C; the padded weights share shared memory with x
STAGE_BYTES = 64 * 1024
CONSUMER_THREADS = 256
WARP = 32


def fused_predictor_softargmax_plain(x, weight, bias, eps: float = 1e-6):
    """The plain version: x (R, H, W, C) @ weight (C, P) + bias (P), then
    softargmax2d_nhwc -> (R, P, 2)."""
    logits = torch.einsum("rhwc,cp->rhwp", x, weight) + bias
    return softargmax2d_nhwc(logits, eps)


# ---- the kernel's work split (fused_predict.cu: item_of, stage_pixels,
# groups, group_width, pixels_per_thread, first_of_group,
# fused_predict_blocks)

def fused_blocks(R, HW, sms):
    """The persistent grid: one block an SM, or one a pixel if fewer."""
    return min(sms, R * HW)


def fused_work(R, HW, blocks):
    """Each block's work items [(row, begin, end), ...]: block b streams
    flat pixels [b T // blocks, (b + 1) T // blocks) of T = R * HW, cut at
    row boundaries."""
    T = R * HW
    work = []
    for b in range(blocks):
        s, e = T * b // blocks, T * (b + 1) // blocks
        items = []
        row = s // HW
        while row * HW < e:
            r0 = row * HW
            items.append((row, max(s, r0) - r0, min(e, r0 + HW) - r0))
            row += 1
        work.append(items)
    return work


def block_of(q, T, blocks):
    """The block whose range holds flat pixel q."""
    return ((q + 1) * blocks + T - 1) // T - 1


def stage_pixels(C):
    """Pixels a ring stage holds: at most 64 KB of x, in whole 128-pixel
    blocks."""
    return STAGE_BYTES // (4 * C) // 128 * 128


def groups(P):
    """Channel groups: P up to 12 in one, up to 24 in two, up to 32 in
    four."""
    return 1 if P <= 12 else 2 if P <= 24 else 4


def group_width(P):
    """Output channels a consumer thread computes: ceil(P / groups) rounded
    up to a multiple of 4, at most 12."""
    return (-(-P // groups(P)) + 3) // 4 * 4


def pixels_per_thread(P):
    """Pixels a consumer thread blocks: 4 in several groups of 8 channels,
    else 2."""
    return 4 if groups(P) > 1 and group_width(P) <= 8 else 2


def stage_groups(n, kpix):
    """The first pixels of a stage's pixel groups, in thread order: group q
    is pixels first + 32 i, i < kpix, first = 32 kpix (q // 32) + q % 32
    (pixel i valid if < n)."""
    block = 32 * kpix
    q = torch.arange(32 * (n // block) + min(n % block, 32))
    return (q // 32) * block + q % 32


def fused_split_reference(x, weight, bias, blocks, eps: float = 1e-6):
    """The kernel's reduction on the CPU: the same blocks, items, stages,
    pixel groups and threads, pushed and merged in the kernel's order with
    its log2-unit arithmetic (online_stats) -> (R, P, 2)."""
    R, H, W, C = x.shape
    P = weight.shape[1]
    HW, T = H * W, R * H * W
    TG = CONSUMER_THREADS // groups(P)  # threads of one channel group
    kpix = pixels_per_thread(P)
    SP = stage_pixels(C)
    xf = x.reshape(R, HW, C).float()
    w2, b2 = weight.float() * ost.LOG2E, bias.float() * ost.LOG2E
    slots = {}
    for b, items in enumerate(fused_work(R, HW, blocks)):
        for row, begin, end in items:
            st = ost.empty((TG, P))
            for s in range(begin, end, SP):
                n = min(SP, end - s)
                logits = torch.full((SP + 32 * kpix, P), -float("inf"))
                logits[:n] = xf[row, s:s + n] @ w2 + b2
                first = stage_groups(n, kpix)
                pix = first[:, None] + 32 * torch.arange(kpix)
                grouped = logits[pix].transpose(1, 2)  # (groups, P, kpix)
                f = pix + s
                fx, fy = f % W, f // W
                for q0 in range(0, len(first), TG):  # a thread's rounds
                    q = slice(q0, q0 + TG)
                    k = grouped[q].shape[0]
                    got = ost.push_group(
                        tuple(t[:k] for t in st), grouped[q],
                        fx[q, None].float(), fy[q, None].float())
                    st = tuple(torch.cat([g, t[k:]]) for g, t in zip(got,
                                                                     st))
            warps = ost.warp_merge2(
                tuple(t.reshape(TG // WARP, WARP, P) for t in st), 1)
            part = ost.empty((P,))
            for v in range(TG // WARP):
                part = ost.merge2(part, tuple(t[v] for t in warps))
            slots[b + row] = part
    out = []
    for row in range(R):
        first = block_of(row * HW, T, blocks)
        last = block_of(row * HW + HW - 1, T, blocks)
        st = ost.empty((P,))
        for v in range(first, last + 1):
            st = ost.merge2(st, slots[v + row])
        out.append(ost.finish(st, eps))
    return torch.stack(out)


# ---- the kernel

# (device, stream) -> the rows' arrival counters, zero between calls
_ARRIVALS = {}
_ARRIVALS_LOCK = threading.Lock()


def _arrivals(device, stream, R):
    """The kernel's per-row arrival counters for calls on `stream` (a
    cudaStream_t as an int): zeroed once, on that stream, and grown when R
    grows; each call's last block of a row sets its counter back to 0. The
    calls of one stream run in order and share the buffer; calls on two
    streams may overlap, so each stream has its own."""
    key = (device, stream)
    with _ARRIVALS_LOCK:
        buf = _ARRIVALS.get(key)
        if buf is None or buf.numel() < R:
            buf = torch.zeros(max(R, 256), dtype=torch.int32, device=device)
            _ARRIVALS[key] = buf
    return buf


def _library():
    lib = _build.load("fused_predict")
    fn = lib.fused_predict_launch
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [i32] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = i32
        lib.fused_predict_items.argtypes = [i32] * 4 + [ctypes.c_void_p, i32]
        for name, n in (("fused_predict_blocks", 2),
                        ("fused_predict_stage_pixels", 1),
                        ("fused_predict_group_width", 1),
                        ("fused_predict_pixels_per_thread", 1),
                        ("fused_predict_smem_bytes", 2)):
            getattr(lib, name).argtypes = [i32] * n
            getattr(lib, name).restype = i32
    return lib


def library_split(R, HW, blocks):
    """The library's own work split (fused_predict_items), for holding
    fused_work against it on the card."""
    lib = _library()
    work = []
    for b in range(blocks):
        n = lib.fused_predict_items(R, HW, blocks, b, None, 0)
        buf = (ctypes.c_int * 3 * n)()
        lib.fused_predict_items(R, HW, blocks, b, buf, n)
        work.append([tuple(buf[k]) for k in range(n)])
    return work


def fused_predictor_softargmax(x, weight, bias, eps: float = 1e-6):
    """(R, H, W, C) activations, (C, P) weight, (P,) bias -> (R, P, 2).

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel, which needs f32 everywhere, x contiguous in NHWC order (the
    NHWC view of a channels_last NCHW tensor), P <= 32 and C <= 128;
    anything else raises.
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
    if not 1 <= P <= MAX_CHANNELS or not 1 <= C <= MAX_IN_CHANNELS:
        raise ValueError(f"fused_predictor_softargmax: P={P}, C={C}; the "
                         f"kernel takes P in [1, {MAX_CHANNELS}] and C in "
                         f"[1, {MAX_IN_CHANNELS}]")
    HW = H * W
    blocks = fused_blocks(R, HW, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    part = torch.empty((R + blocks - 1, P, 4), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((R, P, 2), dtype=torch.float32, device=x.device)
    launch = _library().fused_predict_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                     part.data_ptr(),
                     _arrivals(x.device, stream, R).data_ptr(),
                     out.data_ptr(), R, HW, W, C, P, blocks, float(eps),
                     stream)
    if err != 0:
        raise RuntimeError(f"fused_predict kernel launch failed: error {err}"
                           " (a cudaError_t; 999: no cuTensorMapEncodeTiled;"
                           " 1000 + CUresult: a refused tensor map)")
    fused_predictor_softargmax.launches += 1
    return out


fused_predictor_softargmax.launches = 0
