"""The builders' native windowing kernel (trajwin.cc) with ctypes bindings
(counterpart of mst_tpu/native/__init__.py).

`window_trajectories` fuses split_fragmented -> downsample ->
filter_short_trajectories -> sliding_window into one linear scan over the
annotation rows; data/trajectories.window_chain is its plain pandas
version. The port keeps its own copy of the C++ source. The host compiler
(g++) builds it at first use into build/mst_tpu_torch/,
under a name that carries a hash of the source and flags, so an edited
source rebuilds. A failed build or load raises with the compiler's
output: there is no quiet fallback to pandas.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "trajwin.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "mst_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
CXX = "g++"

_LIB = {}  # (compiler, library path) -> the loaded library


def _target() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtrajwin_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile trajwin.cc unless its library exists -> the library's path.
    Raises RuntimeError with the compiler's output when it fails or is
    missing."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the host compiler {CXX!r} to build "
                           f"{SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a file
    return target


def load_lib() -> ctypes.CDLL:
    """The native library, built on first use (raises if it cannot be)."""
    target = _target()
    lib = _LIB.get((CXX, target))
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.trajwin_count.restype = ctypes.c_int64
    lib.trajwin_count.argtypes = [i64p, i64p, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64]
    lib.trajwin_fill.restype = None
    lib.trajwin_fill.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, i64p]
    lib.trajwin_gather_xy.restype = None
    lib.trajwin_gather_xy.argtypes = [f64p, f64p, i64p, ctypes.c_int64,
                                      ctypes.c_int64, f32p]
    _LIB[(CXX, target)] = lib
    return lib


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def window_trajectories(meta_ids, frames, step, window_size, stride,
                        split_fragments=True):
    """One-pass window extraction.

    meta_ids, frames: int arrays, rows grouped by metaId in appearance
    order, frames ascending within a group. step: the downsample stride;
    window_size, stride: the sliding window's. split_fragments: start a new
    track at a frame gap (SDD yes, inD no).

    -> (row indices (n_win, window_size) int64, n_win): window w's rows;
    the new metaId of window w is w (the appearance-order factorization of
    the pandas chain).
    """
    meta = _i64(meta_ids)
    frame = _i64(frames)
    if meta.ndim != 1 or meta.shape != frame.shape:
        raise ValueError(f"meta_ids {meta.shape} and frames {frame.shape} "
                         "must be 1-D and of one length")
    if min(step, window_size, stride) < 1:
        raise ValueError(f"step {step}, window_size {window_size} and "
                         f"stride {stride} must be at least 1")
    lib = load_lib()
    n = len(meta)
    pm, pf = _ptr(meta, ctypes.c_int64), _ptr(frame, ctypes.c_int64)
    n_win = lib.trajwin_count(pm, pf, n, int(split_fragments), step,
                              window_size, stride)
    out = np.empty((n_win, window_size), np.int64)
    lib.trajwin_fill(pm, pf, n, int(split_fragments), step, window_size,
                     stride, _ptr(out, ctypes.c_int64))
    return out, int(n_win)


def gather_xy(x, y, row_indices):
    """(n_win, window) row indices -> the (n_win, window, 2) float32
    trajectories."""
    xx = np.ascontiguousarray(x, np.float64)
    yy = np.ascontiguousarray(y, np.float64)
    idx = _i64(row_indices)
    if xx.ndim != 1 or xx.shape != yy.shape or idx.ndim != 2:
        raise ValueError(f"x {xx.shape} and y {yy.shape} must be 1-D and of "
                         f"one length, row_indices {idx.shape} 2-D")
    if idx.size and (idx.min() < 0 or idx.max() >= len(xx)):
        raise ValueError(f"row indices outside [0, {len(xx)})")
    lib = load_lib()
    n_win, window = idx.shape
    out = np.empty((n_win, window, 2), np.float32)
    lib.trajwin_gather_xy(_ptr(xx, ctypes.c_double),
                          _ptr(yy, ctypes.c_double),
                          _ptr(idx, ctypes.c_int64), n_win, window,
                          _ptr(out, ctypes.c_float))
    return out


def load_and_window_native(df, step, window_size, stride,
                           split_fragments=True):
    """The DataFrame of trajectories.window_chain(df, ...) in one native
    pass: the windows' rows with re-factorized metaIds."""
    idx, n_win = window_trajectories(df["metaId"].to_numpy(),
                                     df["frame"].to_numpy(), step,
                                     window_size, stride, split_fragments)
    out = df.iloc[idx.reshape(-1)].copy()
    out["metaId"] = np.repeat(np.arange(n_win, dtype=np.int64), window_size)
    return out.reset_index(drop=True)
