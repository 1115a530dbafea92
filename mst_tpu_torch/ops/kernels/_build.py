"""Build the CUDA C++ kernels of `mst_tpu_torch/csrc` for Hopper.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
sm_90a into its own shared library, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go to `build/mst_tpu_torch/` beside
the package; the file name carries a hash of the sources and flags, so an
edited source rebuilds. Nothing happens at import: the first call to
`load` builds.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "mst_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH or "
                           "/usr/local/cuda); the CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return path


def _sources(name):
    srcs = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    return [s for s in srcs if s.exists()]


def _target(name) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names):
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns {name: log}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {}
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, target)  # atomic: a reader never sees half a file
        logs[name] = out
    return logs


def load(name) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
