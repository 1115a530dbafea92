"""What every cell's run shares: finding a cell's files by name, the
run's environment, the card check, the profiler's trace reduced to busy
time, idle gaps and kernel time by name, host synchronisations counted,
the check that nothing of jax or the JAX package was loaded, and the
result line.
"""

import collections
import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import warnings

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# compared by whole top-level name: mst_tpu_torch is the port, not these
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mst_tpu"})


class RunError(Exception):
    """A run that cannot give a result: it exits non-zero, with no
    result line."""


def read_json(kind, name):
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """portbench/<kind>/<name>.py as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_environment():
    """Caches inside the checkout at fixed paths, no library loading JAX
    behind the port's back, and one host thread for CPU operators: the
    timed loops wait on the card, and idle worker threads spinning on the
    host's shared cores only add jitter."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = CHECKOUT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


META_KEYS = frozenset({"source", "assumed", "reduced", "deployment"})


def run_config(config, cell):
    """The configuration a run uses: the configuration file's settings
    with the cell's overrides (a serving cell's test-time sampling)."""
    out = {k: v for k, v in config.items() if k not in META_KEYS}
    out.update(cell.get("overrides", {}))
    return out


def program_params(cfg):
    """The program's flat params dict for a run configuration: its
    defaults, then the configuration. The scene maps a request carries
    are already segmented, so no backbone runs."""
    from mst_tpu_torch.config import get_params

    return get_params(overrides={**cfg, "segmentation_model_fp": None})


def require_cards(torch, chips):
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} are present")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line(torch):
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unreadable"
    return f"card: {torch.cuda.get_device_name(0)} ({smi})"


@contextlib.contextmanager
def count_syncs(torch, counts):
    """Append to `counts` the host synchronisations made inside, as
    torch.cuda.set_sync_debug_mode('warn') reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts.append(sum("synchroniz" in str(w.message) for w in caught))


def _ns(e, which):
    return getattr(e, f"{which}_ns")() if hasattr(e, f"{which}_ns") \
        else 1000 * getattr(e, f"{which}_us")()


class Trace:
    """A torch.profiler run over a traced window, reduced: every device
    activity (kernels, copies, sets) as (start, end, name) in seconds, the
    host operators likewise. The window runs from the first recorded
    event to the last."""

    def __init__(self, torch, prof):
        dev_type = torch.autograd.DeviceType
        self.device, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            start = _ns(e, "start") * 1e-9
            item = (start, start + _ns(e, "duration") * 1e-9, e.name())
            if e.device_type() == dev_type.CUDA:
                self.device.append(item)
            elif e.device_type() == dev_type.CPU:
                self.host.append(item)
        self.device.sort()
        every = self.device + self.host
        self.t0 = min(s for s, _, _ in every) if every else 0.0
        self.t1 = max(e for _, e, _ in every) if every else 0.0

    @property
    def window_s(self):
        return self.t1 - self.t0

    def busy_intervals(self):
        merged = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, part):
        """Device seconds of the activities whose name holds `part`."""
        return sum(e - s for s, e, n in self.device if part in n)

    def top_ops(self, n=10):
        by = collections.Counter()
        for s, e, name in self.device:
            by[name[:120]] += e - s
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """The longest stretches with nothing on the device, each named by
        the innermost host operator running at its start."""
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] \
            + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        out = []
        for length, at in sorted(gaps, reverse=True)[:n]:
            covering = [(e - s, name) for s, e, name in self.host
                        if s <= at < e]
            out.append([min(covering)[1][:120] if covering else "host idle",
                        length])
        return out


def print_checks(checks):
    """Each compared number beside its limit, on standard error."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)

