"""Throughput counter (counterpart of mst_tpu/utils/profiling.py:28-51) and
the port's spans.

`span(name)` marks a stretch of the program: the eval step's forward,
its model and sampling parts, k-means, a train step's forward, backward
and optimizer. It records only while a torch.profiler session records
(torch.autograd._profiler_enabled()) or inside `recording()`; otherwise
it costs one check and does nothing else: no record, no CUDA event, no
record_function. It never records while torch.compile or torch.export
traces the program, nor while the current stream captures a CUDA graph,
so the exported programs and the captured epochs hold none of it.

A recorded span holds its name, the index of the enclosing span
(`parent`), its `request` (the index of its top-level span, shared by
every span under it), its host start and end in Unix nanoseconds
(time.time_ns(), the clock of torch.profiler's events, so a stretch of
the device trace can be put down to the span the host was in), a
record_function range of its name (it nests in an exported chrome
trace), and on CUDA two timing events on the current stream, resolved
only by `spans()`. `note(key, value)` attaches a value to the innermost
open span; a device tensor is kept as it is and read by `spans()`. The
finished spans are kept in a bounded deque (MAX_SPANS); `clear()`
empties it.
"""

import collections
import contextlib
import itertools
import threading
import time

import torch


class ThroughputMeter:
    """Counts trajectories and scene-batches per second over a window."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.n_traj = 0.0
        self.n_batches = 0

    def update(self, n_traj, n_batches=1):
        self.n_traj += float(n_traj)
        self.n_batches += n_batches

    @property
    def elapsed(self):
        return time.perf_counter() - self._t0

    def rates(self):
        dt = max(self.elapsed, 1e-9)
        return {"traj_per_sec": self.n_traj / dt,
                "batches_per_sec": self.n_batches / dt,
                "seconds": dt}


MAX_SPANS = 4096
_OFF = contextlib.nullcontext()


class SpanRecorder:
    """The finished spans, the open ones of each thread, and how many
    `recording()` blocks are open."""

    def __init__(self):
        self.finished = collections.deque(maxlen=MAX_SPANS)
        self.forced = 0
        self.lock = threading.Lock()
        self.indices = itertools.count()
        self.local = threading.local()

    def open_spans(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


RECORDER = SpanRecorder()


class _Span:
    __slots__ = ("name", "index", "parent", "request", "attrs", "start_ns",
                 "end_ns", "events", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = RECORDER.open_spans()
        self.index = next(RECORDER.indices)
        self.parent = stack[-1].index if stack else None
        self.request = stack[0].index if stack else self.index
        self.attrs = {}
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        RECORDER.open_spans().pop()
        self.range.__exit__(*exc)
        if self.events is not None:
            self.events[1].record()
        with RECORDER.lock:
            RECORDER.finished.append(self)
        return False


def span(name):
    """A context manager marking a stretch of the program as `name`
    (the module docstring)."""
    if not (RECORDER.forced or torch.autograd._profiler_enabled()):
        return _OFF
    if torch.compiler.is_compiling() or (
            torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _Span(name)


def note(key, value):
    """Attach `value` to the innermost open span as attrs[key]; nothing
    where no span records."""
    stack = getattr(RECORDER.local, "stack", None)
    if stack and not torch.compiler.is_compiling():
        stack[-1].attrs[key] = value


@contextlib.contextmanager
def recording():
    """Record spans inside, with or without a profiler."""
    with RECORDER.lock:
        RECORDER.forced += 1
    try:
        yield
    finally:
        with RECORDER.lock:
            RECORDER.forced -= 1


def clear():
    with RECORDER.lock:
        RECORDER.finished.clear()


def spans():
    """The finished spans in the order they opened, each a dict: name,
    index, parent, request, start_ns, end_ns, device_ms (the current
    stream's time from the span's first event to its second on CUDA,
    its host duration elsewhere) and attrs (a tensor read as its one
    number). Waits for the device where an event has not completed."""
    with RECORDER.lock:
        finished = sorted(RECORDER.finished, key=lambda s: s.index)
    out = []
    for s in finished:
        if s.events is None:
            device_ms = (s.end_ns - s.start_ns) * 1e-6
        else:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "index": s.index, "parent": s.parent,
                    "request": s.request, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "device_ms": device_ms,
                    "attrs": {k: v.item() if isinstance(v, torch.Tensor)
                              else v for k, v in s.attrs.items()}})
    return out
