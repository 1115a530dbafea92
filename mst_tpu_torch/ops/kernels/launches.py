"""Launch counts of the kernel wrappers that stay true under CUDA graphs.

Each wrapper keeps plain integer counts on its function object
(`launches`, and `launches_bf16` for the serving kernels' bf16
instantiations) and calls `count` where it launches its kernel. A launch
made while the current stream captures a CUDA graph does not run then: it
runs once each time the graph is replayed. So `count` holds it aside for
the capture in progress, and a `Graph` adds what its capture recorded to
the wrappers' counts on every replay. A count is then the number of
kernel executions, whichever way a path reaches the card.
"""

import collections
import gc
import weakref

import torch

# (wrapper, count name) -> launches recorded by the capture in progress
_CAPTURED = collections.Counter()
# every Graph that holds a captured graph, until it is released
_LIVE = weakref.WeakSet()


def count(fn, name="launches"):
    """One launch of fn's kernel, counted in fn.<name> now, or once each
    replay of the graph being captured."""
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[fn, name] += 1
    else:
        setattr(fn, name, getattr(fn, name) + 1)


class Graph:
    """A torch.cuda.CUDAGraph whose replays count the wrappers' launches
    that its capture recorded (`per_replay`: {(wrapper, count name): n})."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.per_replay = {}

    def capture(self, fn, stream):
        """fn() captured on `stream` (the stream its warm-up ran on, where
        the wrappers' per-stream buffers already exist) -> fn's output,
        whose tensors each replay rewrites in place. Python's garbage
        collector stays off while fn() is captured, and the capture
        forbids unsafe CUDA calls in this thread only: a collection could
        run the destructor of an object that holds CUDA resources (an
        earlier run's graph, mesh or process group) inside the capture,
        and NCCL's watchdog thread polls the events of the collectives
        the warm-up enqueued, either of which invalidates a capture (seen
        on the card in two of three runs of a spatial --fused epoch after
        three other flows in one process, whose warm-up enqueues dozens
        of halo all-reduces)."""
        _CAPTURED.clear()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
            self.per_replay = dict(_CAPTURED)
        finally:
            gc.enable()
            _CAPTURED.clear()
        _LIVE.add(self)
        return out

    def replay(self):
        self.graph.replay()
        for (fn, name), n in self.per_replay.items():
            setattr(fn, name, getattr(fn, name) + n)


def release_graphs():
    """Free every captured graph still alive: no Graph replays after this
    (its per_replay stays). NCCL cannot destroy a communicator while a
    CUDA graph that captured its collectives lives, so a world's teardown
    does this first (parallel/mesh.shutdown)."""
    for graph in list(_LIVE):
        graph.graph.reset()
        _LIVE.discard(graph)
