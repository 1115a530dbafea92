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

import torch

# (wrapper, count name) -> launches recorded by the capture in progress
_CAPTURED = collections.Counter()


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
        whose tensors each replay rewrites in place."""
        _CAPTURED.clear()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                out = fn()
            self.per_replay = dict(_CAPTURED)
        finally:
            _CAPTURED.clear()
        return out

    def replay(self):
        self.graph.replay()
        for (fn, name), n in self.per_replay.items():
            setattr(fn, name, getattr(fn, name) + n)
