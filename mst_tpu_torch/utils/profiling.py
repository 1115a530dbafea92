"""Throughput counter (counterpart of mst_tpu/utils/profiling.py:28-51)."""

import time


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
