"""The track table: the rows of trajectories that the data pipeline and the
Experiment loop read, as numpy columns.

The JAX package passes a pandas DataFrame around (columns x, y, frame,
trackId, sceneId, metaId, label); the port keeps the five columns the loop
reads, under the same names, so that it needs no pandas. A DataFrame
becomes a table at the edges only (`Tracks.from_frame`, and the pickle
readers of data/splits.py).
"""

import dataclasses

import numpy as np


def unique_in_order(a):
    """The distinct values of a 1-d array in order of first appearance (as
    pandas' Series.unique)."""
    a = np.asarray(a)
    if not len(a):
        return a
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


@dataclasses.dataclass
class Tracks:
    """One row per (trajectory, frame); a trajectory's rows are consecutive
    and in time order. metaId int64, sceneId str (an object array), frame,
    x and y keep the dtypes they came with."""
    metaId: np.ndarray
    sceneId: np.ndarray
    frame: np.ndarray
    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        self.metaId = np.asarray(self.metaId, np.int64)
        self.sceneId = np.asarray(self.sceneId, object)
        self.frame = np.asarray(self.frame)
        self.x = np.asarray(self.x)
        self.y = np.asarray(self.y)

    @classmethod
    def from_frame(cls, df):
        """A DataFrame (or any mapping of columns) -> its table."""
        if len(df) == 0:
            return cls.empty()
        return cls(**{f.name: np.asarray(df[f.name])
                      for f in dataclasses.fields(cls)})

    @classmethod
    def empty(cls):
        return cls(np.zeros(0, np.int64), np.zeros(0, object),
                   np.zeros(0, np.int64), np.zeros(0), np.zeros(0))

    @classmethod
    def concat(cls, tables):
        tables = [t for t in tables if t is not None]
        if not tables:
            return cls.empty()
        return cls(**{f.name: np.concatenate([getattr(t, f.name)
                                              for t in tables])
                      for f in dataclasses.fields(cls)})

    def __len__(self):
        return len(self.metaId)

    def take(self, rows):
        """The rows a boolean mask or an index array selects."""
        return Tracks(**{f.name: getattr(self, f.name)[rows]
                         for f in dataclasses.fields(self)})

    def replace(self, **columns):
        return dataclasses.replace(self, **columns)

    def meta_ids(self):
        """Distinct metaIds in order of first appearance."""
        return unique_in_order(self.metaId)

    def scene_ids(self):
        """Distinct sceneIds in order of first appearance."""
        return unique_in_order(self.sceneId)
