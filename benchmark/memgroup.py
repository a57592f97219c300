"""An in-memory output group: the subset of h5py's Group that the program's writers use
(a frozen copy of ``chip_smoke.MemGroup``), so that a job's output stays in host memory."""

from __future__ import annotations

import numpy as np


class MemAttrs(dict):
    def create(self, name, value):
        self[name] = value


class MemDataset:
    """The subset of h5py.Dataset that the program's writers use, over a numpy array."""

    def __init__(self, shape, dtype, data=None):
        self.data = np.array(data) if data is not None else np.zeros(shape, dtype)
        self.attrs = MemAttrs()

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value


class MemGroup:
    """The subset of h5py.Group that the program's writers use, held in memory."""

    def __init__(self):
        self.items = {}
        self.attrs = MemAttrs()

    def create_dataset(self, name, shape=None, dtype=None, data=None, chunks=None,
                       compression=None, compression_opts=None):
        self.items[name] = MemDataset(shape, dtype, data)
        return self.items[name]

    def create_group(self, name):
        self.items[name] = MemGroup()
        return self.items[name]

    def __getitem__(self, name):
        return self.items[name]

    def __contains__(self, name):
        return name in self.items

    def __delitem__(self, name):
        del self.items[name]

    def keys(self):
        return self.items.keys()
