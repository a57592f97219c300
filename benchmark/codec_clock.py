"""Host seconds inside the program's HDF5 writer (a frozen copy of
``chip_smoke._CodecClock``)."""

from __future__ import annotations

import functools
import time


class CodecClock:
    """Seconds spent inside the HDF5 codec's writes (``Dataset.__setitem__``,
    ``Group.create_dataset``) and ``File.close`` while it is installed; a call inside
    another (create_dataset's data) counts once."""

    def __init__(self):
        from kwave_tpu_torch.io import h5file

        self.seconds = {"writes": 0.0, "close": 0.0}
        self._depth = 0
        self._saved = [(cls, name, getattr(cls, name), kind) for cls, name, kind in (
            (h5file.Dataset, "__setitem__", "writes"),
            (h5file.Group, "create_dataset", "writes"),
            (h5file.File, "close", "close"))]

    def _timed(self, fn, kind):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds[kind] += time.perf_counter() - t0
        return call

    def total(self) -> float:
        return self.seconds["writes"] + self.seconds["close"]

    def __enter__(self):
        for cls, name, fn, kind in self._saved:
            setattr(cls, name, self._timed(fn, kind))
        return self

    def __exit__(self, *exc):
        for cls, name, fn, _ in self._saved:
            setattr(cls, name, fn)
