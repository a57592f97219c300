"""Output-file layout: raw/aggregated/compressed stream datasets and cuboid groups (port
of `kwave_tpu.io.output_file`).

- Index-mask streams: 3D dataset (1, steps, mSize): raw `(Nt-s)` rows, compressed
  `Nc = max(floor((Nt-s)/oSize), 1)` rows of `mSize = ceil(Nsens*complexSize)*H` floats;
  chunk one row, capped at 1M elements (IndexOutputStream.cpp:87-171).
- Compression attributes on every `_c` dataset: c_harmonics, c_type="c", c_period, c_mos,
  c_shift, c_complex_size, c_max_exp (IndexOutputStream.cpp:147-157).
- Cuboid streams: a group of per-cuboid 4D datasets "1", "2", ... of dims
  (Nc|steps, nz, ny, nx*H*complexSize), chunked by timestep slab
  (CuboidOutputStream.cpp:656-722).
- Aggregates (rms/max/min/_final/_all): plain 3D datasets of the buffer size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from kwave_tpu_torch.io import names
from kwave_tpu_torch.io.h5file import File
from kwave_tpu_torch.io.hdf5 import create_dataset, write_attr, write_file_header

CHUNK_4MB = 1048576  # floats (kChunkSize4MB, BaseOutputStream.h:289)


@dataclasses.dataclass(frozen=True)
class CompressionAttrs:
    """The c_* attribute block (IndexOutputStream.cpp:147-157)."""

    harmonics: int
    period: float
    mos: int
    shift: bool  # stream uses shifted basis tables
    complex_size: float  # 2.0 (64-bit complex) | 1.25 (40-bit)
    max_exp: int  # kMaxExpP=138 | kMaxExpU=114

    def write(self, parent, name: str) -> None:
        write_attr(parent[name], "c_harmonics", int(self.harmonics))
        write_attr(parent[name], "c_type", "c")
        write_attr(parent[name], "c_period", float(self.period))
        write_attr(parent[name], "c_mos", int(self.mos))
        write_attr(parent[name], "c_shift", int(self.shift))
        write_attr(parent[name], "c_complex_size", float(self.complex_size))
        write_attr(parent[name], "c_max_exp", int(self.max_exp))

    @property
    def o_size(self) -> int:
        return int(self.period * self.mos)  # CompressHelper.cpp:50

    def coeff_row_size(self, n_sensors: int) -> int:
        """mSize = ceil(Nsens * complexSize) * harmonics (IndexOutputStream.cpp:91-93)."""
        return int(math.ceil(n_sensors * self.complex_size)) * self.harmonics

    def compressed_steps(self, sampled_steps: int) -> int:
        """Nc = max(floor(steps / oSize), 1) (IndexOutputStream.cpp:111-117)."""
        return max(sampled_steps // self.o_size, 1)


def create_output_file(path: str):
    """Open ``path`` for writing as an HDF5 output file with the reference header."""
    f = File(path, "w")
    write_file_header(f, names.FILE_TYPE_OUTPUT)
    return f


def _row_chunk(row: int) -> tuple[int, int, int]:
    """Chunk (1, 1, row) capped at 1M elements (IndexOutputStream.cpp:119-125)."""
    return (1, 1, CHUNK_4MB if row > CHUNK_4MB * 8 else row)


def create_raw_dataset(f, name: str, n_points: int, n_steps: int,
                       compression_level: int = 0):
    """Raw time-series dataset: file dims (1, steps, n_points)."""
    return create_dataset(
        f, name, (1, n_steps, n_points), chunks=_row_chunk(n_points),
        compression_level=compression_level,
    )


def create_compressed_dataset(f, name: str, n_sensors: int, sampled_steps: int,
                              attrs: CompressionAttrs, compression_level: int = 0):
    """Compressed coefficient dataset `<name>_c`: (1, Nc, mSize) with c_* attrs and
    domain_type=complex."""
    row = attrs.coeff_row_size(n_sensors)
    ds = create_dataset(
        f, name, (1, attrs.compressed_steps(sampled_steps), row),
        chunks=_row_chunk(row), compression_level=compression_level,
        domain=names.DOMAIN_COMPLEX,
    )
    attrs.write(f, name)
    return ds


def create_aggregate_dataset(f, name: str, n_points: int, compression_level: int = 0):
    """Per-sensor rms/max/min buffers: (1, 1, n)."""
    return create_dataset(f, name, (1, 1, n_points), chunks=_row_chunk(n_points),
                          compression_level=compression_level)


def create_field_dataset(f, name: str, field_shape: tuple[int, ...],
                         compression_level: int = 0):
    """Whole-domain dataset (`*_max_all`/`*_min_all`/`*_final`): dims (nz, ny, nx) with
    one-z-slab chunks (WholeDomainOutputStream.cpp:78-99)."""
    shape = (1,) * (3 - len(field_shape)) + tuple(field_shape)  # 2D fields get nz=1
    return create_dataset(f, name, shape, chunks=(1,) + shape[1:],
                          compression_level=compression_level)


def create_cuboid_group(
    f,
    name: str,
    cuboid_shapes: list[tuple[int, int, int]],  # (nx, ny, nz) per cuboid
    n_steps: int,
    attrs: Optional[CompressionAttrs] = None,
    compression_level: int = 0,
):
    """Group of per-cuboid 4D datasets "1", "2", ... with dims
    (steps, nz, ny, nx*H*complexSize) and slab chunking (CuboidOutputStream.cpp:656-722)."""
    grp = f.create_group(name)
    for i, (cx, cy, cz) in enumerate(cuboid_shapes):
        if attrs is not None:
            row_x = int(math.ceil(cx * attrs.complex_size)) * attrs.harmonics
            steps = attrs.compressed_steps(n_steps)
        else:
            row_x = cx
            steps = n_steps
        slab = row_x * cy * cz
        # >=4MB slab-split rule (CuboidOutputStream.cpp:679-690): chunk a z-sub-slab
        if slab > CHUNK_4MB * 8:
            nz_chunk = max(CHUNK_4MB // (row_x * cy), 1)
            chunks = (1, nz_chunk, cy, row_x)
        else:
            chunks = (1, cz, cy, row_x)
        create_dataset(
            grp, str(i + 1), (steps, cz, cy, row_x), chunks=chunks,
            compression_level=compression_level,
            domain=names.DOMAIN_COMPLEX if attrs is not None else names.DOMAIN_REAL,
        )
        if attrs is not None:
            attrs.write(grp, str(i + 1))
    return grp


def write_frame(ds, row: int, data) -> None:
    """One row at compressed / sampled step ``row`` of a stream's dataset (a file's
    dataset or any object with its ``shape`` and item assignment): the (1, steps, mSize) layout
    of an index mask, or a cuboid's 4D one (IndexOutputStream::flushBufferToFile,
    IndexOutputStream.cpp:583-591)."""
    if len(ds.shape) == 3:
        ds[0, row, :] = np.asarray(data).reshape(-1)
    else:
        ds[row, ...] = np.asarray(data).reshape(ds.shape[1:])


def write_frames(ds, start_row: int, data) -> None:
    """A contiguous block of rows from ``start_row`` (``data`` leads with the rows)."""
    data = np.asarray(data)
    n = data.shape[0]
    if len(ds.shape) == 3:
        ds[0, start_row:start_row + n, :] = data.reshape(n, -1)
    else:
        ds[start_row:start_row + n, ...] = data.reshape((n,) + tuple(ds.shape[1:]))


def write_aggregate(ds, data) -> None:
    """An aggregate (rms / max / min / final / whole-domain) into its dataset's shape."""
    ds[...] = np.asarray(data).reshape(ds.shape)
