"""Low-level HDF5 helpers reproducing the reference's encodings (port of
`kwave_tpu.io.hdf5`; Hdf5/Hdf5File.cpp).

- Scalars: (1,1,1)-shaped datasets, u64 for sizes/flags, float32 for physics scalars.
- Datasets: chunked, gzip-deflate at the run's compression level, tagged with fixed-length
  `data_type` ("float"|"long") and `domain_type` ("real"|"complex") attributes.
- File header: root-group string attributes (Hdf5FileHeader.cpp:62-88).

Every function takes an open group-like object; only `open_group`, given a path,
imports h5py.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
from typing import Optional

import numpy as np

from kwave_tpu_torch.io import names

CREATED_BY = "kwave_tpu_torch v0.1"


@contextlib.contextmanager
def open_group(target, mode: str):
    """``target`` as an open group. A path is opened with h5py in ``mode`` and closed on
    exit; an open group-like object is passed through and stays the caller's. Mode "w"
    empties such an object first, as it truncates a file."""
    if isinstance(target, (str, os.PathLike)):
        import h5py

        with h5py.File(os.fspath(target), mode) as f:
            yield f
        return
    if mode == "w":
        for k in list(target.keys()):
            del target[k]
        target.attrs.clear()
    yield target


def is_group(obj) -> bool:
    """A group (per-cuboid layout) rather than a dataset, by what it can do: works on
    h5py objects and on in-memory stand-ins alike."""
    return hasattr(obj, "keys")


def group_datasets(grp) -> list:
    """The per-cuboid datasets "1", "2", ... of a cuboid group, in order."""
    return [grp[k] for k in sorted(grp.keys(), key=int)]


def read_flat(obj) -> np.ndarray:
    """A dataset, or a cuboid group's datasets concatenated, as one flat float32 array
    (cuboid-concatenated point order, x fastest: the sensor mask's order)."""
    if is_group(obj):
        return np.concatenate([np.asarray(d[...], np.float32).reshape(-1)
                               for d in group_datasets(obj)])
    return np.asarray(obj[...], np.float32).reshape(-1)


def _fixed_str(value: str) -> np.bytes_:
    """Fixed-length C string attribute (the reference writes H5T_C_S1 of exact size)."""
    return np.bytes_(value.encode())


def write_attr(obj, name: str, value) -> None:
    if isinstance(value, str):
        obj.attrs.create(name, _fixed_str(value))
    elif isinstance(value, (int, np.integer)):
        obj.attrs.create(name, np.int64(value))  # writeLongLongAttribute (ssize_t)
    elif isinstance(value, (float, np.floating)):
        obj.attrs.create(name, np.float32(value))  # writeFloatAttribute
    else:
        obj.attrs.create(name, value)


def read_attr(obj, name: str):
    v = obj.attrs[name]
    if isinstance(v, bytes):
        return v.decode()
    return v


def write_scalar(f, name: str, value, dtype=None) -> None:
    """(1,1,1) scalar dataset; u64 for ints, float32 for floats."""
    if dtype is None:
        dtype = np.uint64 if isinstance(value, (int, np.integer)) else np.float32
    arr = np.full((1, 1, 1), value, dtype=dtype)
    ds = f.create_dataset(name, data=arr)
    tag_dataset(ds, data=names.DATA_FLOAT if dtype == np.float32 else names.DATA_LONG)


def read_scalar(f, name: str):
    v = np.asarray(f[name][...]).reshape(-1)[0]
    return int(v) if np.issubdtype(v.dtype, np.integer) else float(v)


def tag_dataset(ds, data: str = names.DATA_FLOAT, domain: str = names.DOMAIN_REAL) -> None:
    """data_type / domain_type attributes (Hdf5File.cpp:896-917)."""
    ds.attrs.create(names.DATA_TYPE, _fixed_str(data))
    ds.attrs.create(names.DOMAIN_TYPE, _fixed_str(domain))


def create_dataset(
    f,
    name: str,
    shape: tuple[int, ...],
    chunks: Optional[tuple[int, ...]] = None,
    compression_level: int = 0,
    dtype=np.float32,
    domain: str = names.DOMAIN_REAL,
):
    """Chunked, gzip-deflated dataset with type tags (Hdf5File::createDataset,
    Hdf5File.cpp:321-367). Shapes are C-order (slowest first)."""
    kwargs = {}
    if chunks is not None:
        kwargs["chunks"] = tuple(min(c, s) if s > 0 else c for c, s in zip(chunks, shape))
    if compression_level > 0:
        kwargs["compression"] = "gzip"
        kwargs["compression_opts"] = compression_level
    ds = f.create_dataset(name, shape=shape, dtype=dtype, **kwargs)
    tag_dataset(
        ds,
        data=names.DATA_FLOAT if dtype == np.float32 else names.DATA_LONG,
        domain=domain,
    )
    return ds


def write_file_header(f, file_type: str, major: str = "1", minor: str = "1") -> None:
    """Root-group header attribute block (Hdf5FileHeader; attr names :70-88)."""
    write_attr(f, names.FILE_TYPE, file_type)
    write_attr(f, names.MAJOR_VERSION, major)
    write_attr(f, names.MINOR_VERSION, minor)
    write_attr(f, names.CREATED_BY, CREATED_BY)
    write_attr(
        f, names.CREATION_DATE, datetime.datetime.now().strftime("%d/%m/%y %H:%M:%S")
    )
    write_attr(f, names.FILE_DESCRIPTION, "kwave_tpu_torch simulation output")
    write_attr(f, names.HOST_NAMES, socket.gethostname())


def read_file_type(target) -> str:
    """The root ``file_type`` attribute ("input", "output", "checkpoint") of a path or an
    open group-like object."""
    with open_group(target, "r") as f:
        return read_attr(f, names.FILE_TYPE)


#: File versions the reader accepts, matching the reference (major "1", minor "0"/"1",
#: Hdf5/Hdf5FileHeader.h:201-348).
SUPPORTED_MAJOR = "1"
SUPPORTED_MINORS = ("0", "1")


def validate_file_header(f, expected_type: str, path: str = "") -> None:
    """Fail fast with an actionable error when a file of the wrong kind or an unsupported
    version is opened (Hdf5/Hdf5FileHeader.h:201-348)."""
    where = f" {path!r}" if path else ""
    try:
        ftype = read_attr(f, names.FILE_TYPE)
    except KeyError:
        raise ValueError(
            f"file{where} has no 'file_type' attribute: not a k-Wave HDF5 "
            f"{expected_type} file (expected file_type={expected_type!r})"
        ) from None
    if ftype != expected_type:
        raise ValueError(
            f"file{where} is a k-Wave {ftype!r} file, not an {expected_type!r} file"
        )
    major = str(read_attr(f, names.MAJOR_VERSION)) if names.MAJOR_VERSION in f.attrs else "?"
    minor = str(read_attr(f, names.MINOR_VERSION)) if names.MINOR_VERSION in f.attrs else "?"
    if major != SUPPORTED_MAJOR or minor not in SUPPORTED_MINORS:
        supported = ", ".join(f"{SUPPORTED_MAJOR}.{m}" for m in SUPPORTED_MINORS)
        raise ValueError(
            f"file{where} has file version {major}.{minor}; this build supports "
            f"versions {supported}"
        )
