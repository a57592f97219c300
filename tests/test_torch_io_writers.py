"""The port's row writers, `read_file_type`, the exports of `kwave_tpu_torch.io` and
`bitpack.words_to_bytes`, each against its `kwave_tpu` counterpart on the same data:
the same bytes in the same files, on h5py files and (the port) on in-memory groups."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kwave_tpu.io as jio
from kwave_tpu import bitpack as jbitpack
from kwave_tpu.io import hdf5 as jhdf5
from kwave_tpu_torch import bitpack
from kwave_tpu_torch import io as tio
from kwave_tpu_torch.io import hdf5 as thdf5
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

ATTRS = dict(harmonics=2, period=10.0, mos=1, shift=False, complex_size=2.0, max_exp=138)


class _Dataset:
    """A dataset held in numpy: ``shape`` and item assignment, what the writers use."""

    def __init__(self, shape):
        self.data = np.zeros(shape, np.float32)
        self.shape = shape

    def __setitem__(self, key, value):
        self.data[key] = value


def _fill(f, io):
    """Every writer on one file: raw rows, compressed frames, cuboid rows, aggregates."""
    rng = np.random.default_rng(4)
    raw = io.create_raw_dataset(f, "p", 30, 40)
    io.write_frame(raw, 3, rng.standard_normal(30).astype(np.float32))
    io.write_frames(raw, 10, rng.standard_normal((5, 30)).astype(np.float32))
    pc = io.create_compressed_dataset(f, "p_c", 30, 40, io.CompressionAttrs(**ATTRS))
    io.write_frames(pc, 0, rng.standard_normal((4, 120)).astype(np.float32))
    io.write_frame(pc, 3, rng.standard_normal((2, 60)).astype(np.float32))
    grp = io.create_cuboid_group(f, "ux", [(8, 6, 4), (3, 3, 3)], 40)
    io.write_frame(grp["1"], 7, rng.standard_normal(192).astype(np.float32))
    io.write_frames(grp["2"], 20, rng.standard_normal((3, 27)).astype(np.float32))
    agg = f.create_dataset("p_max", shape=(1, 1, 30), dtype=np.float32)
    io.write_aggregate(agg, rng.standard_normal(30).astype(np.float32))


def _datasets(f):
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj[...])
                 if isinstance(obj, h5py.Dataset) else None)
    return out


def test_writers_write_the_same_files_as_jax(tmp_path):
    paths = {}
    for tag, io in (("jax", jio), ("port", tio)):
        paths[tag] = str(tmp_path / f"{tag}.h5")
        f = io.create_output_file(paths[tag])
        _fill(f, io)
        f.close()
    with h5py.File(paths["jax"], "r") as fj, h5py.File(paths["port"], "r") as ft:
        dj, dt = _datasets(fj), _datasets(ft)
        assert dj.keys() == dt.keys() and len(dj) == 5
        for k in dj:
            assert dj[k].shape == dt[k].shape and dj[k].dtype == dt[k].dtype, k
            np.testing.assert_array_equal(dt[k].view(np.uint32), dj[k].view(np.uint32),
                                          err_msg=k)
            assert np.abs(dt[k]).max() > 0, k


@pytest.mark.parametrize("shape", [(1, 40, 30), (40, 4, 6, 8)])
def test_writers_take_any_dataset_like_object(tmp_path, shape):
    """On an object with ``shape`` and item assignment (an in-memory dataset, as on a
    machine without h5py) the rows land where h5py's dataset gets them."""
    rng = np.random.default_rng(5)
    # a row is the last axis of the (1, steps, mSize) layout, a z-slab block of a cuboid's
    row = rng.standard_normal(int(np.prod(shape[2:] if len(shape) == 3 else shape[1:])))
    row = row.astype(np.float32)
    rows = np.stack([row * k for k in (1, 2, 3)])
    mem = _Dataset(shape)
    with h5py.File(str(tmp_path / "x.h5"), "w") as f:
        ds = f.create_dataset("d", shape=shape, dtype=np.float32)
        for target, io in ((mem, tio), (ds, jio)):
            io.write_frame(target, 5, row)
            io.write_frames(target, 11, rows)
        np.testing.assert_array_equal(mem.data, ds[...])
        io_agg = _Dataset(shape)
        tio.write_aggregate(io_agg, np.arange(np.prod(shape), dtype=np.float32))
        jio.write_aggregate(ds, np.arange(np.prod(shape), dtype=np.float32))
        np.testing.assert_array_equal(io_agg.data, ds[...])


def test_read_file_type_on_a_path_and_on_an_open_group(tmp_path):
    path = str(tmp_path / "out.h5")
    tio.create_output_file(path).close()
    assert thdf5.read_file_type(path) == "output"
    with h5py.File(path, "r") as f:
        assert thdf5.read_file_type(f) == jhdf5.read_file_type(f) == "output"
    ckpt = str(tmp_path / "ckpt.h5")
    with h5py.File(ckpt, "w") as f:
        jhdf5.write_file_header(f, "checkpoint")
    assert thdf5.read_file_type(ckpt) == "checkpoint"


def test_io_exports_every_name_kwave_tpu_io_exports():
    assert sorted(tio.__all__) == sorted(jio.__all__)
    for name in tio.__all__:
        assert getattr(tio, name) is not None


@pytest.mark.parametrize("n", [4, 8, 36])
def test_words_to_bytes_matches_jax(n):
    rng = np.random.default_rng(n)
    hdr = rng.integers(0, 256, (2, n), dtype=np.int64).astype(np.int32)
    mr = rng.integers(0, 1 << 16, (2, n), dtype=np.int64).astype(np.int32)
    mi = rng.integers(0, 1 << 16, (2, n), dtype=np.int64).astype(np.int32)
    words = bitpack.pack_frame_wire(*(torch.from_numpy(a) for a in (hdr, mr, mi)))
    jwords = jbitpack.pack_frame_wire(*(jnp.asarray(a.astype(np.uint32))
                                        for a in (hdr, mr, mi)))
    want = jbitpack.words_to_bytes(jwords)
    assert bitpack.words_to_bytes(words) == want
    assert bitpack.words_to_bytes(words.numpy()) == want
    assert bitpack.words_to_bytes(np.asarray(jwords)) == want
    assert len(want) == 4 * words.numel() and len(want) >= 5 * 2 * n
    np.testing.assert_array_equal(bitpack.frame_wire_bytes(words, 2 * n),
                                  jbitpack.frame_wire_bytes(jwords, 2 * n))
