"""The port's HDF5 codec (`kwave_tpu_torch.io.h5file`) against libhdf5, through h5py as
the oracle: files the codec writes read in h5py as the same calls made through h5py read,
files h5py writes read in the codec as in h5py, ``r+`` sessions both ways, refusals that
name their feature, and a process killed in the middle of an ``r+`` session."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kwave_tpu_torch.io import h5file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("u1", "u2", "u4", "u8", "i1", "i4", "i8", "f4", "f8")
HYPOTHESIS = settings(max_examples=40, deadline=None, derandomize=True, database=None,
                      suppress_health_check=[HealthCheck.function_scoped_fixture])


# ---------------------------------------------------------------------------
# What a file holds, as each library reports it
# ---------------------------------------------------------------------------


def tree(f) -> dict:
    """Every object of an open file (h5py's or the codec's) by path: a group's attributes;
    a dataset's shape, dtype, chunks, filters, bytes and attributes. Attributes as
    (dtype, shape, bytes), so that a type that reads back otherwise shows."""
    out = {}

    def attrs(obj):
        return {k: (np.asarray(v).dtype.str, np.asarray(v).shape, np.asarray(v).tobytes())
                for k, v in obj.attrs.items()}

    def walk(grp, path):
        out[path or "/"] = ("group", attrs(grp))
        for name in grp.keys():
            obj = grp[name]
            where = f"{path}/{name}"
            if hasattr(obj, "keys"):
                walk(obj, where)
                continue
            data = np.asarray(obj[()])
            out[where] = ("dataset", tuple(obj.shape), obj.dtype.str, obj.chunks,
                          obj.compression, obj.compression_opts, obj.shuffle,
                          obj.fletcher32, data.dtype.str, data.tobytes(), attrs(obj))

    walk(f, "")
    return out


def _type(tid) -> tuple:
    """A datatype as libhdf5 reports it: class, size, and order and sign, or a string's
    padding and character set."""
    cls = tid.get_class()
    if cls == h5py.h5t.STRING:
        return cls, tid.get_size(), tid.get_strpad(), tid.get_cset(), tid.is_variable_str()
    if cls == h5py.h5t.INTEGER:
        return cls, tid.get_size(), tid.get_order(), tid.get_sign()
    return cls, tid.get_size(), tid.get_order()


def storage(path: str) -> dict:
    """What libhdf5 reports of every object of a file beyond the data: datatypes, layout,
    filters with their flags and values, fill value settings, allocated chunks, and the
    attributes' types and dataspaces."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            at = {}
            for k in obj.attrs:
                aid = obj.attrs.get_id(k)
                at[k] = (_type(aid.get_type()), aid.shape)
            if isinstance(obj, h5py.Group):
                out[name] = at
                return
            plist = obj.id.get_create_plist()
            layout = plist.get_layout()
            filters = [plist.get_filter(i)[:3] for i in range(plist.get_nfilters())]
            out[name] = (at, _type(obj.id.get_type()), layout,
                         plist.get_chunk() if layout == h5py.h5d.CHUNKED else None,
                         filters, plist.get_alloc_time(), plist.get_fill_time(),
                         plist.fill_value_defined(), obj.id.get_space().get_simple_extent_type(),
                         obj.id.get_num_chunks() if layout == h5py.h5d.CHUNKED else None)
        out["/"] = {k: (_type(f.attrs.get_id(k).get_type()), f.attrs.get_id(k).shape)
                    for k in f.attrs}
        f.visititems(visit)
    return out


# ---------------------------------------------------------------------------
# One description, written through either library
# ---------------------------------------------------------------------------


@st.composite
def datasets(draw):
    """A dataset to make: dtype, shape (rank 0-3, zero-length dimensions where
    contiguous), chunks or none, deflate level or none, and its data as one write or as
    slice writes in random order."""
    dtype = draw(st.sampled_from(DTYPES))
    rank = draw(st.integers(0, 3))
    chunked = rank > 0 and draw(st.booleans())
    shape = tuple(draw(st.integers(1 if chunked else 0, 7)) for _ in range(rank))
    chunks = tuple(draw(st.integers(1, n)) for n in shape) if chunked else None
    level = draw(st.sampled_from((None, 0, 1, 9))) if chunked else None
    seed = draw(st.integers(0, 2**31))
    writes = []
    if rank and draw(st.booleans()):  # slice writes, some overlapping, some not at all
        for _ in range(draw(st.integers(1, 4))):
            key = []
            for n in shape:
                a = draw(st.integers(0, n))
                b = draw(st.integers(a, n))
                picks = (slice(a, b), slice(a, b, 2)) + ((a % n,) if n else ())
                key.append(draw(st.sampled_from(picks)))
            writes.append(tuple(key))
    return dict(dtype=dtype, shape=shape, chunks=chunks, level=level, seed=seed,
                writes=writes)


def _values(dtype: str, shape: tuple, rng) -> np.ndarray:
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


ATTRIBUTES = {  # every kind the port writes, and an array of each number type
    "s": np.bytes_(b"kwave"), "empty": np.bytes_(b""), "i8": np.int64(-3),
    "f4": np.float32(2.5), "f8": np.float64(1e-300), "u8": np.uint64(2**64 - 1),
    "arr_u2": np.arange(6, dtype=np.uint16).reshape(2, 3), "arr_f4": np.ones(3, np.float32),
}


def write(mod, path: str, specs: list, attributes: dict = ATTRIBUTES) -> None:
    """``specs`` (from `datasets`) made through ``mod`` (h5py or the codec), under a
    nested group, with the same calls in the same order."""
    with mod.File(path, "w") as f:
        for k, v in attributes.items():
            f.attrs.create(k, v)
        grp = f.create_group("outer/inner")
        grp.attrs["depth"] = np.int64(2)
        for i, s in enumerate(specs):
            kw = {}
            if s["chunks"] is not None:
                kw["chunks"] = s["chunks"]
            if s["level"] is not None:
                kw.update(compression="gzip", compression_opts=s["level"])
            rng = np.random.default_rng(s["seed"])
            where = grp if i % 2 else f
            if not s["writes"]:
                ds = where.create_dataset(f"d{i}", data=_values(s["dtype"], s["shape"], rng),
                                          **kw)
            else:
                ds = where.create_dataset(f"d{i}", shape=s["shape"], dtype=s["dtype"], **kw)
                for key in s["writes"]:
                    part = np.empty(s["shape"], s["dtype"])[key]
                    ds[key] = _values(s["dtype"], part.shape, rng)
            for k, v in attributes.items():
                ds.attrs.create(k, v)


# ---------------------------------------------------------------------------
# (a) the codec writes, h5py reads
# ---------------------------------------------------------------------------


@HYPOTHESIS
@given(specs=st.lists(datasets(), min_size=1, max_size=4))
def test_codec_writes_what_h5py_writes(tmp_path, specs):
    """The same calls through the codec and through h5py make files that h5py reads
    alike: data, dtypes, shapes, chunks, filters and levels, allocated chunks, fill value
    settings, and every attribute with its type as libhdf5 reports it."""
    mine, theirs = str(tmp_path / "codec.h5"), str(tmp_path / "h5py.h5")
    write(h5file, mine, specs)
    write(h5py, theirs, specs)
    with h5py.File(mine, "r") as a, h5py.File(theirs, "r") as b:
        assert tree(a) == tree(b)
    assert storage(mine) == storage(theirs)


@pytest.mark.parametrize("level", [None, 0, 1, 9])
def test_rows_in_random_order_as_the_writers_write_them(tmp_path, level):
    """An output stream's layout, (1, steps, n) in (1, 1, n) chunks, rows written one at
    a time in random order and some left unwritten, a ragged last column chunk and a
    partly written chunk: h5py reads the values, and the chunks allocated, that h5py's
    own writes give."""
    rng = np.random.default_rng(level or 0)
    full = rng.standard_normal((1, 40, 300)).astype(np.float32)
    paths = []
    for mod in (h5file, h5py):
        path = str(tmp_path / f"{mod.__name__}.h5")
        with mod.File(path, "w") as f:
            kw = {} if level is None else dict(compression="gzip", compression_opts=level)
            ds = f.create_dataset("p", shape=(1, 40, 300), dtype=np.float32,
                                  chunks=(1, 1, 128), **kw)
            for r in np.random.default_rng(1).permutation(40)[:33]:
                ds[0, r, :] = full[0, r]
            ds[0, 39, 5:17] = full[0, 39, 5:17]
        paths.append(path)
    with h5py.File(paths[0], "r") as a, h5py.File(paths[1], "r") as b:
        assert tree(a) == tree(b)
    assert storage(paths[0]) == storage(paths[1])


def test_port_layout_matches_h5py_message_for_message(tmp_path):
    """For the objects the port writes, the codec's object header messages equal h5py's
    byte for byte but for the addresses they hold."""
    paths = []
    for mod in (h5file, h5py):
        path = str(tmp_path / f"{mod.__name__}.h5")
        with mod.File(path, "w") as f:
            f.attrs.create("file_type", np.bytes_(b"output"))
            f.create_dataset("Nx", data=np.full((1, 1, 1), 7, np.uint64)).attrs.create(
                "data_type", np.bytes_(b"long"))
            ds = f.create_dataset("p_c", shape=(1, 3, 20), dtype=np.float32,
                                  chunks=(1, 1, 20), compression="gzip", compression_opts=4)
            ds[...] = 1.0
            ds.attrs.create("c_period", np.float32(16))
            f.create_group("g")
        paths.append(path)

    def without_addresses(mtype, d):
        if mtype == h5file.STAB:  # a B-tree's and a local heap's address
            return b""
        if mtype == h5file.LAYOUT:  # chunked: the B-tree at 3-10; contiguous: 2-9
            return d[:3] + d[11:] if d[1] == 2 else d[:2] + d[10:]
        return d

    def messages(path):
        with h5file.File(path, "r") as f:
            out = {}
            for name in ("/", "Nx", "p_c", "g"):
                obj = f[name]
                hdr = h5file._read_header(f._store, obj._addr, name)
                out[name] = [(t, fl, without_addresses(t, d)) for t, fl, d in hdr.messages]
        return out

    assert messages(paths[0]) == messages(paths[1])


# ---------------------------------------------------------------------------
# (b) h5py writes, the codec reads
# ---------------------------------------------------------------------------


@HYPOTHESIS
@given(specs=st.lists(datasets(), min_size=1, max_size=4))
def test_codec_reads_what_h5py_writes(tmp_path, specs):
    path = str(tmp_path / "h5py.h5")
    write(h5py, path, specs)
    with h5py.File(path, "r") as a, h5file.File(path, "r") as b:
        assert tree(b) == tree(a)


def test_codec_reads_filters_deep_trees_and_fill_values(tmp_path):
    """Shuffle and deflate, fletcher32 (verified), all three, big-endian data, a compact
    dataset, fill values of never written storage, fixed strings of both paddings, a
    group of 40 links (five symbol-table nodes), and 5000 one-row chunks (a chunk B-tree
    three levels deep)."""
    path = str(tmp_path / "h5py.h5")
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 30))
    with h5py.File(path, "w") as f:
        f.create_dataset("shuffle", data=a, chunks=(7, 11), shuffle=True, compression="gzip",
                         compression_opts=9)
        f.create_dataset("fletcher", data=a.astype(np.float32), chunks=(7, 11),
                         fletcher32=True)
        f.create_dataset("all3", data=a, chunks=(40, 1), fletcher32=True, shuffle=True,
                         compression="gzip")
        f.create_dataset("big_endian", data=a.astype(">i4"))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT16,
                        h5py.h5s.create_simple((4, 2)), dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(8, dtype=np.int16).reshape(4, 2))
        f.create_dataset("unwritten", shape=(3, 4), dtype=np.float32, fillvalue=2.5)
        f.create_dataset("unwritten_chunks", shape=(3, 4), dtype="i8", chunks=(1, 4),
                         fillvalue=-7)
        f.create_dataset("deep", data=np.arange(5000 * 3, dtype=np.uint8).reshape(5000, 3),
                         chunks=(1, 3))
        f.create_dataset("empty_rows", shape=(0, 3), dtype=np.float32, chunks=(1, 3),
                         maxshape=(None, 3))
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(6)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        h5py.h5a.create(f.id, b"nullterm", tid, h5py.h5s.create(h5py.h5s.SCALAR)).write(
            np.array(b"hello", "S6"))
        f.attrs["nullpad"] = np.bytes_(b"hello")
        g = f.create_group("many")
        for i in range(40):
            g.create_dataset(f"x{(i * 7919) % 40}", data=np.int32(i))
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert tree(got) == tree(want)
        assert got["unwritten"][1, 2] == 2.5 and got["unwritten_chunks"][2, 3] == -7
        assert got.attrs["nullterm"] == b"hello"
        deep = got["deep"]
        assert got._store.read(deep._btree, 24)[5] >= 2  # the root's level: three deep
        assert list(got["many"].keys()) == sorted(f"x{i}" for i in range(40))


def test_codec_reads_the_latest_format_where_it_can(tmp_path):
    """Superblock version 3, version-2 object headers and links stored in the header."""
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(12.0).reshape(3, 4))
        f.create_group("g").create_dataset("y", data=np.int64(4))
        f.attrs["a"] = np.float32(1.5)
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert tree(got) == tree(want)
    with pytest.raises(h5file.FormatError, match="superblock version 3"):
        h5file.File(path, "r+")


def test_reads_do_not_depend_on_the_order_of_reads(tmp_path):
    """The same selection from a file read in any order, strided and clipped, and a
    scalar read by ``()`` and by ``...``, as in h5py."""
    path = str(tmp_path / "h5py.h5")
    rng = np.random.default_rng(6)
    a = rng.standard_normal((9, 10, 11)).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=a, chunks=(2, 3, 4), compression="gzip")
        f.create_dataset("s", data=np.float64(3.25))
    keys = [(), (Ellipsis,), (1,), (-1, slice(2, 9, 3)), (slice(None), 4, slice(1, None, 2)),
            (Ellipsis, 10), (slice(3, 3),), (slice(8, 100), slice(None, None, 4), -2)]
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        for key in keys + keys[::-1]:
            np.testing.assert_array_equal(got["a"][key], want["a"][key])
        assert got["s"][()] == want["s"][()] and got["s"][...].shape == ()
        assert type(got["s"][()]) is type(want["s"][()])


# ---------------------------------------------------------------------------
# (c) r+ both ways
# ---------------------------------------------------------------------------


LINKS = (0, 1, 7, 8, 9, 33, 120)  # around a symbol-table node's 8 and a B-tree's 32
ROWS = (1, 63, 64, 65, 2048)  # around a chunk B-tree node's 64


def test_h5py_modifies_what_the_codec_wrote(tmp_path):
    """The codec writes groups of every size around its nodes' capacities and datasets
    with every other row; h5py then adds as many links, deletes a third, writes the other
    rows (one chunk B-tree insert each) and sets attributes; h5py and the codec read the
    result alike."""
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(7)
    full = {n: rng.standard_normal((1, n, 10)).astype(np.float32) for n in ROWS}
    with h5file.File(path, "w") as f:
        for n in LINKS:
            g = f.create_group(f"g{n}")
            for i in range(n):
                g.create_dataset(f"n{rng.integers(10**9)}_{i}", data=np.int32(i))
        for n in ROWS:
            for level in (None, 3):
                ds = f.create_dataset(f"r{n}_{level}", shape=(1, n, 10), dtype=np.float32,
                                      chunks=(1, 1, 10), compression=level and "gzip",
                                      compression_opts=level)
                for r in range(0, n, 2):
                    ds[0, r] = full[n][0, r]
    with h5py.File(path, "r+") as f:
        for n in LINKS:
            g = f[f"g{n}"]
            assert len(g) == n
            for i in range(n):
                g.create_dataset(f"h{rng.integers(10**9)}_{i}", data=np.int32(i))
            for k in sorted(g.keys())[::3]:
                del g[k]
        for n in ROWS:
            for level in (None, 3):
                ds = f[f"r{n}_{level}"]
                got = ds[...]
                np.testing.assert_array_equal(got[0, ::2], full[n][0, ::2])
                assert not got[0, 1::2].any()
                for r in rng.permutation(np.arange(1, n, 2)):
                    ds[0, r] = full[n][0, r]
                ds.attrs["rows"] = np.int64(n)
        f.attrs["resumed"] = np.bytes_(b"yes")
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert tree(got) == tree(want)
        for n in ROWS:
            np.testing.assert_array_equal(got[f"r{n}_3"][...], full[n])


def test_codec_modifies_what_h5py_wrote(tmp_path):
    """h5py writes; the codec rewrites rows, sets attributes, creates datasets and
    deletes others; h5py reads the result as the codec does, and modifies it again."""
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(8)
    full = {n: rng.standard_normal((1, n, 10)).astype(np.float32) for n in ROWS}
    with h5py.File(path, "w") as f:
        for n in LINKS:
            g = f.create_group(f"g{n}")
            for i in range(n):
                g.create_dataset(f"n{i}", data=np.int32(i))
        for n in ROWS:
            f.create_dataset(f"r{n}", data=full[n], chunks=(1, 1, 10), compression="gzip")
        f.create_dataset("contiguous", data=np.arange(6.0))
    with h5file.File(path, "r+") as f:
        for n in LINKS:
            g = f[f"g{n}"]
            for k in list(g.keys())[::2]:
                del g[k]
            for i in range(5):
                g.create_dataset(f"c{i}", data=np.float64(i))
        for n in ROWS:
            ds = f[f"r{n}"]
            ds[0, 0] = -1
            ds[0, n // 2, 3:7] = 5
            ds.attrs["touched"] = np.int64(n)
        f["contiguous"][2:4] = [-2, -3]
        del f["r1"]
        f.create_dataset("new", data=np.arange(4, dtype=np.int64), chunks=(2,),
                         compression="gzip", compression_opts=1)
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert tree(got) == tree(want)
        assert "r1" not in want and want["r2048"].attrs["touched"] == 2048
        assert want["r63"][0, 0, 0] == -1 and want["r63"][0, 31, 3] == 5
        np.testing.assert_array_equal(want["r2048"][0, 1:1024], full[2048][0, 1:1024])
        np.testing.assert_array_equal(want["contiguous"][...], [0, 1, -2, -3, 4, 5])
    with h5py.File(path, "r+") as f:
        for n in LINKS:
            f[f"g{n}"].create_dataset("again", data=1)
        f["r2048"][0, 7] = 7
    with h5py.File(path, "r") as want, h5file.File(path, "r") as got:
        assert tree(got) == tree(want)


def test_a_reader_keeps_its_view_while_a_session_writes(tmp_path):
    """A file open for reading (a resumed leg's other processes) reads what the last
    ``close()`` left while another handle appends rows, deletes and adds datasets and
    closes: an ``r+`` session only appends, and rewrites the superblock last."""
    path = str(tmp_path / "f.h5")
    with h5file.File(path, "w") as f:
        f.create_dataset("p", data=np.zeros((1, 4, 8), np.float32), chunks=(1, 1, 8))
        f.create_dataset("gone", data=np.int64(1))
    reader = h5file.File(path, "r")
    with h5file.File(path, "r+") as f:
        f["p"][0, 1:3] = 1.0
        del f["gone"]
        f.create_dataset("new", data=np.int64(2))
    assert not reader["p"][...].any() and reader["gone"][()] == 1 and "new" not in reader
    reader.close()
    with h5py.File(path, "r") as f:
        assert f["p"][0, 1:3].all() and "gone" not in f and f["new"][()] == 2


# ---------------------------------------------------------------------------
# (d) refusals name their feature
# ---------------------------------------------------------------------------


def _latest_dense_links(path):
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("many")
        for i in range(20):
            g.create_dataset(f"d{i}", data=i)


def _vlen_attribute(path):
    with h5py.File(path, "w") as f:
        f.attrs["s"] = "a variable-length str"


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(50.0), chunks=(5,), compression="lzf")


def _layout_v4(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(50.0), chunks=(5,))


@pytest.mark.parametrize("make, touch, feature", [
    (_latest_dense_links, lambda f: f["many"], "dense link storage"),
    (_vlen_attribute, lambda f: f.attrs["s"], "variable-length string"),
    (_lzf, lambda f: f["x"], "filter lzf"),
    (_layout_v4, lambda f: f["x"], "chunk index of layout version 4"),
])
def test_refusals_name_the_feature(tmp_path, make, touch, feature):
    path = str(tmp_path / "f.h5")
    make(path)
    with h5file.File(path, "r") as f, pytest.raises(h5file.FormatError, match=feature):
        touch(f)


def test_not_hdf5_and_truncated_files_are_refused(tmp_path):
    text, short = tmp_path / "text.h5", tmp_path / "short.h5"
    text.write_bytes(b"not an HDF5 file at all" * 10)
    with pytest.raises(h5file.FormatError, match="not an HDF5 file"):
        h5file.File(text)
    with h5file.File(short, "w") as f:
        f.create_dataset("x", data=np.arange(100.0))
    short.write_bytes(short.read_bytes()[:-100])
    with pytest.raises(h5file.FormatError, match="truncated"):
        h5file.File(short)


def test_the_cli_takes_an_unreadable_checkpoint_for_none(tmp_path):
    """`cli._checkpoint_exists` answers False for a file the codec refuses, as for one
    the OS cannot open, and True only where a checkpoint's ``t_index`` is."""
    from kwave_tpu_torch import cli

    junk, other, ckpt = (str(tmp_path / n) for n in ("junk.h5", "other.h5", "ckpt.h5"))
    with open(junk, "wb") as f:
        f.write(b"\0" * 4096)
    with h5file.File(other, "w") as f:
        f.create_dataset("p", data=np.zeros(3))
    with h5file.File(ckpt, "w") as f:
        f.create_dataset("t_index", data=np.full((1, 1, 1), 7, np.uint64))
    assert [cli._checkpoint_exists(p) for p in (junk, other, ckpt, str(tmp_path))] == \
        [False, False, True, False]


def test_api_errors_read_as_h5py_raises_them(tmp_path):
    """The codec raises where h5py raises, with the exception classes the port's callers
    catch: a missing name, a name taken twice, a write to a file open for reading."""
    path = str(tmp_path / "f.h5")
    with h5file.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(3))
        with pytest.raises(ValueError):
            f.create_dataset("x", data=np.arange(3))
        with pytest.raises(ValueError, match="greater than data shape"):
            f.create_dataset("y", shape=(1, 0, 4), dtype=np.float32, chunks=(1, 1, 4))
    with h5file.File(path, "r") as f:
        with pytest.raises(KeyError):
            f["missing"]
        with pytest.raises(OSError):
            f["x"][0] = 5
        with pytest.raises(OSError):
            f.attrs["a"] = 1
    with pytest.raises(FileNotFoundError):
        h5file.File(str(tmp_path / "absent.h5"), "r")


# ---------------------------------------------------------------------------
# (e) a process killed in the middle of an r+ session
# ---------------------------------------------------------------------------


def test_a_killed_session_leaves_the_last_state(tmp_path):
    """A process that writes rows, attributes and datasets in ``r+`` and dies before
    ``close()`` (os._exit) leaves the file as the last ``close()`` left it, readable by
    h5py; a later session completes normally."""
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((1, 64, 100)).astype(np.float32)
    with h5file.File(path, "w") as f:
        ds = f.create_dataset("p", shape=(1, 64, 100), dtype=np.float32, chunks=(1, 1, 100),
                              compression="gzip", compression_opts=1)
        ds[0, :32] = rows[0, :32]
        ds.attrs["rows"] = np.int64(32)
        f.create_dataset("kept", data=np.arange(5))
    with h5py.File(path, "r") as f:
        before = tree(f)
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        sys.path.insert(0, {REPO!r})
        from kwave_tpu_torch.io import h5file
        f = h5file.File({path!r}, "r+")
        f["p"][0, 32:60] = 3.0  # whole chunks: on disk at once
        f["p"][0, 60, :50] = 4.0  # a partial chunk, held in memory
        f["p"][0, 3] = -1.0  # a chunk rewritten
        f["p"].attrs["rows"] = np.int64(60)
        del f["kept"]
        f.create_dataset("more", data=np.ones(1000))
        os._exit(0)
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert os.path.getsize(path) > 0
    with h5py.File(path, "r") as f:
        assert tree(f) == before
    with h5file.File(path, "r+") as f:
        f["p"][0, 32:] = rows[0, 32:]
        f["p"].attrs["rows"] = np.int64(64)
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["p"][...], rows)
        assert f["p"].attrs["rows"] == 64 and f["kept"][-1] == 4
