"""HDF5 files in numpy and the standard library: the reader of the subset of the format
that k-Wave's files use, with the subset of h5py's API that reading needs.

A frozen copy of the read side of `kwave_tpu_torch/io/h5file.py` as of the commit that
added this benchmark (its writer left out), so that the benchmark reads the program's
output files with code that the program's changes cannot move.

``File(path)`` is the root group. A group has item access by name or ``/`` path, ``in``,
``keys()`` and ``attrs``; a dataset has ``shape``, ``dtype``, ``chunks``, ``attrs`` and
item access with ints, slices (step >= 1), ``...`` and ``()``; ``attrs`` has item
access, ``in``, ``keys`` and ``items``.

What it reads, the subset that the program writes without compression (``-c 0``):
superblock version 0 (8-byte offsets and lengths, no user block); version-1 object
headers with their continuation blocks; symbol-table groups (v1 B-tree type 0, local heap,
``SNOD`` nodes); scalar and simple dataspaces; fixed-point and IEEE float types of 1 to 8
bytes in either byte order and fixed-length strings; the compact, contiguous (an undefined
address reads as the fill value) and chunked layouts, the last as layout version 3 over a
v1 B-tree type 1 of any depth, with no filter; attribute messages versions 1 to 3.
Anything else is refused with a `FormatError` that names it.
"""

from __future__ import annotations

import itertools
import math
import os
import struct
from typing import Optional

import numpy as np

__all__ = ["AttributeManager", "Dataset", "File", "FormatError", "Group"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, EXTERNAL, LAYOUT = range(9)
PIPELINE, ATTRIBUTE, CONTINUATION, STAB, ATTR_INFO = 0x0B, 0x0C, 0x10, 0x11, 0x15
# IEEE layouts: size -> (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class FormatError(ValueError):
    """A file, or a part of one, that this module cannot read or write: not HDF5,
    damaged, or using a feature outside the supported subset (the message names it)."""


def _refuse(feature: str, where: str = "") -> FormatError:
    at = f" ({where})" if where else ""
    return FormatError(f"unsupported HDF5 feature{at}: {feature}")


def _align8(n: int) -> int:
    return n + (-n % 8)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


class _Type:
    """A datatype: its numpy dtype, and for a string its padding and character set."""

    def __init__(self, dtype: np.dtype, pad: int = 1, cset: int = 0):
        self.dtype, self.pad, self.cset = np.dtype(dtype), pad, cset


    @classmethod
    def decode(cls, d: bytes, where: str) -> "_Type":
        cls_id, bits, size = d[0] & 0x0F, d[1] | (d[2] << 8), struct.unpack_from("<I", d, 4)[0]
        order = ">" if bits & 1 else "<"
        if cls_id == 0:
            off, prec = struct.unpack_from("<HH", d, 8)
            if size not in (1, 2, 4, 8) or off or prec != 8 * size:
                raise _refuse(f"fixed-point type of {size} bytes, bit offset {off}, "
                              f"precision {prec}", where)
            return cls(np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
        if cls_id == 1:
            off, prec, eloc, esize, mloc, msize, bias = struct.unpack_from("<HHBBBBI", d, 8)
            if bits & 0x40 or size not in _IEEE or (off, prec, mloc) != (0, 8 * size, 0) \
                    or (eloc, esize, msize, bias) != _IEEE[size]:
                raise _refuse(f"floating-point type of {size} bytes that is not IEEE "
                              "little- or big-endian", where)
            return cls(np.dtype(f"{order}f{size}"))
        if cls_id == 3:
            return cls(np.dtype(f"S{size}"), pad=bits & 0x0F, cset=(bits >> 4) & 0x0F)
        raise _refuse(f"datatype of class {cls_id}", where)


def _decode_space(d: bytes, where: str) -> tuple:
    ver, rank = d[0], d[1]
    if ver != 1:
        raise _refuse(f"dataspace message version {ver}", where)
    return struct.unpack_from(f"<{rank}Q", d, 8)


class _Attr:
    """One attribute: its type and value, or the message it was read from (decoded on
    first use)."""

    def __init__(self, typ: Optional[_Type] = None, value: Optional[np.ndarray] = None,
                 raw: Optional[bytes] = None, where: str = ""):
        self.typ, self._value, self.raw, self._where = typ, value, raw, where

    @property
    def value(self) -> np.ndarray:
        if self._value is None:
            self.typ, self._value = _decode_attribute_value(self.raw, self._where)
        return self._value


def _attribute_fields(d: bytes, where: str) -> tuple[str, int, int, int, int, callable]:
    ver = d[0]
    if ver not in (1, 2, 3):
        raise _refuse(f"attribute message version {ver}", where)
    if ver > 1 and d[1] & 3:
        raise _refuse("shared datatype or dataspace in an attribute", where)
    nsize, tsize, ssize = struct.unpack_from("<HHH", d, 2)
    p = 9 if ver == 3 else 8
    name = d[p:p + nsize].split(b"\0", 1)[0].decode()
    return name, p, nsize, tsize, ssize, (_align8 if ver == 1 else (lambda n: n))


def _decode_attribute(d: bytes, where: str) -> tuple[str, _Attr]:
    """The attribute's name, and the attribute with its value left to be decoded."""
    name = _attribute_fields(d, where)[0]
    return name, _Attr(raw=d, where=f"{where}, attribute {name!r}")


def _decode_attribute_value(d: bytes, where: str) -> tuple[_Type, np.ndarray]:
    _, p, nsize, tsize, ssize, step = _attribute_fields(d, where)
    p += step(nsize)
    typ = _Type.decode(d[p:p + tsize], where)
    p += step(tsize)
    shape = _decode_space(d[p:p + ssize], where)
    p += step(ssize)
    n = math.prod(shape) * typ.dtype.itemsize
    return typ, np.frombuffer(d[p:p + n], typ.dtype).reshape(shape).copy()


def _decode_fill(d: bytes, mtype: int) -> Optional[bytes]:
    """The fill value's bytes, or None where the file leaves it to the library (zero)."""
    ver = d[0]
    if mtype == FILL_OLD or ver not in (1, 2):
        raise _refuse(f"fill value message (type {mtype}, version {ver})")
    if ver == 2 and not d[3]:
        return None
    size, = struct.unpack_from("<i", d, 4)
    return d[8:8 + size] if size > 0 else None


# ---------------------------------------------------------------------------
# Object headers
# ---------------------------------------------------------------------------


class _Header:
    """A parsed object header: its version, reference count and messages, each as
    (type, flags, data)."""

    def __init__(self, version: int, refcount: int, messages: list):
        self.version, self.refcount, self.messages = version, refcount, messages

    def first(self, mtype: int):
        return next((m for m in self.messages if m[0] == mtype), None)


def _read_header(store: "_Store", addr: int, where: str) -> _Header:
    pre = store.read(addr, 16, where)
    ver, _, _, refcount, size = struct.unpack_from("<BBHII", pre)
    if ver != 1:
        raise FormatError(f"{where}: no object header at {addr} (version byte {ver})")
    messages = []
    chunks = [(addr + 16, size)]
    while chunks:
        caddr, csize = chunks.pop(0)
        buf = store.read(caddr, csize, where)
        p = 0
        while p + 8 <= csize:
            mtype, msize, mflags = struct.unpack_from("<HHB", buf, p)
            data = buf[p + 8:p + 8 + msize]
            p = _align8(p + 8 + msize)
            if mflags & 2:
                raise _refuse(f"shared object header message (type {mtype})", where)
            if mtype == CONTINUATION:
                chunks.append(struct.unpack_from("<QQ", data))
            elif mtype != NIL:
                messages.append((mtype, mflags, data))
    return _Header(1, refcount, messages)


# ---------------------------------------------------------------------------
# The file's storage and v1 B-trees
# ---------------------------------------------------------------------------


class _Store:
    """Reads at an address (os.pread)."""

    def __init__(self, fd: int, eof: int):
        self.fd, self.eof = fd, eof

    def read(self, addr: int, n: int, where: str = "") -> bytes:
        if n == 0:
            return b""
        buf = os.pread(self.fd, n, addr)
        if len(buf) != n:
            raise FormatError(f"{where}: file truncated (wanted {n} bytes at {addr})")
        return buf


def _btree_walk(store: _Store, addr: int, ntype: int, key_size: int, where: str):
    """(key bytes, child address) of every leaf entry of a v1 B-tree, in key order."""
    head = store.read(addr, 24, where)
    if head[:4] != b"TREE" or head[4] != ntype:
        raise FormatError(f"{where}: no B-tree node of type {ntype} at {addr}")
    level, n = head[5], struct.unpack_from("<H", head, 6)[0]
    body = store.read(addr + 24, n * (key_size + 8) + key_size, where)
    for i in range(n):
        p = i * (key_size + 8)
        key, child = body[p:p + key_size], struct.unpack_from("<Q", body, p + key_size)[0]
        if level:
            yield from _btree_walk(store, child, ntype, key_size, where)
        else:
            yield key, child


# ---------------------------------------------------------------------------
# Objects
# ---------------------------------------------------------------------------


class _Node:
    """What groups and datasets share: the file, the object header on disk (None for an
    object made in this session), the messages kept from it, and the attributes."""

    def __init__(self, file: "File", addr: Optional[int], header: Optional[_Header],
                 path: str):
        self._file = file
        self._addr = addr
        self._path = path
        self._refcount = header.refcount if header else 1
        attrs = {}
        if header is not None:
            if header.first(ATTR_INFO) is not None:
                raise _refuse("attribute info message (dense or ordered attributes)", path)
            for m in header.messages:
                if m[0] == ATTRIBUTE:
                    name, a = _decode_attribute(m[2], path)
                    attrs[name] = a
        self.attrs = AttributeManager(self, attrs)

    def __bool__(self) -> bool:
        return self._file._store is not None


class AttributeManager:
    """The attributes of a group or dataset (h5py's ``.attrs``). Scalars read as numpy
    scalars (a fixed-length string as ``np.bytes_``), arrays as arrays."""

    def __init__(self, node: _Node, items: dict):
        self._node, self._items = node, items

    def __getitem__(self, name: str):
        v = self._items[name].value
        return v[()] if v.ndim == 0 else v.copy()

    def __contains__(self, name) -> bool:
        return name in self._items

    def keys(self) -> list:
        return sorted(self._items, key=str.encode)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> list:
        return [(k, self[k]) for k in self.keys()]


class Group(_Node):
    """A group: links by name to groups and datasets."""

    def __init__(self, file: "File", addr: int, header: _Header, path: str = "/"):
        super().__init__(file, addr, header, path)
        # name -> a loaded object, or (header address, symbol-table cache bytes)
        self._links: dict = {}
        stab = header.first(STAB)
        if stab is None:
            raise _refuse("a group without a symbol table (link messages)", path)
        self._stab = struct.unpack_from("<QQ", stab[2])  # (B-tree, local heap) on disk
        self._read_symbol_table(file._store)

    def _read_symbol_table(self, store: _Store) -> None:
        btree, heap = self._stab
        hd = store.read(heap, 32, self._path)
        if hd[:4] != b"HEAP":
            raise FormatError(f"{self._path}: no local heap at {heap}")
        dsize, _, daddr = struct.unpack_from("<QQQ", hd, 8)
        names = store.read(daddr, dsize, self._path)
        entry = 8 + 2 * self._file._leaf_k * 40
        for _, snod in _btree_walk(store, btree, 0, 8, self._path):
            node = store.read(snod, entry, self._path)
            if node[:4] != b"SNOD":
                raise FormatError(f"{self._path}: no symbol table node at {snod}")
            for i in range(struct.unpack_from("<H", node, 6)[0]):
                off, obj = struct.unpack_from("<QQ", node, 8 + 40 * i)
                name = names[off:names.index(b"\0", off)].decode()
                self._links[name] = (obj, node[8 + 40 * i + 16:8 + 40 * i + 40])

    # -- navigation --------------------------------------------------------

    def _walk(self, name: str):
        """(parent group, last part) of a ``/`` path relative to this group."""
        grp = self._file if name.startswith("/") else self
        parts = [p for p in name.split("/") if p and p != "."]
        if not parts:
            raise ValueError(f"empty object name {name!r}")
        for p in parts[:-1]:
            grp = grp._child(p)
            if not isinstance(grp, Group):
                raise KeyError(f"{p!r} in {name!r} is not a group")
        return grp, parts[-1]

    def _child(self, name: str):
        if self._file._store is None:
            raise ValueError(f"{self._file.filename}: file is closed")
        link = self._links[name]
        if isinstance(link, _Node):
            return link
        obj = self._file._load(link[0], self._path.rstrip("/") + "/" + name)
        self._links[name] = obj
        return obj

    def __getitem__(self, name: str):
        if name == "/":
            return self._file
        grp, last = self._walk(name)
        if last not in grp._links:
            raise KeyError(f"object {name!r} does not exist in {self._path!r}")
        return grp._child(last)

    def __contains__(self, name) -> bool:
        try:
            grp, last = self._walk(name)
        except (KeyError, ValueError):
            return False
        return last in grp._links

    def keys(self) -> list:
        return sorted(self._links, key=str.encode)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._links)


def _selection(key, shape: tuple):
    """Per dimension (start, count, step, dropped) of an index of ints, slices (step
    >= 1), ``...`` and ``()``."""
    if key is Ellipsis or (isinstance(key, tuple) and not key):
        key = (Ellipsis,)
    elif not isinstance(key, tuple):
        key = (key,)
    if sum(k is Ellipsis for k in key) > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError(f"too many indices ({len(key)}) for a dataset of rank {len(shape)}")
    key = key + (slice(None),) * (len(shape) - len(key))
    out = []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)) and not isinstance(k, bool):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(k)} is out of range for a dimension of {n}")
            out.append((i, 1, 1, True))
        elif isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("step must be >= 1")
            out.append((start, len(range(start, stop, step)), step, False))
        else:
            raise TypeError(f"index {k!r}: only ints, slices, ... and () are supported")
    return out


def _within(sel, from_first_row: bool = False) -> tuple:
    """Numpy slices of the selection within the whole data (or within the rows that
    `Dataset._whole` read, from the first selected one)."""
    return tuple(slice(b, b + s * (c - 1) + 1, s) if c else slice(0, 0)
                 for b, (_, c, s, _) in
                 zip([0 if from_first_row and i == 0 else st
                      for i, (st, _, _, _) in enumerate(sel)], sel))


class Dataset(_Node):
    """A dataset: compact, contiguous or chunked, with its data read by selection."""

    def __init__(self, file: "File", addr: Optional[int] = None,
                 header: Optional[_Header] = None, path: str = ""):
        super().__init__(file, addr, header, path)
        self._index = None  # chunked: scaled chunk offsets -> (address, size, mask)
        self._btree = None
        self._fill = None
        msgs: dict = {}
        for m in header.messages:
            msgs.setdefault(m[0], m)
        if DATASPACE not in msgs or DATATYPE not in msgs:
            raise FormatError(f"{path}: dataset header without dataspace or datatype")
        if EXTERNAL in msgs:
            raise _refuse("external data storage", path)
        self._shape = tuple(_decode_space(msgs[DATASPACE][2], path))
        self._type = _Type.decode(msgs[DATATYPE][2], path)
        fill = msgs.get(FILL) or msgs.get(FILL_OLD)
        if fill is not None:
            self._fill = _decode_fill(fill[2], fill[0])
        if PIPELINE in msgs:
            raise _refuse("filter pipeline (compressed or checksummed chunks)", path)
        self._chunks = None
        d = msgs[LAYOUT][2]
        ver, self._layout = d[0], d[1]
        if ver < 3 or ver > 4:
            raise _refuse(f"data layout message version {ver}", path)
        if self._layout == 0:
            size, = struct.unpack_from("<H", d, 2)
            self._compact = bytearray(d[4:4 + size])
        elif self._layout == 1:
            self._contig = struct.unpack_from("<QQ", d, 2)
        elif self._layout == 2 and ver == 3:
            rank = d[2]
            self._btree, = struct.unpack_from("<Q", d, 3)
            dims = struct.unpack_from(f"<{rank}I", d, 11)
            self._chunks = tuple(dims[:-1])
        else:
            raise _refuse(f"layout class {self._layout} (virtual dataset)", path)

    # -- what it is ----------------------------------------------------------

    @property
    def shape(self) -> tuple:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    @property
    def chunks(self) -> Optional[tuple]:
        return self._chunks

    def _fill_array(self, shape) -> np.ndarray:
        if self._fill is None:
            return np.zeros(shape, self.dtype)
        return np.full(shape, np.frombuffer(self._fill, self.dtype)[0])

    # -- reading -------------------------------------------------------------

    def __getitem__(self, key):
        if self._file._store is None:
            raise ValueError(f"{self._file.filename}: file is closed")
        sel = _selection(key, self._shape)
        out = self._read(sel)
        if not self._shape and isinstance(key, tuple) and not key:
            return out[()]
        return out.reshape([c for (_, c, _, dropped) in sel if not dropped])

    def __array__(self, dtype=None, copy=None):
        a = self[...]
        return a if dtype is None else a.astype(dtype)

    def _read(self, sel) -> np.ndarray:
        counts = tuple(c for _, c, _, _ in sel)
        if self._layout == 2:
            out = np.empty(counts, self.dtype)
            if 0 in counts:
                return out
            for scaled, out_sl, chunk_sl, _ in self._chunk_parts(sel):
                out[out_sl] = self._chunk(scaled)[chunk_sl]
            return out
        return self._whole(sel)[_within(sel, from_first_row=True)]

    def _whole(self, sel) -> np.ndarray:
        """Compact or contiguous data: the rows of axis 0 that ``sel`` spans, from its
        first (a scalar whole)."""
        shape = self._shape
        first, n0 = 0, 1
        if shape:
            start, count, step, _ = sel[0]
            first, n0 = start, step * (count - 1) + 1 if count else 0
        rows = (n0,) + shape[1:] if shape else ()
        row = math.prod(shape[1:]) * self.dtype.itemsize
        if self._layout == 0:
            raw = bytes(self._compact[first * row:(first + n0) * row])
        elif self._contig[0] == UNDEF:
            return self._fill_array(rows)
        else:
            raw = self._file._store.read(self._contig[0] + first * row, n0 * row, self._path)
        return np.frombuffer(raw, self.dtype).reshape(rows).copy()

    def _chunk_parts(self, sel):
        """For each chunk that the selection touches: its scaled offsets, the slices of
        the output and of the chunk, and whether the selection covers all of the chunk
        that lies inside the dataset."""
        per_dim = []
        for (start, count, step, _), c, n in zip(sel, self._chunks, self._shape):
            idx = start + step * np.arange(count)
            ids = idx // c
            parts = []
            for cid in np.unique(ids):
                lo, hi = np.searchsorted(ids, cid), np.searchsorted(ids, cid, "right")
                first = int(idx[lo]) - cid * c
                last = int(idx[hi - 1]) - cid * c
                valid = min(c, n - cid * c)
                full = step == 1 and first == 0 and last == valid - 1
                parts.append((int(cid), slice(int(lo), int(hi)), slice(first, last + 1, step),
                              full))
            per_dim.append(parts)
        for combo in itertools.product(*per_dim):
            yield (tuple(p[0] for p in combo), tuple(p[1] for p in combo),
                   tuple(p[2] for p in combo), all(p[3] for p in combo))

    def _load_index(self) -> dict:
        if self._index is None:
            self._index = {}
            rank = len(self._shape)
            ks = 8 + 8 * (rank + 1)
            if self._btree == UNDEF:  # no chunk written yet
                return self._index
            for key, addr in _btree_walk(self._file._store, self._btree, 1, ks, self._path):
                size, mask = struct.unpack_from("<II", key)
                offs = struct.unpack_from(f"<{rank}Q", key, 8)
                self._index[tuple(o // c for o, c in zip(offs, self._chunks))] = \
                    (addr, size, mask)
        return self._index

    def _chunk(self, scaled) -> np.ndarray:
        found = self._load_index().get(scaled)
        if found is None:
            return self._fill_array(self._chunks)
        addr, size, _ = found
        raw = self._file._store.read(addr, size, self._path)
        return np.frombuffer(raw, self.dtype).reshape(self._chunks).copy()


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------


class File(Group):
    """An HDF5 file opened to read (``mode`` "r"); the root group."""

    def __init__(self, name, mode: str = "r"):
        self.filename = os.fspath(name)
        self.mode = mode
        if mode != "r":
            raise ValueError(f"mode {mode!r}: this reader only reads ('r')")
        self._store = None
        fd = os.open(self.filename, os.O_RDONLY)
        self._cache: dict = {}
        try:
            self._store = _Store(fd, 0)
            root = self._read_superblock()
            header = _read_header(self._store, root, "/")
            Group.__init__(self, self, root, header, "/")
            self._file = self
            self._cache[root] = self
        except BaseException:
            self._store = None
            os.close(fd)
            raise

    def _read_superblock(self) -> int:
        store = self._store
        sb = os.pread(store.fd, 96, 0)
        if sb[:8] != SIGNATURE:
            for at in (512, 1024, 2048, 4096):
                if os.pread(store.fd, 8, at) == SIGNATURE:
                    raise _refuse(f"user block ({at} bytes before the superblock)",
                                  self.filename)
            raise FormatError(f"{self.filename}: not an HDF5 file (signature not found)")
        ver = sb[8]
        if ver != 0:
            raise _refuse(f"superblock version {ver}", self.filename)
        sizes = (sb[13], sb[14])
        self._leaf_k, _ = struct.unpack_from("<HH", sb, 16)
        base, _, eof, driver = struct.unpack_from("<QQQQ", sb, 24)
        root, = struct.unpack_from("<Q", sb, 24 + 32 + 8)
        if driver != UNDEF:
            raise _refuse("driver information block (family or multi driver)",
                          self.filename)
        if sizes != (8, 8):
            raise _refuse(f"offsets of {sizes[0]} and lengths of {sizes[1]} bytes",
                          self.filename)
        if base != 0:
            raise _refuse(f"base address {base}", self.filename)
        size = os.fstat(store.fd).st_size
        if size < eof:
            raise FormatError(f"{self.filename}: file truncated (end of file {eof} "
                              f"in the superblock, {size} bytes on disk)")
        store.eof = eof
        return root

    def _load(self, addr: int, path: str) -> _Node:
        if addr in self._cache:
            return self._cache[addr]
        header = _read_header(self._store, addr, path)
        kinds = {m[0] for m in header.messages}
        if LAYOUT in kinds:
            obj = Dataset(self, addr, header, path)
        elif kinds & {STAB, LINK, LINK_INFO}:
            obj = Group(self, addr, header, path)  # refuses link messages
        elif DATATYPE in kinds:
            raise _refuse("committed (named) datatype", path)
        else:
            raise FormatError(f"{path}: object at {addr} is neither a group nor a dataset")
        self._cache[addr] = obj
        return obj

    def close(self) -> None:
        """Release the file."""
        if self._store is None:
            return
        os.close(self._store.fd)
        self._store = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_store", None) is not None:
            try:
                self.close()
            except Exception:  # noqa: BLE001 - a finalizer must not raise
                pass
