"""HDF5 files in numpy and the standard library: a reader and writer for the subset of the
format that k-Wave's files use, with the subset of h5py's API that the port calls.

``File(path, mode)`` (modes ``r``, ``r+``, ``w``) is the root group. A group has
``create_dataset``, ``create_group``, item access by name or ``/`` path, ``in``, ``del``,
``keys()`` and ``attrs``; a dataset has ``shape``, ``dtype``, ``chunks``, ``compression``,
``compression_opts``, ``shuffle``, ``fletcher32``, ``attrs`` and item access with ints,
slices (step >= 1), ``...`` and ``()``; ``attrs`` has ``create``, item access, ``in``,
``keys``, ``items`` and ``clear``.

What the reader reads: superblock versions 0 to 3 (8-byte offsets and lengths, no user
block, no superblock extension); version-1 and version-2 object headers with their
continuation blocks; symbol-table groups (v1 B-tree type 0, local heap, ``SNOD`` nodes) and
groups whose links are compact link messages; scalar and simple dataspaces; fixed-point
and IEEE float types of 1 to 8 bytes in either byte order and fixed-length strings; the
compact, contiguous (an undefined address reads as the fill value) and chunked layouts,
the last as layout version 3 over a v1 B-tree type 1 of any depth; the deflate, shuffle
and fletcher32 filters (the checksum is verified); attribute messages versions 1 to 3.
Anything else is refused with a `FormatError` that names it: dense link or attribute
storage (fractal heap, v2 B-tree), the chunk indices of layout version 4, variable-length
and other types, other filters, soft and external links.

What the writer writes is what libhdf5 writes under its default (earliest) format, as
h5py does by default, so that libhdf5 reads and modifies the result like its own files:
superblock version 0 with K values 4 (group leaf), 16 (group internal) and 32 (chunks);
version-1 object headers; symbol-table groups whose nodes hold their names in sorted
order; a dataset's dataspace, datatype, fill value, filter pipeline (where deflated) and
layout messages: chunked (layout version 3, a v1 B-tree type 1 keyed by (size, filter
mask, offsets..., 0)) or contiguous.

How it writes. Chunk bytes are only ever appended: a chunk goes to the end of the file
once every element of it has been written (at ``close()`` with the fill value in what is
left), and a write into a chunk already on disk reads it back, changes it and appends the
new version. All metadata (object headers, local heaps, B-trees, symbol-table nodes) is
appended at ``close()`` for the objects that changed, and the superblock's root entry and
end-of-file address are rewritten last. So a reader that opened the file earlier keeps a
consistent view, the codec takes no file locks, and a process killed in the middle of an
``r+`` session leaves the file as the last ``close()`` left it. An ``r+`` session leaves
the old versions of what it changed behind as dead bytes, as libhdf5 also can. A
contiguous dataset that existed before the session is copied to the end on its first
write, for the same reason.
"""

from __future__ import annotations

import itertools
import math
import os
import struct
import zlib
from typing import Optional

import numpy as np

from kwave_tpu_torch.utils.observability import span

__all__ = ["AttributeManager", "Dataset", "File", "FormatError", "Group"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K = 4, 16, 32  # libhdf5's defaults
SUPERBLOCK_V0_SIZE = 96
DATASET_HEADER_MIN = 256  # libhdf5's smallest dataset object header (H5D_MINHDR_SIZE)
HEAP_DATA_MIN = 88  # libhdf5's first local heap of a group
FREE_NULL = 1  # the end of a local heap's free list

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, EXTERNAL, LAYOUT = range(9)
PIPELINE, ATTRIBUTE, CONTINUATION, STAB, ATTR_INFO = 0x0B, 0x0C, 0x10, 0x11, 0x15

DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {DEFLATE: "deflate", SHUFFLE: "shuffle", FLETCHER32: "fletcher32",
                 4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enumerated", 10: "array", 11: "complex"}
_CHUNK_INDICES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                  4: "extensible array", 5: "version-2 B-tree"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class FormatError(ValueError):
    """A file, or a part of one, that this module cannot read or write: not HDF5,
    damaged, or using a feature outside the supported subset (the message names it)."""


def _refuse(feature: str, where: str = "") -> FormatError:
    at = f" ({where})" if where else ""
    return FormatError(f"unsupported HDF5 feature{at}: {feature}")


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _align8(n: int) -> int:
    return n + (-n % 8)


# ---------------------------------------------------------------------------
# Checksums and filters
# ---------------------------------------------------------------------------


def fletcher32(data: bytes) -> int:
    """libhdf5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit words, sums
    folded every 360 words."""
    b = np.frombuffer(data, np.uint8)
    n = b.size // 2
    w = (b[:2 * n:2].astype(np.int64) << 8) | b[1:2 * n:2]
    s1 = s2 = 0
    for lo in range(0, n, 360):
        blk = w[lo:lo + 360]
        ln = blk.size
        s2 = (s2 + ln * s1 + int((blk * np.arange(ln, 0, -1)).sum())) & 0xFFFFFFFF
        s1 = (s1 + int(blk.sum())) & 0xFFFFFFFF
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if b.size % 2:
        s1 += int(b[-1]) << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _shuffle(data: bytes, size: int, inverse: bool) -> bytes:
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    a = np.frombuffer(data, np.uint8)
    body = a[:n * size].reshape((size, n) if inverse else (n, size)).T
    return np.ascontiguousarray(body).tobytes() + data[n * size:]


class _Filter:
    """One filter of a dataset's pipeline (H5O_pline_t entry)."""

    def __init__(self, fid: int, flags: int, name: bytes, values: tuple):
        self.id, self.flags, self.name, self.values = fid, flags, name, values

    def encode(self, data: bytes, itemsize: int) -> bytes:
        if self.id == DEFLATE:
            return zlib.compress(data, self.values[0] if self.values else 6)
        if self.id == SHUFFLE:
            return _shuffle(data, self.values[0] if self.values else itemsize, False)
        return data + struct.pack("<I", fletcher32(data))

    def decode(self, data: bytes, itemsize: int, where: str) -> bytes:
        if self.id == DEFLATE:
            return zlib.decompress(data)
        if self.id == SHUFFLE:
            return _shuffle(data, self.values[0] if self.values else itemsize, True)
        body, (stored,) = data[:-4], struct.unpack("<I", data[-4:])
        if stored != fletcher32(body):
            raise FormatError(f"fletcher32 checksum mismatch in a chunk of {where}")
        return body


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


class _Type:
    """A datatype: its numpy dtype, and for a string its padding and character set."""

    def __init__(self, dtype: np.dtype, pad: int = 1, cset: int = 0):
        self.dtype, self.pad, self.cset = np.dtype(dtype), pad, cset

    @classmethod
    def of(cls, dtype, what: str) -> "_Type":
        dt = np.dtype(dtype)
        if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
            return cls(dt)
        if dt.kind == "f" and dt.itemsize in _IEEE:
            return cls(dt)
        if dt.kind == "S":
            return cls(np.dtype(f"S{max(dt.itemsize, 1)}"))
        raise TypeError(f"{what}: numpy type {dt} has no counterpart here (integers, "
                        "IEEE floats and fixed-length byte strings are supported; a str "
                        "would be a variable-length string: pass bytes)")

    def encode(self) -> bytes:
        dt = self.dtype
        be = 1 if dt.byteorder == ">" else 0
        if dt.kind in "iu":
            return struct.pack("<BBBBIHH", 0x10, be | (8 if dt.kind == "i" else 0), 0, 0,
                               dt.itemsize, 0, 8 * dt.itemsize)
        if dt.kind == "f":
            eloc, esize, msize, bias = _IEEE[dt.itemsize]
            return struct.pack("<BBBBIHHBBBBI", 0x11, be | 0x20, 8 * dt.itemsize - 1, 0,
                               dt.itemsize, 0, 8 * dt.itemsize, eloc, esize, 0, msize,
                               bias)
        return struct.pack("<BBBBI", 0x13, self.pad | (self.cset << 4), 0, 0, dt.itemsize)

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
        if cls_id == 9:
            kind = "string" if (bits & 0x0F) == 1 else "sequence"
            raise _refuse(f"variable-length {kind} datatype", where)
        raise _refuse(f"{_TYPE_CLASSES.get(cls_id, f'class {cls_id}')} datatype", where)


def _encode_space(shape: tuple) -> bytes:
    """Dataspace message version 1: scalar as rank 0, else the dims and max dims = dims."""
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0) + dims \
        + (dims if shape else b"")


def _decode_space(d: bytes, where: str) -> tuple:
    ver, rank, flags = d[0], d[1], d[2]
    if ver == 1:
        p = 8
    elif ver == 2:
        if d[3] == 2:
            raise _refuse("null dataspace", where)
        p = 4
    else:
        raise _refuse(f"dataspace message version {ver}", where)
    return struct.unpack_from(f"<{rank}Q", d, p)


def _encode_attribute(name: str, typ: _Type, value: np.ndarray) -> bytes:
    """Attribute message version 1 (version 3 for a name that is not ASCII)."""
    nb = name.encode() + b"\0"
    tb, sb = typ.encode(), _encode_space(value.shape)
    data = np.ascontiguousarray(value, typ.dtype).tobytes()
    if nb.isascii():
        return struct.pack("<BBHHH", 1, 0, len(nb), len(tb), len(sb)) + _pad8(nb) \
            + _pad8(tb) + _pad8(sb) + data
    return struct.pack("<BBHHHB", 3, 0, len(nb), len(tb), len(sb), 1) + nb + tb + sb + data


class _Attr:
    """One attribute: its type and value, or the message it was read from (decoded on
    first use, and written back as it was while unchanged)."""

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


def _decode_filters(d: bytes, where: str) -> list[_Filter]:
    ver, n = d[0], d[1]
    p = 8 if ver == 1 else 2
    out = []
    for _ in range(n):
        fid, = struct.unpack_from("<H", d, p)
        p += 2
        if ver == 1 or fid >= 256:
            nlen, = struct.unpack_from("<H", d, p)
            p += 2
        else:
            nlen = 0
        flags, nval = struct.unpack_from("<HH", d, p)
        p += 4
        name = d[p:p + nlen].split(b"\0", 1)[0]
        p += _align8(nlen) if ver == 1 else nlen
        values = struct.unpack_from(f"<{nval}I", d, p)
        p += 4 * nval + (4 if ver == 1 and nval % 2 else 0)
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
            label = name.decode(errors="replace") or _FILTER_NAMES.get(fid, "")
            raise _refuse(f"filter {label or 'unknown'} (id {fid})", where)
        out.append(_Filter(fid, flags, name, values))
    return out


def _encode_filters(filters: list[_Filter]) -> bytes:
    out = struct.pack("<BB6x", 1, len(filters))
    for f in filters:
        name = _pad8(f.name + b"\0") if f.name else b""
        out += struct.pack("<HHHH", f.id, len(name), f.flags, len(f.values)) + name
        out += struct.pack(f"<{len(f.values)}I", *f.values)
        out += b"\0\0\0\0" if len(f.values) % 2 else b""
    return out


def _decode_fill(d: bytes, mtype: int) -> Optional[bytes]:
    """The fill value's bytes, or None where the file leaves it to the library (zero)."""
    if mtype == FILL_OLD:
        size, = struct.unpack_from("<I", d, 0)
        return d[4:4 + size] if size else None
    ver = d[0]
    if ver in (1, 2):
        if ver == 2 and not d[3]:
            return None
        size, = struct.unpack_from("<i", d, 4)
        return d[8:8 + size] if size > 0 else None
    if d[1] & 0x20:
        size, = struct.unpack_from("<I", d, 2)
        return d[6:6 + size] if size else None
    return None


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
    if pre[:4] == b"OHDR":
        return _read_header_v2(store, addr, where)
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


def _read_header_v2(store: "_Store", addr: int, where: str) -> _Header:
    head = store.read(addr, 32, where)
    flags = head[5]
    p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size = int.from_bytes(head[p:p + width], "little")
    p += width
    messages = []
    chunks = [(addr + p, size)]
    first = True
    while chunks:
        caddr, csize = chunks.pop(0)
        if not first:  # an OCHK block: signature, messages, checksum
            if store.read(caddr, 4, where) != b"OCHK":
                raise FormatError(f"{where}: bad object header continuation at {caddr}")
            caddr, csize = caddr + 4, csize - 8
        first = False
        buf = store.read(caddr, csize, where)
        q = 0
        hdr = 6 if flags & 0x04 else 4
        while q + hdr <= csize:
            mtype, msize, mflags = struct.unpack_from("<BHB", buf, q)
            data = buf[q + hdr:q + hdr + msize]
            q += hdr + msize
            if mflags & 2:
                raise _refuse(f"shared object header message (type {mtype})", where)
            if mtype == CONTINUATION:
                chunks.append(struct.unpack_from("<QQ", data))
            elif mtype != NIL:
                messages.append((mtype, mflags, data))
    return _Header(2, 1, messages)


def _header_bytes(messages: list, refcount: int, min_size: int) -> bytes:
    """A version-1 object header: the messages in one chunk, filled up to ``min_size``
    with a NIL message that leaves libhdf5 room for a continuation message."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(d)), fl) + _pad8(d)
                    for t, fl, d in messages)
    size = max(min_size, len(body) + 24)
    body += struct.pack("<HHB3x", NIL, size - len(body) - 8, 0)
    body += b"\0" * (size - len(body))
    return struct.pack("<BBHII4x", 1, 0, len(messages) + 1, refcount, size) + body


# ---------------------------------------------------------------------------
# The file's storage and v1 B-trees
# ---------------------------------------------------------------------------


class _Store:
    """Reads at an address and appends at the end of the file (os.pread / os.pwrite)."""

    def __init__(self, fd: int, eof: int):
        self.fd, self.eof = fd, eof

    def read(self, addr: int, n: int, where: str = "") -> bytes:
        if n == 0:
            return b""
        buf = os.pread(self.fd, n, addr)
        if len(buf) != n:
            raise FormatError(f"{where}: file truncated (wanted {n} bytes at {addr})")
        return buf

    def write(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        while view.nbytes:
            n = os.pwrite(self.fd, view, addr)
            view, addr = view[n:], addr + n

    def append(self, data) -> int:
        addr = self.eof
        self.write(addr, data)
        self.eof += memoryview(data).nbytes
        return addr


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


def _write_btree(store: _Store, ntype: int, k2: int, key_size: int,
                 entries: list, last_key: bytes) -> int:
    """Write a v1 B-tree over ``entries`` [(left key, child address)] in key order whose
    last right key is ``last_key``, bottom up, at most ``k2`` children a node and every
    node written at its full size; returns the root's address."""
    node_size = 24 + (k2 + 1) * key_size + k2 * 8
    level = 0
    while True:
        n_nodes = max(1, -(-len(entries) // k2))
        sizes = [len(entries) // n_nodes + (i < len(entries) % n_nodes)
                 for i in range(n_nodes)]
        groups = [entries[sum(sizes[:i]):sum(sizes[:i + 1])] for i in range(n_nodes)]
        base = store.eof
        out = bytearray()
        for j, g in enumerate(groups):
            right = groups[j + 1][0][0] if j + 1 < n_nodes else last_key
            left_sib = base + (j - 1) * node_size if j else UNDEF
            right_sib = base + (j + 1) * node_size if j + 1 < n_nodes else UNDEF
            node = b"TREE" + struct.pack("<BBHQQ", ntype, level, len(g), left_sib, right_sib)
            node += b"".join(k + struct.pack("<Q", c) for k, c in g) + right
            out += node + b"\0" * (node_size - len(node))
        store.append(out)
        if n_nodes == 1:
            return base
        entries = [(g[0][0], base + j * node_size) for j, g in enumerate(groups)]
        level += 1


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
        self._kept = []  # messages written back as they were read
        attrs = {}
        if header is not None:
            info = header.first(ATTR_INFO)
            if info is not None:
                heap, = struct.unpack_from("<Q", info[2], 2 + (2 if info[2][1] & 1 else 0))
                if heap != UNDEF:
                    raise _refuse("dense attribute storage (fractal heap, v2 B-tree)", path)
            for m in header.messages:
                if m[0] == ATTRIBUTE:
                    name, a = _decode_attribute(m[2], path)
                    attrs[name] = a
        self._dirty = addr is None
        self.attrs = AttributeManager(self, attrs)

    def _writable(self) -> None:
        if self._file._store is None:
            raise ValueError(f"{self._file.filename}: file is closed")
        if not self._file._write:
            raise OSError(f"{self._file.filename}: file is open read-only")

    def _touch(self) -> None:
        self._writable()
        self._dirty = True
        self._file._changed = True

    def _attr_messages(self) -> list:
        return [(ATTRIBUTE, 0, a.raw if a.raw is not None
                 else _encode_attribute(name, a.typ, a.value))
                for name, a in self.attrs._items.items()]

    def __bool__(self) -> bool:
        return self._file._store is not None

    def _commit_node(self, memo: dict) -> int:
        """The header address after writing what changed (the old one if nothing did);
        each object once, however many links lead to it."""
        if id(self) not in memo:
            memo[id(self)] = self._commit(memo) if self._dirty or isinstance(self, Group) \
                else self._addr
        return memo[id(self)]

    def _place(self, messages: list, min_size: int) -> int:
        addr = self._file._store.append(_header_bytes(messages, self._refcount, min_size))
        self._file._cache.pop(self._addr, None)
        self._addr, self._dirty = addr, False
        self._file._cache[addr] = self
        return addr


class AttributeManager:
    """The attributes of a group or dataset (h5py's ``.attrs``). Scalars read as numpy
    scalars (a fixed-length string as ``np.bytes_``), arrays as arrays."""

    def __init__(self, node: _Node, items: dict):
        self._node, self._items = node, items

    def __getitem__(self, name: str):
        v = self._items[name].value
        return v[()] if v.ndim == 0 else v.copy()

    def create(self, name: str, data, shape=None, dtype=None) -> None:
        self._node._touch()
        value = np.asarray(data, dtype=dtype)
        if shape is not None:
            value = value.reshape(shape)
        typ = _Type.of(value.dtype, f"attribute {name!r}")
        self._items.pop(name, None)
        self._items[name] = _Attr(typ, value.astype(typ.dtype))

    def __setitem__(self, name: str, value) -> None:
        self.create(name, value)

    def clear(self) -> None:
        self._node._touch()
        self._items.clear()

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

    def __init__(self, file: "File", addr: Optional[int] = None,
                 header: Optional[_Header] = None, path: str = "/"):
        super().__init__(file, addr, header, path)
        # name -> a loaded object, or (header address, symbol-table cache bytes)
        self._links: dict = {}
        self._stab = None  # (B-tree, local heap) addresses on disk
        self._compact = False  # links stored as link messages (read only)
        if header is None:
            return
        stab = header.first(STAB)
        if stab is not None:
            self._stab = struct.unpack_from("<QQ", stab[2])
            self._read_symbol_table(file._store)
        else:
            info = header.first(LINK_INFO)
            if info is not None:
                heap, = struct.unpack_from("<Q", info[2], 2 + (8 if info[2][1] & 1 else 0))
                if heap != UNDEF:
                    raise _refuse("dense link storage (fractal heap, v2 B-tree)", path)
            self._compact = True
            for m in header.messages:
                if m[0] == LINK:
                    name, addr_ = _decode_link(m[2], path)
                    self._links[name] = (addr_, None)
        self._kept = [m for m in header.messages
                      if m[0] not in (STAB, ATTRIBUTE, LINK, LINK_INFO)]

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

    def _walk(self, name: str, create: bool = False):
        """(parent group, last part) of a ``/`` path relative to this group; with
        ``create``, the missing groups on the way are made (as h5py makes them)."""
        grp = self._file if name.startswith("/") else self
        parts = [p for p in name.split("/") if p and p != "."]
        if not parts:
            raise ValueError(f"empty object name {name!r}")
        for p in parts[:-1]:
            if create and p not in grp._links:
                grp.create_group(p)
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

    # -- changes -------------------------------------------------------------

    def _new_link(self, name: str, obj_of) -> _Node:
        grp, last = self._walk(name, create=True)
        grp._touch()
        if grp._compact:
            raise _refuse("adding links to a group stored with link messages", grp._path)
        if last in grp._links:
            raise ValueError(f"name {last!r} already exists in {grp._path!r}")
        obj = obj_of(grp._path.rstrip("/") + "/" + last)
        grp._links[last] = obj
        return obj

    def create_group(self, name: str) -> "Group":
        return self._new_link(name, lambda path: Group(self._file, path=path))

    def create_dataset(self, name: str, shape=None, dtype=None, data=None, chunks=None,
                       compression=None, compression_opts=None) -> "Dataset":
        """A new dataset, as h5py makes it: ``data`` fixes shape and dtype where they
        are not given; ``chunks`` (a tuple, each no larger than its dimension) makes it
        chunked, else contiguous; ``compression="gzip"`` (or a level 0-9) adds deflate at
        ``compression_opts`` (4 by default) and needs ``chunks``."""
        arr = None
        if data is not None:
            arr = np.asarray(data, dtype=dtype)
            shape = arr.shape if shape is None else tuple(shape)
            if math.prod(shape) != arr.size:
                raise ValueError(f"shape {shape} does not match the data's {arr.shape}")
            arr = arr.reshape(shape)
            dtype = arr.dtype
        if shape is None:
            raise TypeError("create_dataset needs shape= or data=")
        shape = (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)
        typ = _Type.of(dtype if dtype is not None else np.float32, f"dataset {name!r}")
        if isinstance(compression, int) and not isinstance(compression, bool):
            compression, compression_opts = "gzip", compression
        filters = []
        if compression is not None:
            if compression != "gzip":
                raise ValueError(f"compression {compression!r} is not supported (gzip)")
            level = 4 if compression_opts is None else compression_opts
            if level not in range(10):
                raise ValueError(f"gzip level must be an integer from 0-9, not {level!r}")
            filters = [_Filter(DEFLATE, 1, b"deflate", (int(level),))]
        elif compression_opts is not None:
            raise TypeError("compression_opts needs compression=")
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            if not shape or len(chunks) != len(shape):
                raise ValueError('"chunks" must have same rank as dataset shape')
            if any(c < 1 for c in chunks):
                raise ValueError(f"chunk dimensions must be positive, got {chunks}")
            if any(c > s for c, s in zip(chunks, shape)):
                raise ValueError("Chunk shape must not be greater than data shape in any "
                                 f"dimension. {chunks} is not compatible with {shape}")
        elif filters:
            raise ValueError("a compressed dataset needs chunks=")
        ds = self._new_link(name, lambda path: Dataset(
            self._file, path=path, new=(shape, typ, chunks, filters)))
        if arr is not None:
            ds[...] = arr
        return ds

    def __delitem__(self, name: str) -> None:
        grp, last = self._walk(name)
        if last not in grp._links:
            raise KeyError(f"object {name!r} does not exist in {self._path!r}")
        grp._touch()
        if grp._compact:
            raise _refuse("removing links from a group stored with link messages",
                          grp._path)
        del grp._links[last]

    # -- commit --------------------------------------------------------------

    def _commit(self, memo: dict) -> int:
        entries = {}
        changed = self._dirty
        for name, link in self._links.items():
            if isinstance(link, _Node):
                before = link._addr
                addr = link._commit_node(memo)
                changed |= addr != before
                cache = (struct.pack("<IIQQ", 1, 0, *link._stab)
                         if isinstance(link, Group) and link._stab
                         else struct.pack("<II16x", 0, 0))
                entries[name] = (addr, cache)
            else:
                entries[name] = (link[0], link[1] if link[1] is not None
                                 else struct.pack("<II16x", 0, 0))
        if not changed:
            return self._addr
        if self._compact:
            raise _refuse("rewriting a group stored with link messages", self._path)
        store, f = self._file._store, self._file
        names = sorted(entries, key=str.encode)
        # the local heap: "" at 0, then each name NUL-terminated and padded to 8
        heap, offsets = bytearray(8), {}
        for n in names:
            offsets[n] = len(heap)
            heap += _pad8(n.encode() + b"\0")
        free = max(HEAP_DATA_MIN - len(heap), 16)
        heap += struct.pack("<QQ", FREE_NULL, free) + b"\0" * (free - 16)
        heap_addr = store.eof
        store.append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), len(heap) - free,
                                           heap_addr + 32) + heap)
        # the symbol-table nodes, then the B-tree over them
        k2 = 2 * f._leaf_k
        n_snod = -(-len(names) // k2)
        sizes = [len(names) // n_snod + (i < len(names) % n_snod) for i in range(n_snod)]
        snod_size = 8 + k2 * 40
        btree_entries, start, out, base = [], 0, bytearray(), store.eof
        for j, sz in enumerate(sizes):
            part = names[start:start + sz]
            node = b"SNOD" + struct.pack("<BBH", 1, 0, sz) + b"".join(
                struct.pack("<QQ", offsets[n], entries[n][0]) + entries[n][1] for n in part)
            out += node + b"\0" * (snod_size - len(node))
            left = offsets[names[start - 1]] if start else 0
            btree_entries.append((struct.pack("<Q", left), base + j * snod_size))
            start += sz
        store.append(out)
        last = struct.pack("<Q", offsets[names[-1]] if names else 0)
        btree = _write_btree(store, 0, 2 * f._internal_k, 8, btree_entries, last)
        self._stab = (btree, heap_addr)
        messages = [(STAB, 0, struct.pack("<QQ", btree, heap_addr))] + self._kept \
            + self._attr_messages()
        return self._place(messages, 0)


def _decode_link(d: bytes, where: str) -> tuple[str, int]:
    flags = d[1]
    p = 2
    ltype = 0
    if flags & 0x08:
        ltype = d[p]
        p += 1
    if flags & 0x04:
        p += 8
    if flags & 0x10:
        p += 1
    width = 1 << (flags & 3)
    n = int.from_bytes(d[p:p + width], "little")
    p += width
    name = d[p:p + n].decode()
    p += n
    if ltype != 0:
        kind = {1: "soft link", 64: "external link"}.get(ltype, f"link type {ltype}")
        raise _refuse(f"{kind} {name!r}", where)
    return name, struct.unpack_from("<Q", d, p)[0]


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


def _everything(shape: tuple) -> list:
    return [(0, n, 1, False) for n in shape]


def _within(sel, from_first_row: bool = False) -> tuple:
    """Numpy slices of the selection within the whole data (or within the rows that
    `Dataset._whole` read, from the first selected one)."""
    return tuple(slice(b, b + s * (c - 1) + 1, s) if c else slice(0, 0)
                 for b, (_, c, s, _) in
                 zip([0 if from_first_row and i == 0 else st
                      for i, (st, _, _, _) in enumerate(sel)], sel))


class Dataset(_Node):
    """A dataset: compact, contiguous or chunked, with its data read and written by
    selection."""

    def __init__(self, file: "File", addr: Optional[int] = None,
                 header: Optional[_Header] = None, path: str = "", new=None):
        super().__init__(file, addr, header, path)
        self._index = None  # chunked: scaled chunk offsets -> (address, size, mask)
        self._pending = {}  # chunked: scaled offsets -> (buffer, written mask)
        self._index_dirty = False
        self._btree = None
        self._fresh = False  # contiguous storage allocated in this session
        self._fill = None
        if new is not None:
            self._shape, self._type, self._chunks, self._filters = new
            self._layout = 2 if self._chunks else 1
            self._contig = (UNDEF, math.prod(self._shape) * self._type.dtype.itemsize)
            self._index = {}
            return
        msgs = {}
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
        self._filters = _decode_filters(msgs[PIPELINE][2], path) if PIPELINE in msgs else []
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
        elif self._layout == 2:
            index = _CHUNK_INDICES.get(d[5 + d[3] * d[4]], "")
            raise _refuse(f"chunk index of layout version 4 ({index or 'unknown'})", path)
        else:
            raise _refuse(f"layout class {self._layout} (virtual dataset)", path)
        self._kept = [m for m in header.messages if m[0] not in (LAYOUT, ATTRIBUTE)]

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

    @property
    def compression(self) -> Optional[str]:
        return "gzip" if any(f.id == DEFLATE for f in self._filters) else None

    @property
    def compression_opts(self) -> Optional[int]:
        return next((f.values[0] if f.values else None
                     for f in self._filters if f.id == DEFLATE), None)

    @property
    def shuffle(self) -> bool:
        return any(f.id == SHUFFLE for f in self._filters)

    @property
    def fletcher32(self) -> bool:
        return any(f.id == FLETCHER32 for f in self._filters)

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
        if scaled in self._pending:
            return self._pending[scaled][0]
        found = self._load_index().get(scaled)
        if found is None:
            return self._fill_array(self._chunks)
        addr, size, mask = found
        raw = self._file._store.read(addr, size, self._path)
        for i in reversed(range(len(self._filters))):
            if not mask & (1 << i):
                raw = self._filters[i].decode(raw, self.dtype.itemsize, self._path)
        return np.frombuffer(raw, self.dtype).reshape(self._chunks).copy()

    # -- writing -------------------------------------------------------------

    def __setitem__(self, key, value) -> None:
        with span("kwave.h5.write"):
            self._setitem(key, value)

    def _setitem(self, key, value) -> None:
        self._writable()
        sel = _selection(key, self._shape)
        counts = tuple(c for _, c, _, _ in sel)
        kept = [c for (_, c, _, dropped) in sel if not dropped]
        val = np.broadcast_to(np.asarray(value).astype(self.dtype, copy=False),
                              kept).reshape(counts)
        if 0 in counts:
            return
        self._touch()
        if self._layout == 2:
            for scaled, out_sl, chunk_sl, full in self._chunk_parts(sel):
                self._write_chunk(scaled, chunk_sl, val[out_sl], full)
            return
        if self._layout == 0:
            whole = self._whole(_everything(self._shape))
            whole[_within(sel)] = val
            self._compact[:] = whole.tobytes()
            return
        self._write_contiguous(sel, val)

    def _write_contiguous(self, sel, val) -> None:
        store = self._file._store
        nbytes = math.prod(self._shape) * self.dtype.itemsize
        if not self._fresh:
            # a new allocation, or a copy of what an earlier session wrote: never change
            # bytes that a reader of the file's last state may read
            whole = self._whole(_everything(self._shape))
            whole[_within(sel)] = val
            self._contig = (store.append(whole.tobytes()), nbytes)
            self._fresh = True
            return
        part = self._whole(sel)
        part[_within(sel, from_first_row=True)] = val
        row = math.prod(self._shape[1:]) * self.dtype.itemsize if self._shape else 0
        store.write(self._contig[0] + (sel[0][0] * row if self._shape else 0),
                    part.tobytes())

    def _write_chunk(self, scaled, chunk_sl, val, full: bool) -> None:
        index = self._load_index()
        if scaled in self._pending:
            buf, written = self._pending[scaled]
        elif full:
            buf = self._fill_array(self._chunks)
            buf[chunk_sl] = val
            self._store_chunk(scaled, buf)
            return
        elif scaled in index:
            buf = self._chunk(scaled)
            buf[chunk_sl] = val
            self._store_chunk(scaled, buf)
            return
        else:
            buf, written = self._fill_array(self._chunks), np.zeros(self._chunks, bool)
            self._pending[scaled] = (buf, written)
            self._file._partial.add(self)
        buf[chunk_sl] = val
        written[chunk_sl] = True
        inside = tuple(slice(0, min(c, n - s * c))
                       for s, c, n in zip(scaled, self._chunks, self._shape))
        if written[inside].all():
            del self._pending[scaled]
            self._store_chunk(scaled, buf)

    def _store_chunk(self, scaled, buf: np.ndarray) -> None:
        raw = np.ascontiguousarray(buf).tobytes()
        for f in self._filters:
            raw = f.encode(raw, self.dtype.itemsize)
        self._load_index()[scaled] = (self._file._store.append(raw), len(raw), 0)
        self._index_dirty = True

    def _flush_partial(self) -> None:
        for scaled, (buf, _) in list(self._pending.items()):
            self._store_chunk(scaled, buf)
        self._pending.clear()

    # -- commit --------------------------------------------------------------

    def _commit(self, memo: dict) -> int:
        store = self._file._store
        if self._layout == 2:
            if self._btree is None or self._index_dirty:
                self._btree = self._write_index(store)
                self._index_dirty = False
            dims = self._chunks + (self.dtype.itemsize,)
            layout = struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims), self._btree, *dims)
        elif self._layout == 1:
            layout = struct.pack("<BBQQ", 3, 1, *self._contig)
        else:
            layout = struct.pack("<BBH", 3, 0, len(self._compact)) + bytes(self._compact)
        if self._addr is None:
            # what libhdf5 writes for a new dataset: fill value "default" (version 2:
            # allocation late / incremental, written if set, defined, size 0)
            alloc = {0: 1, 1: 2, 2: 3}[self._layout]  # early, late, incremental
            messages = [(DATASPACE, 0, _encode_space(self._shape)),
                        (DATATYPE, 1, self._type.encode()),
                        (FILL, 1, struct.pack("<BBBBI", 2, alloc, 2, 1, 0))]
            if self._filters:
                messages.append((PIPELINE, 1, _encode_filters(self._filters)))
            messages.append((LAYOUT, 0, layout))
        else:
            messages = self._kept + [(LAYOUT, 0, layout)]
        return self._place(messages + self._attr_messages(), DATASET_HEADER_MIN)

    def _write_index(self, store: _Store) -> int:
        rank = len(self._shape)
        dims = self._chunks

        def key(size, mask, scaled, elem):
            offs = [s * c for s, c in zip(scaled, dims)]
            return struct.pack(f"<II{rank + 1}Q", size, mask, *offs, elem)

        items = sorted(self._index.items())
        if not items:
            return UNDEF
        entries = [(key(size, mask, s, 0), addr) for s, (addr, size, mask) in items]
        # libhdf5's right key past the last chunk: its scaled offsets plus one, also in
        # the element dimension
        last = key(0, 0, tuple(x + 1 for x in items[-1][0]), self.dtype.itemsize)
        return _write_btree(store, 1, 2 * self._file._chunk_k, 8 + 8 * (rank + 1),
                            entries, last)


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------


class File(Group):
    """An HDF5 file opened ``r`` (read), ``r+`` (read and write) or ``w`` (created or
    truncated); the root group. ``close()`` (or the end of a ``with`` block) writes what
    changed."""

    def __init__(self, name, mode: str = "r"):
        self.filename = os.fspath(name)
        self.mode = mode
        flags = {"r": os.O_RDONLY, "r+": os.O_RDWR,
                 "w": os.O_RDWR | os.O_CREAT | os.O_TRUNC}.get(mode)
        if flags is None:
            raise ValueError(f"mode {mode!r}: only 'r', 'r+' and 'w' are supported")
        self._store = None
        fd = os.open(self.filename, flags, 0o666)
        self._write = mode != "r"
        self._changed = mode == "w"
        self._cache: dict = {}
        self._partial: set = set()
        try:
            if mode == "w":
                self._sb_version = 0
                self._leaf_k, self._internal_k, self._chunk_k = \
                    GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K
                self._store = _Store(fd, SUPERBLOCK_V0_SIZE)
                Group.__init__(self, self)
                self._file = self
                return
            self._store = _Store(fd, 0)
            root = self._read_superblock()
            header = _read_header(self._store, root, "/")
            if self._write and header.version != 1:
                raise _refuse("writing a file whose root has a version-2 object header",
                              self.filename)
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
        if ver in (0, 1):
            sizes = (sb[13], sb[14])
            self._leaf_k, self._internal_k = struct.unpack_from("<HH", sb, 16)
            p = 24
            self._chunk_k = CHUNK_K
            if ver == 1:
                self._chunk_k, = struct.unpack_from("<H", sb, 24)
                p = 28
            base, _, eof, driver = struct.unpack_from("<QQQQ", sb, p)
            root, = struct.unpack_from("<Q", sb, p + 32 + 8)
            if driver != UNDEF:
                raise _refuse("driver information block (family or multi driver)",
                              self.filename)
            ext = UNDEF
        elif ver in (2, 3):
            sizes = (sb[9], sb[10])
            base, ext, eof, root = struct.unpack_from("<QQQQ", sb, 12)
            if self._write:
                raise _refuse(f"writing a superblock version {ver} file", self.filename)
            self._leaf_k, self._internal_k, self._chunk_k = \
                GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K
        else:
            raise _refuse(f"superblock version {ver}", self.filename)
        if sizes != (8, 8):
            raise _refuse(f"offsets of {sizes[0]} and lengths of {sizes[1]} bytes",
                          self.filename)
        if base != 0:
            raise _refuse(f"base address {base}", self.filename)
        if ext != UNDEF:
            raise _refuse("superblock extension", self.filename)
        size = os.fstat(store.fd).st_size
        if size < eof:
            raise FormatError(f"{self.filename}: file truncated (end of file {eof} "
                              f"in the superblock, {size} bytes on disk)")
        self._sb_version = ver
        store.eof = eof
        return root

    def _load(self, addr: int, path: str) -> _Node:
        if addr in self._cache:
            return self._cache[addr]
        header = _read_header(self._store, addr, path)
        if self._write and header.version != 1:
            raise _refuse("writing a file with version-2 object headers", path)
        kinds = {m[0] for m in header.messages}
        if LAYOUT in kinds:
            obj = Dataset(self, addr, header, path)
        elif kinds & {STAB, LINK, LINK_INFO}:
            obj = Group(self, addr, header, path)
        elif DATATYPE in kinds:
            raise _refuse("committed (named) datatype", path)
        else:
            raise FormatError(f"{path}: object at {addr} is neither a group nor a dataset")
        self._cache[addr] = obj
        return obj

    def close(self) -> None:
        """Write what changed, then the superblock; release the file."""
        if self._store is None:
            return
        try:
            if self._write:
                with span("kwave.h5.write"):
                    for ds in list(self._partial):
                        ds._flush_partial()
                    self._partial.clear()
                    if self._changed:
                        self._commit_file()
        finally:
            os.close(self._store.fd)
            self._store = None

    def _commit_file(self) -> None:
        root = self._commit_node({})
        btree, heap = self._stab
        entry = struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap)
        fields = struct.pack("<BBBBBBBB", self._sb_version, 0, 0, 0, 0, 8, 8, 0)
        fields += struct.pack("<HHI", self._leaf_k, self._internal_k, 0)
        if self._sb_version == 1:
            fields += struct.pack("<HH", self._chunk_k, 0)
        eof = self._store.eof
        sb = SIGNATURE + fields + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF) + entry
        self._store.write(0, sb)
        self._changed = False

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
