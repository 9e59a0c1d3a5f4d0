"""A reader and a writer of the part of HDF5 the ERA5 archive uses, with
``struct`` and numpy alone (no h5py).

The yearly ERA5 files (``[T, C, H, W]`` under ``fields``), the conditioning
fields and the statistics pass need only a contiguous, unfiltered dataset of
the root group: its byte offset, shape and dtype. This module reads that
much of the format:

  * superblock versions 0/1 (h5py's default ``libver='earliest'``: the root
    group is a symbol table -- a v1 B-tree ``TREE``, a local heap ``HEAP``
    and symbol nodes ``SNOD``) and 2/3 (``libver='latest'``: ``OHDR``
    object headers with compact link messages);
  * object headers v1 and v2 with their continuation blocks;
  * the dataspace, datatype (little-endian IEEE float, 32 or 64 bits) and
    data layout (versions 3 and 4, contiguous) messages.

Anything else a file may hold -- a filter pipeline, a chunked, compact or
virtual layout, an undefined storage address, dense link storage (a fractal
heap), a shared message, another datatype -- raises :class:`Unsupported`
(a ``ValueError``) naming the file and the feature. Checksums of v2 headers
are not verified.

:func:`create_contiguous` writes such files (superblock v0, a root symbol
table, v1 object headers with dataspace, datatype, fill-value and
contiguous-layout messages) and returns writable memmaps of the datasets,
so a year file is filled frame by frame without a second copy in memory.

:func:`open_dataset` is what the data modules read through: this reader,
or h5py where this reader refuses the file and h5py is installed.
"""

from __future__ import annotations

import contextlib
import logging
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _LINK, _LAYOUT = 0x0001, 0x0002, 0x0003, 0x0006, 0x0008
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x000B, 0x0010, 0x0011

_TYPE_CLASSES = ("fixed-point (integer)", "floating-point", "time", "string", "bitfield",
                 "opaque", "compound", "reference", "enumerated", "variable-length", "array")


class Unsupported(ValueError):
    """A file, or a dataset in it, that this reader does not take."""


class _Reader:
    """One open file: its superblock and the structures read through it."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            self._superblock()
        except BaseException:
            self.f.close()
            raise

    def close(self) -> None:
        self.f.close()

    def fail(self, feature: str):
        raise Unsupported(f"{self.path}: {feature} is not supported by the pure-numpy "
                          "HDF5 reader")

    def at(self, addr: int, n: int) -> bytes:
        self.f.seek(self.base + addr)
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated file (read of {n} bytes at {addr})")
        return data

    def offset(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self.so], "little")

    def length(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self.sl], "little")

    # -- superblock ---------------------------------------------------------
    def _superblock(self) -> None:
        size = os.fstat(self.f.fileno()).st_size
        where = 0
        while where + 8 <= size:
            self.f.seek(where)
            if self.f.read(8) == SIGNATURE:
                break
            where = 512 if where == 0 else where * 2
        else:
            raise ValueError(f"{self.path}: no HDF5 superblock signature")
        self.f.seek(where)
        head = self.f.read(96)
        version = head[8]
        if version in (0, 1):
            self.so, self.sl = head[13], head[14]
            pos = 24 + (4 if version == 1 else 0)
            self.base = self.offset(head, pos)
            # the root group's symbol table entry: link name offset, then its
            # object header's address
            self.root = self.offset(head, pos + 4 * self.so + self.so)
        elif version in (2, 3):
            self.so, self.sl = head[9], head[10]
            self.base = self.offset(head, 12)
            self.root = self.offset(head, 12 + 3 * self.so)
        else:
            self.fail(f"superblock version {version}")
        if self.so != 8 or self.sl != 8:
            self.fail(f"{self.so}-byte offsets / {self.sl}-byte lengths")

    # -- object headers -----------------------------------------------------
    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """Every message (type, flags, data) of the object header at
        ``addr``, continuation blocks followed."""
        out: List[Tuple[int, int, bytes]] = []
        prefix = self.at(addr, 16)
        if prefix[:4] == b"OHDR":
            version, flags = prefix[4], prefix[5]
            if version != 2:
                self.fail(f"object header version {version}")
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x03)
            head = self.at(addr, pos + width)
            size = int.from_bytes(head[pos:pos + width], "little")
            blocks = [(addr + pos + width, size)]
            tracked = bool(flags & 0x04)
            while blocks:
                start, n = blocks.pop(0)
                buf = self.at(start, n)
                p, end = 0, n
                if buf[:4] == b"OCHK":
                    p, end = 4, n - 4
                hdr = 6 if tracked else 4
                while p + hdr <= end:
                    mtype, msize, mflags = buf[p], struct.unpack_from("<H", buf, p + 1)[0], buf[p + 3]
                    data = buf[p + hdr:p + hdr + msize]
                    p += hdr + msize
                    if mtype == _CONTINUATION:
                        blocks.append((self.offset(data, 0), self.length(data, self.so)))
                    out.append((mtype, mflags, data))
            return out
        version = prefix[0]
        if version != 1:
            self.fail(f"object header version {version}")
        nmsgs, size = struct.unpack_from("<H", prefix, 2)[0], struct.unpack_from("<I", prefix, 8)[0]
        blocks = [(addr + 16, size)]
        while blocks and len(out) < nmsgs:
            start, n = blocks.pop(0)
            buf = self.at(start, n)
            p = 0
            while p + 8 <= n and len(out) < nmsgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, p)
                data = buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self.offset(data, 0), self.length(data, self.so)))
                out.append((mtype, mflags, data))
        return out

    # -- the root group -----------------------------------------------------
    def links(self) -> Dict[str, int]:
        """The root group's members: name -> object header address."""
        names: Dict[str, int] = {}
        for mtype, _, data in self.messages(self.root):
            if mtype == _SYMBOL_TABLE:
                names.update(self._symbol_table(self.offset(data, 0), self.offset(data, self.so)))
            elif mtype == _LINK_INFO:
                pos = 2 + (8 if data[1] & 0x01 else 0)
                if self.offset(data, pos) != UNDEF:
                    self.fail("dense link storage (a fractal heap)")
            elif mtype == _LINK:
                name, addr = self._link(data)
                if addr is not None:
                    names[name] = addr
        return names

    def _link(self, data: bytes):
        flags = data[1]
        p = 2
        kind = 0
        if flags & 0x08:
            kind = data[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 0x03)
        n = int.from_bytes(data[p:p + width], "little")
        p += width
        name = data[p:p + n].decode("utf-8")
        p += n
        return name, (self.offset(data, p) if kind == 0 else None)  # soft/external: skipped

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        head = self.at(heap, 8 + 2 * self.sl + self.so)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        seg_size = self.length(head, 8)
        segment = self.at(self.offset(head, 8 + 2 * self.sl), seg_size)

        def name_at(off: int) -> str:
            return segment[off:segment.index(b"\0", off)].decode("utf-8")

        names: Dict[str, int] = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop()
            head = self.at(node, 8 + 2 * self.so)
            if head[:4] != b"TREE" or head[4] != 0:
                raise ValueError(f"{self.path}: no group B-tree node at {node}")
            level, used = head[5], struct.unpack_from("<H", head, 6)[0]
            body = self.at(node + 8 + 2 * self.so, used * (self.sl + self.so) + self.sl)
            children = [self.offset(body, self.sl + i * (self.sl + self.so)) for i in range(used)]
            if level > 0:
                nodes.extend(children)
                continue
            for snod in children:
                head = self.at(snod, 8)
                if head[:4] != b"SNOD":
                    raise ValueError(f"{self.path}: no symbol node at {snod}")
                count = struct.unpack_from("<H", head, 6)[0]
                entry = 2 * self.so + 24
                body = self.at(snod + 8, count * entry)
                for i in range(count):
                    names[name_at(self.offset(body, i * entry))] = self.offset(body, i * entry + self.so)
        return names

    # -- a dataset ----------------------------------------------------------
    def dataset(self, name: str) -> Tuple[int, Tuple[int, ...], np.dtype]:
        links = self.links()
        if name not in links:
            raise KeyError(f"{self.path}: no dataset {name!r} in the root group "
                           f"(members: {sorted(links)})")
        shape = dtype = layout = None
        for mtype, mflags, data in self.messages(links[name]):
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT) and mflags & 0x02:
                self.fail(f"a shared message (type {mtype:#06x}) in {name!r}")
            if mtype == _FILTERS:
                self.fail(f"a filter pipeline (compression or another filter) on {name!r}")
            elif mtype == _DATASPACE:
                shape = self._dataspace(data, name)
            elif mtype == _DATATYPE:
                dtype = self._datatype(data, name)
            elif mtype == _LAYOUT:
                layout = self._layout(data, name)
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        addr, size = layout
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if size != want:
            raise ValueError(f"{self.path}: {name!r} holds {size} bytes, its shape {shape} "
                             f"and dtype {dtype} {want}")
        return self.base + addr, shape, dtype

    def _dataspace(self, data: bytes, name: str) -> Tuple[int, ...]:
        version, rank = data[0], data[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                self.fail(f"a null dataspace ({name!r})")
            pos = 4
        else:
            self.fail(f"dataspace message version {version}")
        return tuple(self.length(data, pos + i * self.sl) for i in range(rank))

    def _datatype(self, data: bytes, name: str) -> np.dtype:
        cls = data[0] & 0x0F
        bits = data[1] | data[2] << 8 | data[3] << 16
        size = struct.unpack_from("<I", data, 4)[0]
        if cls != 1:
            kind = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else f"class {cls}"
            self.fail(f"the {kind} datatype of {name!r} (only IEEE float is read)")
        if bits & 0x41:
            self.fail(f"a big-endian or VAX-order float ({name!r})")
        offset, precision, e_loc, e_size, m_loc, m_size = struct.unpack_from("<HHBBBB", data, 8)
        mantissa, exponent = {4: (23, 8), 8: (52, 11)}.get(size, (None, None))
        if mantissa is None or (offset, precision, m_loc) != (0, 8 * size, 0) or (
                e_loc, e_size, m_size) != (mantissa, exponent, mantissa):
            self.fail(f"a {8 * size}-bit float that is not IEEE single or double ({name!r})")
        return np.dtype("<f4" if size == 4 else "<f8")

    def _layout(self, data: bytes, name: str) -> Tuple[int, int]:
        version, cls = data[0], data[1]
        if version not in (3, 4):
            self.fail(f"data layout message version {version} ({name!r})")
        if cls != 1:
            kind = {0: "compact", 2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
            self.fail(f"a {kind} layout ({name!r}; only contiguous is read)")
        addr = self.offset(data, 2)
        if addr == UNDEF:
            self.fail(f"an undefined storage address ({name!r} was never written)")
        return addr, self.length(data, 2 + self.so)


def dataset_info(path: str, name: str) -> Tuple[int, Tuple[int, ...], np.dtype]:
    """(byte offset, shape, dtype) of the contiguous, unfiltered dataset
    ``name`` in the root group of the HDF5 file ``path``; raises
    :class:`Unsupported` naming the file and the feature otherwise."""
    r = _Reader(path)
    try:
        return r.dataset(name)
    finally:
        r.close()


def read_dataset(path: str, name: str) -> np.ndarray:
    """The dataset as a read-only ``np.memmap`` (an array for an empty or
    scalar one)."""
    offset, shape, dtype = dataset_info(path, name)
    count = int(np.prod(shape, dtype=np.int64))
    if count == 0 or not shape:
        return np.fromfile(path, dtype=dtype, count=count, offset=offset).reshape(shape)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)


@contextlib.contextmanager
def open_dataset(path: str, name: str) -> Iterator:
    """An array-like of the dataset for slicing: this module's memmap, else,
    where this reader refuses the file and h5py is installed, the h5py
    dataset (with a log line); without h5py the refusal propagates."""
    try:
        array = read_dataset(path, name)
    except Unsupported as reason:
        try:
            import h5py
        except ImportError:
            raise reason from None
        logger.info("%s; reading it with h5py", reason)
        with h5py.File(path, "r") as f:
            yield f[name]
        return
    yield array


# --------------------------------------------------------------------------
# the writer
# --------------------------------------------------------------------------


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataset_header(shape: Tuple[int, ...], dtype: np.dtype, addr: int) -> bytes:
    space = struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)
    size = dtype.itemsize
    e_size, m_size, bias = (8, 23, 127) if size == 4 else (11, 52, 1023)
    # class 1 (float), version 1; byte order LE, mantissa normalized (implied
    # msb), sign bit at the top
    bits = 0x20 | (8 * size - 1) << 8
    dtype_msg = struct.pack("<BBBBI", 0x11, bits & 0xFF, bits >> 8 & 0xFF, bits >> 16, size)
    dtype_msg += struct.pack("<HHBBBBI", 0, 8 * size, m_size, e_size, 0, m_size, bias)
    # fill value v2: allocation early, fill never written, value undefined
    fill = struct.pack("<BBBB", 2, 1, 1, 0)
    nbytes = int(np.prod(shape, dtype=np.int64)) * size
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    return _object_header([_message(_DATASPACE, space), _message(_DATATYPE, dtype_msg, 0x01),
                           _message(0x0005, fill, 0x01), _message(_LAYOUT, layout)])


def create_contiguous(path: str, datasets: Dict[str, Tuple[Tuple[int, ...], object]]
                      ) -> Dict[str, np.memmap]:
    """Write an HDF5 file holding each ``name: (shape, dtype)`` of
    ``datasets`` as a contiguous fp32 or fp64 dataset of the root group, and
    return writable memmaps of them (their content starts zeroed; flush or
    drop them when filled; an empty or scalar dataset gets none). h5py opens
    the file as any other."""
    specs = []
    for name, (shape, dtype) in sorted(datasets.items()):
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype("<f4"), np.dtype("<f8")):
            raise ValueError(f"{name!r}: only little-endian float32/float64 is written, "
                             f"not {dtype}")
        specs.append((name, tuple(int(n) for n in shape), dtype))
    if not specs:
        raise ValueError("no dataset to write")
    leaf_k = max(4, (len(specs) + 1) // 2)  # one symbol node holds every member
    internal_k = 16

    # the local heap's data segment: "" at 0, then the names
    segment = bytearray(8)
    name_offsets = []
    for name, _, _ in specs:
        name_offsets.append(len(segment))
        raw = name.encode("utf-8") + b"\0"
        segment += raw + b"\0" * (_pad8(len(raw)) - len(raw))

    sb_size = 56 + 40
    root_hdr = sb_size
    root_hdr_size = 16 + 8 + 16
    btree = root_hdr + root_hdr_size
    btree_size = 24 + (2 * internal_k) * 8 + (2 * internal_k + 1) * 8
    heap = btree + btree_size
    heap_seg = heap + 32
    snod = heap_seg + len(segment)
    snod_size = 8 + 2 * leaf_k * 40
    pos = snod + snod_size
    headers = []
    for name, shape, dtype in specs:
        headers.append(pos)
        pos += len(_dataset_header(shape, dtype, 0))
    data_addrs = []
    for name, shape, dtype in specs:
        pos = (pos + 4095) & ~4095
        data_addrs.append(pos)
        pos += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    eof = pos

    def entry(name_off: int, header: int, cache: int = 0, scratch: bytes = b"") -> bytes:
        return struct.pack("<QQII", name_off, header, cache, 0) + scratch.ljust(16, b"\0")

    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, internal_k, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    sb += entry(0, root_hdr, 1, struct.pack("<QQ", btree, heap))
    root = _object_header([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
    tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
    tree += struct.pack("<QQQ", 0, snod, name_offsets[-1])
    heap_hdr = b"HEAP" + struct.pack("<B3xQQQ", 0, len(segment), 1, heap_seg)
    node = b"SNOD" + struct.pack("<BBH", 1, 0, len(specs))
    node += b"".join(entry(off, hdr) for off, hdr in zip(name_offsets, headers))

    with open(path, "wb") as f:
        for addr, blob in ((0, sb), (root_hdr, root), (btree, tree), (heap, heap_hdr),
                           (heap_seg, bytes(segment)), (snod, node)):
            f.seek(addr)
            f.write(blob)
        for (name, shape, dtype), hdr, addr in zip(specs, headers, data_addrs):
            f.seek(hdr)
            f.write(_dataset_header(shape, dtype, addr))
        f.truncate(eof)
    out = {}
    for (name, shape, dtype), addr in zip(specs, data_addrs):
        if int(np.prod(shape, dtype=np.int64)) == 0 or not shape:
            continue
        out[name] = np.memmap(path, dtype=dtype, mode="r+", offset=addr, shape=shape)
    return out
