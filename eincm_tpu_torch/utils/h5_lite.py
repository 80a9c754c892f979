"""A reader and writer for the subset of HDF5 that the datasets use.

The card's machine has no h5py. This module reads, in numpy and zlib,
what h5py writes by default (`libver="earliest"`), following the HDF5 File
Format Specification (version 3.0):

- superblock version 0 or 1, 8-byte offsets and lengths;
- version 1 object headers, with continuation blocks;
- symbol-table groups (version 1 B-tree group nodes, local heaps, `SNOD`
  nodes), so a path such as `davis/left/events` resolves;
- scalar and simple dataspaces;
- fixed-point (signed or unsigned) and IEEE floating-point datatypes, little
  or big endian;
- layout message version 3: compact, contiguous, and chunked with the
  version 1 chunk B-tree, through the deflate and shuffle filters and the
  Blosc filter (32001, as hdf5plugin writes it for real DSEC files:
  `utils/blosc.py`, its blosclz, LZ4 and zlib codecs).

Anything else raises `UnsupportedHDF5`, naming the file, the object and the
feature ("filter 32000 (LZF)", "filter 32001 (Blosc) codec 4 (Zstd)",
"layout message v4", "superblock v2"); it never returns a guess. A contiguous dataset is read with one `np.fromfile`.

`write_h5(path, {path: array})` writes contiguous datasets and scalars in
the same format family (h5py reads them); the loaders never call it.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from eincm_tpu_torch.utils import blosc

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address

_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
            6: "scaleoffset", 32000: "LZF", 32001: "Blosc", 32004: "LZ4",
            32008: "bitshuffle", 32015: "Zstandard"}
_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
            4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
            8: "enumerated", 9: "variable-length", 10: "array"}
_LAYOUTS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}

# message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTER = 0x1, 0x3, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE, _LINK, _LINK_INFO = 0x10, 0x11, 0x6, 0x2


class UnsupportedHDF5(ValueError):
    """An HDF5 feature outside the subset this module reads."""


class File:
    """One HDF5 file opened for reading: `read(path)` gives a dataset as a
    numpy array (a 0-d array for a scalar)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        try:
            self._root = self._superblock()
        except BaseException:
            self._f.close()
            raise

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- helpers

    def _unsupported(self, obj: str, feature: str):
        return UnsupportedHDF5(f"{self.path}: {obj}: {feature} is not supported")

    def _read(self, addr: int, n: int) -> bytes:
        self._f.seek(addr)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at byte {addr} (+{n})")
        return data

    def _superblock(self) -> int:
        head = self._read(0, 16)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (or a user block)")
        version = head[8]
        if version not in (0, 1):
            raise self._unsupported("superblock", f"superblock v{version}")
        if head[13] != 8 or head[14] != 8:
            raise self._unsupported("superblock", f"{head[13]}-byte offsets and "
                                    f"{head[14]}-byte lengths")
        pos = 24 + (4 if version == 1 else 0)
        base, _, _, _ = struct.unpack("<4Q", self._read(pos, 32))
        if base != 0:
            raise self._unsupported("superblock", f"base address {base}")
        # the root group's symbol table entry: its object header's address
        _, root = struct.unpack("<2Q", self._read(pos + 32, 16))
        return root

    # ------------------------------------------------------ object headers

    def _messages(self, addr: int, obj: str) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of a version 1 object header,
        continuation blocks followed."""
        head = self._read(addr, 16)
        if head[0] != 1:
            if head[:4] == b"OHDR":
                raise self._unsupported(obj, "object header v2")
            raise self._unsupported(obj, f"object header v{head[0]}")
        n_msgs, _, size = struct.unpack("<HII", head[2:12])
        blocks = [(addr + 16, size)]
        out: List[Tuple[int, bytes]] = []
        while blocks:
            start, length = blocks.pop(0)
            data = self._read(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack("<HHB", data[pos:pos + 5])
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack("<QQ", body[:16]))
                if flags & 0x02:
                    raise self._unsupported(obj, "a shared message")
                out.append((mtype, body))
        return out

    def _find(self, parts: List[str]) -> Tuple[int, str]:
        addr, obj = self._root, "/"
        for name in parts:
            msgs = self._messages(addr, obj)
            table = [b for t, b in msgs if t == _SYMBOL_TABLE]
            if not table:
                if any(t in (_LINK, _LINK_INFO) for t, _ in msgs):
                    raise self._unsupported(obj, "a group with link messages "
                                            "(new-style group)")
                raise KeyError(f"{self.path}: {obj} is not a group")
            btree, heap = struct.unpack("<QQ", table[0][:16])
            children = self._group_entries(btree, heap, obj)
            if name not in children:
                raise KeyError(f"{self.path}: no object {name!r} in {obj}")
            addr = children[name]
            obj = obj.rstrip("/") + "/" + name
        return addr, obj

    def _group_entries(self, btree: int, heap: int, obj: str) -> Dict[str, int]:
        hd = self._read(heap, 32)
        if hd[:4] != b"HEAP":
            raise ValueError(f"{self.path}: {obj}: bad local heap signature")
        seg_size, _, seg_addr = struct.unpack("<3Q", hd[8:32])
        names = self._read(seg_addr, seg_size)
        out: Dict[str, int] = {}
        for snod in self._btree_children(btree, 0, obj):
            sd = self._read(snod, 8)
            if sd[:4] != b"SNOD":
                raise ValueError(f"{self.path}: {obj}: bad symbol node signature")
            (n,) = struct.unpack("<H", sd[6:8])
            entries = self._read(snod + 8, 40 * n)
            for k in range(n):
                name_off, hdr = struct.unpack("<QQ", entries[40 * k:40 * k + 16])
                end = names.index(b"\0", name_off)
                out[names[name_off:end].decode()] = hdr
        return out

    def _btree_children(self, addr: int, node_type: int, obj: str, ndims: int = 0):
        """Leaf entries of a version 1 B-tree: child addresses (group nodes)
        or (chunk size, filter mask, offsets, address) (chunk nodes)."""
        hd = self._read(addr, 24)
        if hd[:4] != b"TREE" or hd[4] != node_type:
            raise ValueError(f"{self.path}: {obj}: bad B-tree node")
        level, used = hd[5], struct.unpack("<H", hd[6:8])[0]
        key = 8 if node_type == 0 else 8 + 8 * ndims
        body = self._read(addr + 24, used * (key + 8) + key)
        out = []
        for i in range(used):
            k = body[i * (key + 8):i * (key + 8) + key]
            (child,) = struct.unpack("<Q", body[i * (key + 8) + key:(i + 1) * (key + 8)])
            if level > 0:
                out += self._btree_children(child, node_type, obj, ndims)
            elif node_type == 0:
                out.append(child)
            else:
                size, mask = struct.unpack("<II", k[:8])
                offsets = struct.unpack(f"<{ndims}Q", k[8:])
                out.append((size, mask, offsets, child))
        return out

    # ------------------------------------------------------------ datasets

    def read(self, path: str) -> np.ndarray:
        """The dataset at `path` ('a/b/c'), as h5py's `np.asarray(f[path])`."""
        parts = [p for p in path.split("/") if p]
        addr, obj = self._find(parts)
        msgs = self._messages(addr, obj)
        by_type: Dict[int, bytes] = {}
        for t, b in msgs:
            by_type.setdefault(t, b)
        if _LAYOUT not in by_type:
            raise KeyError(f"{self.path}: {obj} is not a dataset")
        shape = self._dataspace(by_type[_DATASPACE], obj)
        dtype = self._datatype(by_type[_DATATYPE], obj)
        filters = self._filters(by_type[_FILTER], obj) if _FILTER in by_type else []
        return self._data(by_type[_LAYOUT], shape, dtype, filters, obj)

    def _dataspace(self, b: bytes, obj: str) -> Tuple[int, ...]:
        version, rank, flags = b[0], b[1], b[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if b[3] == 2:
                raise self._unsupported(obj, "a null dataspace")
            pos = 4
        else:
            raise self._unsupported(obj, f"dataspace message v{version}")
        if version == 1 and flags & 0x02:
            raise self._unsupported(obj, "a dataspace permutation index")
        return tuple(struct.unpack(f"<{rank}Q", b[pos:pos + 8 * rank]))

    def _datatype(self, b: bytes, obj: str) -> np.dtype:
        cls, version = b[0] & 0x0F, b[0] >> 4
        bits = b[1] | b[2] << 8 | b[3] << 16
        (size,) = struct.unpack("<I", b[4:8])
        if cls not in (0, 1):
            raise self._unsupported(obj, f"datatype class {cls} "
                                    f"({_CLASSES.get(cls, 'unknown')})")
        order = ">" if bits & 0x01 else "<"
        offset, precision = struct.unpack("<HH", b[8:12])
        if offset != 0 or precision != 8 * size:
            raise self._unsupported(obj, f"a {precision}-bit field at bit {offset} "
                                    f"of a {size}-byte element")
        if cls == 0:
            if size not in (1, 2, 4, 8):
                raise self._unsupported(obj, f"a {size}-byte integer")
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if bits & 0x40:
            raise self._unsupported(obj, "VAX float byte order")
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                8: (63, 52, 11, 0, 52, 1023)}
        sign = (bits >> 8) & 0xFF
        if size not in ieee or (sign, *b[12:16], struct.unpack("<I", b[16:20])[0]) != ieee[size]:
            raise self._unsupported(obj, f"a non-IEEE {size}-byte float")
        return np.dtype(f"{order}f{size}")

    def _filters(self, b: bytes, obj: str) -> List[Tuple[int, int, Tuple[int, ...]]]:
        version, n = b[0], b[1]
        if version not in (1, 2):
            raise self._unsupported(obj, f"filter pipeline message v{version}")
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            (fid,) = struct.unpack("<H", b[pos:pos + 2])
            if version == 1 or fid >= 256:
                name_len, flags, n_vals = struct.unpack("<HHH", b[pos + 2:pos + 8])
                pos += 8
            else:
                name_len = 0
                flags, n_vals = struct.unpack("<HH", b[pos + 2:pos + 6])
                pos += 6
            pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
            vals = struct.unpack(f"<{n_vals}I", b[pos:pos + 4 * n_vals])
            pos += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
            if fid not in (1, 2, 32001):
                raise self._unsupported(obj, f"filter {fid} "
                                        f"({_FILTERS.get(fid, 'unregistered')})")
            out.append((fid, flags, vals))
        return out

    def _data(self, b: bytes, shape, dtype: np.dtype, filters, obj: str) -> np.ndarray:
        version, cls = b[0], b[1]
        if version != 3:
            raise self._unsupported(obj, f"layout message v{version}")
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 0:  # compact
            (size,) = struct.unpack("<H", b[2:4])
            return np.frombuffer(b[4:4 + size], dtype, count).reshape(shape).copy()
        if cls == 1:  # contiguous
            addr, size = struct.unpack("<QQ", b[2:18])
            if addr == UNDEF:  # never written: h5py gives the fill value 0
                return np.zeros(shape, dtype)
            self._f.seek(addr)
            out = np.fromfile(self._f, dtype, count)
            if out.size != count:
                raise ValueError(f"{self.path}: {obj}: truncated data")
            return out.reshape(shape)
        if cls != 2:
            raise self._unsupported(obj, f"{_LAYOUTS.get(cls, cls)} layout")
        ndims = b[2]
        (btree,) = struct.unpack("<Q", b[3:11])
        chunk = struct.unpack(f"<{ndims}I", b[11:11 + 4 * ndims])[:-1]
        out = np.zeros(shape, dtype)
        if btree == UNDEF:
            return out
        n_chunk = int(np.prod(chunk, dtype=np.int64))
        for size, mask, offsets, addr in self._btree_children(btree, 1, obj, ndims):
            raw = self._read(addr, size)
            for i, (fid, _, vals) in reversed(list(enumerate(filters))):
                if mask & (1 << i):
                    continue
                if fid == 1:
                    raw = zlib.decompress(raw)
                elif fid == 32001:
                    try:
                        raw = blosc.decompress(raw)
                    except blosc.UnsupportedBlosc as e:
                        raise self._unsupported(obj, f"filter 32001 (Blosc) {e}") from None
                else:  # shuffle: the bytes of each element were grouped by position
                    width = vals[0] if vals else dtype.itemsize
                    n = len(raw) // width
                    head = np.frombuffer(raw[:n * width], np.uint8).reshape(width, n)
                    raw = head.T.tobytes() + raw[n * width:]
            block = np.frombuffer(raw, dtype, n_chunk).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out


# ---------------------------------------------------------------- writing

_LEAF_K = 4  # the group leaf node K h5py writes; raised when a group is larger
_INTERNAL_K = 16


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return (struct.pack("<BBBBI", 0x10, bits, 0, 0, size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in (2, 4, 8):
        sign, exp_loc, exp_size, mant_size, bias = {
            2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
            8: (63, 52, 11, 52, 1023)}[size]
        return (struct.pack("<BBBBI", 0x11, order | 0x20, sign, 0, size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0,
                              mant_size, bias))
    raise UnsupportedHDF5(f"write_h5: dtype {dtype} is not supported "
                          "(integers and IEEE floats only)")


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def alloc(self, n: int) -> int:
        addr = len(self.buf)
        self.buf += b"\0" * (n + (-n % 8))
        return addr

    def put(self, addr: int, data: bytes):
        self.buf[addr:addr + len(data)] = data

    def append(self, data: bytes) -> int:
        addr = self.alloc(len(data))
        self.put(addr, data)
        return addr


def write_h5(path, datasets: Dict[str, np.ndarray]) -> None:
    """Write `{'a/b/name': array}` as an HDF5 file: symbol-table groups,
    contiguous datasets (a 0-d array or a Python number is a scalar)."""
    tree: dict = {}
    for key, value in datasets.items():
        parts = [p for p in key.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"write_h5: {key}: {p} is a dataset")
        if parts[-1] in node:
            raise ValueError(f"write_h5: {key} given twice")
        node[parts[-1]] = np.asarray(value)
    leaf_k = max(_LEAF_K, max(_largest_group(tree) + 1, 2) // 2)

    w = _Writer()
    w.alloc(96)  # superblock v0 with the root symbol table entry
    root, btree, heap = _write_group(w, tree, leaf_k)
    sb = (SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
          + struct.pack("<HHI", leaf_k, _INTERNAL_K, 0)
          + struct.pack("<4Q", 0, UNDEF, len(w.buf), UNDEF)
          + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap))
    w.put(0, sb)
    Path(path).write_bytes(bytes(w.buf))


def _largest_group(tree: dict) -> int:
    return max([len(tree)] + [_largest_group(v) for v in tree.values()
                              if isinstance(v, dict)])


def _write_group(w: _Writer, tree: dict, leaf_k: int) -> Tuple[int, int, int]:
    """Write a group's members, then its heap, symbol node and B-tree leaf;
    returns the addresses of its object header, B-tree and heap."""
    names = sorted(tree)  # a symbol node's entries are sorted by name
    members = []
    for name in names:
        value = tree[name]
        if isinstance(value, dict):
            members.append(_write_group(w, value, leaf_k))
        else:
            members.append((_write_dataset(w, value), None, None))

    heap_data = bytearray(b"\0" * 8)  # offset 0: the empty name
    offsets = []
    for name in names:
        offsets.append(len(heap_data))
        heap_data += _pad8(name.encode() + b"\0")
    seg = w.append(bytes(heap_data))
    heap = w.append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, seg))

    snod = w.alloc(8 + 2 * leaf_k * 40)
    entries = b"".join(
        struct.pack("<QQII", off, hdr, 1 if bt is not None else 0, 0)
        + (struct.pack("<QQ", bt, hp) if bt is not None else b"\0" * 16)
        for off, (hdr, bt, hp) in zip(offsets, members))
    w.put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + entries)

    btree = w.alloc(24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8)
    last = offsets[-1] if offsets else 0
    w.put(btree, b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
          + struct.pack("<QQQ", 0, snod, last))

    header = w.append(_object_header([
        _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
    return header, btree, heap


def _write_dataset(w: _Writer, value: np.ndarray) -> int:
    dtype = value.dtype
    if dtype == np.bool_:
        raise UnsupportedHDF5("write_h5: bool arrays are not supported "
                              "(h5py writes them as an enum); cast to uint8")
    dt = _datatype_message(dtype)
    space = struct.pack("<BBBB4x", 1, value.ndim, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in value.shape)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # the type's default fill, as h5py
    data = value.tobytes(order="C")
    addr = w.append(data) if data else UNDEF
    layout = struct.pack("<BBQQ", 3, 1, addr, len(data))
    return w.append(_object_header([
        _message(_DATASPACE, space), _message(_DATATYPE, dt, flags=1),
        _message(0x5, fill, flags=1), _message(_LAYOUT, layout)]))
