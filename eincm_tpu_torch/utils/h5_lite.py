"""A reader and writer for the subset of HDF5 that the datasets use.

The card's machine has no h5py. This module reads, in numpy and zlib, what
h5py writes under every `libver`, from "earliest" (its default) to
"latest" (and so every file written for SWMR), following the HDF5 File
Format Specification (version 3.0); the structures of the newer format
live in `utils/h5_latest.py`:

- superblock versions 0 to 3, 8-byte offsets and lengths (a version 2 or 3
  superblock's checksum checked and its extension read; a version 3 file
  still marked open for writing raises, as h5py refuses it);
- object headers of version 1 and 2 (`OHDR`, `OCHK`, every chunk's
  checksum), continuation blocks followed;
- groups by symbol table (version 1 B-tree, local heap, `SNOD`) and by
  link messages, compact or dense (fractal heap, version 2 B-tree name
  index), so a path such as `davis/left/events` resolves; soft links are
  followed as h5py follows them;
- scalar, simple and null dataspaces (`read` of a null one raises
  TypeError, as numpy does on h5py's dataset; `read_value` gives `Empty`);
- fixed-point and IEEE floating-point datatypes, little or big endian;
  enumerations (h5py's bool enum as numpy `bool`, any other as its base
  integer type); fixed-length strings as `S{n}` and variable-length
  strings as an object array of `bytes` (from the global heap), padded
  and cut as h5py gives them; compound types as h5py's structured dtype
  (nested, with array, enum, bool and string members; {r, i} as complex);
  array types; variable-length sequences as an object array of 1-D
  arrays; object and dataset region references as an object array of
  `Reference` / `RegionReference` (`dereference`, `read_region`);
- committed datatypes: a message shared in another object header;
- fill values (the old and the new message), wherever h5py uses them:
  storage never allocated, chunks that no index lists;
- layout messages version 3 and 4: compact, contiguous, and chunked
  through the version 1 chunk B-tree or any of version 4's five chunk
  indexes (single chunk, implicit, fixed array, extensible array, version
  2 B-tree); virtual datasets (their sources in this file, in others or
  missing, unlimited and printf-style mappings); external data files;
- the filters deflate, shuffle, Fletcher-32 (checked and stripped: a
  mismatch raises naming the chunk), h5py's LZF (32000), Blosc (32001, as
  hdf5plugin writes it for real DSEC files: `utils/blosc.py`, every codec
  of c-blosc 1.x) and hdf5plugin's Zstandard (32015: a chunk is Zstandard
  frames). LZF and Zstd chunks go through the native library
  (`native/blosc.cpp`, `native/zstd.cpp`); LZF has a plain Python decoder
  where it did not build, Zstd none: without it filter 32015 and Blosc's
  Zstd raise;
- external links, followed into the file they name as soft links are.

The structures that point at other objects or files live in
`utils/h5_features.py`, which also says where HDF5 looks for a file that
a link, a virtual dataset or an external data file names; a file opened
on the way is opened once and closed with the file that reached it.

Anything else raises `UnsupportedHDF5`, naming the file, the object and the
feature ("filter 32008 (bitshuffle)", "datatype class 5 (opaque)", "a
message shared through the SOHM table"); it never returns a guess. A
malformed file raises `ValueError`: every field is bounds-checked, and an
index, heap, B-tree or link chain that points back at itself raises
instead of looping. A contiguous dataset is read with one `np.fromfile`.

`write_h5(path, {path: array})` writes contiguous datasets and scalars in
the version 0 format (h5py reads them); the loaders never call it.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from eincm_tpu_torch.native import blosc as native_blosc
from eincm_tpu_torch.utils import blosc, h5_features, h5_latest
from eincm_tpu_torch.utils.h5_features import (
    Empty, Reference, RegionReference, UnsupportedHDF5,
)
from eincm_tpu_torch.utils.h5_latest import Cursor, check_sum

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address (and an unlimited dimension)

_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
            6: "scaleoffset", 32000: "LZF", 32001: "Blosc", 32004: "LZ4",
            32008: "bitshuffle", 32015: "Zstandard", 32026: "Blosc2"}
_READ_FILTERS = (1, 2, 3, 32000, 32001, 32015)
_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
            4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
            8: "enumerated", 9: "variable-length", 10: "array"}
_LAYOUTS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTER = 0x6, 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# a message's header in object headers v1 and v2 (type, size, flags); a
# symbol table entry (name's heap offset, object header, cache type, scratch)
_MSG_V1, _MSG_V2 = struct.Struct("<HHB3x"), struct.Struct("<BHB")
_SYMBOL_ENTRY = struct.Struct("<QQI4x16s")

# `_fill`'s answer for an undefined fill value: zeros in a chunk no index
# lists, but nothing at all where no storage was ever allocated (h5py fails)
_UNDEFINED_FILL = b""
# soft and external links followed in one lookup, as HDF5 (H5L_NUM_LINKS)
_MAX_SOFT_LINKS = 16
# a variable-length element: its length, then the global heap object's ID;
# a dataset region reference: the global heap object's ID
_VLEN = np.dtype([("n", "<u4"), ("collection", "<u8"), ("index", "<u4")])
_REGION = np.dtype([("collection", "<u8"), ("index", "<u4")])
_OBJECT_KINDS = ("vlen string", "vlen", "reference", "region reference")


class _Type:
    """A dataset's datatype: the numpy dtype its elements are stored as,
    and what h5py makes of them (`kind`: "plain", "bool", "string" with its
    padding `pad` (0 null-terminated, 1 null-padded, 2 space-padded), "vlen
    string", "vlen" (a sequence of `base`), "array" (`dims` of `base`),
    "compound" (`members`: (name, offset, type)), "reference", "region
    reference")."""

    __slots__ = ("storage", "kind", "pad", "base", "dims", "members")

    def __init__(self, storage: np.dtype, kind: str = "plain", pad: int = 0, base=None,
                 dims: Tuple[int, ...] = (), members=()):
        self.storage, self.kind, self.pad = storage, kind, pad
        self.base, self.dims, self.members = base, dims, tuple(members)

    @property
    def out(self) -> np.dtype:
        """The dtype h5py gives."""
        if self.kind in ("plain", "string"):
            return self.storage
        if self.kind == "bool":
            return np.dtype(bool)
        if self.kind in _OBJECT_KINDS:
            return np.dtype(object)
        if self.kind == "array":
            return np.dtype((self.base.out, self.dims))
        names = [m[0] for m in self.members]
        types = [m[2] for m in self.members]
        f = types[0].storage
        # h5py reads a compound {r, i} of two equal floats as numpy complex
        if (names == ["r", "i"] and all(t.kind == "plain" and t.storage == f for t in types)
                and f.kind == "f" and f.itemsize in (4, 8)
                and [m[1] for m in self.members] == [0, f.itemsize]
                and self.storage.itemsize == 2 * f.itemsize):
            return np.dtype(f"{f.byteorder if f.byteorder in '<>' else '='}c{2 * f.itemsize}")
        return np.dtype({"names": names, "formats": [t.out for t in types],
                         "offsets": [m[1] for m in self.members],
                         "itemsize": self.storage.itemsize})

    @property
    def converts(self) -> bool:
        """Whether h5py's elements differ from the stored bytes."""
        if self.kind == "compound":
            return self.out != self.storage or any(m[2].converts for m in self.members)
        if self.kind == "array":
            return self.base.converts
        return not (self.kind == "plain" or self.kind == "string" and self.pad == 1)

    @property
    def io(self) -> np.dtype:
        """The dtype the storage is read as: an array type's elements as
        opaque bytes (numpy would fold its dimensions into the shape)."""
        return np.dtype(f"V{self.storage.itemsize}") if self.kind == "array" else self.storage


class _Opened:
    """What a file shares with the files it opened through external links
    and virtual datasets: those files, by (device, inode), each opened once
    and closed with it, and the virtual datasets being read (a dataset
    that is its own source raises)."""

    def __init__(self):
        self.files: Dict[Tuple[int, int], "File"] = {}
        self.reading: set = set()


class File:
    """One HDF5 file opened for reading: `read(path)` gives a dataset as a
    numpy array (a 0-d array for a scalar), `read_value(path)` as h5py's
    `f[path][()]`, `dereference(ref)` a reference's path and
    `read_region(ref)` a region reference's elements."""

    def __init__(self, path, _opened: Optional[_Opened] = None):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        try:
            st = os.fstat(self._f.fileno())
            self._size = st.st_size
            # the directory HDF5 resolves external names against (H5F_EXTPATH)
            self._origin = os.path.dirname(os.path.abspath(self.path))
            self._owner = _opened is None
            self._opened = _Opened() if _opened is None else _opened
            self._groups: Dict[int, Dict[str, Tuple[str, object]]] = {}  # _links by address
            self._shared_msgs: Dict[Tuple[int, int], bytes] = {}
            self._sharing: set = set()
            self._paths: Optional[Dict[int, str]] = None
            self._global_heap = h5_latest.GlobalHeap(self._read, str(self.path))
            self._root = self._superblock()
        except BaseException:
            self._f.close()
            raise
        self._opened.files.setdefault((st.st_dev, st.st_ino), self)

    def close(self):
        if self._owner:
            for f in self._opened.files.values():
                if f is not self:
                    f._f.close()
            self._opened.files.clear()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- helpers

    def _unsupported(self, obj: str, feature: str):
        return UnsupportedHDF5(f"{self.path}: {obj}: {feature} is not supported")

    def _where(self, obj: str, what: str) -> str:
        return f"{self.path}: {obj}: {what}"

    def _read(self, addr: int, n: int) -> bytes:
        if addr < 0 or n < 0 or addr + n > self._size:
            raise ValueError(f"{self.path}: truncated: {n} bytes at {addr} run past the end "
                             f"of the {self._size}-byte file")
        self._f.seek(addr)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at byte {addr} (+{n})")
        return data

    def _open(self, name: str, kind: str) -> Optional["File"]:
        """The file that `name` names from this one (an external link's,
        kind "link", or a virtual dataset's source, "vds") at the first
        place HDF5 looks where one exists (`h5_features.candidates`), opened
        once; None where there is none."""
        for path in h5_features.candidates(name, kind, self._origin):
            if not os.path.isfile(path):
                continue
            st = os.stat(path)
            key = (st.st_dev, st.st_ino)
            if key not in self._opened.files:
                File(path, self._opened)  # registers itself
            return self._opened.files[key]
        return None

    def _superblock(self) -> int:
        head = self._read(0, min(16, self._size))
        if head[:8] != SIGNATURE or len(head) < 16:
            raise ValueError(f"{self.path}: not an HDF5 file (or a user block)")
        version = head[8]
        if version not in (0, 1, 2, 3):
            raise self._unsupported("superblock", f"superblock v{version}")
        sizes = (head[13], head[14]) if version < 2 else (head[9], head[10])
        if sizes != (8, 8):
            raise self._unsupported("superblock", f"{sizes[0]}-byte offsets and "
                                    f"{sizes[1]}-byte lengths")
        where = self._where("superblock", f"version {version}")
        if version < 2:
            pos = 24 + (4 if version == 1 else 0)
            c = Cursor(self._read(0, pos + 48), where, pos)
            base, _, eof = c.u64(), c.u64(), c.u64()
            c.take(8 + 8)  # the I/O info block's address; the root entry's name offset
            root = c.u64()  # the root group's symbol table entry: its object header
        else:
            sb = self._read(0, 48)
            check_sum(sb, where)
            c = Cursor(sb, where, 12)
            base, extension, eof, root = c.u64(), c.u64(), c.u64(), c.u64()
            if version == 3 and sb[11] & 0x05:
                raise ValueError(f"{self.path}: the file is marked open for writing "
                                 f"(superblock flags {sb[11]:#x}), as a writer that did not "
                                 "close it leaves it; h5clear -s clears the mark")
            if extension != UNDEF:
                self._messages(extension, "superblock extension")
        if base != 0:
            raise self._unsupported("superblock", f"base address {base}")
        if eof > self._size:  # as HDF5, which refuses a file shorter than it says
            raise ValueError(f"{self.path}: truncated: the superblock gives {eof} bytes, the "
                             f"file has {self._size}")
        return root

    # ------------------------------------------------------ object headers

    def _messages(self, addr: int, obj: str) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of an object header (version 1 or
        2), continuation blocks followed."""
        head = self._read(addr, 4)
        if head == b"OHDR":
            return self._messages_v2(addr, obj)
        if head[0] != 1:
            raise self._unsupported(obj, f"object header v{head[0]}")
        where = self._where(obj, f"object header at {addr}")
        c = Cursor(self._read(addr, 16), where, 2)
        n_msgs, _, size = c.u16(), c.u32(), c.u32()
        blocks, seen = [(addr + 16, size)], set()
        out: List[Tuple[int, bytes]] = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            h5_latest.visit_once(seen, start, where)
            b = Cursor(self._read(start, length), f"{where}: block at {start}")
            while b.left() >= 8 and len(out) < n_msgs:
                mtype, msize, flags = b.unpack(_MSG_V1)
                self._message(out, blocks, mtype, b.take(msize), flags, obj)
        return out

    def _messages_v2(self, addr: int, obj: str) -> List[Tuple[int, bytes]]:
        where = self._where(obj, f"object header at {addr}")
        c = Cursor(self._read(addr, 6), where)
        c.signature(b"OHDR", 2)
        flags = c.u8()
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)  # times, phases
        width = 1 << (flags & 0x03)
        size = int.from_bytes(self._read(addr + pos, width), "little")
        blocks = [(addr, pos + width + size + 4)]
        order = 2 if flags & 0x04 else 0  # each message's creation order
        seen: set = set()
        out: List[Tuple[int, bytes]] = []
        while blocks:
            start, length = blocks.pop(0)
            h5_latest.visit_once(seen, start, where)
            bw = f"{where}: block at {start}"
            block = self._read(start, length)
            check_sum(block, bw)
            if start != addr and block[:4] != b"OCHK":
                raise ValueError(f"{bw}: not an OCHK block")
            b = Cursor(block[:-4], bw, pos + width if start == addr else 4)
            while b.left() >= 4 + order:  # less is a gap
                mtype, msize, mflags = b.unpack(_MSG_V2)
                b.take(order)
                self._message(out, blocks, mtype, b.take(msize), mflags, obj)
        return out

    def _message(self, out, blocks, mtype: int, body: bytes, flags: int, obj: str) -> None:
        if mtype == _CONTINUATION:
            c = Cursor(body, self._where(obj, "continuation message"))
            blocks.append((c.u64(), c.u64()))
        if flags & 0x02:
            body = self._shared(mtype, body, obj)
        out.append((mtype, body))

    def _shared(self, mtype: int, body: bytes, obj: str) -> bytes:
        """The body of a message shared in another object header (a
        committed datatype): that header's first message of its type."""
        where = self._where(obj, f"message {mtype:#x}")
        addr = h5_features.shared_address(body, where)
        key = (addr, mtype)
        if key not in self._shared_msgs:
            if key in self._sharing:
                raise ValueError(f"{where}: shared from the object header at {addr}, which "
                                 "shares it back (a cycle)")
            self._sharing.add(key)
            try:
                found = [b for t, b in self._messages(addr, f"{obj} (shared from {addr})")
                         if t == mtype]
            finally:
                self._sharing.discard(key)
            if not found:
                raise ValueError(f"{where}: shared from the object header at {addr}, which "
                                 f"holds no message {mtype:#x}")
            self._shared_msgs[key] = found[0]
        return self._shared_msgs[key]

    # -------------------------------------------------------------- groups

    def _find(self, parts: List[str]) -> Tuple[int, str]:
        """(its object header's address, its path) of the object at `parts`
        in this file."""
        f, addr, obj = self._locate(parts)
        if f is not self:
            raise KeyError(f"{self.path}: {obj} is in {f.path}")
        return addr, obj

    def _locate(self, parts: List[str]) -> Tuple["File", int, str]:
        """(the file that holds it, its object header's address, its path)
        of the object at `parts`, links followed into other files."""
        return self._resolve(self._root, "/", parts, [0])

    def _resolve(self, addr: int, obj: str, parts: List[str], hops: List[int]):
        if not parts:
            return self, addr, obj
        name, rest = parts[0], parts[1:]
        links = self._links(addr, obj)
        if name not in links:
            raise KeyError(f"{self.path}: no object {name!r} in {obj}")
        kind, target = links[name]
        child = obj.rstrip("/") + "/" + name
        if kind == "hard":
            return self._resolve(target, child, rest, hops)
        if kind not in ("soft", "external"):
            raise self._unsupported(child, f"{kind} ({target})")
        hops[0] += 1
        if hops[0] > _MAX_SOFT_LINKS:
            raise ValueError(f"{self.path}: {child}: more than {_MAX_SOFT_LINKS} soft links and "
                             "external links in one lookup (a cycle?)")
        if kind == "soft":
            start = (self._root, "/") if target.startswith("/") else (addr, obj)
            f, at, _ = self._resolve(*start, _parts(target), hops)
        else:
            name, path = target
            f = self._open(name, "link")
            if f is None:
                raise KeyError(f"{self.path}: {child}: an external link to {name}:{path}, and "
                               f"no file {name!r} in "
                               f"{h5_features.candidates(name, 'link', self._origin)}")
            f, at, _ = f._resolve(f._root, "/", _parts(path), hops)
        return f._resolve(at, child, rest, hops)

    def _links(self, addr: int, obj: str) -> Dict[str, Tuple[str, object]]:
        """{name: ("hard", header address) | ("soft", path) | ("external",
        (file, path)) | (other kind, its description)} of the group at
        `addr`."""
        if addr not in self._groups:
            self._groups[addr] = self._group_links(addr, obj)
        return self._groups[addr]

    def _group_links(self, addr: int, obj: str) -> Dict[str, Tuple[str, object]]:
        msgs = self._messages(addr, obj)
        table = [b for t, b in msgs if t == _SYMBOL_TABLE]
        if table:
            c = Cursor(table[0], self._where(obj, "symbol table message"))
            return self._symbol_table(c.u64(), c.u64(), obj)
        info = [b for t, b in msgs if t == _LINK_INFO]
        links = dict(self._link(b, obj) for t, b in msgs if t == _LINK)
        if not info and not links:
            raise KeyError(f"{self.path}: {obj} is not a group")
        if info:
            c = Cursor(info[0], self._where(obj, "link info message"))
            version, flags = c.u8(), c.u8()
            if version != 0:
                raise self._unsupported(obj, f"link info message v{version}")
            if flags & 0x01:
                c.u64()  # the largest creation index
            heap, names = c.u64(), c.u64()
            if heap != UNDEF:  # dense storage
                where = f"{self.path}: {obj}"
                fheap = h5_latest.FractalHeap(self._read, heap, where)
                for rec in h5_latest.btree2_records(self._read, names, 5, where):
                    name, link = self._link(fheap.get(rec[4:]), obj)
                    if h5_latest.lookup3(name.encode()) != int.from_bytes(rec[:4], "little"):
                        raise ValueError(f"{where}: link {name!r} is filed under another "
                                         "name's hash")
                    links[name] = link
        return links

    def _link(self, b: bytes, obj: str) -> Tuple[str, Tuple[str, object]]:
        c = Cursor(b, self._where(obj, "link message"))
        version, flags = c.u8(), c.u8()
        if version != 1:
            raise self._unsupported(obj, f"link message v{version}")
        kind = c.u8() if flags & 0x08 else 0
        if flags & 0x04:
            c.u64()  # creation order
        if flags & 0x10:
            c.u8()  # the name's character set
        name = c.take(c.uint(1 << (flags & 0x03))).decode("utf-8")
        if kind == 0:
            return name, ("hard", c.u64())
        value = c.take(c.u16())
        if kind == 1:
            return name, ("soft", value.decode("utf-8"))
        if kind == 64:  # flags, then the file's and the object's names
            file, _, path = value[1:].rstrip(b"\0").partition(b"\0")
            return name, ("external", (file.decode("utf-8"), path.decode("utf-8")))
        return name, ("a user-defined link", f"type {kind}")

    def _local_heap(self, heap: int, obj: str) -> bytes:
        """The data segment of the local heap at `heap`."""
        hw = self._where(obj, f"local heap at {heap}")
        hd = Cursor(self._read(heap, 32), hw)
        if hd.take(4) != b"HEAP":
            raise ValueError(f"{hw}: bad local heap signature")
        hd.take(4)
        seg_size, _, seg_addr = hd.u64(), hd.u64(), hd.u64()
        return self._read(seg_addr, seg_size)

    def _symbol_table(self, btree: int, heap: int, obj: str) -> Dict[str, Tuple[str, object]]:
        hw = self._where(obj, f"local heap at {heap}")
        names = self._local_heap(heap, obj)
        out: Dict[str, Tuple[str, object]] = {}
        for snod in self._btree1(btree, 0, obj):
            sw = self._where(obj, f"symbol node at {snod}")
            sd = Cursor(self._read(snod, 8), sw)
            if sd.take(4) != b"SNOD":
                raise ValueError(f"{sw}: bad symbol node signature")
            sd.take(2)
            n = sd.u16()
            e = Cursor(self._read(snod + 8, 40 * n), sw)
            for _ in range(n):
                name_off, hdr, cache, scratch = e.unpack(_SYMBOL_ENTRY)
                name = _cstr(names, name_off, hw).decode("utf-8")
                if cache == 2:  # a soft link: its value's offset in the heap
                    out[name] = ("soft", _cstr(names, int.from_bytes(scratch[:4], "little"),
                                               hw).decode("utf-8"))
                else:
                    out[name] = ("hard", hdr)
        return out

    def _btree1(self, addr: int, node_type: int, obj: str, ndims: int = 0) -> list:
        """Leaf entries of a version 1 B-tree: child addresses (group nodes)
        or (chunk size, filter mask, offsets, address) (chunk nodes)."""
        key = 8 if node_type == 0 else 8 + 8 * ndims
        entry = struct.Struct("<QQ" if node_type == 0 else f"<II{ndims}QQ")  # key, child
        out: list = []
        seen: set = set()

        def node(at: int, level: Optional[int]) -> None:
            nw = self._where(obj, f"B-tree node at {at}")
            h5_latest.visit_once(seen, at, nw)
            hd = self._read(at, 24)
            if hd[:4] != b"TREE" or hd[4] != node_type:
                raise ValueError(f"{nw}: bad B-tree node")
            lvl, used = hd[5], struct.unpack("<H", hd[6:8])[0]
            if level is not None and lvl != level:
                raise ValueError(f"{nw}: level {lvl}, its parent's child is at {level}")
            c = Cursor(self._read(at + 24, used * (key + 8) + key), nw)
            for _ in range(used):
                fields = c.unpack(entry)
                child = fields[-1]
                if lvl > 0:
                    node(child, lvl - 1)
                elif node_type == 0:
                    out.append(child)
                else:
                    out.append((fields[0], fields[1], fields[2:-1], child))

        node(addr, None)
        return out

    # ------------------------------------------------------------ datasets

    def read(self, path: str) -> np.ndarray:
        """The dataset at `path` ('a/b/c'), as h5py's `np.asarray(f[path])`."""
        f, addr, obj = self._locate(_parts(path))
        return f._dataset(addr, obj)

    def read_value(self, path: str):
        """The dataset at `path` as h5py's `f[path][()]`: a numpy scalar for
        a scalar, `Empty(dtype)` for a null dataspace, else the array."""
        f, addr, obj = self._locate(_parts(path))
        _, shape, _, t = f._header(addr, obj)
        if shape is None:
            return Empty(t.out)
        return f._dataset(addr, obj)[()]

    def _header(self, addr: int, obj: str):
        """(first message of each type, shape (None: a null dataspace),
        maximum shape, datatype) of the dataset at `addr`."""
        by_type: Dict[int, bytes] = {}
        for t, b in self._messages(addr, obj):
            by_type.setdefault(t, b)
        if _LAYOUT not in by_type:
            raise KeyError(f"{self.path}: {obj} is not a dataset")
        for t in (_DATASPACE, _DATATYPE):
            if t not in by_type:
                raise ValueError(f"{self.path}: {obj}: a dataset without message {t:#x}")
        shape, maxshape = self._dataspace(by_type[_DATASPACE], obj)
        dtype = self._datatype(Cursor(by_type[_DATATYPE], self._where(obj, "datatype")), obj)
        return by_type, shape, maxshape, dtype

    def _dataset(self, addr: int, obj: str) -> np.ndarray:
        by_type, shape, maxshape, t = self._header(addr, obj)
        if shape is None:  # numpy's answer to h5py's Empty dataset
            raise TypeError(f"{self.path}: {obj}: Empty datasets have no numpy representation")
        fill = self._fill(by_type, t.storage, obj)
        layout = by_type[_LAYOUT]
        if layout[:2] == b"\x04\x03":  # layout message version 4, virtual
            return self._virtual(layout, shape, t, fill, addr, obj)
        if _EXTERNAL in by_type:
            raw = self._external_data(by_type[_EXTERNAL], shape, t.io, obj)
        else:
            filters = self._filters(by_type[_FILTER], obj) if _FILTER in by_type else []
            raw = self._data(layout, shape, maxshape, t.io, filters, fill, obj)
        if t.kind == "array":  # h5py folds the element's dimensions into the shape
            raw = np.ascontiguousarray(raw).view(t.base.storage).reshape(shape + t.dims)
        return self._convert(raw, t, obj)

    def _dataspace(self, b: bytes, obj: str):
        c = Cursor(b, self._where(obj, "dataspace"))
        version, rank, flags = c.u8(), c.u8(), c.u8()
        if version == 1:
            c.take(5)
        elif version == 2:
            if c.u8() == 2:
                return None, None
        else:
            raise self._unsupported(obj, f"dataspace message v{version}")
        if version == 1 and flags & 0x02:
            raise self._unsupported(obj, "a dataspace permutation index")
        if rank > 32:
            raise ValueError(f"{self.path}: {obj}: a dataspace of rank {rank}")
        dims = tuple(c.u64() for _ in range(rank))
        maxdims = tuple(c.u64() for _ in range(rank)) if flags & 0x01 else dims
        return dims, maxdims

    def _datatype(self, c: Cursor, obj: str) -> _Type:
        head = c.u8()
        cls, version = head & 0x0F, head >> 4
        bits, size = c.uint(3), c.u32()
        if version not in (1, 2, 3, 4):  # 4 changed only the reference class
            raise self._unsupported(obj, f"datatype message v{version}")
        if cls in (0, 1):
            return _Type(self._number(c, cls, bits, size, obj))
        if cls == 3:  # fixed-length string
            if size == 0 or bits & 0x0F > 2:
                raise ValueError(f"{self.path}: {obj}: a {size}-byte string padded "
                                 f"by rule {bits & 0x0F}")
            return _Type(np.dtype(f"S{size}"), "string", bits & 0x0F)
        if cls == 6:
            return self._compound(c, version, bits & 0xFFFF, size, obj)
        if cls == 7:  # references: an object header's address, a region's heap object
            kind = bits & 0x0F
            if version == 4 or kind > 1:
                raise self._unsupported(obj, f"a reference of type {kind} in datatype "
                                        f"message v{version} (H5R_ref_t)")
            want = ("<u8", "reference") if kind == 0 else (_REGION, "region reference")
            if size != np.dtype(want[0]).itemsize:
                raise ValueError(f"{self.path}: {obj}: a {size}-byte {want[1]}")
            return _Type(np.dtype(want[0]), want[1])
        if cls == 8:  # enumeration: base type, names, values
            base = self._datatype(c, obj)
            if base.kind != "plain" or base.storage.kind not in "iu" or (
                    base.storage.itemsize != size):
                raise self._unsupported(obj, f"an enumeration of {base.storage} "
                                        f"as {size} bytes")
            names = []
            for _ in range(bits & 0xFFFF):
                names.append(_name(c))
                c.take(0 if version >= 3 else -(len(names[-1]) + 1) % 8)
            values = np.frombuffer(c.take(len(names) * size), base.storage).tolist()
            # h5py gives the enum {FALSE: 0, TRUE: 1} as numpy bool, any other
            # as its base type
            if dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}:
                return _Type(base.storage, "bool")
            return base
        if cls == 9:  # variable-length: a sequence or a string of its base type
            base = self._datatype(c, obj)
            if size != _VLEN.itemsize:
                raise ValueError(f"{self.path}: {obj}: a {size}-byte variable-length type")
            if bits & 0x0F == 1:
                return _Type(_VLEN, "vlen string")
            if bits & 0x0F != 0:
                raise ValueError(f"{self.path}: {obj}: variable-length type {bits & 0x0F}")
            if base.out.hasobject:
                raise self._unsupported(obj, f"a variable-length sequence of {base.kind}")
            return _Type(_VLEN, "vlen", base=base)
        if cls == 10:  # array: dimensions (and, before version 3, a permutation)
            ndims = c.u8()
            c.take(3 if version < 3 else 0)
            dims = tuple(c.u32() for _ in range(ndims))
            c.take(4 * ndims if version < 3 else 0)
            base = self._datatype(c, obj)
            return self._array(base, dims, size, obj)
        raise self._unsupported(obj, f"datatype class {cls} ({_CLASSES.get(cls, 'unknown')})")

    def _array(self, base: _Type, dims: Tuple[int, ...], size: int, obj: str) -> _Type:
        if base.out.hasobject:
            raise self._unsupported(obj, f"an array of {base.kind}")
        if not dims or math.prod(dims) * base.storage.itemsize != size:
            raise ValueError(f"{self.path}: {obj}: an array {dims} of "
                             f"{base.storage.itemsize}-byte elements in {size} bytes")
        return _Type(np.dtype((base.storage, dims)), "array", base=base, dims=dims)

    def _compound(self, c: Cursor, version: int, n: int, size: int, obj: str) -> _Type:
        """A compound type (datatype message versions 1 to 4): each member's
        name, byte offset (and, in version 1, dimensions) and type."""
        members = []
        for _ in range(n):
            name = _name(c)
            c.take(0 if version >= 3 else -(len(name) + 1) % 8)
            dims: Tuple[int, ...] = ()
            if version == 1:
                offset, ndims = c.u32(), c.u8()
                c.take(3 + 4 + 4)  # reserved, permutation, reserved
                dims = tuple(c.u32() for _ in range(4))[:ndims]
            elif version == 2:
                offset = c.u32()
            else:  # as few bytes as the compound's size needs
                offset = c.uint(h5_latest._bytes_for(size))
            t = self._datatype(c, obj)
            if dims:
                t = self._array(t, dims, math.prod(dims) * t.storage.itemsize, obj)
            if t.out.hasobject:
                raise self._unsupported(obj, f"a {t.kind} member of a compound type")
            if offset + t.storage.itemsize > size:
                raise ValueError(f"{self.path}: {obj}: compound member {name!r} of "
                                 f"{t.storage.itemsize} bytes at {offset} of {size}")
            members.append((name.decode("utf-8"), offset, t))
        try:
            storage = np.dtype({"names": [m[0] for m in members],
                                "formats": [m[2].storage for m in members],
                                "offsets": [m[1] for m in members], "itemsize": size})
        except (ValueError, TypeError) as e:
            raise ValueError(f"{self.path}: {obj}: compound type: {e}") from None
        return _Type(storage, "compound", members=members)

    def _number(self, c: Cursor, cls: int, bits: int, size: int, obj: str) -> np.dtype:
        order = ">" if bits & 0x01 else "<"
        offset, precision = c.u16(), c.u16()
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
        layout = ((bits >> 8) & 0xFF, c.u8(), c.u8(), c.u8(), c.u8(), c.u32())
        if size not in ieee or layout != ieee[size]:
            raise self._unsupported(obj, f"a non-IEEE {size}-byte float")
        return np.dtype(f"{order}f{size}")

    def _fill(self, by_type: Dict[int, bytes], storage: np.dtype, obj: str) -> Optional[bytes]:
        """The fill value's bytes; None where h5py fills with zeros (no fill
        value, the default one, or never filling); `_UNDEFINED_FILL` for an
        undefined one."""
        if _FILL in by_type:
            c = Cursor(by_type[_FILL], self._where(obj, "fill value message"))
            version = c.u8()
            if version in (1, 2):
                c.u8()  # space allocation time
                never, defined, given = c.u8() == 1, c.u8(), True
            elif version == 3:
                flags = c.u8()
                never, defined, given = (flags >> 2) & 0x03 == 1, not flags & 0x10, flags & 0x20
            else:
                raise self._unsupported(obj, f"fill value message v{version}")
            if never:
                return None
            if not defined:
                return _UNDEFINED_FILL
            if not given:
                return None
        elif _FILL_OLD in by_type:
            c = Cursor(by_type[_FILL_OLD], self._where(obj, "fill value message"))
        else:
            return None
        size = c.u32()
        if size == 0:
            return None
        if size != storage.itemsize:
            raise self._unsupported(obj, f"a {size}-byte fill value of "
                                    f"{storage.itemsize}-byte elements")
        return c.take(size)

    def _filters(self, b: bytes, obj: str) -> List[Tuple[int, int, Tuple[int, ...]]]:
        c = Cursor(b, self._where(obj, "filter pipeline"))
        version, n = c.u8(), c.u8()
        if version == 1:
            c.take(6)
        elif version != 2:
            raise self._unsupported(obj, f"filter pipeline message v{version}")
        out = []
        for _ in range(n):
            fid = c.u16()
            name_len = c.u16() if version == 1 or fid >= 256 else 0
            flags, n_vals = c.u16(), c.u16()
            c.take((name_len + 7) // 8 * 8 if version == 1 else name_len)
            vals = tuple(c.u32() for _ in range(n_vals))
            if version == 1 and n_vals % 2:
                c.take(4)
            if fid not in _READ_FILTERS:
                raise self._unsupported(obj, f"filter {fid} "
                                        f"({_FILTERS.get(fid, 'unregistered')})")
            out.append((fid, flags, vals))
        return out

    def _filled(self, shape, storage: np.dtype, fill: Optional[bytes], obj: str) -> np.ndarray:
        try:
            if not fill:
                return np.zeros(shape, storage)
            out = np.empty(shape, storage)
        except MemoryError:
            raise ValueError(f"{self.path}: {obj}: {shape} elements of {storage} do not fit "
                             "in memory") from None
        out.reshape(-1)[:] = np.frombuffer(fill, storage, 1)
        return out

    def _data(self, b: bytes, shape, maxshape, storage: np.dtype, filters, fill, obj: str):
        c = Cursor(b, self._where(obj, "layout message"))
        version, cls = c.u8(), c.u8()
        if version not in (3, 4):
            raise self._unsupported(obj, f"layout message v{version}")
        count = math.prod(shape)
        nbytes = count * storage.itemsize
        if cls == 0:  # compact
            data = c.take(c.u16())
            return np.frombuffer(data, storage, count).reshape(shape).copy()
        if cls == 1:  # contiguous
            addr = c.u64()
            if addr == UNDEF:  # never written: h5py gives the fill value
                self._check_unwritten(fill, obj)
                return self._filled(shape, storage, fill, obj)
            if c.u64() < nbytes or addr + nbytes > self._size:
                raise ValueError(f"{self.path}: {obj}: truncated data")
            self._f.seek(addr)
            out = np.fromfile(self._f, storage, count)
            if out.size != count:
                raise ValueError(f"{self.path}: {obj}: truncated data")
            return out.reshape(shape)
        if cls != 2:
            raise self._unsupported(obj, f"{_LAYOUTS.get(cls, f'class {cls}')} layout")
        rank = len(shape)
        flags = 0
        if version == 3:
            ndims, index = c.u8(), c.u64()
            dims = [c.u32() for _ in range(ndims)]
        else:
            flags, ndims, enc = c.u8(), c.u8(), c.u8()
            if not 1 <= enc <= 8:
                raise ValueError(f"{c.where}: {enc}-byte chunk dimensions")
            dims = [c.uint(enc) for _ in range(ndims)]
        if ndims != rank + 1 or dims[-1] != storage.itemsize or 0 in dims:
            raise ValueError(f"{c.where}: chunk {dims} of a rank-{rank} dataset of "
                             f"{storage.itemsize}-byte elements")
        chunk = tuple(dims[:-1])
        chunk_bytes = math.prod(dims)
        if chunk_bytes >= 1 << 32:
            raise ValueError(f"{c.where}: a chunk of {chunk_bytes} bytes (HDF5's limit: 4 GiB)")
        if version == 3:
            chunks = ([] if index == UNDEF else
                      [(k[:rank], addr, size, mask) for size, mask, k, addr in
                       self._btree1(index, 1, obj, ndims)])
        else:
            index, chunks = self._chunk_index(c, shape, maxshape, chunk, chunk_bytes, flags,
                                              bool(filters), obj)
        if index == UNDEF:
            self._check_unwritten(fill, obj)
        return self._assemble(shape, chunk, storage, filters, fill, chunks, flags, obj)

    def _check_unwritten(self, fill: Optional[bytes], obj: str) -> None:
        """A dataset whose storage was never allocated: HDF5 reads nothing
        where its fill value is undefined."""
        if fill == _UNDEFINED_FILL:
            raise ValueError(f"{self.path}: {obj}: never written, and its fill value is "
                             "undefined: HDF5 reads no data")

    def _chunk_index(self, c: Cursor, shape, maxshape, chunk, chunk_bytes: int, flags: int,
                     filtered: bool, obj: str) -> Tuple[int, list]:
        """(the index's address, [(element offsets, address, stored size,
        filter mask)] of every chunk that a layout message version 4's index
        lists)."""
        where = f"{self.path}: {obj}"
        kind = c.u8()
        rank = len(shape)
        if kind == 1:  # single chunk: the whole dataset
            size, mask = (c.u64(), c.u32()) if flags & 0x02 else (chunk_bytes, 0)
            addr = c.u64()
            return addr, [] if addr == UNDEF else [((0,) * rank, addr, size, mask)]
        c.take({2: 0, 3: 1, 4: 5, 5: 6}.get(kind, 0))  # the index's parameters
        addr = c.u64()
        if kind not in (2, 3, 4, 5):
            raise ValueError(f"{c.where}: chunk index type {kind}")
        if addr == UNDEF:
            return addr, []
        if kind == 5:  # version 2 B-tree: records of type 10 (unfiltered), 11
            out = []
            for rec in h5_latest.btree2_records(self._read, addr, 11 if filtered else 10,
                                                where):
                r = Cursor(rec, f"{where}: chunk record")
                at = r.u64()
                size, mask = ((r.uint(len(rec) - 12 - 8 * rank), r.u32()) if filtered
                              else (chunk_bytes, 0))
                out.append((tuple(r.u64() * d for d in chunk), at, size, mask))
            return addr, out
        unlimited = [d for d, m in enumerate(maxshape) if m == UNDEF]
        if kind in (2, 3) and unlimited or kind == 4 and len(unlimited) != 1:
            raise ValueError(f"{c.where}: chunk index type {kind} with unlimited "
                             f"dimensions {unlimited}")
        # chunks are numbered in C order over the grid of the largest extent,
        # the extensible array's unlimited dimension moved first
        order = unlimited + [d for d in range(rank) if d not in unlimited]
        grid = [-(-maxshape[d] // chunk[d]) for d in order[1 if unlimited else 0:]]

        def offsets(i: int):
            scaled = []
            for g in reversed(grid):
                scaled.append(i % g)
                i //= g
            scaled = ([i] if unlimited else []) + scaled[::-1]
            out = [0] * rank
            for d, s in zip(order, scaled):
                out[d] = s * chunk[d]
            return tuple(out)

        if kind == 2:  # implicit: every chunk, in index order, from `addr`
            n = math.prod(grid)
            if addr + n * chunk_bytes > self._size:
                raise ValueError(f"{where}: truncated: {n} chunks of {chunk_bytes} bytes "
                                 f"at {addr}")
            return addr, [(offsets(i), addr + i * chunk_bytes, chunk_bytes, 0) for i in range(n)]
        esize, elements = (h5_latest.fixed_array if kind == 3 else h5_latest.extensible_array)(
            self._read, addr, where)
        if esize < 13 if filtered else esize != 8:  # address[, size, filter mask]
            raise ValueError(f"{where}: {esize}-byte chunk index elements")
        out = []
        for i, e in elements:
            r = Cursor(e, f"{where}: chunk index element {i}")
            at = r.u64()
            if at == UNDEF:
                continue
            size, mask = (r.uint(esize - 12), r.u32()) if filtered else (chunk_bytes, 0)
            out.append((offsets(i), at, size, mask))
        return addr, out

    def _assemble(self, shape, chunk, storage: np.dtype, filters, fill, chunks, flags: int,
                  obj: str) -> np.ndarray:
        out = self._filled(shape, storage, fill, obj)
        n_chunk = math.prod(chunk)
        chunk_bytes = n_chunk * storage.itemsize
        for offsets, addr, size, mask in chunks:
            if any(o % c for o, c in zip(offsets, chunk)):
                raise ValueError(f"{self.path}: {obj}: a chunk at {offsets}, off the grid of "
                                 f"{chunk}")
            if any(o >= s for o, s in zip(offsets, shape)):
                continue  # past the dataset's extent
            raw = self._read(addr, size)
            partial = any(o + c > s for o, c, s in zip(offsets, chunk, shape))
            if filters and not (flags & 0x01 and partial):  # edge chunks left unfiltered
                raw = self._unfilter(raw, filters, mask, chunk_bytes, storage, obj, offsets)
            if len(raw) < chunk_bytes:
                raise ValueError(f"{self.path}: {obj}: the chunk at {offsets} holds "
                                 f"{len(raw)} bytes, not {chunk_bytes}")
            block = np.frombuffer(raw, storage, n_chunk).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _unfilter(self, raw: bytes, filters, mask: int, chunk_bytes: int, storage: np.dtype,
                  obj: str, offsets) -> bytes:
        """A chunk's stored bytes through its filters, last first."""
        def bad(what: str) -> ValueError:
            return ValueError(f"{self.path}: {obj}: the chunk at {offsets}: {what}")

        active = [not mask & (1 << i) for i in range(len(filters))]
        for i, (fid, _, vals) in reversed(list(enumerate(filters))):
            if not active[i]:
                continue
            # what this filter was given: the chunk and the checksums of the
            # Fletcher-32 filters before it
            n_out = chunk_bytes + 4 * sum(1 for j in range(i)
                                          if active[j] and filters[j][0] == 3)
            if fid == 1:
                d = zlib.decompressobj()
                try:
                    out = d.decompress(raw, n_out + 1)
                except zlib.error as e:
                    raise bad(f"deflate: {e}") from None
                if len(out) > n_out or not d.eof:
                    raise bad(f"deflate stream {'longer than' if d.eof else 'truncated before'} "
                              f"{n_out} bytes")
                raw = out
            elif fid == 3:
                if len(raw) < 4 or not h5_latest.fletcher32_matches(
                        raw[:-4], int.from_bytes(raw[-4:], "little")):
                    raise bad("Fletcher-32 checksum mismatch (filter 3)")
                raw = raw[:-4]
            elif fid == 32000:  # LZF: liblzf's stream of the chunk
                lzf = (native_blosc.lzf_decompress if native_blosc.available()
                       else blosc.lzf_decompress_plain)
                raw = lzf(raw, n_out)
            elif fid == 32001:
                try:
                    raw = blosc.decompress(raw)
                except blosc.UnsupportedBlosc as e:
                    raise self._unsupported(obj, f"filter 32001 (Blosc) {e}") from None
            elif fid == 32015:
                if not native_blosc.available():
                    raise self._unsupported(obj, "filter 32015 (Zstandard) needs the native "
                                            "library, which did not build")
                try:
                    raw = native_blosc.zstd_decompress(raw, n_out)
                except native_blosc.UnsupportedZstd as e:
                    raise self._unsupported(obj, f"filter 32015 (Zstandard) {e}") from None
            elif fid == 2:  # shuffle: the bytes of each element were grouped by position
                width = vals[0] if vals else storage.itemsize
                if width < 1:
                    raise bad(f"shuffle of {width}-byte elements")
                n = len(raw) // width
                head = np.frombuffer(raw[:n * width], np.uint8).reshape(width, n)
                out = np.empty((n, width), np.uint8)
                for k in range(width):  # a plane at a time: ~10x `head.T.tobytes()`
                    out[:, k] = head[k]
                raw = out.tobytes() + raw[n * width:]
        return raw

    def _external_data(self, body: bytes, shape, storage: np.dtype, obj: str) -> np.ndarray:
        """A dataset stored in external data files: each slot's bytes of
        its file, in order, where HDF5 looks for it (a relative name from
        the working directory, or HDF5_EXTFILE_PREFIX)."""
        where = self._where(obj, "external data files")
        heap, slots = h5_features.external_files(body, where)
        names = self._local_heap(heap, obj)
        count = math.prod(shape)
        need, parts = count * storage.itemsize, []
        for name_off, offset, size in slots:
            if need <= 0:
                break
            name = _cstr(names, name_off, where).decode("utf-8")
            n = need if size == UNDEF else min(size, need)
            parts.append(h5_features.read_external(
                h5_features.candidates(name, "efile", self._origin)[0], offset, n, where))
            need -= n
        if need > 0:
            raise ValueError(f"{where}: its files hold {need} bytes fewer than the dataset's "
                             f"{count * storage.itemsize}")
        return np.frombuffer(b"".join(parts), storage, count).reshape(shape)

    def _virtual(self, layout: bytes, shape, t: _Type, fill, addr: int, obj: str) -> np.ndarray:
        """A virtual dataset as h5py's default view reads it: the fill
        value, then each mapping's source elements in its virtual
        selection; a missing source file or dataset leaves the fill value.
        A dimension with unlimited mappings takes the extent their sources
        give now; a printf-style mapping (`%b`) takes sources 0, 1, ... up
        to the first missing one."""
        where = self._where(obj, "virtual layout")
        if t.out.hasobject:
            raise self._unsupported(obj, f"a virtual dataset of {t.kind}")
        c = Cursor(layout, where, 2)
        maps = h5_features.vds_mappings(self._global_heap.get(c.u64(), c.u32()), where)
        key = (str(self.path), addr)
        if key in self._opened.reading:
            raise ValueError(f"{where}: a virtual dataset that is its own source")
        self._opened.reading.add(key)
        try:
            return self._map(maps, shape, t, fill, obj, where)
        finally:
            self._opened.reading.discard(key)

    def _map(self, maps, shape, t: _Type, fill, obj: str, where: str) -> np.ndarray:
        sources: Dict[Tuple[str, str], Optional[np.ndarray]] = {}

        def source(file: str, dset: str) -> Optional[np.ndarray]:
            if (file, dset) not in sources:
                f = self if file == "." else self._open(file, "vds")
                try:
                    sources[file, dset] = None if f is None else f.read(dset)
                except KeyError:  # no such dataset: as a missing file
                    sources[file, dset] = None
            return sources[file, dset]

        rank = len(shape)
        plans, unlimited, limited = [], {}, [0] * rank
        for file0, dset0, ssel, vsel in maps:
            d = vsel.unlimited_dim()
            file, printf_file = h5_features.printf_name(file0, where)
            dset, printf_dset = h5_features.printf_name(dset0, where)
            if printf_file or printf_dset:  # source j fills block j
                if d is None or vsel.regular[d][3] is None or ssel.unlimited_dim() is not None:
                    raise ValueError(f"{where}: printf-style source names ({file0}:{dset0}) "
                                     "need unlimited blocks of a virtual selection and a "
                                     "limited source selection")
                j = 0
                while True:
                    src = source(h5_features.printf_name(file0, where, j)[0],
                                 h5_features.printf_name(dset0, where, j)[0])
                    if src is None:
                        break
                    plans.append((vsel.block(d, j), src, ssel))
                    j += 1
                unlimited[d] = max(unlimited.get(d, 0), vsel.with_count(d, j).extent(d))
            elif d is not None:
                sd = ssel.unlimited_dim()
                src = source(file, dset)
                if sd is None:
                    raise ValueError(f"{where}: an unlimited virtual selection mapped from a "
                                     "limited source selection")
                sclip = ssel.clip(sd, src.shape[sd]) if src is not None else None
                n = sclip.along(sd) if sclip is not None else 0
                vblock = vsel.regular[d][3]
                if vblock is not None and n % vblock:
                    raise ValueError(f"{where}: {n} source elements along dimension {sd} do "
                                     f"not fill blocks of {vblock}")
                vclip = vsel.with_count(d, n if vblock is None else n // vblock)
                if src is not None:
                    plans.append((vclip, src, sclip))
                unlimited[d] = max(unlimited.get(d, 0), vclip.extent(d))
            else:
                src = source(file, dset)
                for k in range(rank):
                    limited[k] = max(limited[k], vsel.extent(k))
                if src is not None:
                    plans.append((vsel, src, ssel))
        shape = tuple(max(unlimited[k], limited[k]) if k in unlimited else n
                      for k, n in enumerate(shape))
        first = self._convert(self._filled((1,), t.storage, fill or None, obj), t, obj)
        out = np.empty(shape, t.out)
        out[...] = first[0]
        flat = out.reshape(-1)
        for vsel, src, ssel in plans:
            vbox, sbox = vsel.slices(len(shape)), ssel.slices(src.ndim)
            if vbox is not None and sbox is not None and all(  # boxes: no index arrays
                    b.stop is None or b.stop <= n for b, n in zip(vbox, shape)) and all(
                    b.stop is None or b.stop <= n for b, n in zip(sbox, src.shape)):
                dst, part = out[vbox], src[sbox]
                if dst.size != part.size:
                    raise ValueError(f"{where}: a mapping of {part.size} source elements "
                                     f"to {dst.size} virtual ones")
                out[vbox] = self._as_type(part, t.out, obj).reshape(dst.shape)
                continue
            vi, si = vsel.indices(shape, where), ssel.indices(src.shape, where)
            if len(vi) != len(si):
                raise ValueError(f"{where}: a mapping of {len(si)} source elements to "
                                 f"{len(vi)} virtual ones")
            flat[vi] = self._as_type(src.reshape(-1)[si], t.out, obj)
        return out

    def _as_type(self, a: np.ndarray, dtype: np.dtype, obj: str) -> np.ndarray:
        """A virtual dataset's source elements in its own dtype, as HDF5
        converts numbers: integers saturated at the target's range, integers
        and floats to floats rounded."""
        if a.dtype == dtype:
            return a
        if a.dtype.kind in "iu" and dtype.kind in "iu":
            info = np.iinfo(dtype)
            return np.clip(a, max(info.min, np.iinfo(a.dtype).min),
                           min(info.max, np.iinfo(a.dtype).max)).astype(dtype)
        if a.dtype.kind in "iuf" and dtype.kind == "f":
            return a.astype(dtype)
        raise self._unsupported(obj, f"a source of {a.dtype} in a virtual dataset of {dtype}")

    def _convert(self, a: np.ndarray, t: _Type, obj: str) -> np.ndarray:
        """Stored elements as h5py gives them."""
        if t.kind == "plain":
            return a
        if t.kind == "array":  # its dimensions already folded into the shape
            return self._convert(a, t.base, obj)
        if t.kind == "bool":  # as h5py's bool enum (int8): other bases convert by value
            if a.dtype == np.int8:
                return a.view(np.bool_)
            out = np.full(a.shape, 0xFF, np.uint8)
            out[a == 0], out[a == 1] = 0, 1
            return out.view(np.bool_)
        if t.kind == "string":
            if t.pad == 1:  # null-padded: h5py's own string type, read as stored
                return a
            n = a.dtype.itemsize
            b = a.copy().view(np.uint8).reshape(-1, n)
            pos = np.arange(n)
            if t.pad == 0:  # null-terminated: cut at the first null
                end = np.where((b == 0).any(axis=1), (b == 0).argmax(axis=1), n)
            else:  # space-padded: the trailing spaces dropped
                keep = b != 0x20
                end = np.where(keep.any(axis=1), n - keep[:, ::-1].argmax(axis=1), 0)
            b[pos[None, :] >= end[:, None]] = 0
            return b.view(a.dtype).reshape(a.shape)
        if t.kind == "compound":
            out_dtype = t.out
            if not t.converts:
                return a
            if out_dtype.kind == "c":
                return np.ascontiguousarray(a).view(out_dtype).reshape(a.shape)
            out = np.empty(a.shape, out_dtype)
            for name, _, m in t.members:
                out[name] = self._convert(a[name], m, obj)
            return out
        out = np.empty(a.shape, object)
        flat = out.reshape(-1)
        if t.kind == "reference":
            for i, addr in enumerate(a.reshape(-1).tolist()):
                flat[i] = Reference(str(self.path), addr)
            return out
        if t.kind == "region reference":
            for i, (collection, index) in enumerate(a.reshape(-1).tolist()):
                flat[i] = RegionReference(str(self.path), collection, index)
            return out
        for i, (n, collection, index) in enumerate(a.reshape(-1).tolist()):
            if t.kind == "vlen":  # n elements of the base type
                size = n * t.base.storage.itemsize
                data = self._global_heap.get(collection, index) if n else b""
            else:  # a string of n bytes
                if n == 0:
                    flat[i] = b""
                    continue
                size, data = n, self._global_heap.get(collection, index)
            if size > len(data):
                raise ValueError(f"{self.path}: {obj}: {size} bytes of a variable-length "
                                 f"element in a {len(data)}-byte heap object")
            if t.kind == "vlen":
                seq = np.frombuffer(data, t.base.io, n)
                if t.base.kind == "array":
                    seq = seq.view(t.base.base.storage).reshape((n,) + t.base.dims)
                seq = self._convert(seq, t.base, obj)
                # h5py labels a sequence's stored numbers with the machine's
                # byte order, whatever the file's (its elements are read raw)
                flat[i] = (seq.view(seq.dtype.newbyteorder("=")) if seq.dtype.kind in "iufc"
                           else seq).copy()
            else:
                flat[i] = data[:n].split(b"\0", 1)[0]  # h5py reads it as a C string
        return out

    # ---------------------------------------------------------- references

    def _file_of(self, ref: Reference) -> "File":
        """The open file that `ref` was read from."""
        for f in self._opened.files.values():
            if str(f.path) == ref.file:
                return f
        raise ValueError(f"{self.path}: {ref!r} was read from a file this one did not open")

    def _region(self, ref: RegionReference) -> Tuple[int, "h5_features.Selection"]:
        """(the dataset's object header, the selection) of a region
        reference's heap object."""
        if not isinstance(ref, RegionReference) or not ref:
            raise ValueError(f"{self.path}: {ref!r} is not a dataset region reference")
        where = f"{self.path}: region reference {ref.addr}:{ref.index}"
        c = Cursor(self._global_heap.get(ref.addr, ref.index), where)
        return c.u64(), h5_features.decode_selection(c)

    def dereference(self, ref: Reference) -> str:
        """The path of the object that `ref` (object or region reference)
        points to, as h5py's `f[ref].name`: the first path to it that a
        walk of the groups finds (`_object_paths`)."""
        f = self._file_of(ref)
        if f is not self:
            return f.dereference(ref)
        if not ref:
            raise ValueError(f"{self.path}: a null reference")
        addr = f._region(ref)[0] if isinstance(ref, RegionReference) else ref.addr
        paths = self._object_paths()
        if addr not in paths:
            raise KeyError(f"{self.path}: no group links the object at {addr}")
        return paths[addr]

    def read_region(self, ref: RegionReference) -> np.ndarray:
        """The elements that a dataset region reference selects, in HDF5's
        order, as h5py's `f[ref][ref]`: shaped as h5py guesses the
        selection's shape (`h5_features.Selection.guess_shape`)."""
        f = self._file_of(ref)
        addr, sel = f._region(ref)
        obj = f.dereference(ref)
        data = f._dataset(addr, obj)
        flat = sel.indices(data.shape, f._where(obj, "region"))
        return data.reshape(-1)[flat].reshape(sel.guess_shape(data.shape, flat))

    def _object_paths(self) -> Dict[int, str]:
        """{object header: its first path}, the groups walked depth first as
        HDF5's H5Iget_name walks them: each group's hard links in their
        stored order (a symbol table's by name, link messages as written,
        a dense group's by its name index)."""
        if self._paths is None:
            paths, seen = {self._root: "/"}, {self._root}

            def walk(addr: int, obj: str) -> None:
                try:
                    links = self._links(addr, obj)
                except KeyError:  # not a group
                    return
                for name, (kind, target) in links.items():
                    if kind != "hard":
                        continue
                    child = obj.rstrip("/") + "/" + name
                    paths.setdefault(target, child)
                    if target not in seen:
                        seen.add(target)
                        walk(target, child)

            walk(self._root, "/")
            self._paths = paths
        return self._paths


def _parts(path: str) -> List[str]:
    return [p for p in path.split("/") if p not in ("", ".")]


def _name(c: Cursor) -> bytes:
    """A null-terminated name at the cursor, its null taken."""
    end = c.buf.find(b"\0", c.pos)
    if end < 0:
        raise ValueError(f"{c.where}: a name without its end")
    name = c.take(end - c.pos)
    c.take(1)
    return name


def _cstr(buf: bytes, off: int, where: str) -> bytes:
    end = buf.find(b"\0", off)
    if off >= len(buf) or end < 0:
        raise ValueError(f"{where}: no name at offset {off}")
    return buf[off:end]


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
