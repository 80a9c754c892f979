"""The structures of HDF5's newer file format, for `utils/h5_lite.py`.

What HDF5 writes from version 1.8 on, and everything h5py writes under
`libver="latest"`, follows the HDF5 File Format Specification (version
3.0) in these structures, each read here in numpy and plain Python:

- Jenkins' lookup3 hash, the checksum of every block below and of version
  2 superblocks and object headers, and the Fletcher-32 checksum of HDF5's
  filter 3;
- the version 2 B-tree (`BTHD`, `BTIN`, `BTLF`): its records, whatever
  their type;
- the fractal heap (`FRHP`, `FHIB`, `FHDB`): managed and tiny objects,
  through the doubling table of its indirect blocks;
- the fixed array (`FAHD`, `FADB`, paged or not) and the extensible array
  (`EAHD`, `EAIB`, `EASB`, `EADB`, paged or not), two of layout message
  version 4's chunk indexes;
- the global heap collection (`GCOL`), where variable-length strings live.

Every field is read through `Cursor`, which raises `ValueError` naming the
block where a field would run past it, and every block is checksummed
before it is parsed. A structure that points back at a block already read
raises instead of looping.
"""

from __future__ import annotations

import struct
from bisect import bisect_right
from typing import Callable, Dict, List, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
_M32 = 0xFFFFFFFF

# Read(addr, n) -> exactly n bytes of the file, or ValueError
Read = Callable[[int, int], bytes]


# ------------------------------------------------------------- checksums

def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle`, as HDF5's `H5_checksum_lookup3`."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    full = (n - 1) // 12  # blocks mixed; the last 1-12 bytes are the tail
    words = struct.unpack_from(f"<{3 * full}I", data)
    for i in range(0, 3 * full, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    tail = bytes(data[12 * full:]).ljust(12, b"\0")
    x, y, z = struct.unpack("<3I", tail)
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = (c ^ b) - _rot(b, 14) & _M32
    a = (a ^ c) - _rot(c, 11) & _M32
    b = (b ^ a) - _rot(a, 25) & _M32
    c = (c ^ b) - _rot(b, 16) & _M32
    a = (a ^ c) - _rot(c, 4) & _M32
    b = (b ^ a) - _rot(a, 14) & _M32
    c = (c ^ b) - _rot(b, 24) & _M32
    return c


def _fold(s: int) -> int:
    """A sum reduced as `H5_checksum_fletcher32` reduces it: 0 for 0, else
    the member of [1, 65535] congruent to it modulo 65535."""
    return 0 if s == 0 else (s - 1) % 65535 + 1


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (`H5_checksum_fletcher32`): big-endian 16-bit words,
    an odd last byte the high byte of a last word; both sums folded to 16
    bits as HDF5 folds them."""
    b = np.frombuffer(data, np.uint8)
    if len(b) % 2:
        b = np.append(b, np.uint8(0))
    w = (b[0::2].astype(np.int64) << 8) | b[1::2]
    n = len(w)
    s1 = int(w.sum())
    # sum2 is the sum of the running sums: word i counts n - i times
    s2, step = 0, 1 << 20
    for i in range(0, n, step):
        part = w[i:i + step]
        weight = np.arange(n - i, n - i - len(part), -1, dtype=np.int64) % 65535
        s2 = (s2 + int((part * weight).sum())) % 65535
    s2 = 0 if s1 == 0 else (s2 - 1) % 65535 + 1
    return (s2 << 16) | _fold(s1)


def fletcher32_matches(data: bytes, stored: int) -> bool:
    """Whether `stored` is the Fletcher-32 of `data`, or that value with the
    bytes of each half swapped (what HDF5 before 1.6.3 wrote, which HDF5
    still accepts)."""
    f = fletcher32(data)
    return stored in (f, ((f & 0x00FF00FF) << 8) | ((f >> 8) & 0x00FF00FF))


def check_sum(block: bytes, where: str) -> None:
    """The block's last 4 bytes are the lookup3 of the bytes before them."""
    if len(block) < 4 or lookup3(block[:-4]) != int.from_bytes(block[-4:], "little"):
        raise ValueError(f"{where}: checksum mismatch")


# -------------------------------------------------------------- fields

_U8, _U16, _U32, _U64 = (struct.Struct(f"<{c}") for c in "BHIQ")

class Cursor:
    """Little-endian fields of one block, each read bounds-checked: a field
    that runs past the block raises `ValueError` naming it."""

    __slots__ = ("buf", "pos", "where")

    def __init__(self, buf: bytes, where: str, pos: int = 0):
        self.buf, self.where, self.pos = buf, where, pos

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise ValueError(f"{self.where}: a {n}-byte field at byte {self.pos} runs past "
                             f"the {len(self.buf)}-byte block")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fields: struct.Struct) -> tuple:
        """The `fields` that start at the cursor, read as one."""
        pos = self.pos
        if pos + fields.size > len(self.buf):
            self.take(fields.size)  # raises
        self.pos = pos + fields.size
        return fields.unpack_from(self.buf, pos)

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self) -> int:
        return self.unpack(_U8)[0]

    def u16(self) -> int:
        return self.unpack(_U16)[0]

    def u32(self) -> int:
        return self.unpack(_U32)[0]

    def u64(self) -> int:
        return self.unpack(_U64)[0]

    def left(self) -> int:
        return len(self.buf) - self.pos

    def signature(self, sig: bytes, version: int = 0) -> None:
        if self.take(4) != sig:
            raise ValueError(f"{self.where}: not a {sig.decode()} block")
        v = self.u8()
        if v != version:
            raise ValueError(f"{self.where}: {sig.decode()} version {v}, not {version}")


def _bytes_for(n: int) -> int:
    """Bytes HDF5 gives a field that counts up to n (`H5VM_limit_enc_size`)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int, what: str, where: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{where}: {what} {n} is not a power of two")
    return n.bit_length() - 1


def visit_once(seen: set, addr: int, where: str) -> None:
    """Mark the block at `addr` read; a second visit is a cycle."""
    if addr in seen:
        raise ValueError(f"{where}: block at {addr} reached twice (a cycle)")
    seen.add(addr)


# ------------------------------------------------------ version 2 B-tree

def btree2_records(read: Read, addr: int, rtype: int, where: str) -> List[bytes]:
    """Every record of the version 2 B-tree whose header is at `addr`, each
    the record's raw bytes; the tree's record type must be `rtype`."""
    hw = f"{where}: v2 B-tree header at {addr}"
    hdr = read(addr, 38)
    check_sum(hdr, hw)
    c = Cursor(hdr, hw)
    c.signature(b"BTHD")
    if c.u8() != rtype:
        raise ValueError(f"{hw}: record type {hdr[5]}, not {rtype}")
    node_size, rec_size, depth = c.u32(), c.u16(), c.u16()
    c.take(2)  # split and merge percents
    root, n_root, total = c.u64(), c.u16(), c.u64()
    if rec_size == 0 or not 10 + rec_size <= node_size <= 1 << 24:
        raise ValueError(f"{hw}: {rec_size}-byte records in {node_size}-byte nodes")
    # the sizes of the child pointers' count fields (H5B2__hdr_init)
    max_leaf = (node_size - 10) // rec_size
    nrec_size = _bytes_for(max_leaf)
    max_nrec, cum_max, cum_size = [max_leaf], [max_leaf], [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + cum_size[d - 1]
        n = (node_size - 10 - ptr) // (rec_size + ptr)
        if n < 1:
            raise ValueError(f"{hw}: depth {depth} does not fit {node_size}-byte nodes")
        max_nrec.append(n)
        cum_max.append((n + 1) * cum_max[d - 1] + n)
        cum_size.append(_bytes_for(cum_max[d]))
    out: List[bytes] = []
    seen: set = set()

    def node(at: int, nrec: int, d: int) -> None:
        nw = f"{where}: v2 B-tree node at {at}"
        visit_once(seen, at, nw)
        if nrec > max_nrec[d]:
            raise ValueError(f"{nw}: {nrec} records, at most {max_nrec[d]} fit")
        ptr = 8 + nrec_size + cum_size[d - 1] if d else 0
        blk = read(at, 10 + nrec * rec_size + (nrec + 1) * ptr if d else 10 + nrec * rec_size)
        check_sum(blk, nw)
        b = Cursor(blk, nw)
        b.signature(b"BTIN" if d else b"BTLF")
        if b.u8() != rtype:
            raise ValueError(f"{nw}: record type {blk[5]}, not {rtype}")
        for _ in range(nrec):
            out.append(b.take(rec_size))
        if d:
            children = [(b.u64(), b.uint(nrec_size), b.take(cum_size[d - 1]))
                        for _ in range(nrec + 1)]
            for child, n_child, _ in children:
                node(child, n_child, d - 1)

    if root != UNDEF and n_root:
        node(root, n_root, depth)
    if len(out) != total:
        raise ValueError(f"{hw}: {len(out)} records found, the header counts {total}")
    return out


# ------------------------------------------------------------ fractal heap

class FractalHeap:
    """A fractal heap's managed and tiny objects, by heap ID."""

    def __init__(self, read: Read, addr: int, where: str):
        self.read, self.addr = read, addr
        self.where = hw = f"{where}: fractal heap at {addr}"
        hdr = read(addr, 146)
        c = Cursor(hdr, hw)
        c.signature(b"FRHP")
        self.id_len, filter_len, flags = c.u16(), c.u16(), c.u8()
        if filter_len:
            raise ValueError(f"{hw}: I/O filters on a fractal heap are not read")
        check_sum(hdr, hw)
        max_managed = c.u32()
        c.take(8 * 12)  # huge objects, free space, the managed space's counters
        self.width, self.start, max_direct = c.u16(), c.u64(), c.u64()
        max_heap_bits, _, root, rows = c.u16(), c.u16(), c.u64(), c.u16()
        _log2(self.width, "table width", hw)
        start_bits = _log2(self.start, "starting block size", hw)
        direct_bits = _log2(max_direct, "maximum direct block size", hw)
        if not 0 < max_heap_bits <= 64 or direct_bits < start_bits:
            raise ValueError(f"{hw}: {max_heap_bits}-bit heap with {max_direct}-byte blocks "
                             f"from {self.start}")
        self.checksummed = bool(flags & 0x02)
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((direct_bits + 7) // 8, _bytes_for(max_managed))
        self.max_direct_rows = direct_bits - start_bits + 2
        self.blocks: List[Tuple[int, int, int]] = []  # (heap offset, address, size)
        self._cache: Dict[int, bytes] = {}
        if root != UNDEF:
            if rows == 0:
                self.blocks.append((0, root, self.start))
            else:
                self._indirect(root, rows, 0, set())
        self.blocks.sort()
        self._starts = [b[0] for b in self.blocks]

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def _indirect(self, at: int, rows: int, off: int, seen: set) -> None:
        iw = f"{self.where}: indirect block at {at}"
        visit_once(seen, at, iw)
        if rows > 64:
            raise ValueError(f"{iw}: {rows} rows")
        n_direct = min(rows, self.max_direct_rows) * self.width
        n_entries = rows * self.width
        blk = self.read(at, 13 + self.off_size + 8 * n_entries + 4)
        check_sum(blk, iw)
        c = Cursor(blk, iw)
        c.signature(b"FHIB")
        if c.u64() != self.addr or c.uint(self.off_size) != off:
            raise ValueError(f"{iw}: not the block of this heap at offset {off}")
        for k in range(n_entries):
            child, size = c.u64(), self._row_size(k // self.width)
            if child != UNDEF:
                if k < n_direct:
                    self.blocks.append((off, child, size))
                else:  # an indirect block spanning `size` bytes
                    child_rows = size.bit_length() - (self.start * self.width).bit_length() + 1
                    if not 0 < child_rows < rows:
                        raise ValueError(f"{iw}: a child of {child_rows} rows")
                    self._indirect(child, child_rows, off, seen)
            off += size

    def _direct(self, off: int, at: int, size: int) -> bytes:
        if at not in self._cache:
            dw = f"{self.where}: direct block at {at}"
            blk = self.read(at, size)
            c = Cursor(blk, dw)
            c.signature(b"FHDB")
            if c.u64() != self.addr or c.uint(self.off_size) != off:
                raise ValueError(f"{dw}: not the block of this heap at offset {off}")
            if self.checksummed:  # over the whole block, its checksum field zeroed
                pos = c.pos
                stored = c.u32()
                if lookup3(blk[:pos] + b"\0\0\0\0" + blk[pos + 4:]) != stored:
                    raise ValueError(f"{dw}: checksum mismatch")
            self._cache[at] = blk
        return self._cache[at]

    def get(self, heap_id: bytes) -> bytes:
        """The object that `heap_id` names."""
        c = Cursor(heap_id, f"{self.where}: heap ID {heap_id.hex()}")
        first = c.u8()
        kind = (first >> 4) & 0x3
        if first >> 6:
            raise ValueError(f"{c.where}: heap ID version {first >> 6}")
        if kind == 2:  # tiny: the object is in the ID
            n = (first & 0x0F) + 1 if self.id_len <= 18 else ((first & 0x0F) << 8 | c.u8()) + 1
            return c.take(n)
        if kind != 0:
            raise ValueError(f"{c.where}: huge objects in a fractal heap are not read")
        off, n = c.uint(self.off_size), c.uint(self.len_size)
        i = bisect_right(self._starts, off) - 1
        if i < 0 or off + n > self.blocks[i][0] + self.blocks[i][2]:
            raise ValueError(f"{c.where}: offset {off} (+{n}) is in no direct block")
        start, at, size = self.blocks[i]
        blk = self._direct(start, at, size)
        head = 13 + self.off_size + (4 if self.checksummed else 0)
        if off - start < head:
            raise ValueError(f"{c.where}: offset {off} is inside a block's header")
        return blk[off - start:off - start + n]


# ------------------------------------------------------------ fixed array

def _bit(bitmap: bytes, i: int) -> bool:
    """Bit i of an HDF5 bitmap, the first in the high bit of byte 0."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def fixed_array(read: Read, addr: int, where: str) -> Tuple[int, List[Tuple[int, bytes]]]:
    """(element size, [(index, element bytes)]) of the fixed array whose
    header is at `addr`: every element of its data block, paged or not
    (the elements of a page never written are left out)."""
    hw = f"{where}: fixed array header at {addr}"
    hdr = read(addr, 28)
    check_sum(hdr, hw)
    c = Cursor(hdr, hw)
    c.signature(b"FAHD")
    client, esize, page_bits, n, dblk = c.u8(), c.u8(), c.u8(), c.u64(), c.u64()
    if esize == 0 or page_bits >= 64:
        raise ValueError(f"{hw}: {esize}-byte elements, {page_bits} page bits")
    if dblk == UNDEF:
        return esize, []
    dw = f"{where}: fixed array data block at {dblk}"
    page = 1 << page_bits
    n_pages = -(-n // page) if n > page else 0
    bitmap_size = (n_pages + 7) // 8
    size = 14 + bitmap_size + (0 if n_pages else n * esize) + 4
    blk = read(dblk, size)
    check_sum(blk, dw)
    d = Cursor(blk, dw)
    d.signature(b"FADB")
    if d.u8() != client or d.u64() != addr:
        raise ValueError(f"{dw}: not the data block of {hw}")
    if not n_pages:
        return esize, [(i, d.take(esize)) for i in range(n)]
    bitmap, out = d.take(bitmap_size), []
    for p in range(n_pages):
        if not _bit(bitmap, p):
            continue
        m = min(page, n - p * page)
        at = dblk + size + p * (page * esize + 4)
        pw = f"{dw}: page {p} at {at}"
        pg = read(at, m * esize + 4)
        check_sum(pg, pw)
        out += [(p * page + i, pg[i * esize:(i + 1) * esize]) for i in range(m)]
    return esize, out


# -------------------------------------------------------- extensible array

def extensible_array(read: Read, addr: int, where: str) -> Tuple[int, List[Tuple[int, bytes]]]:
    """(element size, [(index, element bytes)]) of the extensible array
    whose header is at `addr`: the index block's elements, then those of
    each data block, reached from the index block or through its super
    blocks (paged or not); blocks never allocated are left out."""
    hw = f"{where}: extensible array header at {addr}"
    hdr = read(addr, 72)
    check_sum(hdr, hw)
    c = Cursor(hdr, hw)
    c.signature(b"EAHD")
    client, esize, max_bits, idx_elmts, min_elmts, min_ptrs, page_bits = (
        c.u8() for _ in range(7))
    c.take(8 * 6)  # statistics: super and data blocks, the largest index set
    iblock = c.u64()
    if esize == 0 or not 0 < max_bits <= 64 or page_bits >= max_bits:
        raise ValueError(f"{hw}: {esize}-byte elements, {max_bits} bits, {page_bits} page bits")
    min_elmts_bits = _log2(min_elmts, "data block minimum", hw)
    ptr_bits = _log2(min_ptrs, "super block minimum", hw)
    if min_elmts_bits > max_bits:
        raise ValueError(f"{hw}: data blocks of {min_elmts} in a {max_bits}-bit array")
    if iblock == UNDEF:
        return esize, []
    n_sblks = 1 + max_bits - min_elmts_bits
    # super block u: 2^(u/2) data blocks of 2^((u+1)/2) * min_elmts elements
    n_dblks = [1 << (u // 2) for u in range(n_sblks)]
    dblk_n = [(1 << ((u + 1) // 2)) * min_elmts for u in range(n_sblks)]
    starts, start_dblk, s, k = [], [], idx_elmts, 0
    for u in range(n_sblks):
        starts.append(s)
        start_dblk.append(k)
        s += n_dblks[u] * dblk_n[u]
        k += n_dblks[u]
    iblock_sblks = min(2 * ptr_bits, n_sblks)
    n_dblk_addrs = 2 * (min_ptrs - 1)
    n_sblk_addrs = n_sblks - iblock_sblks
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits

    iw = f"{where}: extensible array index block at {iblock}"
    blk = read(iblock, 14 + idx_elmts * esize + 8 * (n_dblk_addrs + n_sblk_addrs) + 4)
    check_sum(blk, iw)
    b = Cursor(blk, iw)
    b.signature(b"EAIB")
    if b.u8() != client or b.u64() != addr:
        raise ValueError(f"{iw}: not the index block of {hw}")
    out = [(i, b.take(esize)) for i in range(idx_elmts)]
    dblk_addrs = [b.u64() for _ in range(n_dblk_addrs)]
    sblk_addrs = [b.u64() for _ in range(n_sblk_addrs)]
    seen: set = {addr, iblock}

    def data_block(at: int, first: int, n: int, pages: List[bool]) -> None:
        dw = f"{where}: extensible array data block at {at}"
        visit_once(seen, at, dw)
        prefix = 14 + off_size + 4
        blk = read(at, prefix + (0 if pages else n * esize))
        check_sum(blk, dw)
        d = Cursor(blk, dw)
        d.signature(b"EADB")
        # its offset field is not read: HDF5 writes it as the index block's
        # data blocks' global number times their size, and never reads it
        if d.u8() != client or d.u64() != addr:
            raise ValueError(f"{dw}: not a data block of {hw}")
        d.take(off_size)
        if not pages:
            out.extend((first + i, d.take(esize)) for i in range(n))
            return
        for p, init in enumerate(pages):
            if not init:
                continue
            pat = at + prefix + p * (page * esize + 4)
            pg = read(pat, page * esize + 4)
            check_sum(pg, f"{dw}: page {p} at {pat}")
            out.extend((first + p * page + i, pg[i * esize:(i + 1) * esize])
                       for i in range(page))

    for u in range(iblock_sblks):
        if dblk_n[u] > page:
            raise ValueError(f"{hw}: paged data blocks in the index block are not read")
        for j in range(n_dblks[u]):
            k = start_dblk[u] + j
            if k < n_dblk_addrs and dblk_addrs[k] != UNDEF:
                data_block(dblk_addrs[k], starts[u] + j * dblk_n[u], dblk_n[u], [])
    for si, at in enumerate(sblk_addrs):
        if at == UNDEF:
            continue
        u = iblock_sblks + si
        sw = f"{where}: extensible array super block at {at}"
        visit_once(seen, at, sw)
        n_pages = dblk_n[u] // page if dblk_n[u] > page else 0
        # a bitmap of whole bytes for each data block, whose bits HDF5 numbers
        # as one run (data block j's page p is bit j * n_pages + p)
        bitmap_size = n_dblks[u] * ((n_pages + 7) // 8)
        blk = read(at, 14 + off_size + bitmap_size + 8 * n_dblks[u] + 4)
        check_sum(blk, sw)
        d = Cursor(blk, sw)
        d.signature(b"EASB")
        if d.u8() != client or d.u64() != addr:
            raise ValueError(f"{sw}: not a super block of {hw}")
        d.take(off_size)
        bitmap = d.take(bitmap_size)
        for j in range(n_dblks[u]):
            child = d.u64()
            if child != UNDEF:
                pages = [_bit(bitmap, j * n_pages + p) for p in range(n_pages)]
                data_block(child, starts[u] + j * dblk_n[u], dblk_n[u], pages)
    return esize, out


# ------------------------------------------------------------ global heap

class GlobalHeap:
    """Objects of global heap collections, by (collection address, index)."""

    def __init__(self, read: Read, where: str):
        self.read, self.where = read, where
        self._collections: Dict[int, Dict[int, bytes]] = {}

    def _collection(self, addr: int) -> Dict[int, bytes]:
        gw = f"{self.where}: global heap collection at {addr}"
        head = Cursor(self.read(addr, 16), gw)
        head.signature(b"GCOL", 1)
        head.take(3)
        size = head.u64()
        if size < 16:
            raise ValueError(f"{gw}: a collection of {size} bytes")
        c = Cursor(self.read(addr, size), gw, 16)
        objects: Dict[int, bytes] = {}
        while c.left() >= 16:
            index, _, _, n = c.u16(), c.u16(), c.u32(), c.u64()
            if index == 0:  # the free space: the collection's end
                break
            objects[index] = c.take(n)
            c.take(min(-n % 8, c.left()))
        return objects

    def get(self, addr: int, index: int) -> bytes:
        if addr not in self._collections:
            self._collections[addr] = self._collection(addr)
        objects = self._collections[addr]
        if index not in objects:
            raise ValueError(f"{self.where}: no object {index} in the global heap "
                             f"collection at {addr}")
        return objects[index]
