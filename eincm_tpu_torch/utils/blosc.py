"""A decoder of Blosc1 chunks, for HDF5 filter 32001 (`utils/h5_lite.py`).

Real DSEC event files compress their datasets with the HDF5 Blosc filter,
which the reference reads through h5py and hdf5plugin; the card's machine
has neither, nor the blosc or lz4 packages. This module decodes a chunk from
the format's published description alone:

- the 16-byte header (c-blosc's README_HEADER.rst): format version (1 or 2,
  c-blosc 1.x), codec format version, flags, typesize, nbytes, blocksize,
  cbytes, all little endian. Flags: bit 0 byte shuffle, bit 1 memcpyed
  (the data follow the header uncompressed), bit 2 bit shuffle, bit 4 the
  blocks are not split into streams, bits 5-7 the codec (0 blosclz, 1 LZ4
  or LZ4HC, 2 Snappy, 3 zlib, 4 Zstd);
- then one int32 start offset per block (ceil(nbytes / blocksize) blocks,
  the last one nbytes % blocksize long where that is not 0);
- each block is `typesize` streams (its bytes split by position within an
  element) where its flags allow it, typesize <= 16, blocksize / typesize
  >= 128 and it is not the short last block, else one stream; each stream
  is an int32 compressed length and that many bytes, stored raw where the
  length equals the stream's size;
- a block is then unshuffled: byte shuffle (typesize > 1) had grouped byte
  j of every element together; bit shuffle (block >= typesize, and the
  block's element count a multiple of 8, else the block was left as it
  was) had grouped bit b of byte j of every element, least significant
  element bit first, in rows (j * 8 + b).

The HDF5 filter's cd_values (filter version, format version, typesize,
chunk bytes, clevel, shuffle, codec) restate the header; the decoder reads
the header. blosclz, LZ4 and Snappy streams are decoded by the native
library (`native/blosc.cpp`) where g++ built it, else by the plain Python
decoders here, which the tests hold it to; zlib streams by `zlib`; Zstd
streams by the native library alone (`native/zstd.cpp`): without it codec 4
raises `UnsupportedBlosc`, as any codec above 4 does, naming it. So every
codec that c-blosc 1.x writes is read.

`lzf_decompress_plain` is the plain version of the native LZF decoder,
which `utils/h5_lite.py` takes for h5py's LZF filter (HDF5 filter 32000).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

CODECS = {0: "blosclz", 1: "LZ4", 2: "Snappy", 3: "zlib", 4: "Zstd"}
HEADER = 16
MAX_SPLITS = 16
MIN_BUFFERSIZE = 128
BLOSCLZ_MAX_DISTANCE = 8191
_BYTE_SHUFFLE, _MEMCPYED, _BIT_SHUFFLE, _DONT_SPLIT = 0x1, 0x2, 0x4, 0x10


class UnsupportedBlosc(ValueError):
    """A Blosc chunk this module does not decode (its codec or version)."""


def _run(src: bytes, i: int, n: int) -> tuple:
    """A length continued in bytes, each 255 but the last: (sum, next i)."""
    total = 0
    while True:
        if i >= n:
            raise ValueError("truncated stream")
        b = src[i]
        i += 1
        total += b
        if b != 255:
            return total, i


def _copy_match(out: bytearray, dist: int, length: int) -> None:
    if dist <= 0 or dist > len(out):
        raise ValueError("match before the start of the stream")
    start = len(out) - dist
    if dist >= length:
        out += out[start:start + length]
    else:  # overlapping: a run
        for k in range(length):
            out.append(out[start + k])


def blosclz_decompress_plain(src: bytes, n_out: int) -> bytes:
    """The blosclz stream `src` decoded into `n_out` bytes (see
    native/blosc.cpp:blosclz_decompress for the format)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        if n_out:
            raise ValueError("empty stream")
        return b""
    i = 1
    ctrl = src[0] & 31
    while True:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:
                extra, i = _run(src, i, n)
                length += extra
            if i >= n:
                raise ValueError("truncated stream")
            code = src[i]
            i += 1
            dist = ofs + code + 1
            if code == 255 and ofs == 31 << 8:
                if i + 2 > n:
                    raise ValueError("truncated stream")
                dist = (src[i] << 8 | src[i + 1]) + BLOSCLZ_MAX_DISTANCE + 1
                i += 2
            _copy_match(out, dist, length + 3)
        else:
            if i + ctrl + 1 > n:
                raise ValueError("truncated stream")
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
        if len(out) > n_out:
            raise ValueError("stream longer than its block")
        if i >= n:
            break
        ctrl = src[i]
        i += 1
    if len(out) != n_out:
        raise ValueError(f"malformed blosclz stream: {len(out)} of {n_out} bytes decoded")
    return bytes(out)


def lz4_decompress_plain(src: bytes, n_out: int) -> bytes:
    """The LZ4 block `src` decoded into `n_out` bytes (see
    native/blosc.cpp:lz4_decompress for the format)."""
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            extra, i = _run(src, i, n)
            lit += extra
        if i + lit > n:
            raise ValueError("truncated stream")
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # the last sequence: literals only
        if i + 2 > n:
            raise ValueError("truncated stream")
        dist = src[i] | src[i + 1] << 8
        i += 2
        length = (token & 15) + 4
        if token & 15 == 15:
            extra, i = _run(src, i, n)
            length += extra
        _copy_match(out, dist, length)
        if len(out) > n_out:
            raise ValueError("stream longer than its block")
    if len(out) != n_out:
        raise ValueError(f"malformed LZ4 stream: {len(out)} of {n_out} bytes decoded")
    return bytes(out)


def snappy_decompress_plain(src: bytes, n_out: int) -> bytes:
    """The raw Snappy stream `src` decoded into `n_out` bytes (see
    native/blosc.cpp:snappy_decompress for the format)."""
    n = len(src)
    length, shift, i = 0, 0, 0
    while True:
        if i >= n or shift > 28:
            raise ValueError("truncated stream")
        b = src[i]
        i += 1
        length |= (b & 127) << shift
        if not b & 128:
            break
        shift += 7
    if length != n_out:
        raise ValueError(f"malformed Snappy stream: it states {length} of {n_out} bytes")
    out = bytearray()
    while i < n:
        tag = src[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            run = tag >> 2
            if run >= 60:
                nb = run - 59
                if i + nb > n:
                    raise ValueError("truncated stream")
                run = int.from_bytes(src[i:i + nb], "little")
                i += nb
            run += 1
            if i + run > n:
                raise ValueError("truncated stream")
            out += src[i:i + run]
            i += run
        else:
            nb = (1, 2, 4)[kind - 1]
            if i + nb > n:
                raise ValueError("truncated stream")
            if kind == 1:
                run = 4 + ((tag >> 2) & 7)
                dist = (tag >> 5) << 8 | src[i]
            else:
                run = (tag >> 2) + 1
                dist = int.from_bytes(src[i:i + nb], "little")
            i += nb
            _copy_match(out, dist, run)
        if len(out) > n_out:
            raise ValueError("stream longer than its block")
    if len(out) != n_out:
        raise ValueError(f"malformed Snappy stream: {len(out)} of {n_out} bytes decoded")
    return bytes(out)


def lzf_decompress_plain(src: bytes, n_out: int) -> bytes:
    """The liblzf stream `src` decoded into `n_out` bytes (see
    native/blosc.cpp:lzf_decompress for the format)."""
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            if i + ctrl + 1 > n:
                raise ValueError("truncated stream")
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
        else:
            run = ctrl >> 5
            if run == 7:
                if i >= n:
                    raise ValueError("truncated stream")
                run += src[i]
                i += 1
            if i >= n:
                raise ValueError("truncated stream")
            dist = ((ctrl & 31) << 8 | src[i]) + 1
            i += 1
            _copy_match(out, dist, run + 2)
        if len(out) > n_out:
            raise ValueError("stream longer than its chunk")
    if len(out) != n_out:
        raise ValueError(f"malformed LZF stream: {len(out)} of {n_out} bytes decoded")
    return bytes(out)


_PLAIN = {0: blosclz_decompress_plain, 1: lz4_decompress_plain, 2: snappy_decompress_plain}


def _decoder(codec: int, native: bool):
    if codec == 3:
        def inflate(src, n_out):
            try:
                out = zlib.decompress(src)
            except zlib.error as e:
                raise ValueError(f"malformed zlib stream: {e}") from None
            if len(out) != n_out:
                raise ValueError(f"malformed zlib stream: {len(out)} of {n_out} bytes")
            return out
        return inflate
    if codec not in (0, 1, 2, 4):
        raise UnsupportedBlosc(f"codec {codec} ({CODECS.get(codec, 'unknown')})")
    from eincm_tpu_torch.native import blosc as nb

    if codec == 4:
        if not nb.available():
            raise UnsupportedBlosc("codec 4 (Zstd) needs the native library, which did not build")

        def unzstd(src, n_out):
            try:
                return nb.zstd_decompress(src, n_out)
            except nb.UnsupportedZstd as e:
                raise UnsupportedBlosc(f"codec 4 (Zstd): {e}") from None
        return unzstd
    if native and nb.available():
        return {0: nb.blosclz_decompress, 1: nb.lz4_decompress, 2: nb.snappy_decompress}[codec]
    return _PLAIN[codec]


def unshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """Undo the byte shuffle of one block (uint8)."""
    n = len(block) // typesize * typesize
    out = block.copy()
    out[:n] = block[:n].reshape(typesize, -1).T.reshape(-1)
    return out


def bitunshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """Undo the bit shuffle of one block (uint8); a block whose element
    count is not a multiple of 8 was not shuffled."""
    size = len(block) // typesize
    if size % 8:
        return block.copy()
    rows = np.unpackbits(block.reshape(8 * typesize, size // 8), axis=1, bitorder="little")
    bits = rows.reshape(typesize, 8, size).transpose(2, 0, 1)  # (element, byte, bit)
    return np.packbits(bits, axis=2, bitorder="little").reshape(-1)


def decompress(chunk: bytes, native: Optional[bool] = True) -> bytes:
    """One Blosc1 chunk's bytes. `native=False` takes the plain decoders
    (Zstd has none: codec 4 takes the native one either way)."""
    if len(chunk) < HEADER:
        raise ValueError("truncated Blosc chunk: no header")
    version, _, flags, typesize = chunk[:4]
    nbytes, blocksize, cbytes = struct.unpack("<III", chunk[4:HEADER])
    if version not in (1, 2):
        raise UnsupportedBlosc(f"format version {version} (c-blosc 1.x writes 1 and 2)")
    if cbytes > len(chunk) or typesize == 0:
        raise ValueError(f"malformed Blosc chunk: cbytes {cbytes} of {len(chunk)}, "
                         f"typesize {typesize}")
    if flags & _MEMCPYED:
        if HEADER + nbytes > len(chunk):
            raise ValueError("truncated Blosc chunk")
        return bytes(chunk[HEADER:HEADER + nbytes])
    if nbytes == 0:
        return b""
    decode = _decoder(flags >> 5, native)
    if blocksize == 0:
        raise ValueError("malformed Blosc chunk: blocksize 0")
    n_blocks = -(-nbytes // blocksize)
    leftover = nbytes % blocksize
    if HEADER + 4 * n_blocks > len(chunk):
        raise ValueError(f"malformed Blosc chunk: {n_blocks} block starts past its end")
    starts = struct.unpack(f"<{n_blocks}i", chunk[HEADER:HEADER + 4 * n_blocks])
    out = np.empty(nbytes, np.uint8)
    for b, pos in enumerate(starts):
        short = b == n_blocks - 1 and leftover > 0
        bsize = leftover if short else blocksize
        split = (not flags & _DONT_SPLIT and typesize <= MAX_SPLITS
                 and blocksize // typesize >= MIN_BUFFERSIZE and not short)
        n_streams = typesize if split else 1
        size = bsize // n_streams
        parts = []
        for _ in range(n_streams):
            if pos < 0 or pos + 4 > len(chunk):
                raise ValueError("malformed Blosc chunk: a stream past its end")
            (clen,) = struct.unpack("<i", chunk[pos:pos + 4])
            pos += 4
            if clen < 0 or pos + clen > len(chunk):
                raise ValueError("malformed Blosc chunk: a stream past its end")
            src = chunk[pos:pos + clen]
            pos += clen
            parts.append(bytes(src) if clen == size else decode(src, size))
        block = np.frombuffer(b"".join(parts), np.uint8)
        if len(block) != bsize:
            raise ValueError(f"malformed Blosc chunk: block {b} of {len(block)} bytes")
        if flags & _BYTE_SHUFFLE and typesize > 1:
            block = unshuffle(block, typesize)
        elif flags & _BIT_SHUFFLE and bsize >= typesize:
            block = bitunshuffle(block, typesize)
        out[b * blocksize:b * blocksize + bsize] = block
    return out.tobytes()
