"""Minimal 16-bit RGB PNG writer/reader (pure Python, zlib only).

The DSEC submission format is 16-bit 3-channel PNG
(src/dsec_npz_to_png.py:94-101 writes via imageio's FreeImage plugin, which
needs a downloaded binary). This codec handles exactly that subset: 8- or
16-bit, greyscale or RGB, no interlacing, filter type 0.

Carried over unchanged from eincm_tpu/utils/png16.py.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG color type (grey, truecolor)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png16(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, C in {1,3}) uint8/uint16 image as PNG."""
    img = np.asarray(img)
    assert img.dtype in (np.uint8, np.uint16), img.dtype
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    assert c in _COLOR_TYPE, f"unsupported channel count {c}"
    depth = 8 if img.dtype == np.uint8 else 16

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)

    if depth == 16:
        raw = img.astype(">u2").tobytes()
        stride = w * c * 2
    else:
        raw = img.tobytes()
        stride = w * c
    # prepend filter byte 0 per scanline
    lines = b"".join(
        b"\x00" + raw[y * stride : (y + 1) * stride] for y in range(h)
    )
    idat = zlib.compress(lines, 6)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def read_png16(path) -> np.ndarray:
    """Read a PNG written by `write_png16` (or any filter-0/sub/up/avg/paeth
    non-interlaced grey/RGB PNG) into uint8/uint16."""
    data = Path(path).read_bytes()
    assert data[:8] == _MAGIC, "not a PNG"
    pos = 8
    ihdr = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = ihdr
    assert interlace == 0, "interlaced PNG unsupported"
    c = {0: 1, 2: 3}[color_type]
    bypp = c * (depth // 8)  # bytes per pixel
    stride = w * bypp

    raw = zlib.decompress(idat)
    out = bytearray(h * stride)
    prev = bytearray(stride)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1 : pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:  # sub
            for i in range(bypp, stride):
                line[i] = (line[i] + line[i - bypp]) & 0xFF
        elif ftype == 2:  # up
            for i in range(stride):
                line[i] = (line[i] + prev[i]) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                left = line[i - bypp] if i >= bypp else 0
                line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = line[i - bypp] if i >= bypp else 0
                b = prev[i]
                cc = prev[i - bypp] if i >= bypp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (line[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"unsupported filter {ftype}")
        out[y * stride : (y + 1) * stride] = line
        prev = line

    dtype = np.dtype(">u2") if depth == 16 else np.uint8
    arr = np.frombuffer(bytes(out), dtype).reshape(h, w, c)
    arr = arr.astype(np.uint16 if depth == 16 else np.uint8)
    return arr[..., 0] if c == 1 else arr
