"""Minimal 16-bit RGB PNG writer/reader (pure Python, zlib only).

The DSEC submission format is 16-bit 3-channel PNG
(src/dsec_npz_to_png.py:94-101 writes via imageio's FreeImage plugin, which
needs a downloaded binary). `write_png16` writes that subset (8- or
16-bit, greyscale or RGB, filter type 0) and `read_png16` reads it with all
five filter types. `read_png` reads every colour type and bit depth of a
PNG, plain or interlaced (Adam7: seven passes, each a small image of its
own filtered rows), as the JAX package's `imageio.imread` (PIL) gives it,
for `data/readers.py:imread_gray`.

Carried over from eincm_tpu/utils/png16.py; the reader's per-byte loops
are vectorized (rows of None, Sub and Up filters row by row, images with
Average or Paeth rows along anti-diagonals of pixels), bitwise the same.
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


_KINDS = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale + alpha", 6: "RGBA"}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# the seven passes of Adam7 interlacing: (first column, first row, column
# step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _decode(path):
    """(bit depth, colour type, PLTE entries or None, samples (h, w, c) as
    stored: uint8 below 16 bits, each sample in one byte, else uint16)."""
    data = Path(path).read_bytes()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR" and len(body) == 13:
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: a PNG without its IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    if interlace > 1:
        raise ValueError(f"{path}: interlace method {interlace}")
    if depth not in _DEPTHS.get(color_type, ()):
        raise ValueError(f"{path}: PNG colour type {color_type} "
                         f"({_KINDS.get(color_type, 'unknown')}) at {depth} bits is not a "
                         "PNG colour type and depth")
    if color_type == 3 and plte is None:
        raise ValueError(f"{path}: a palette PNG without its PLTE")
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass has no rows, not even filter bytes
            continue
        stride = -(-pw * c * depth // 8)
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError(f"{path}: {raw.size} bytes of image data, fewer than its rows need")
        out[y0::dy, x0::dx] = _samples(raw[pos:pos + n], pw, ph, c, depth, path)
        pos += n
    if pos != raw.size:
        raise ValueError(f"{path}: {raw.size} bytes of image data, not {pos}")
    return depth, color_type, plte, out


def _samples(raw: np.ndarray, w: int, h: int, c: int, depth: int, path) -> np.ndarray:
    """The (h, w, c) samples of one image (or Adam7 pass) of filtered
    rows: uint8 below 16 bits, each sample in one byte, else uint16."""
    bypp = max(1, c * depth // 8)  # the filters' unit: bytes per pixel, at least one
    stride = -(-w * c * depth // 8)
    raw = raw.reshape(h, stride + 1)
    ftypes, lines = raw[:, 0], raw[:, 1:].reshape(h, stride // bypp, bypp)
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"{path}: unsupported filter {int(ftypes.max())}")
    out = _unfilter_rows(ftypes, lines) if ftypes.max(initial=0) <= 2 else (
        _unfilter_diagonals(ftypes, lines))
    out = out.reshape(h, stride)
    if depth == 16:
        return np.frombuffer(out.tobytes(), ">u2").reshape(h, w, c).astype(np.uint16)
    if depth < 8:  # samples packed from the high bit
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    return out.reshape(h, w, c)


def read_png16(path) -> np.ndarray:
    """Read a PNG written by `write_png16` (or any filter-0/sub/up/avg/paeth
    grey/RGB PNG, interlaced or not) into uint8/uint16."""
    depth, color_type, _, img = _decode(path)
    if color_type not in (0, 2) or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {color_type} "
                         f"({_KINDS.get(color_type, 'unknown')}) at {depth} bits is not "
                         "supported (8/16-bit grey or RGB)")
    return img[..., 0] if color_type == 0 else img


def read_png(path) -> np.ndarray:
    """Read any PNG as imageio's PIL plugin gives it (the JAX
    package's `imageio.imread`): 1-bit grey as bool (bitwise), 2- and 4-bit grey
    scaled to uint8, 8- and 16-bit grey as uint8 and uint16; a palette
    expanded through PLTE to RGB (its tRNS dropped); RGB, RGBA and
    grey + alpha as uint8 channels, 16-bit samples cut to their high byte
    (16-bit grey + alpha as RGBA)."""
    depth, color_type, plte, img = _decode(path)
    if color_type == 3:
        if img.max(initial=0) >= len(plte):
            raise ValueError(f"{path}: a palette index past the {len(plte)} PLTE entries")
        return plte[img[..., 0]]
    if color_type == 0:
        if depth == 1:  # PIL's bool holds True as the byte 0xFF
            return (img[..., 0] * np.uint8(255)).view(bool)
        return img[..., 0] * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else img[..., 0]
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if color_type == 4:
            img = img[..., [0, 0, 0, 1]]
    return img


def _unfilter_rows(ftypes: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """None, Sub and Up rows (h, w, bytes per pixel), one row at a time: Sub
    is a running sum along the row, Up a sum with the row above, mod 256."""
    out = np.empty_like(lines)
    prev = np.zeros_like(lines[0])
    for y, f in enumerate(ftypes):
        line = lines[y]
        if f == 1:
            line = np.cumsum(line, axis=0, dtype=np.uint8)
        elif f == 2:
            line = line + prev
        out[y] = line
        prev = out[y]
    return out


def _unfilter_diagonals(ftypes: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """Rows of any filter, along the anti-diagonals y + x = d. A pixel needs
    its left, upper and upper-left neighbours, which lie on the two earlier
    diagonals, so each diagonal is one vector step over all rows. The image
    is skewed so a diagonal is one row of `rec`: rec[d + 2, y + 1] holds
    pixel (y, d - y); pixels left of the image stay 0 (their data is 0 and
    so are their neighbours), those right of it are never read."""
    h, w, bypp = lines.shape
    ys, ds = np.arange(h)[None, :], np.arange(h + w - 1)[:, None]
    xs = ds - ys
    inside = (xs >= 0) & (xs < w)
    data = np.where(inside[..., None], lines[ys, np.clip(xs, 0, w - 1)], 0).astype(np.int16)
    rec = np.zeros((h + w + 1, h + 1, bypp), np.int16)
    f = ftypes[:, None]
    sub, up, avg, paeth = ((f == k).astype(np.int16) for k in (1, 2, 3, 4))
    any_avg, any_paeth = bool(avg.any()), bool(paeth.any())
    for d in range(h + w - 1):
        a, b, c = rec[d + 1, 1:], rec[d + 1, :-1], rec[d, :-1]
        pred = sub * a + up * b
        if any_avg:
            pred += avg * ((a + b) >> 1)
        if any_paeth:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred += paeth * np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rec[d + 2, 1:] = (data[d] + pred) & 0xFF
    ry = np.arange(h)[:, None]
    return rec[ry + np.arange(w)[None, :] + 2, ry + 1].astype(np.uint8)
