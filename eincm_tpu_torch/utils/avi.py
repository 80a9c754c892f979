"""Minimal MJPEG AVI writer — no OpenCV/ffmpeg dependency.

The reference assembles the per-window end-result frames into an .avi with
``cv.VideoWriter`` (DIVX fourcc, src/experiments/e00/exp_mgr.py:758-792).
This module writes the standard RIFF-AVI container by hand with Motion-JPEG
frames (every mainstream player decodes MJPG), using PIL only for the JPEG
encode of each frame.

Carried over unchanged from eincm_tpu/utils/avi.py.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    arr = np.asarray(frame)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        a = arr.astype(np.float64)
        a = (a - a.min()) / (a.max() - a.min() + 1e-12)
        arr = (a * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., :3]).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(
    frames: Iterable[np.ndarray] | Sequence[np.ndarray],
    path,
    fps: int = 2,
    quality: int = 90,
) -> Path:
    """Write RGB/gray frames (all the same size) to an MJPEG .avi file.

    Args:
        frames: iterable of (H, W[, 3]) uint8/float arrays.
        path: output file path.
        fps: playback rate.
        quality: JPEG quality (0-100).
    """
    jpegs = []
    w = h = None
    for f in frames:
        f = np.asarray(f)
        if w is None:
            h, w = f.shape[:2]
        assert f.shape[:2] == (h, w), "all frames must share one size"
        jpegs.append(_jpeg_bytes(f, quality))
    assert jpegs, "no frames"
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        body = kind + payload
        pad = b"\x00" if len(body) % 2 else b""
        return b"LIST" + struct.pack("<I", len(body)) + body + pad

    us_per_frame = int(1_000_000 / fps)
    # AVIMAINHEADER (56 bytes after the fourcc/size)
    avih = struct.pack(
        "<14I",
        us_per_frame,
        max_size * fps,  # max bytes/sec
        0,  # padding granularity
        0x10,  # AVIF_HASINDEX
        n,  # total frames
        0,  # initial frames
        1,  # streams
        max_size,  # suggested buffer size
        w,
        h,
        0, 0, 0, 0,  # reserved
    )
    # AVISTREAMHEADER
    strh = (
        b"vids"
        + b"MJPG"
        + struct.pack(
            "<IHHIIIIIIII4H",
            0,  # flags
            0, 0,  # priority, language
            0,  # initial frames
            1,  # scale
            fps,  # rate
            0,  # start
            n,  # length
            max_size,  # suggested buffer
            0xFFFFFFFF,  # quality (default)
            0,  # sample size
            0, 0, w, h,  # rcFrame
        )
    )
    # BITMAPINFOHEADER
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0
    )
    hdrl = lst(
        b"hdrl",
        chunk(b"avih", avih)
        + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
    )

    movi_payload = b""
    index = []
    for j in jpegs:
        # offset measured from the start of the 'movi' fourcc
        index.append((4 + len(movi_payload), len(j)))
        movi_payload += chunk(b"00dc", j)
    movi = lst(b"movi", movi_payload)

    idx1 = b"".join(
        b"00dc" + struct.pack("<III", 0x10, off, size)  # AVIIF_KEYFRAME
        for off, size in index
    )
    body = b"AVI " + hdrl + movi + chunk(b"idx1", idx1)

    path = Path(path)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path
