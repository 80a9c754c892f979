"""ctypes bindings to the native codec decoders (blosc.cpp, zstd.cpp).

`blosclz_decompress`, `lz4_decompress` and `snappy_decompress` decode one
compressed stream of a Blosc1 chunk, `lzf_decompress` one chunk of HDF5
filter 32000 (LZF), into exactly `n_out` bytes; `utils/blosc.py` parses the
chunk around them and falls back to its plain Python decoders when the
shared object is unavailable. `zstd_decompress` decodes Zstandard frames
(Blosc codec 4, HDF5 filter 32015) into exactly `n_out` bytes; it has no
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from eincm_tpu_torch.native.build import build

_lib: Optional[ctypes.CDLL] = None

# zstd.cpp's failure classes
_ZSTD_ERRORS = {
    -1: "truncated input",
    -2: "corrupt data",
    -3: "output longer than {n_out} bytes",
    -4: "content checksum mismatch",
    -6: "not a Zstandard frame (bad magic number)",
    -7: "a frame decoded to a size other than its Frame_Content_Size",
}


class UnsupportedZstd(ValueError):
    """A well-formed Zstandard frame this decoder does not read (one that
    names a dictionary)."""


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    for name in ("blosclz_decompress", "lz4_decompress", "snappy_decompress",
                 "lzf_decompress", "zstd_decompress"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ctypes.c_int64]
        fn.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _run(name: str, src: bytes, n_out: int) -> tuple:
    out = np.empty(n_out, np.uint8)
    return getattr(_load(), name)(bytes(src), len(src), out, n_out), out


def _decode(name: str, src: bytes, n_out: int) -> bytes:
    n, out = _run(name, src, n_out)
    if n != n_out:
        raise ValueError(f"malformed {name.split('_')[0]} stream: {n} of {n_out} bytes decoded")
    return out.tobytes()


def blosclz_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("blosclz_decompress", src, n_out)


def lz4_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("lz4_decompress", src, n_out)


def snappy_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("snappy_decompress", src, n_out)


def lzf_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("lzf_decompress", src, n_out)


def zstd_decompress(src: bytes, n_out: int) -> bytes:
    """The Zstandard frames in `src` (skippable frames skipped), decoded
    into exactly `n_out` bytes. Raises `UnsupportedZstd` for a frame that
    names a dictionary, ValueError for anything malformed."""
    n, out = _run("zstd_decompress", src, n_out)
    if n == -5:
        raise UnsupportedZstd("a Zstd dictionary (a frame's Dictionary_ID is not 0)")
    if n < 0:
        raise ValueError(f"malformed Zstd frame: {_ZSTD_ERRORS[n].format(n_out=n_out)}")
    if n != n_out:
        raise ValueError(f"malformed Zstd frame: {n} of {n_out} bytes decoded")
    return out.tobytes()
