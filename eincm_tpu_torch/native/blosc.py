"""ctypes bindings to the native Blosc codec decoders (blosc.cpp).

`blosclz_decompress` and `lz4_decompress` decode one compressed stream of
a Blosc1 chunk into exactly `n_out` bytes; `utils/blosc.py` parses the
chunk around them and falls back to its plain Python decoders when the
shared object is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from eincm_tpu_torch.native.build import build

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    for name in ("blosclz_decompress", "lz4_decompress"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ctypes.c_int64]
        fn.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _decode(name: str, src: bytes, n_out: int) -> bytes:
    out = np.empty(n_out, np.uint8)
    n = getattr(_load(), name)(bytes(src), len(src), out, n_out)
    if n != n_out:
        raise ValueError(f"malformed {name.split('_')[0]} stream: {n} of {n_out} bytes decoded")
    return out.tobytes()


def blosclz_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("blosclz_decompress", src, n_out)


def lz4_decompress(src: bytes, n_out: int) -> bytes:
    return _decode("lz4_decompress", src, n_out)
