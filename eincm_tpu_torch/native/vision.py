"""ctypes bindings to the native vision library (vision.cpp).

Exposes the same callables as the numpy fallbacks in
eincm_tpu_torch/edge/{filters_np,canny,iedt}.py — the edge pipeline picks these up
automatically via `_native_or` when the shared object builds.
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
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_int, c_dbl = ctypes.c_int, ctypes.c_double

    lib.gaussian_blur_f64.argtypes = [f64, f64, c_int, c_int, c_dbl]
    lib.nl_means_u8.argtypes = [u8, u8, c_int, c_int, c_dbl, c_int, c_int]
    lib.clahe_u8.argtypes = [u8, u8, c_int, c_int, c_dbl, c_int, c_int]
    lib.bilateral_u8.argtypes = [u8, u8, c_int, c_int, c_int, c_dbl, c_dbl]
    lib.canny_u8.argtypes = [u8, u8, c_int, c_int, c_dbl, c_dbl, c_int]
    lib.exact_edt.argtypes = [u8, f64, c_int, c_int]
    for fn in (
        lib.gaussian_blur_f64, lib.nl_means_u8, lib.clahe_u8,
        lib.bilateral_u8, lib.canny_u8, lib.exact_edt,
    ):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def gaussian_blur(img: np.ndarray, sigma: float, radius=None) -> np.ndarray:
    if radius is not None:
        raise ValueError(
            "native gaussian_blur uses radius=ceil(3*sigma); pass "
            "radius=None or use edge.filters_np.gaussian_blur"
        )
    lib = _load()
    src = np.ascontiguousarray(img, np.float64)
    dst = np.empty_like(src)
    lib.gaussian_blur_f64(src, dst, *src.shape, float(sigma))
    return dst


def nl_means_denoise(
    img: np.ndarray, h: float = 4.0, template_win_size: int = 3,
    search_win_size: int = 11,
) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    dst = np.empty_like(src)
    lib.nl_means_u8(
        src, dst, *src.shape, float(h), int(template_win_size),
        int(search_win_size),
    )
    return dst


def clahe(
    img: np.ndarray, clip_limit: float = 5.0, tile_grid_size=(10, 10),
    n_bins: int = 256,
) -> np.ndarray:
    if n_bins != 256:
        raise ValueError(
            "native clahe histograms are fixed at 256 bins; use "
            "edge.filters_np.clahe for other n_bins"
        )
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    dst = np.empty_like(src)
    lib.clahe_u8(
        src, dst, *src.shape, float(clip_limit),
        int(tile_grid_size[0]), int(tile_grid_size[1]),
    )
    return dst


def bilateral_filter(
    img: np.ndarray, neigh_diameter: int = 5, sigma_color: float = 15.0,
    sigma_space: float = 15.0,
) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    dst = np.empty_like(src)
    lib.bilateral_u8(
        src, dst, *src.shape, int(neigh_diameter), float(sigma_color),
        float(sigma_space),
    )
    return dst


def canny(
    img: np.ndarray, threshold1: float = 30.0, threshold2: float = 80.0,
    aperture_size: int = 3, l2_gradient: bool = True,
) -> np.ndarray:
    if aperture_size != 3:
        raise ValueError(
            "native canny gradients are fixed Sobel-3; use edge.canny for "
            "other aperture sizes"
        )
    lib = _load()
    src = np.ascontiguousarray(img, np.uint8)
    dst = np.empty_like(src)
    lib.canny_u8(
        src, dst, *src.shape, float(threshold1), float(threshold2),
        int(l2_gradient),
    )
    return dst


def exact_edt(edge_mask: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance to the nearest True pixel (Meijster)."""
    lib = _load()
    src = np.ascontiguousarray(edge_mask.astype(np.uint8))
    dst = np.empty(src.shape, np.float64)
    lib.exact_edt(src, dst, *src.shape)
    return dst
