"""The edge-extraction pipeline: preprocess -> Canny -> smoothen/IEDT, on the host.

Carried over from eincm_tpu/edge/pipeline.py (reference staging:
src/experiments/e00/exp_mgr.py:335-350) in numpy and scipy. Per frame:
  1. preprocess_image: NL-means denoise -> CLAHE -> unsharp sharpen ->
     bilateral filter (src/utils/img_utils.py:131-189)
  2. image_to_edge: Canny (src/utils/img_utils.py:192-208)
  3. smoothen: Gaussian edge blunting (img_utils.py:210-220) or an IEDT
     surface (img_utils.py:223-233)
with unit-range normalization around each stage.

As in the JAX package, NL-means, CLAHE, the bilateral filter and Canny
(Sobel-3) run the C++ filters of `eincm_tpu_torch/native` when g++ has
built them, and the numpy filters otherwise; the two NL-means and CLAHE
differ by one grey level on a few pixels, so the choice is the JAX
package's. An error inside a native filter is raised, never answered by
the numpy one.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np

from eincm_tpu_torch.edge import filters_np
from eincm_tpu_torch.edge.canny import canny
from eincm_tpu_torch.edge.iedt import (  # noqa: F401  (re-exported)
    eincm_inv_exp_dist_transform,
    rtef_inv_exp_dist_transform,
)
from eincm_tpu_torch.native import vision as _native

EPSN = sys.float_info.epsilon


def _native_or(fallback):
    """The native filter named as `fallback` where the library is built,
    else `fallback` (eincm_tpu/edge/pipeline.py:_native_or)."""
    if _native.available() and hasattr(_native, fallback.__name__):
        return getattr(_native, fallback.__name__)
    return fallback


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    return np.round((img - lo) / (hi - lo + EPSN) * 255).astype(np.uint8)


def preprocess_image(
    img: np.ndarray,
    denoise_h: float = 4,
    denoise_template_win_size: int = 3,
    denoise_search_win_size: int = 11,
    clahe_clip_limit: float = 5,
    clahe_tile_grid_size: tuple = (10, 10),
    sharpen_kernel_size: int = 3,
    sharpen_sigma_x: float = 2,
    sharpen_alpha: float = 1.5,
    sharpen_beta: float = -0.5,
    bilateral_filter_neigh_diameter: int = 5,
    bilateral_filter_sigma_color: float = 15,
    bilateral_filter_sigma_space: float = 15,
) -> np.ndarray:
    """Frame-quality pipeline ahead of edge detection (img_utils.py:131-189)."""
    img = _to_uint8(img)
    nl_means = _native_or(filters_np.nl_means_denoise)
    clahe_fn = _native_or(filters_np.clahe)
    bilateral = _native_or(filters_np.bilateral_filter)

    denoised = nl_means(
        img, denoise_h, denoise_template_win_size, denoise_search_win_size
    )
    equalized = clahe_fn(denoised, clahe_clip_limit, tuple(clahe_tile_grid_size))
    blurred = filters_np.gaussian_blur(equalized, sharpen_sigma_x)
    sharpened = filters_np.add_weighted(
        equalized, sharpen_alpha, blurred, sharpen_beta
    )
    return bilateral(
        _to_uint8(sharpened),
        bilateral_filter_neigh_diameter,
        bilateral_filter_sigma_color,
        bilateral_filter_sigma_space,
    )


def image_to_edge(
    img: np.ndarray, apert_size: int = 3, th1: float = 30, th2: float = 80
) -> np.ndarray:
    """Canny edges, L2 gradient (img_utils.py:192-208); the native kernel's
    gradients are Sobel-3 only, so other apertures take numpy."""
    canny_fn = _native_or(canny) if apert_size == 3 else canny
    return canny_fn(_to_uint8(img), th1, th2, apert_size, True)


def smoothen_edges(edge_img: np.ndarray, k_size: float = 1, sigma: float = 1
                   ) -> np.ndarray:
    """Gaussian edge blunting (img_utils.py:210-220): sigma rules when > 0,
    otherwise it follows OpenCV's rule from the kernel size."""
    if sigma <= 0:
        sigma = 0.3 * ((float(k_size) - 1) * 0.5 - 1) + 0.8
    return filters_np.gaussian_blur(edge_img.astype(np.float64), max(sigma, 0.8))


def extract_edges(
    images: np.ndarray,
    preprocess: bool = True,
    smoothen_fn: Optional[Callable] = None,
    canny_th1: float = 30,
    canny_th2: float = 80,
    canny_aperture: int = 3,
    preprocess_kwargs: Optional[dict] = None,
) -> np.ndarray:
    """Per-frame pipeline over a stack of grayscale images -> (N, H, W):
    normalize(preprocess) -> canny -> normalize(smoothen(edges))
    (exp_mgr.py:335-350)."""
    smoothen_fn = smoothen_fn or smoothen_edges
    out = []
    for img in images:
        if preprocess:
            img = preprocess_image(img, **(preprocess_kwargs or {}))
        edges = image_to_edge(img, canny_aperture, canny_th1, canny_th2)
        sm = np.asarray(smoothen_fn(edges), np.float64)
        out.append((sm - sm.min()) / (sm.max() - sm.min() + EPSN))
    return np.stack(out)


def iedt_edge_fn(iedt_alpha: float = 6.0):
    """images -> Canny + EINCM-IEDT edge maps without preprocessing (the
    experiments' `EdgeConfig(smoothen_method="eincm_iedt")` edge function)."""
    smoothen = lambda e: eincm_inv_exp_dist_transform(e, iedt_alpha)
    return lambda images: extract_edges(images, preprocess=False, smoothen_fn=smoothen)
