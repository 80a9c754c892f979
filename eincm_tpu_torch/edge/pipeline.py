"""The edge-extraction pipeline: Canny -> smoothen/IEDT, on the host.

Carried over from eincm_tpu/edge/pipeline.py (reference staging:
src/experiments/e00/exp_mgr.py:335-350) in numpy and scipy. The frame
preprocessing (NL-means, CLAHE, sharpening, bilateral filter) is not
carried over yet: `extract_edges(preprocess=True)` raises.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
from scipy.ndimage import convolve1d

from eincm_tpu_torch.edge.canny import canny
from eincm_tpu_torch.edge.iedt import eincm_inv_exp_dist_transform

EPSN = sys.float_info.epsilon


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    return np.round((img - lo) / (hi - lo + EPSN) * 255).astype(np.uint8)


def image_to_edge(
    img: np.ndarray, apert_size: int = 3, th1: float = 30, th2: float = 80
) -> np.ndarray:
    """Canny edges, L2 gradient (img_utils.py:192-208)."""
    return canny(_to_uint8(img), th1, th2, apert_size, True)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflected borders (cv BORDER_REFLECT_101)."""
    radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = convolve1d(img.astype(np.float64), k, axis=0, mode="mirror")
    return convolve1d(out, k, axis=1, mode="mirror")


def smoothen_edges(edge_img: np.ndarray, k_size: float = 1, sigma: float = 1
                   ) -> np.ndarray:
    """Gaussian edge blunting (img_utils.py:210-220): sigma rules when > 0,
    otherwise it follows OpenCV's rule from the kernel size."""
    if sigma <= 0:
        sigma = 0.3 * ((float(k_size) - 1) * 0.5 - 1) + 0.8
    return _gaussian_blur(edge_img.astype(np.float64), max(sigma, 0.8))


def extract_edges(
    images: np.ndarray,
    preprocess: bool = True,
    smoothen_fn: Optional[Callable] = None,
    canny_th1: float = 30,
    canny_th2: float = 80,
    canny_aperture: int = 3,
) -> np.ndarray:
    """Per-frame pipeline over a stack of grayscale images -> (N, H, W):
    canny -> normalize(smoothen(edges)) (exp_mgr.py:335-350)."""
    if preprocess:
        raise NotImplementedError(
            "edge preprocessing (NL-means, CLAHE, bilateral) is not ported"
        )
    smoothen_fn = smoothen_fn or smoothen_edges
    out = []
    for img in images:
        edges = image_to_edge(img, canny_aperture, canny_th1, canny_th2)
        sm = np.asarray(smoothen_fn(edges), np.float64)
        out.append((sm - sm.min()) / (sm.max() - sm.min() + EPSN))
    return np.stack(out)


def iedt_edge_fn(iedt_alpha: float = 6.0):
    """images -> Canny + EINCM-IEDT edge maps without preprocessing (the
    experiments' `EdgeConfig(smoothen_method="eincm_iedt")` edge function)."""
    smoothen = lambda e: eincm_inv_exp_dist_transform(e, iedt_alpha)
    return lambda images: extract_edges(images, preprocess=False, smoothen_fn=smoothen)
