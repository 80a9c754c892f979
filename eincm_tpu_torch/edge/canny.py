"""Canny edge detection on the host (numpy + scipy).

Functional equivalent of cv.Canny with L2 gradient (reference:
src/utils/img_utils.py:192-208): Sobel gradients at the given aperture,
gradient-direction non-maximum suppression (4-sector quantization, as in
OpenCV), double threshold, and hysteresis via connected components.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve, label

_SOBEL3_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
_SOBEL3_Y = _SOBEL3_X.T


def _sobel_kernels(aperture_size: int):
    if aperture_size == 3:
        return _SOBEL3_X, _SOBEL3_Y
    # larger apertures: iterate smoothing ([1,2,1]) convolutions like OpenCV's
    # getDerivKernels
    smooth = np.array([1.0, 2.0, 1.0])
    deriv = np.array([-1.0, 0.0, 1.0])
    k = aperture_size // 2 - 1
    for _ in range(k):
        smooth = np.convolve(smooth, np.array([1.0, 2.0, 1.0]))
        deriv = np.convolve(deriv, np.array([1.0, 2.0, 1.0]))
    gx = np.outer(smooth, deriv)
    return gx, gx.T


def canny(
    img: np.ndarray,
    threshold1: float = 30.0,
    threshold2: float = 80.0,
    aperture_size: int = 3,
    l2_gradient: bool = True,
) -> np.ndarray:
    """Binary edge map (uint8, 0/255) like cv.Canny."""
    lo, hi = sorted((threshold1, threshold2))
    img_f = img.astype(np.float64)
    kx, ky = _sobel_kernels(aperture_size)
    gx = convolve(img_f, kx[::-1, ::-1], mode="nearest")
    gy = convolve(img_f, ky[::-1, ::-1], mode="nearest")

    if l2_gradient:
        mag = np.sqrt(gx * gx + gy * gy)
    else:
        mag = np.abs(gx) + np.abs(gy)

    # --- non-maximum suppression with OpenCV's 4-sector quantization ---
    h, w = img.shape
    ax = np.abs(gx)
    ay = np.abs(gy)
    tan225 = 0.4142135623730951  # tan(22.5 deg)
    tan675 = 2.414213562373095  # tan(67.5 deg)

    horiz = ay <= tan225 * ax  # gradient ~ horizontal -> compare left/right
    vert = ay >= tan675 * ax  # gradient ~ vertical -> compare up/down
    diag = ~horiz & ~vert
    same_sign = (gx * gy) > 0  # 45-deg vs 135-deg diagonal

    pm = np.pad(mag, 1, mode="constant")

    def sh(dy, dx):
        return pm[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    keep = np.zeros_like(mag, dtype=bool)
    keep |= horiz & (mag > sh(0, -1)) & (mag >= sh(0, 1))
    keep |= vert & (mag > sh(-1, 0)) & (mag >= sh(1, 0))
    keep |= diag & same_sign & (mag > sh(-1, -1)) & (mag >= sh(1, 1))
    keep |= diag & ~same_sign & (mag > sh(-1, 1)) & (mag >= sh(1, -1))

    nms = np.where(keep, mag, 0.0)

    # --- double threshold + hysteresis ---
    strong = nms > hi
    weak = nms > lo
    # connected components of `weak` containing a strong pixel survive
    lbl, n = label(weak, structure=np.ones((3, 3), int))
    if n == 0:
        return np.zeros_like(img, np.uint8)
    strong_labels = np.unique(lbl[strong])
    strong_labels = strong_labels[strong_labels != 0]
    edges = np.isin(lbl, strong_labels)
    return (edges * 255).astype(np.uint8)
