"""Host-side image filters in vectorized numpy.

Carried over from eincm_tpu/edge/filters_np.py (the reference's OpenCV
calls, src/utils/img_utils.py:131-220): non-local-means denoising, CLAHE,
Gaussian blur, unsharp masking (addWeighted), and bilateral filtering.
The JAX package's C++ backend for the same entry points (eincm_tpu/native)
is not carried over: these numpy versions are its reference and the port
runs them.
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: np.ndarray, sigma: float, radius: int | None = None) -> np.ndarray:
    """Separable Gaussian blur with reflected borders (cv BORDER_REFLECT_101)."""
    from scipy.ndimage import convolve1d

    k = gaussian_kernel1d(sigma, radius)
    out = convolve1d(img.astype(np.float64), k, axis=0, mode="mirror")
    out = convolve1d(out, k, axis=1, mode="mirror")
    return out


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv.addWeighted with uint8 saturation when inputs are uint8."""
    out = alpha * a.astype(np.float64) + beta * b.astype(np.float64) + gamma
    if a.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def nl_means_denoise(
    img: np.ndarray,
    h: float = 4.0,
    template_win_size: int = 3,
    search_win_size: int = 11,
) -> np.ndarray:
    """Non-local means denoising (Buades et al.), vectorized over shifts.

    Functional equivalent of cv.fastNlMeansDenoising: for each pixel, average
    over the search window weighted by exp(-patch_distance / h^2) with patch
    L2 distances. Patch distances for every shift are computed with a box
    filter over the squared-difference image (one O(N) pass per shift).
    """
    img_f = img.astype(np.float64)
    tr = template_win_size // 2
    sr = search_win_size // 2
    patch_area = template_win_size**2

    from scipy.ndimage import uniform_filter

    acc = np.zeros_like(img_f)
    wacc = np.zeros_like(img_f)
    h2 = (h * h) * patch_area
    for dy in range(-sr, sr + 1):
        for dx in range(-sr, sr + 1):
            shifted = np.roll(np.roll(img_f, dy, axis=0), dx, axis=1)
            d2 = uniform_filter((img_f - shifted) ** 2, size=template_win_size,
                                mode="mirror") * patch_area
            w = np.exp(-np.maximum(d2 - 2.0 * 0.0, 0.0) / h2)
            acc += w * shifted
            wacc += w
    out = acc / wacc
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def clahe(
    img: np.ndarray,
    clip_limit: float = 5.0,
    tile_grid_size: tuple = (10, 10),
    n_bins: int = 256,
) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization (uint8).

    Per-tile clipped histograms -> equalization LUTs -> bilinear blend of the
    four surrounding tile LUTs per pixel (standard CLAHE; functional
    equivalent of cv.createCLAHE(...).apply).
    """
    assert img.dtype == np.uint8 and img.ndim == 2
    h, w = img.shape
    gh, gw = tile_grid_size
    # pad so tiles divide evenly (cv pads with border replicate)
    th = -(-h // gh)
    tw = -(-w // gw)
    ph, pw = th * gh - h, tw * gw - w
    padded = np.pad(img, ((0, ph), (0, pw)), mode="edge")

    tiles = padded.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3)
    luts = np.empty((gh, gw, n_bins), np.float64)
    clip = max(1.0, clip_limit * th * tw / n_bins)
    for i in range(gh):
        for j in range(gw):
            hist = np.bincount(tiles[i, j].ravel(), minlength=n_bins).astype(
                np.float64
            )
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / n_bins
            cdf = hist.cumsum()
            cdf = cdf / cdf[-1]
            luts[i, j] = cdf * (n_bins - 1)

    # bilinear interpolation between tile LUTs
    yy, xx = np.mgrid[0:h, 0:w]
    ty = (yy + 0.5) / th - 0.5  # tile-space coords
    tx = (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(ty).astype(int), 0, gh - 1)
    x0 = np.clip(np.floor(tx).astype(int), 0, gw - 1)
    y1 = np.clip(y0 + 1, 0, gh - 1)
    x1 = np.clip(x0 + 1, 0, gw - 1)
    fy = np.clip(ty - y0, 0, 1)
    fx = np.clip(tx - x0, 0, 1)

    v = img
    v00 = luts[y0, x0, v]
    v01 = luts[y0, x1, v]
    v10 = luts[y1, x0, v]
    v11 = luts[y1, x1, v]
    out = (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def bilateral_filter(
    img: np.ndarray,
    neigh_diameter: int = 5,
    sigma_color: float = 15.0,
    sigma_space: float = 15.0,
) -> np.ndarray:
    """Bilateral filter, vectorized over window shifts
    (equivalent of cv.bilateralFilter)."""
    img_f = img.astype(np.float64)
    r = neigh_diameter // 2
    acc = np.zeros_like(img_f)
    wacc = np.zeros_like(img_f)
    inv_2sc2 = 1.0 / (2.0 * sigma_color**2)
    inv_2ss2 = 1.0 / (2.0 * sigma_space**2)
    padded = np.pad(img_f, r, mode="symmetric")
    h, w = img_f.shape
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy > r * r and neigh_diameter > 0:
                # cv uses a circular neighborhood of radius d/2
                continue
            shifted = padded[r + dy : r + dy + h, r + dx : r + dx + w]
            ws = np.exp(-(dx * dx + dy * dy) * inv_2ss2)
            wc = np.exp(-((shifted - img_f) ** 2) * inv_2sc2)
            wgt = ws * wc
            acc += wgt * shifted
            wacc += wgt
    out = acc / wacc
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out
