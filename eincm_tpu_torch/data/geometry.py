"""Camera geometry helpers for DSEC: SE(3) transforms, undistortion, remap.

Carried over unchanged from eincm_tpu/data/geometry.py.

Replaces the reference's OpenCV dependencies with self-contained numpy:
- `Transform`: SE(3) compose/inverse (reference:
  src/dataloaders/dsec_utils/euclidean_transform.py:6-70).
- `undistort_points_iter`: iterative radial-tangential undistortion
  (replaces cv.undistortPointsIter, dsec_loader.py:232-233).
- `remap_bicubic`: image warp by a coordinate map with Catmull-Rom-style
  cubic convolution, a = -0.75 (matches cv.remap INTER_CUBIC semantics,
  dsec_loader.py:243-244).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as Rot


class Transform:
    """Rigid SE(3) transform with numerically stable compose/inverse."""

    def __init__(self, translation: np.ndarray, rotation: Rot):
        t = np.asarray(translation).reshape(-1)
        assert t.size == 3
        self._translation = t
        self._rotation = rotation

    @staticmethod
    def from_transform_matrix(m: np.ndarray) -> "Transform":
        return Transform(m[:3, 3], Rot.from_matrix(m[:3, :3]))

    @staticmethod
    def from_rotation(rotation: Rot) -> "Transform":
        return Transform(np.zeros(3), rotation)

    def R(self) -> Rot:
        return self._rotation

    def R_matrix(self) -> np.ndarray:
        return self._rotation.as_matrix()

    def t(self) -> np.ndarray:
        return self._translation

    def __matmul__(self, other: "Transform") -> "Transform":
        rotation = self._rotation * other._rotation
        translation = self._rotation.apply(other._translation) + self._translation
        return Transform(translation, rotation)

    def inverse(self) -> "Transform":
        rotation = self._rotation.inv()
        return Transform(-rotation.apply(self._translation), rotation)


def _distort(xn: np.ndarray, yn: np.ndarray, dist: np.ndarray):
    """Apply the OpenCV radial-tangential model (k1,k2,p1,p2[,k3])."""
    k1, k2, p1, p2 = dist[:4]
    k3 = dist[4] if len(dist) > 4 else 0.0
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def undistort_points_iter(
    coords: np.ndarray,
    K: np.ndarray,
    dist_coeffs: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    n_iters: int = 100,
    eps: float = 1e-3,
) -> np.ndarray:
    """Undistort pixel coords via fixed-point iteration, then rectify.

    Matches cv.undistortPointsIter(coords, K, dist, R, P, criteria=(100, 1e-3)):
    normalize with K^-1, iterate x_n <- (x_d - delta(x_n)) / radial(x_n),
    then project through R and P.

    Args:
        coords: (2, N) pixel coordinates.
        K: (3, 3) camera matrix of the distorted camera.
        dist_coeffs: (4+,) distortion coefficients.
        R: (3, 3) rectification rotation.
        P: (3, 3) new projection matrix.

    Returns:
        (N, 2) rectified pixel coordinates.
    """
    x = (coords[0] - K[0, 2]) / K[0, 0]
    y = (coords[1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()  # distorted normalized coords

    k1, k2, p1, p2 = dist_coeffs[:4]
    k3 = dist_coeffs[4] if len(dist_coeffs) > 4 else 0.0
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x_new = (x0 - dx) / radial
        y_new = (y0 - dy) / radial
        # cv's criteria eps (default 1e-3) applies to PIXEL-scale error;
        # this delta is in normalized camera coordinates, which the focal
        # length (~10^3 px for DSEC) scales up — eps * 1e-3 in normalized
        # units therefore approximates eps in pixels (slightly conservative
        # for shorter focal lengths; the iteration cap bounds the cost).
        if max(np.abs(x_new - x).max(initial=0), np.abs(y_new - y).max(initial=0)) < eps * 1e-3:
            x, y = x_new, y_new
            break
        x, y = x_new, y_new

    pts = np.stack([x, y, np.ones_like(x)])  # (3, N)
    pts = R @ pts
    pts = pts / pts[2]
    proj = P @ pts
    return proj[:2].T  # (N, 2)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), a=-0.75 as in OpenCV."""
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    w = np.where(
        at <= 1,
        (a + 2) * at3 - (a + 3) * at2 + 1,
        np.where(at < 2, a * at3 - 5 * a * at2 + 8 * a * at - 4 * a, 0.0),
    )
    return w


def remap_bicubic(img: np.ndarray, map_xy: np.ndarray) -> np.ndarray:
    """Sample `img` at float coords map_xy (H, W, 2) with cubic convolution.

    Out-of-bounds samples are zero (cv.remap BORDER_CONSTANT default).
    """
    h, w = img.shape[:2]
    mx = map_xy[..., 0]
    my = map_xy[..., 1]
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    fx = mx - x0
    fy = my - y0

    out = np.zeros(mx.shape, np.float64)
    imgf = img.astype(np.float64)
    for dy in range(-1, 3):
        wy = _cubic_kernel(dy - fy)
        yi = y0 + dy
        inside_y = (yi >= 0) & (yi < h)
        for dx in range(-1, 3):
            wx = _cubic_kernel(dx - fx)
            xi = x0 + dx
            inside = inside_y & (xi >= 0) & (xi < w)
            wgt = wy * wx
            vals = np.zeros_like(out)
            vals[inside] = imgf[yi[inside], xi[inside]]
            out += wgt * vals  # vals is already 0 at out-of-bounds taps

    # cv.remap BORDER_CONSTANT semantics: out-of-bounds taps contribute the
    # border value (0) at FULL weight — no renormalization at the borders
    # (the cubic kernel is a partition of unity, so interior pixels are
    # unaffected either way)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(img.dtype)
