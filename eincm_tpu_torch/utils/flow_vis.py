"""Optical-flow visualization: UV field -> RGB via the Middlebury color wheel.

Replaces the reference's external `flow_vis` dependency
(src/utils/flow_utils.py:8-59) with a self-contained implementation of the
standard Baker et al. color coding, plus the embedded color-code legend.

Carried over unchanged from eincm_tpu/utils/flow_vis.py.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """(55, 3) RGB rows spanning the standard 6 hue transitions."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False),  # red -> yellow
        (YG, 1, 0, True),  # yellow -> green
        (GC, 1, 2, False),  # green -> cyan
        (CB, 2, 1, True),  # cyan -> blue
        (BM, 2, 0, False),  # blue -> magenta
        (MR, 0, 2, True),  # magenta -> red
    ]
    for n, base, ramp, down in ramps:
        wheel[col : col + n, base] = 255
        vals = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, ramp] = 255 - vals if down else vals
        col += n
    return wheel


_WHEEL = _make_colorwheel()


def flow_uv_to_img(
    flow_uv: np.ndarray, clip_flow: float | None = None
) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB, magnitude-normalized."""
    u = np.array(flow_uv[..., 0], np.float64)
    v = np.array(flow_uv[..., 1], np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u * u + v * v)
    rad_max = rad.max()
    eps = np.finfo(np.float64).eps
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    rad = rad / (rad_max + eps)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        # saturate toward white at low magnitude
        col = 1 - rad * (1 - col)
        img[..., c] = np.floor(255 * col)
    return img


def get_flow_color_code(size: int = 64) -> np.ndarray:
    """Square legend image of the color wheel (flow_utils.py:36-59)."""
    r = size // 2
    ys, xs = np.mgrid[-r:r, -r:r].astype(np.float64)
    legend = flow_uv_to_img(np.stack([xs, ys], axis=-1))
    mask = xs**2 + ys**2 > r * r
    legend[mask] = 255
    return legend


def embed_flow_code_in_img(
    flow_img: np.ndarray, code_size: int | None = None
) -> np.ndarray:
    """Paste the color-code legend into the bottom-right corner."""
    out = flow_img.copy()
    h, w = out.shape[:2]
    size = code_size or max(16, min(h, w) // 6)
    legend = get_flow_color_code(size)
    out[h - size :, w - size :] = legend[: size, : size]
    return out
