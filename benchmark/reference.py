"""The plain reference: what a window's loss, gradient and flow should be.

Plain NumPy, SciPy and PyTorch, written from the published method (the
EINCM reference, src/eincm/losses.py:39-276, src/utils/event_utils.py:
13-77, src/utils/img_utils.py:192-233, src/utils/theta_utils.py:10-37), in
any precision (float64 for the check, lower for its control). It imports
nothing of the program and takes nothing the program made: it works out
the window's normalised times and edge maps again from the raw window.
The Canny detector is a frozen copy of `eincm_tpu_torch/edge/canny.py`
(commit eee0051), which follows cv.Canny with the L2 gradient.

The loss of a coarse theta (h, w, 2) over one window:
1. the theta at each event: the bilinear (triangle) upscale of theta to
   the sensor, sampled at the event's rounded pixel;
2. each event warped to each frame's time t_r:
   x' = round(x) - theta_x (t - t_r), and so for y;
3. per frame r, the image of warped events: a 3x3 window of separable
   standard-normal pdf values g(i - y') g(j - x') around the rounded warped
   coordinate, texels off the sensor dropped;
4. loss = alpha * -mean_r(w_r C_r / C_0) + beta * -mean_r(w_r K_r / K_0,r),
   C the mean squared Scharr gradient of the frame, K = -mean((edge_r -
   normalised frame)^2), w the Gaussian weights of the frames, and C_0,
   K_0 the same of the unwarped events;
5. at the finest level (0) only, where gamma != 0, + gamma * TV: the
   event-masked L1 total variation of the theta upscaled to the sensor
   (src/eincm/regularizers.py:14-38, applied at level 0 by
   src/eincm/losses.py:171; `masked_tv`).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

import numpy as np
import torch
from scipy.ndimage import convolve, distance_transform_edt, label

EPS = sys.float_info.epsilon
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
SCHARR_X = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
SCHARR_Y = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))


# ---- edge maps (on the host) -----------------------------------------------

def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    return np.round((img - lo) / (hi - lo + EPS) * 255).astype(np.uint8)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)


def canny(img: np.ndarray, th1: float, th2: float) -> np.ndarray:
    """Binary edges (bool) like cv.Canny with aperture 3 and the L2
    gradient: Sobel gradients, OpenCV's 4-sector non-maximum suppression,
    double threshold and 8-connected hysteresis."""
    lo, hi = sorted((th1, th2))
    f = img.astype(np.float64)
    gx = convolve(f, _SOBEL_X[::-1, ::-1], mode="nearest")
    gy = convolve(f, _SOBEL_X.T[::-1, ::-1], mode="nearest")
    mag = np.sqrt(gx * gx + gy * gy)
    h, w = img.shape
    ax, ay = np.abs(gx), np.abs(gy)
    horiz = ay <= 0.4142135623730951 * ax
    vert = ay >= 2.414213562373095 * ax
    diag = ~horiz & ~vert
    same = (gx * gy) > 0
    pm = np.pad(mag, 1)

    def sh(dy, dx):
        return pm[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    keep = horiz & (mag > sh(0, -1)) & (mag >= sh(0, 1))
    keep |= vert & (mag > sh(-1, 0)) & (mag >= sh(1, 0))
    keep |= diag & same & (mag > sh(-1, -1)) & (mag >= sh(1, 1))
    keep |= diag & ~same & (mag > sh(-1, 1)) & (mag >= sh(1, -1))
    nms = np.where(keep, mag, 0.0)
    lbl, n = label(nms > lo, structure=np.ones((3, 3), int))
    if n == 0:
        return np.zeros(img.shape, bool)
    strong = np.unique(lbl[nms > hi])
    return np.isin(lbl, strong[strong != 0])


def _unit(a: np.ndarray) -> np.ndarray:
    return (a - a.min()) / (a.max() - a.min() + EPS)


def edge_maps(images: np.ndarray, edge_cfg: Dict) -> np.ndarray:
    """(n, H, W) edge maps of grey frames: Canny, then the EINCM inverse
    exponential distance transform 1 - unit(1 - exp(-EDT / alpha)), then
    unit range (src/utils/img_utils.py:192-233, no preprocessing)."""
    if edge_cfg.get("smoothen_method") != "eincm_iedt" or edge_cfg.get(
            "enable_image_preprocessing", True) or edge_cfg.get("canny_aperture", 3) != 3:
        raise NotImplementedError("the reference computes Canny (aperture 3) + EINCM IEDT "
                                  "edges without preprocessing")
    alpha = float(edge_cfg.get("iedt_alpha", 6.0))
    out = []
    for img in np.asarray(images, np.float64):
        edges = canny(to_uint8(img), float(edge_cfg["canny_th1"]), float(edge_cfg["canny_th2"]))
        edt = distance_transform_edt(~edges)
        sm = 1.0 - _unit(1.0 - np.exp(-edt / alpha))
        out.append(_unit(sm))
    return np.stack(out)


# ---- the window's inputs ---------------------------------------------------

class RefWindow:
    """A raw window made ready for the reference on `device` in `dtype`:
    times normalised to the evaluation span, edge maps worked out again,
    the pixels with events (`mask`) and the unwarped frame's statistics."""

    def __init__(self, datasample: Dict, edge_cfg: Dict, sensor: Tuple[int, int],
                 device, dtype=torch.float64, edges: np.ndarray = None,
                 mask: torch.Tensor = None):
        ev = datasample["events"]
        t0, t1 = np.asarray(datasample["eval_ts"], np.float64)
        span = t1 - t0 + EPS
        ts = (np.asarray(ev["t"], np.float64) - t0) / span
        frame_ts = (np.asarray(datasample["image_ts"], np.float64) - t0) / span
        if edges is None:
            edges = edge_maps(datasample["images"], edge_cfg)
        self.edges_np = edges
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        self.sensor = tuple(sensor)
        self.dtype = dtype
        self.xs = as_t(np.asarray(ev["x"], np.float64))
        self.ys = as_t(np.asarray(ev["y"], np.float64))
        self.ts = as_t(ts)
        self.frame_ts = as_t(frame_ts)
        self.edges = as_t(edges)
        n = len(frame_ts)
        q = np.linspace(-1.5, 1.5, n)
        wts = np.exp(-0.5 * q * q)
        self.weights = as_t(wts / wts.sum())
        self.mask = event_mask(datasample, self.sensor, device) if mask is None else mask
        with torch.no_grad():
            zero = splat(self.xs[None], self.ys[None], self.sensor)[0]
            self.zero_contrast = contrast(zero)
            self.zero_corrs = -((self.edges - unit_range(zero)) ** 2).mean(dim=(-2, -1))

    def loss(self, theta: torch.Tensor, alpha: float, beta: float, gamma: float = 0.0,
             level: int = 0) -> torch.Tensor:
        """The loss of `theta` at pyramid `level` (0 the finest); with
        gamma 0 only the data terms, by the same operations at every
        level."""
        data = self._data_loss(theta, alpha, beta)
        weight = tv_weight(gamma, level)
        if weight != 0.0:
            return data + weight * self.tv(theta)
        return data

    def tv(self, theta: torch.Tensor) -> torch.Tensor:
        return masked_tv(theta, self.mask, self.sensor)

    def tv_and_grad(self, theta):
        """The masked TV of `theta` and its gradient, whatever the level."""
        th = theta.detach().to(self.dtype).clone().requires_grad_(True)
        f = self.tv(th)
        (g,) = torch.autograd.grad(f, th)
        return f.detach(), g

    def _data_loss(self, theta: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
        th = interp_at_events(theta, self.xs, self.ys, self.sensor)
        dts = self.ts[None, :] - self.frame_ts[:, None]
        wx = torch.round(self.xs)[None, :] - th[None, :, 0] * dts
        wy = torch.round(self.ys)[None, :] - th[None, :, 1] * dts
        frames = splat(wx, wy, self.sensor)
        corrs = -((self.edges - unit_range(frames)) ** 2).mean(dim=(-2, -1))
        rel_c = self.weights * contrast(frames) / (self.zero_contrast + EPS)
        rel_k = self.weights * corrs / (self.zero_corrs + EPS)
        return alpha * -rel_c.mean() + beta * -rel_k.mean()

    def loss_and_grad(self, theta, alpha: float, beta: float, gamma: float = 0.0,
                      level: int = 0):
        th = theta.detach().to(self.dtype).clone().requires_grad_(True)
        f = self.loss(th, alpha, beta, gamma, level)
        (g,) = torch.autograd.grad(f, th)
        return f.detach(), g


# ---- the operations ---------------------------------------------------------

def _taps(c: torch.Tensor, n: int, full_n: int):
    """The two triangle taps of pixel coordinate `c` on an axis of n cells
    scaled to full_n pixels (jax.image.scale_and_translate, 'bilinear'):
    indices clamped into range, weights normalised over the taps inside."""
    u = (c + 0.5) * (n / full_n) - 0.5
    k0 = torch.floor(u)
    k1 = k0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(k0 - u), 0.0) * ((k0 >= 0) & (k0 < n))
    w1 = torch.clamp_min(1.0 - torch.abs(k1 - u), 0.0) * ((k1 >= 0) & (k1 < n))
    s = torch.clamp_min(w0 + w1, 1e-20)
    return k0.clamp(0, n - 1).long(), k1.clamp(0, n - 1).long(), w0 / s, w1 / s


def interp_at_events(theta: torch.Tensor, xs, ys, sensor) -> torch.Tensor:
    """(E, 2): the theta upscaled to the sensor, at each event's rounded
    pixel, as products with dense (E, h) and (E, w) tap weights, so that
    the gradient sums over the events without atomics."""
    h, w, _ = theta.shape
    H, W = sensor
    wy = _dense(torch.round(ys), h, H)
    wx = _dense(torch.round(xs), w, W)
    rows = (wy @ theta.reshape(h, w * 2)).reshape(-1, w, 2)
    return (rows * wx[:, :, None]).sum(dim=1)


def _dense(c: torch.Tensor, n: int, full_n: int) -> torch.Tensor:
    i0, i1, w0, w1 = _taps(c, n, full_n)
    out = torch.zeros((c.shape[0], n), dtype=c.dtype, device=c.device)
    out.scatter_add_(1, i0[:, None], w0[:, None])
    return out.scatter_add_(1, i1[:, None], w1[:, None])


def upscale(theta: torch.Tensor, sensor) -> torch.Tensor:
    """(H, W, 2): the theta upscaled to the sensor at every pixel."""
    H, W = sensor
    ys = torch.arange(H, dtype=theta.dtype, device=theta.device)
    xs = torch.arange(W, dtype=theta.dtype, device=theta.device)
    gy = ys[:, None].expand(H, W).reshape(-1)
    gx = xs[None, :].expand(H, W).reshape(-1)
    return interp_at_events(theta, gx, gy, sensor).reshape(H, W, 2)


SPLAT_COPIES = 64  # partial frames the taps are spread over


def splat(wx: torch.Tensor, wy: torch.Tensor, sensor) -> torch.Tensor:
    """(R, E) warped coordinates -> (R, H, W) frames. Event e adds into
    partial frame e mod SPLAT_COPIES, and the partials are summed: events
    crowd onto few pixels, and one frame would make their adds wait on
    each other."""
    R = wx.shape[0]
    H, W = sensor
    d = torch.arange(-1, 2, dtype=wx.dtype, device=wx.device)
    rows = torch.round(wy)[..., None] + d
    cols = torch.round(wx)[..., None] + d
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    zero = torch.zeros((), dtype=wx.dtype, device=wx.device)
    qy = torch.where(vr, rows - wy[..., None], zero)
    qx = torch.where(vc, cols - wx[..., None], zero)
    gy = torch.where(vr, torch.exp(-0.5 * qy * qy) * _INV_SQRT_2PI, zero)
    gx = torch.where(vc, torch.exp(-0.5 * qx * qx) * _INV_SQRT_2PI, zero)
    vals = gy[..., :, None] * gx[..., None, :]
    ri = torch.where(vr, rows, zero).long()
    ci = torch.where(vc, cols, zero).long()
    E = wx.shape[1]
    copy = (torch.arange(E, device=wx.device) % SPLAT_COPIES)[None, :, None, None]
    ref = torch.arange(R, device=wx.device)[:, None, None, None]
    flat = ((copy * R + ref) * H + ri[..., :, None]) * W + ci[..., None, :]
    frames = torch.zeros(SPLAT_COPIES * R * H * W, dtype=wx.dtype, device=wx.device)
    frames = frames.index_add(0, flat.reshape(-1), vals.reshape(-1))
    return frames.reshape(SPLAT_COPIES, R, H, W).sum(dim=0)


def _conv3(img: torch.Tensor, k) -> torch.Tensor:
    """True 2-D convolution of (..., H, W) with a 3x3 kernel, zero padded."""
    H, W = img.shape[-2:]
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            c = k[2 - i][2 - j]
            if c:
                out = out + c * p[..., i:i + H, j:j + W]
    return out


def contrast(frames: torch.Tensor) -> torch.Tensor:
    """Mean squared Scharr gradient magnitude of each (H, W) frame."""
    gx, gy = _conv3(frames, SCHARR_X), _conv3(frames, SCHARR_Y)
    return (gx * gx + gy * gy).mean(dim=(-2, -1))


def unit_range(frames: torch.Tensor) -> torch.Tensor:
    lo = torch.amin(frames, dim=(-2, -1), keepdim=True)
    hi = torch.amax(frames, dim=(-2, -1), keepdim=True)
    return (frames - lo) / (hi - lo + EPS)


def tv_weight(gamma: float, level: int) -> float:
    """The TV term's weight in the loss at pyramid `level`: gamma at the
    finest level (0), else 0."""
    return gamma if level == 0 else 0.0


def tv_terms(theta: torch.Tensor, mask: torch.Tensor, sensor):
    """(l1, nonzero), each (H, W), of a coarse theta (h, w, 2): the flow
    upscaled to the sensor and zeroed at pixels without events (`mask`),
    the Scharr x and y gradients of both its channels, l1 a quarter of
    their four absolute values summed, and `nonzero` where any of the
    four is nonzero.

    The gradient takes d|x|/dx = sign(x), and 0 at x = 0 (torch.abs's,
    as jnp.abs's in the published method): outside the mask the flow is
    exactly 0, so a pixel whose 3x3 neighbourhood holds no event adds
    nothing to l1, to the count or to the gradient."""
    flow = upscale(theta, sensor) * mask[..., None].to(theta.dtype)
    grads = [_conv3(flow[..., c], k) for c in (0, 1) for k in (SCHARR_X, SCHARR_Y)]
    mags = [g.abs() for g in grads]
    l1 = 0.25 * (mags[0] + mags[1] + mags[2] + mags[3])
    nonzero = (mags[0] > 0) | (mags[1] > 0) | (mags[2] > 0) | (mags[3] > 0)
    return l1, nonzero


def masked_tv(theta: torch.Tensor, mask: torch.Tensor, sensor) -> torch.Tensor:
    """The event-masked L1 total variation: l1 summed over the count of
    nonzero pixels (+ EPS), `tv_terms`."""
    l1, nonzero = tv_terms(theta, mask, sensor)
    return l1.sum() / (nonzero.sum().to(theta.dtype) + EPS)


def event_mask(datasample: Dict, sensor, device) -> torch.Tensor:
    """(H, W) bool: pixels with at least one event."""
    H, W = sensor
    ev = datasample["events"]
    x = np.asarray(ev["x"], np.int64)
    y = np.asarray(ev["y"], np.int64)
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    mask = np.zeros((H, W), bool)
    mask[y[ok], x[ok]] = True
    return torch.as_tensor(mask, device=device)


def aee(theta0: torch.Tensor, vel, mask: torch.Tensor, sensor) -> float:
    """Mean endpoint error (px) at the pixels of `mask` between the level-0
    theta upscaled to the sensor and the constant velocity `vel`."""
    flow = upscale(theta0.detach().to(torch.float64), sensor)
    gt = torch.tensor(vel, dtype=torch.float64, device=flow.device)
    return float(torch.linalg.norm(flow - gt, dim=-1)[mask].mean())
