"""Theta (velocity field) rescaling between pyramid levels and sensor size.

Reference: src/utils/theta_utils.py:10-37 (`scale_theta_to_sensor_size`),
src/eincm/solver.py:350-377 (`_upscale_theta`, `_downscale_theta`).

The interpolating resizes follow `jax.image.scale_and_translate` with its
default `antialias=True`, which eincm_tpu/ops/resize.py uses: when
downscaling, the kernel widens by the inverse scale. So
`F.interpolate(mode="bilinear")` does not match it; the weight matrix of
each axis (the channel axis too, at scale 1) is built here as JAX builds it
(`compute_weight_mat`: the widened kernel, the `1000 * eps` sum guard and
the out-of-range mask) and applied as small products. The kernels are
JAX's: the triangle, Keys cubic (a = -0.5) and Lanczos of radius 3 and 5.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

# the interpolating methods of eincm_tpu/ops/resize.py:_INTERP_METHODS
_INTERP_METHODS = (
    "linear", "bilinear", "trilinear", "cubic", "bicubic", "tricubic",
    "lanczos3", "lanczos5",
)
_SUM_GUARD = 1000.0 * float(np.finfo(np.float32).eps)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi**2 * x**2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)

    return kernel


# jax.image.ResizeMethod.from_string's names and kernels
_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def _weight_mat(
    in_size: int, out_size: int, kernel, dtype: torch.dtype, device
) -> torch.Tensor:
    """(in_size, out_size) resampling weights of `kernel`, antialiased."""
    scale = torch.tensor(out_size / in_size, dtype=dtype, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = (
        torch.arange(out_size, dtype=dtype, device=device) + 0.5
    ) * inv_scale - 0.5
    x = (
        torch.abs(
            sample_f[None, :]
            - torch.arange(in_size, dtype=dtype, device=device)[:, None]
        )
        / kernel_scale
    )
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > _SUM_GUARD,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _scale_hw(theta: torch.Tensor, out_h: int, out_w: int, method: str):
    kernel = _KERNELS.get(method)
    if kernel is None:
        raise ValueError(f'Unknown resize method "{method}"')
    h, w, c = theta.shape
    dtype = torch.promote_types(theta.dtype, torch.float32)
    th = theta.to(dtype)
    wh = _weight_mat(h, out_h, kernel, dtype, theta.device)  # (h, out_h)
    ww = _weight_mat(w, out_w, kernel, dtype, theta.device)  # (w, out_w)
    wc = _weight_mat(c, c, kernel, dtype, theta.device)  # the identity, but
    # for Lanczos, whose weight at distance 1 is sin(pi) ~ 1e-16, not 0
    rows = (wh.T @ th.reshape(h, w * c)).reshape(out_h, w, c)
    return torch.einsum("hjc,jw,cd->hwd", rows, ww, wc)


def scale_theta_to_sensor_size(
    theta: torch.Tensor,
    sensor_size: Tuple[int, int],
    method: str = "bilinear",
) -> torch.Tensor:
    """Upscale a coarse theta (h, w, 2) to the full sensor (H, W, 2)."""
    return _scale_hw(theta, sensor_size[0], sensor_size[1], method)


def upscale_theta(
    theta: torch.Tensor, base: int = 2, method: str = "repeat"
) -> torch.Tensor:
    """Upscale theta by `base` along both spatial axes ('repeat' duplicates
    pixels, the reference default, src/eincm/solver.py:351-352)."""
    if method == "repeat":
        return theta.repeat_interleave(base, dim=0).repeat_interleave(
            base, dim=1
        )
    if method in _INTERP_METHODS:
        return _scale_hw(
            theta, theta.shape[0] * base, theta.shape[1] * base, method
        )
    raise NotImplementedError(f"upscale method {method!r}")


def downscale_theta(
    theta: torch.Tensor, base: int = 2, method: str = "bilinear"
) -> torch.Tensor:
    """Downscale theta by `base` along both spatial axes (interpolating)."""
    if method in _INTERP_METHODS:
        return _scale_hw(
            theta, theta.shape[0] // base, theta.shape[1] // base, method
        )
    raise NotImplementedError(f"downscale method {method!r}")
