"""Theta (velocity field) rescaling between pyramid levels and sensor size.

Reference: src/utils/theta_utils.py:10-37 (`scale_theta_to_sensor_size`),
src/eincm/solver.py:350-377 (`_upscale_theta`, `_downscale_theta`).

The interpolating resizes follow `jax.image.scale_and_translate` with its
default `antialias=True`, which eincm_tpu/ops/resize.py uses: when
downscaling, the triangle kernel widens by the inverse scale. So
`F.interpolate(mode="bilinear")` does not match it; the per-axis weight
matrix is built here as JAX builds it (`compute_weight_mat`: the widened
kernel, the `1000 * eps` sum guard and the out-of-range mask) and applied
as two small products.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_LINEAR = ("linear", "bilinear", "trilinear")
_SUM_GUARD = 1000.0 * float(np.finfo(np.float32).eps)


def _weight_mat(
    in_size: int, out_size: int, dtype: torch.dtype, device
) -> torch.Tensor:
    """(in_size, out_size) triangle resampling weights, antialiased."""
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
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > _SUM_GUARD,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _scale_hw(theta: torch.Tensor, out_h: int, out_w: int, method: str):
    if method not in _LINEAR:
        raise NotImplementedError(f"resize method {method!r}")
    h, w, c = theta.shape
    dtype = torch.promote_types(theta.dtype, torch.float32)
    th = theta.to(dtype)
    wh = _weight_mat(h, out_h, dtype, theta.device)  # (h, out_h)
    ww = _weight_mat(w, out_w, dtype, theta.device)  # (w, out_w)
    rows = (wh.T @ th.reshape(h, w * c)).reshape(out_h, w, c)
    return torch.einsum("hjc,jw->hwc", rows, ww)


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
    return _scale_hw(
        theta, theta.shape[0] * base, theta.shape[1] * base, method
    )


def downscale_theta(
    theta: torch.Tensor, base: int = 2, method: str = "bilinear"
) -> torch.Tensor:
    """Downscale theta by `base` along both spatial axes (interpolating)."""
    return _scale_hw(
        theta, theta.shape[0] // base, theta.shape[1] // base, method
    )
