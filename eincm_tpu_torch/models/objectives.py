"""Contrast / correlation / collapse objectives, regularizers, and FWL.

Ports of eincm_tpu/models/objectives.py (reference: contrast_objectives.py:
13-87, correlation_objectives.py:12-130, event_collapse_objectives.py:8-19,
regularizers.py:14-57, contrast_metrics.py:6-18 of src/eincm/). The image
objectives reduce over the last two (H, W) dims, so a leading batch of
reference frames (or of tiles) is handled in one call.
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

from eincm_tpu_torch.ops.filters import divergence_filter, scharr_grads
from eincm_tpu_torch.ops.normalize import extract_tiles
from eincm_tpu_torch.ops.splat import event_counts

EPSN = sys.float_info.epsilon
_HW = (-2, -1)
_TILE = (32, 42)  # the reference's default tile size


# ---- contrast ---------------------------------------------------------------

def compute_mean_gradient_magnitude(arr: torch.Tensor) -> torch.Tensor:
    """Mean squared Scharr gradient magnitude (no sqrt) of (..., H, W)."""
    g = scharr_grads(arr)
    return (g[..., 0] ** 2 + g[..., 1] ** 2).mean(dim=_HW)


def compute_variance(arr: torch.Tensor) -> torch.Tensor:
    """Population variance of each (H, W) image, as `jnp.var` computes it."""
    centered = arr - arr.mean(dim=_HW, keepdim=True)
    return (centered * centered).mean(dim=_HW)


def compute_adaptive_mean_gradient_magnitude(
    arr: torch.Tensor, tile_size: Tuple[int, int] | None = None
) -> torch.Tensor:
    """Sum of per-tile mean gradient magnitudes of a 2-D array."""
    return compute_mean_gradient_magnitude(extract_tiles(arr, *(tile_size or _TILE))).sum()


def compute_adaptive_variance(
    arr: torch.Tensor, tile_size: Tuple[int, int] | None = None
) -> torch.Tensor:
    """Sum of per-tile variances of a 2-D array."""
    return compute_variance(extract_tiles(arr, *(tile_size or _TILE))).sum()


# ---- correlation ------------------------------------------------------------

def compute_mean_squared_error(
    arr_1: torch.Tensor, arr_2: torch.Tensor
) -> torch.Tensor:
    return ((arr_1 - arr_2) ** 2).mean(dim=_HW)


def compute_sum_squared_error(arr_1: torch.Tensor, arr_2: torch.Tensor) -> torch.Tensor:
    return ((arr_1 - arr_2) ** 2).sum(dim=_HW)


def compute_mean_hadamard_product(arr_1: torch.Tensor, arr_2: torch.Tensor) -> torch.Tensor:
    return (arr_1 * arr_2).mean(dim=_HW)


def compute_sum_hadamard_product(arr_1: torch.Tensor, arr_2: torch.Tensor) -> torch.Tensor:
    return (arr_1 * arr_2).sum(dim=_HW)


def compute_joint_contrast(arr_1: torch.Tensor, arr_2: torch.Tensor) -> torch.Tensor:
    """Joint-filtering correlation: the contrast of the sum image."""
    return compute_mean_gradient_magnitude(arr_1 + arr_2)


def compute_adaptive_mean_squared_error(
    arr_1: torch.Tensor, arr_2: torch.Tensor, tile_size: Tuple[int, int] | None = None
) -> torch.Tensor:
    """Sum of per-tile MSEs of two 2-D arrays."""
    th, tw = tile_size or _TILE
    return compute_mean_squared_error(
        extract_tiles(arr_1, th, tw), extract_tiles(arr_2, th, tw)
    ).sum()


# ---- event collapse ---------------------------------------------------------

def iwe_divergence(iwe: torch.Tensor) -> torch.Tensor:
    """Mean |divergence| of the IWE gradient field (anti-collapse)."""
    g = scharr_grads(iwe)  # (..., H, W, 2)
    div_x = divergence_filter(g[..., 0])
    div_y = divergence_filter(g[..., 1])
    return torch.abs(div_x + div_y).mean(dim=_HW)


# ---- regularizers -----------------------------------------------------------

def per_pix_theta_to_flow(
    theta: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """Flow displacement field with dt = 1: theta (H, W, 2) masked to the
    pixels with events (the reference scatter-writes theta[y, x] at each
    event, src/utils/theta_utils.py:40-73)."""
    mask = event_counts(xs, ys, (theta.shape[0], theta.shape[1])) > 0
    return theta * mask[..., None].to(theta.dtype)


def per_pix_total_variation(
    theta: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """L1 total variation of the event-masked flow field, over the count
    of pixels with any nonzero flow gradient."""
    flow = per_pix_theta_to_flow(theta, xs, ys, ts)
    gx = scharr_grads(flow[..., 0])  # (H, W, 2)
    gy = scharr_grads(flow[..., 1])
    nz = (
        (torch.abs(gx[..., 0]) > 0)
        | (torch.abs(gx[..., 1]) > 0)
        | (torch.abs(gy[..., 0]) > 0)
        | (torch.abs(gy[..., 1]) > 0)
    )
    l1 = 0.25 * (
        torch.abs(gx[..., 0]) + torch.abs(gx[..., 1])
        + torch.abs(gy[..., 0]) + torch.abs(gy[..., 1])
    )
    return l1.sum() / (nz.sum().to(theta.dtype) + EPSN)


def per_pix_theta_divergence(theta: torch.Tensor) -> torch.Tensor:
    """Mean |divergence| of the theta gradient fields."""
    gx = scharr_grads(theta[..., 0])
    gy = scharr_grads(theta[..., 1])
    div = (
        divergence_filter(gx[..., 0])
        + divergence_filter(gx[..., 1])
        + divergence_filter(gy[..., 0])
        + divergence_filter(gy[..., 1])
    )
    return torch.abs(div).mean()


# ---- contrast metric --------------------------------------------------------

def compute_fwl(iwe: torch.Tensor, zero_iwe: torch.Tensor) -> torch.Tensor:
    """Flow-Warp-Loss: var(IWE) / var(IUE), per IWE of (..., H, W)."""
    return compute_variance(iwe) / compute_variance(zero_iwe)
