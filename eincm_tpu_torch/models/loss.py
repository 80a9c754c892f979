"""The EINCM bi-modal objective ("C^2Max"): contrast + edge correlation.

Port of the solver-path loss of eincm_tpu/models/loss.py (reference:
src/eincm/losses.py:39-205). Every theta-independent quantity is computed
once per window (`compute_window_statics`); `solver_loss` is the lean loss
the optimizer evaluates: coarse-theta interp + multi-reference warp, one
splat of all references, then normalized contrast and edge correlation.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from eincm_tpu_torch.models.objectives import (
    compute_mean_gradient_magnitude,
    compute_mean_squared_error,
    iwe_divergence,
)
from eincm_tpu_torch.ops.filters import scharr_grads
from eincm_tpu_torch.ops.normalize import normalize_to_unit_range
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.ops.splat import (
    events_to_pdf_frame,
    make_event_mask,
    splat_multi_ref,
)
from eincm_tpu_torch.ops.warp import (
    warp_events_multi_ref,
    warp_events_multi_ref_coarse,
)

EPSN = sys.float_info.epsilon
SENTINEL = -1e4


def _sanitize_events(xs, ys, ts):
    """Replace non-finite (padding) events by a far off-sensor sentinel,
    x = y = -1e4, t = 0.

    NaN coordinates drop out of every forward op but poison the backward
    (NaN * 0 = NaN reaches dtheta). The sentinel contributes zero to every
    splat, mask and objective and keeps all gradients finite; it sits far
    enough that no physical flow (|theta| * dt << 1e4 px) brings it back
    onto the sensor.
    """
    finite = torch.isfinite(xs) & torch.isfinite(ys) & torch.isfinite(ts)
    sent = torch.full((), SENTINEL, dtype=xs.dtype, device=xs.device)
    zero = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return (
        torch.where(finite, xs, sent),
        torch.where(finite, ys, sent),
        torch.where(finite, ts, zero),
    )


@dataclass(frozen=True)
class LossParams:
    """Objective weights (reference: src/eincm/losses.py:115-118).

    alpha: contrast weight, beta: edge-correlation weight,
    gamma: total-variation weight, delta: IWE-divergence weight.
    """

    alpha: float
    beta: float
    gamma: float = 0.0
    delta: float = 0.0


@dataclass(frozen=True)
class LossStatics:
    """Constants of the loss."""

    sensor_size: Tuple[int, int]
    n_pyr_lvls: int
    scale_to_sensor_size_method: str = "bilinear"


class WindowStatics(NamedTuple):
    """Theta-independent per-window quantities."""

    zero_iwe: torch.Tensor  # (H, W)
    normalized_zero_iwe: torch.Tensor  # (H, W)
    zero_contrast: torch.Tensor  # ()
    zero_corrs: torch.Tensor  # (n_refs,)
    zero_iwe_divergence: torch.Tensor  # ()
    event_mask: torch.Tensor  # (H, W) bool


def compute_weights_for_multi_reference(
    n_refs: int, n_sigma: float = 1.5
) -> np.ndarray:
    """Gaussian weights over reference times, normalized to sum 1
    (reference: src/eincm/losses.py:39-46)."""
    q = np.linspace(-n_sigma, n_sigma, n_refs)
    w = np.exp(-0.5 * q * q) / math.sqrt(2.0 * math.pi)
    return w / w.sum()


@torch.no_grad()
def compute_window_statics(
    xs: torch.Tensor,
    ys: torch.Tensor,
    edges: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> WindowStatics:
    """Every theta-independent loss input of one event window."""
    zero_iwe = events_to_pdf_frame(xs, ys, sensor_size)
    nzi = normalize_to_unit_range(zero_iwe)
    zero_contrast = compute_mean_gradient_magnitude(zero_iwe)
    zero_corrs = -compute_mean_squared_error(edges, nzi)
    zero_div = iwe_divergence(nzi)
    mask = make_event_mask(xs, ys, sensor_size)
    return WindowStatics(zero_iwe, nzi, zero_contrast, zero_corrs, zero_div, mask)


def _solver_loss_tail(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    edges: torch.Tensor,
    params: LossParams,
    window_statics: WindowStatics,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """Splat the (n_refs, E) warped events and combine the relative
    contrast, correlation and (when delta != 0) divergence terms."""
    dtype = warped_xs.dtype
    w = torch.as_tensor(
        compute_weights_for_multi_reference(n_refs=edges.shape[0]),
        dtype=dtype,
        device=warped_xs.device,
    )
    iwes = splat_multi_ref(warped_xs, warped_ys, sensor_size)
    normalized_iwes = normalize_to_unit_range(iwes)

    corrs = -compute_mean_squared_error(edges, normalized_iwes)
    contrasts = compute_mean_gradient_magnitude(iwes)

    rel_corrs = (w * corrs) / (window_statics.zero_corrs + EPSN)
    rel_contrasts = (w * contrasts) / (window_statics.zero_contrast + EPSN)
    loss = params.alpha * (-rel_contrasts.mean()) + params.beta * (
        -rel_corrs.mean()
    )
    if params.delta != 0.0:
        divs = iwe_divergence(normalized_iwes)
        rel_divs = (w * divs) / (window_statics.zero_iwe_divergence + EPSN)
        loss = loss + params.delta * rel_divs.mean()
    return loss


def _masked_tv(
    scaled_theta: torch.Tensor, event_mask: torch.Tensor
) -> torch.Tensor:
    """Event-masked L1 total variation (reference regularizers.py:14-38)."""
    dtype = scaled_theta.dtype
    flow = scaled_theta * event_mask[..., None].to(dtype)
    gx = scharr_grads(flow[..., 0])
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
    return l1.sum() / (nz.sum().to(dtype) + EPSN)


def solver_loss(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    edges: torch.Tensor,
    edge_ts: torch.Tensor,
    params: LossParams,
    cur_pyr_lvl: int,
    statics: LossStatics,
    window_statics: WindowStatics,
) -> torch.Tensor:
    """The optimizer's loss of a coarse theta (h, w, 2) over one window.

    FWL is never computed; the IWE divergence is skipped when delta == 0
    and TV when gamma == 0 or above the finest pyramid level
    (src/eincm/losses.py:171).
    """
    sensor_size = statics.sensor_size
    xs, ys, ts = _sanitize_events(xs, ys, ts)
    if statics.scale_to_sensor_size_method == "bilinear":
        warped_xs, warped_ys = warp_events_multi_ref_coarse(
            theta, xs, ys, ts, edge_ts, sensor_size
        )
    else:
        scaled = scale_theta_to_sensor_size(
            theta, sensor_size, statics.scale_to_sensor_size_method
        )
        warped_xs, warped_ys = warp_events_multi_ref(
            scaled, xs, ys, ts, edge_ts, 1.0
        )

    loss = _solver_loss_tail(
        warped_xs, warped_ys, edges, params, window_statics, sensor_size
    )

    if params.gamma != 0.0 and cur_pyr_lvl <= 0:
        scaled = scale_theta_to_sensor_size(
            theta, sensor_size, statics.scale_to_sensor_size_method
        )
        tv = _masked_tv(scaled, window_statics.event_mask)
        loss = loss + params.gamma * tv
    return loss
