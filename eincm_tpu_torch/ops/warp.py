"""Per-event warping under a per-pixel velocity field ("theta").

Reference semantics (src/eincm/event_warpers.py:6-37): coordinates are
rounded, the velocity at that pixel is read, and the event is displaced
back in time to `t_ref`:

    x' = round(x) - theta[round(y), round(x), 0] * (t - t_ref) * delta_time
    y' = round(y) - theta[round(y), round(x), 1] * (t - t_ref) * delta_time

The per-event velocity is read once and reused for every reference time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eincm_tpu_torch.ops.interp import interp_theta_at_events


def _gather_index(c: torch.Tensor, n: int) -> torch.Tensor:
    r = torch.round(c)
    r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
    r = r.clamp(-(2**31), 2**31 - 1).long()
    r = torch.where(r < 0, r + n, r)
    return r.clamp(0, n - 1)


class _GatherTheta(torch.autograd.Function):
    """theta[round(y), round(x), :] with JAX's custom VJP
    (eincm_tpu/ops/warp.py:_gather_bwd): the cotangent of an event goes to
    the pixel its rounded coordinates name, and nowhere when they lie off
    the grid or are not finite, although the forward read a clamped pixel
    for it."""

    @staticmethod
    def forward(ctx, theta, xs, ys):
        h, w, _ = theta.shape
        ctx.save_for_backward(xs, ys)
        ctx.theta_shape = theta.shape
        return theta[_gather_index(ys, h), _gather_index(xs, w), :]

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.saved_tensors
        h, w, c = ctx.theta_shape
        xi, yi = torch.round(xs), torch.round(ys)
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
        flat = (torch.where(ok, yi, zero) * w + torch.where(ok, xi, zero)).long()
        d = torch.zeros((h * w, c), dtype=g.dtype, device=g.device)
        d.index_add_(0, flat, torch.where(ok[:, None], g, torch.zeros_like(g)))
        return d.reshape(h, w, c), None, None


def gather_theta_at_events(
    theta: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Per-event velocities theta[round(y), round(x), :] -> (E, 2).

    Indices follow JAX's gather: a negative index wraps once, then every
    index is clamped into range; a non-finite coordinate reads index 0.
    The gradient is JAX's: off-grid and non-finite events contribute none.
    """
    return _GatherTheta.apply(theta, xs, ys)


def per_pix_warp(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    t_ref,
    delta_time: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp events to one `t_ref` under a full-sensor theta (H, W, 2)
    (reference: src/eincm/event_warpers.py:6-37). Returns (E,) xs and ys."""
    th = gather_theta_at_events(theta, xs, ys)  # (E, 2)
    dts = (ts - t_ref) * delta_time
    return torch.round(xs) - th[:, 0] * dts, torch.round(ys) - th[:, 1] * dts


def warp_events_multi_ref_coarse(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    t_refs: torch.Tensor,
    sensor_size: Tuple[int, int],
    delta_time: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp events to several reference times under a COARSE theta.

    Equal to `warp_events_multi_ref(scale_theta_to_sensor_size(theta), ...)`
    for the 'bilinear' scaling method. Returns (n_refs, E) xs and ys.
    """
    th = interp_theta_at_events(theta, xs, ys, sensor_size)  # (E, 2)
    return _displace(th, xs, ys, ts, t_refs, delta_time)


def warp_events_multi_ref(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    t_refs: torch.Tensor,
    delta_time: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp events to several reference times under a full-sensor theta
    (H, W, 2). Returns (n_refs, E) xs and ys."""
    th = gather_theta_at_events(theta, xs, ys)  # (E, 2)
    return _displace(th, xs, ys, ts, t_refs, delta_time)


def _displace(th, xs, ys, ts, t_refs, delta_time):
    dts = (ts[None, :] - t_refs[:, None]) * delta_time  # (n_refs, E)
    warped_xs = torch.round(xs)[None, :] - th[None, :, 0] * dts
    warped_ys = torch.round(ys)[None, :] - th[None, :, 1] * dts
    return warped_xs, warped_ys
