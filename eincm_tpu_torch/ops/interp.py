"""Per-event bilinear sample of the coarse theta grid -> (E, 2).

Replaces the TPU kernels of eincm_tpu/ops/interp_pallas.py (`_fwd_kernel`
through `_interp_fwd`, `_bwd_kernel` through `_interp_bwd`) with the CUDA
kernels of `csrc/interp.cu`, and keeps their plain PyTorch version beside
them.

The sample reads the *unwarped, rounded* event coordinates (round half to
even) and follows `scale_and_translate(method='bilinear')`: pixel centre
`c` maps to `u = (c + 0.5) * n / N - 0.5` on an axis of n coarse cells,
with triangle weights `max(0, 1 - |k - u|)` at the two cells around `u`,
masked to [0, n) and divided by `max(sum, 1e-20)`. An event far off the
sensor (the -1e4 padding sentinel) therefore samples exactly 0. Gradients
flow to theta only; the coordinates enter through round() and get no
cotangent.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda_f32

MAX_GRID = 128  # the kernel gate of eincm_tpu/ops/warp.py:interp_theta_at_events


def _axis_taps(coord: torch.Tensor, n: int, full_n: int):
    """Two taps per event along one axis: (index0, index1, w0, w1).

    Indices are clamped for safe gathers; a clamped tap carries weight 0.
    A NaN coordinate gives NaN weights, as the reference's do.
    """
    u = (torch.round(coord) + 0.5) * (n / full_n) - 0.5
    k0 = torch.floor(u)
    k1 = k0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(k0 - u), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(k1 - u), 0.0)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    w0 = torch.where((k0 >= 0) & (k0 < n), w0, zero)
    w1 = torch.where((k1 >= 0) & (k1 < n), w1, zero)
    s = torch.clamp_min(w0 + w1, 1e-20)
    nan = torch.isnan(u)
    w0 = torch.where(nan, u, w0 / s)
    w1 = torch.where(nan, u, w1 / s)
    k0 = torch.where(torch.isfinite(k0), k0, zero).clamp(-1, n).long()
    return k0.clamp(0, n - 1), (k0 + 1).clamp(0, n - 1), w0, w1


def interp_theta_at_events_plain(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """The plain version: four gathered taps, rows summed first, then
    columns, as the reference contracts them. Differentiable by autograd."""
    h, w, _ = theta.shape
    H, W = sensor_size
    y0, y1, uy0, uy1 = _axis_taps(ys.to(theta.dtype), h, H)
    x0, x1, vx0, vx1 = _axis_taps(xs.to(theta.dtype), w, W)
    uy0, uy1 = uy0[:, None], uy1[:, None]
    m0 = uy0 * theta[y0, x0] + uy1 * theta[y1, x0]
    m1 = uy0 * theta[y0, x1] + uy1 * theta[y1, x1]
    return m0 * vx0[:, None] + m1 * vx1[:, None]


def _scales(h, w, sensor_size):
    H, W = sensor_size
    if not (1 <= h <= MAX_GRID and 1 <= w <= MAX_GRID):
        raise ValueError(f"interp kernel takes h, w <= {MAX_GRID}, got {h}x{w}")
    return float(h) / H, float(w) / W


def interp_fwd_cuda(theta, xs, ys, sensor_size) -> torch.Tensor:
    """Launch the forward kernel: (h, w, 2) theta, (E,) coords -> (E, 2)."""
    h, w, c = theta.shape
    e = xs.shape[0]
    check_cuda_f32("interp_fwd", (theta, xs, ys), ((h, w, 2), (e,), (e,)))
    sy, sx = _scales(h, w, sensor_size)
    out = torch.empty((e, 2), dtype=torch.float32, device=theta.device)
    if e:
        with torch.cuda.device(theta.device):
            KERNELS["interp_fwd"](
                theta.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                e, h, w, sy, sx, torch.cuda.current_stream().cuda_stream,
            )
    return out


def interp_bwd_cuda(g, xs, ys, theta_shape, sensor_size) -> torch.Tensor:
    """Launch the backward kernel: (E, 2) cotangent -> (h, w, 2) dtheta."""
    h, w, _ = theta_shape
    e = xs.shape[0]
    check_cuda_f32("interp_bwd", (g, xs, ys), ((e, 2), (e,), (e,)))
    sy, sx = _scales(h, w, sensor_size)
    dtheta = torch.zeros((h, w, 2), dtype=torch.float32, device=g.device)
    if e:
        with torch.cuda.device(g.device):
            KERNELS["interp_bwd"](
                g.data_ptr(), xs.data_ptr(), ys.data_ptr(), dtheta.data_ptr(),
                e, h, w, sy, sx, torch.cuda.current_stream().cuda_stream,
            )
    return dtheta


class _InterpCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, xs, ys, sensor_size):
        ctx.save_for_backward(xs, ys)
        ctx.theta_shape = tuple(theta.shape)
        ctx.sensor_size = sensor_size
        return interp_fwd_cuda(theta, xs, ys, sensor_size)

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.saved_tensors
        dtheta = interp_bwd_cuda(
            g.contiguous(), xs, ys, ctx.theta_shape, ctx.sensor_size
        )
        return dtheta, None, None, None


def interp_theta_at_events(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """Per-event velocity sampled from the coarse (h, w, 2) theta -> (E, 2).

    Equal to gathering `scale_theta_to_sensor_size(theta, S, 'bilinear')`
    at the rounded event coordinates, without the full-sensor field.
    """
    if all(t.device.type == "cpu" for t in (theta, xs, ys)):
        return interp_theta_at_events_plain(theta, xs, ys, sensor_size)
    return _InterpCuda.apply(theta, xs, ys, tuple(sensor_size))
