"""The IWE splat of all reference times at once: (R, E) warped coordinates
-> (R, H, W) frames, and its coordinate gradient.

Replaces the TPU kernels of eincm_tpu/ops/splat_pallas.py (`_splat_kernel`,
`_bwd_kernel`) and eincm_tpu/ops/splat_banded.py (`_fwd_kernel`,
`_bwd_kernel`) with the two CUDA kernels of `csrc/splat.cu`, and keeps
their plain PyTorch version beside them.

Each event deposits the 3x3 window of separable standard-normal pdf values
`g(i - y) g(j - x)`, `g(q) = exp(-q^2 / 2) / sqrt(2 pi)`, around its
rounded (half to even) coordinate. Texels outside the sensor are dropped on
every side; an event whose coordinate is NaN or infinite, or whose window
misses the sensor (the -1e4 padding sentinel, a far line-search probe),
deposits nothing and gets a zero gradient.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernels, and anything they do not take raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda_f32

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gauss1d(q: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * q * q) * _INV_SQRT_2PI


def splat_plain(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """The plain version: a 9-tap `index_put(accumulate=True)` into the
    flattened frames, differentiated by autograd. Also the scatter oracle."""
    R, E = warped_xs.shape
    H, W = sensor_size
    dtype = torch.promote_types(warped_xs.dtype, torch.float32)
    wx, wy = warped_xs.to(dtype), warped_ys.to(dtype)
    dev = wx.device
    d = torch.tensor([-1.0, 0.0, 1.0], dtype=dtype, device=dev)
    rows = torch.round(wy)[..., None] + d  # (R, E, 3)
    cols = torch.round(wx)[..., None] + d
    # NaN and +-inf fail these comparisons: such taps are dropped
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # substitute before the pdf so dropped taps have finite zero gradients
    qy = torch.where(vr, rows - wy[..., None], zero)
    qx = torch.where(vc, cols - wx[..., None], zero)
    gy = torch.where(vr, _gauss1d(qy), zero)
    gx = torch.where(vc, _gauss1d(qx), zero)
    vals = gy[..., :, None] * gx[..., None, :]  # (R, E, 3, 3)
    ri = torch.where(vr, rows, zero).long()
    ci = torch.where(vc, cols, zero).long()
    ref = torch.arange(R, device=dev)[:, None, None, None]
    flat = (ref * H + ri[..., :, None]) * W + ci[..., None, :]
    frames = torch.zeros(R * H * W, dtype=dtype, device=dev)
    frames = frames.index_put((flat.reshape(-1),), vals.reshape(-1), accumulate=True)
    return frames.reshape(R, H, W)


def splat_fwd_cuda(warped_xs, warped_ys, sensor_size) -> torch.Tensor:
    """Launch the forward kernel: (R, E) coordinates -> (R, H, W) frames."""
    R, E = warped_xs.shape
    H, W = sensor_size
    check_cuda_f32("splat_fwd", (warped_xs, warped_ys), ((R, E), (R, E)))
    frames = torch.zeros((R, H, W), dtype=torch.float32, device=warped_xs.device)
    if R * E:
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_fwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(), frames.data_ptr(),
                R, E, H, W, torch.cuda.current_stream().cuda_stream,
            )
    return frames


def splat_bwd_cuda(warped_xs, warped_ys, grad_frames, sensor_size):
    """Launch the backward kernel: (R, H, W) cotangent -> (dwx, dwy), each
    (R, E)."""
    R, E = warped_xs.shape
    H, W = sensor_size
    check_cuda_f32(
        "splat_bwd",
        (warped_xs, warped_ys, grad_frames),
        ((R, E), (R, E), (R, H, W)),
    )
    dwx = torch.empty_like(warped_xs)
    dwy = torch.empty_like(warped_ys)
    if R * E:
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_bwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(),
                grad_frames.data_ptr(), dwx.data_ptr(), dwy.data_ptr(),
                R, E, H, W, torch.cuda.current_stream().cuda_stream,
            )
    return dwx, dwy


class _SplatCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped_xs, warped_ys, sensor_size):
        ctx.save_for_backward(warped_xs, warped_ys)
        ctx.sensor_size = sensor_size
        return splat_fwd_cuda(warped_xs, warped_ys, sensor_size)

    @staticmethod
    def backward(ctx, grad_frames):
        wx, wy = ctx.saved_tensors
        dwx, dwy = splat_bwd_cuda(wx, wy, grad_frames.contiguous(), ctx.sensor_size)
        return dwx, dwy, None

