"""Fused warp + splat forward for one reference time (measurement vehicle).

Replaces the two TPU kernels of eincm_tpu/experimental/splat_fused.py
(`_fused_fwd_kernel` through `fused_warp_splat_frame`,
`_fully_fused_fwd_kernel` through `fully_fused_warp_splat_frame`) with the
CUDA kernels of `csrc/fused.cu`, and keeps their plain PyTorch versions
beside them.

The production path warps every event to every reference time in one step
(`ops/warp.py`) and splats the (n_refs, E) warped coordinates in another
(`ops/splat_kernel.py`), so the warped coordinates make a round trip
through device memory. Here they never leave the kernel:

- `fused_warp_splat_frame` takes the per-event velocities (thx, thy) from
  the production interp and warps inside the splat;
- `fully_fused_warp_splat_frame` also samples the coarse theta inside the
  kernel, with the production interp's taps, at (xi, yi) as given.

Per event cx = xi - thx * (ts - t_ref), cy likewise, then the
(2 hw + 1)^2 Gaussian taps around (round(cx), round(cy)), hw =
window_size // 2 (window_size 3 or 5), with the production splat's drop
semantics. xi and yi
are used as given, not rounded: callers pass rounded coordinates.

Both return `(frame (H, W), ok)`. On the TPU `ok` said whether the row
bands of sorted events covered every event (a frame with `ok` False had
lost mass). The port scatters with atomics and has no bands, so every
frame is complete, in any event order, and `ok` is a 0-d True tensor on
the frame's device. The TPU versions' `b` (band height) and `interpret`
arguments only shaped that band tiling and are dropped.

Forward only; nothing in the solver or the loss calls these. Dispatch: CPU
tensors take the plain version; CUDA tensors launch the kernel, and
anything it does not take raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda_f32
from eincm_tpu_torch.ops.interp import _scales, interp_theta_at_events_plain
from eincm_tpu_torch.ops.splat_kernel import splat_plain

WINDOW_SIZES = (3, 5)  # the kernels are built for these


def _half_window(window_size: int) -> int:
    if int(window_size) not in WINDOW_SIZES:
        raise ValueError(f"window_size {window_size}: must be one of {WINDOW_SIZES}")
    return int(window_size) // 2


def _f32(t_ref) -> float:
    return float(np.float32(float(t_ref)))


def _ok(frame: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=frame.device)


def _warp_splat_plain(xi, yi, ts, thx, thy, t_ref, sensor_size, window_size):
    dt = ts - t_ref
    cx = xi - thx * dt
    cy = yi - thy * dt
    return splat_plain(cx[None], cy[None], sensor_size, window_size)[0]


def fused_warp_splat_frame_plain(
    xi, yi, ts, thx, thy, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """The plain version of kernel 7: the displacement as two torch ops,
    then the (2 hw + 1)-tap plain splat. Returns the (H, W) frame."""
    _half_window(window_size)
    return _warp_splat_plain(
        xi, yi, ts, thx, thy, _f32(t_ref), sensor_size, window_size
    )


def fully_fused_warp_splat_frame_plain(
    xi, yi, ts, theta, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """The plain version of kernel 8: the production interp's plain version
    at (xi, yi) as given, then kernel 7's plain version."""
    _half_window(window_size)
    th = interp_theta_at_events_plain(theta, xi, yi, sensor_size, round_coords=False)
    return _warp_splat_plain(
        xi, yi, ts, th[:, 0], th[:, 1], _f32(t_ref), sensor_size, window_size
    )


def fused_warp_splat_cuda(
    xi, yi, ts, thx, thy, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """Launch kernel 7: (E,) xi, yi, ts, thx, thy -> (H, W) frame."""
    hw = _half_window(window_size)
    e = xi.shape[0]
    check_cuda_f32("fused_warp_splat", (xi, yi, ts, thx, thy), [(e,)] * 5)
    H, W = sensor_size
    frame = torch.zeros((H, W), dtype=torch.float32, device=xi.device)
    if e:
        with torch.cuda.device(xi.device):
            KERNELS["fused_warp_splat"](
                xi.data_ptr(), yi.data_ptr(), ts.data_ptr(), thx.data_ptr(),
                thy.data_ptr(), frame.data_ptr(), e, _f32(t_ref), H, W, hw,
                torch.cuda.current_stream().cuda_stream,
            )
    return frame


def fully_fused_warp_splat_cuda(
    xi, yi, ts, theta, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """Launch kernel 8: (E,) xi, yi, ts and (h, w, 2) theta -> (H, W)."""
    hw = _half_window(window_size)
    e = xi.shape[0]
    h, w, _ = theta.shape
    check_cuda_f32(
        "fully_fused_warp_splat", (xi, yi, ts, theta), [(e,)] * 3 + [(h, w, 2)]
    )
    sy, sx = _scales(h, w, sensor_size)
    H, W = sensor_size
    frame = torch.zeros((H, W), dtype=torch.float32, device=xi.device)
    if e:
        with torch.cuda.device(xi.device):
            KERNELS["fully_fused_warp_splat"](
                xi.data_ptr(), yi.data_ptr(), ts.data_ptr(), theta.data_ptr(),
                frame.data_ptr(), e, _f32(t_ref), H, W, hw, h, w, sy, sx,
                torch.cuda.current_stream().cuda_stream,
            )
    return frame


def fused_warp_splat_frame(
    xi: torch.Tensor,
    yi: torch.Tensor,
    ts: torch.Tensor,
    thx: torch.Tensor,
    thy: torch.Tensor,
    t_ref,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward IWE for ONE reference time, warped inside the splat.

    Args:
        xi, yi: rounded event coordinates (float).
        ts: event timestamps.
        thx, thy: per-event velocities (from `interp_theta_at_events`).
        t_ref: scalar reference time (rounded to float32).

    Returns:
        (frame (H, W), ok): `ok` is always True (see the module docstring).
    """
    if all(t.device.type == "cpu" for t in (xi, yi, ts, thx, thy)):
        frame = fused_warp_splat_frame_plain(
            xi, yi, ts, thx, thy, t_ref, sensor_size, window_size
        )
    else:
        frame = fused_warp_splat_cuda(
            xi, yi, ts, thx, thy, t_ref, sensor_size, window_size
        )
    return frame, _ok(frame)


def fully_fused_warp_splat_frame(
    xi: torch.Tensor,
    yi: torch.Tensor,
    ts: torch.Tensor,
    theta: torch.Tensor,
    t_ref,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward IWE for ONE reference time with the coarse-theta interp, the
    warp and the splat in one kernel: neither per-event velocities nor
    warped coordinates exist in device memory.

    Returns (frame (H, W), ok): `ok` is always True (module docstring).
    """
    if all(t.device.type == "cpu" for t in (xi, yi, ts, theta)):
        frame = fully_fused_warp_splat_frame_plain(
            xi, yi, ts, theta, t_ref, sensor_size, window_size
        )
    else:
        frame = fully_fused_warp_splat_cuda(
            xi, yi, ts, theta, t_ref, sensor_size, window_size
        )
    return frame, _ok(frame)
