"""Image-of-Warped-Events (IWE) accumulation and event masks.

Reference: src/utils/event_utils.py:13-77. The splat itself lives in
`ops/splat_kernel.py` (the CUDA kernels and their plain version); this
module is the router the loss calls, plus the plain event counts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eincm_tpu_torch.ops.splat_kernel import _SplatCuda, splat_plain


def splat_multi_ref(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """(n_refs, E) warped coordinates -> (n_refs, H, W) IWEs, every ref in
    one launch. CPU tensors take the plain version; CUDA tensors the
    kernels."""
    if warped_xs.device.type == "cpu" and warped_ys.device.type == "cpu":
        return splat_plain(warped_xs, warped_ys, sensor_size)
    return _SplatCuda.apply(warped_xs, warped_ys, tuple(sensor_size))


def events_to_pdf_frame(
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int] = (260, 346),
) -> torch.Tensor:
    """(E,) warped coordinates (x = column, y = row) -> (H, W) IWE: a 3x3
    window of 2-D standard normal pdf values around each rounded
    coordinate, out-of-sensor texels dropped on every side."""
    return splat_multi_ref(xs[None], ys[None], sensor_size)[0]


def events_to_pdf_frame_scatter(
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int] = (260, 346),
) -> torch.Tensor:
    """IWE by scatter-add on any device: the numerical oracle."""
    return splat_plain(xs[None], ys[None], sensor_size)[0]


def event_counts(
    xs: torch.Tensor, ys: torch.Tensor, sensor_size: Tuple[int, int]
) -> torch.Tensor:
    """(H, W) float32 per-pixel event counts. Coordinates are truncated
    toward zero like the reference's `.astype(jnp.int16)`
    (src/utils/event_utils.py:76); off-sensor and non-finite events are
    not counted."""
    H, W = sensor_size
    xi = torch.trunc(xs.to(torch.float32))
    yi = torch.trunc(ys.to(torch.float32))
    ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
    zero = torch.zeros((), dtype=torch.float32, device=xs.device)
    flat = (torch.where(ok, yi, zero) * W + torch.where(ok, xi, zero)).long()
    counts = torch.zeros(H * W, dtype=torch.float32, device=xs.device)
    counts.index_put_((flat,), ok.to(torch.float32), accumulate=True)
    return counts.reshape(H, W)


def make_event_mask(
    xs: torch.Tensor, ys: torch.Tensor, sensor_size: Tuple[int, int]
) -> torch.Tensor:
    """Boolean (H, W) mask of pixels with at least one event
    (reference: src/utils/event_utils.py:64-77)."""
    return event_counts(xs, ys, sensor_size) > 0
