"""Image-of-Warped-Events (IWE) accumulation and event masks.

Reference: src/utils/event_utils.py:13-77. The splat itself lives in
`ops/splat_kernel.py` (the CUDA kernels and their plain version); this
module is the router the loss calls, plus the plain event counts.

Routing: CPU tensors take the plain version. On the card, float64
coordinates, every call while the wrap-compat switch is on and a window
size the slab kernels are not built for (`WINDOW_SIZES`: 3 and 5) launch
the direct kernels (`csrc/direct.cu`: float32 or float64, any window of
1 or more, with 2 (w // 2) + 1 taps a side as in the JAX package, which
keeps float64 and wrapped calls off its Pallas kernels the same way,
eincm_tpu/ops/splat.py:173-177, :347-352); every other CUDA tensor
launches the slab and stream kernels. Whatever a kernel does not take
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eincm_tpu_torch.ops.splat_kernel import (
    WINDOW_SIZES, _SplatCuda, _SplatDirect, splat_plain,
)

# Opt-in reproduction of the reference's negative-index wrap (splat mass at
# coordinate -k lands on the opposite sensor edge; src/utils/event_utils.py:
# 59): eincm_tpu/ops/splat.py:set_splat_wrap_compat. For parity studies
# only; dropping out-of-sensor texels is the physical behaviour.
_SPLAT_WRAP_COMPAT = False


def set_splat_wrap_compat(enable: bool) -> None:
    """Toggle the wrap-compat splat (read at every call)."""
    global _SPLAT_WRAP_COMPAT
    _SPLAT_WRAP_COMPAT = bool(enable)


def splat_multi_ref(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> torch.Tensor:
    """(n_refs, E) warped coordinates -> (n_refs, H, W) IWEs, every ref in
    one launch. CPU tensors take the plain version; on the card, float64
    coordinates (the condition is warped_xs's dtype), the wrap-compat
    switch and a window other than 3 and 5 take the direct kernels, and
    float32 at windows 3 and 5 the slab kernels."""
    if warped_xs.device.type == "cpu" and warped_ys.device.type == "cpu":
        return splat_plain(
            warped_xs, warped_ys, sensor_size, window_size, wrap=_SPLAT_WRAP_COMPAT
        )
    if (_SPLAT_WRAP_COMPAT or warped_xs.dtype == torch.float64
            or int(window_size) not in WINDOW_SIZES):
        return _SplatDirect.apply(warped_xs, warped_ys, tuple(sensor_size), window_size,
                                  _SPLAT_WRAP_COMPAT)
    return _SplatCuda.apply(warped_xs, warped_ys, tuple(sensor_size), window_size)


def events_to_pdf_frame(
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int] = (260, 346),
    window_size: int = 3,
    chunk_size: int | None = None,
) -> torch.Tensor:
    """(E,) warped coordinates (x = column, y = row) -> (H, W) IWE: a
    `window_size` x `window_size` window of 2-D standard normal pdf values
    around each rounded coordinate, out-of-sensor texels dropped on every
    side. `chunk_size` is the JAX signature's (its matrix products' events
    per step); the port does not chunk and ignores it."""
    return splat_multi_ref(xs[None], ys[None], sensor_size, window_size)[0]


def events_to_pdf_frame_scatter(
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int] = (260, 346),
    window_size: int = 3,
) -> torch.Tensor:
    """IWE by scatter-add on any device: the numerical oracle. It drops
    out-of-sensor texels on every side, wrap-compat or not, as JAX's
    oracle does."""
    return splat_plain(xs[None], ys[None], sensor_size, window_size)[0]


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
