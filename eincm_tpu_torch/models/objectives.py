"""The objectives the solver loss uses: contrast, correlation, collapse.

Ports of src/eincm/objectives/contrast_objectives.py:13-26,
correlation_objectives.py:12-27 and event_collapse_objectives.py:8-19.
Each reduces over the last two (H, W) dims, so a leading batch of
reference frames is handled in one call.
"""

from __future__ import annotations

import torch

from eincm_tpu_torch.ops.filters import divergence_filter, scharr_grads


def compute_mean_gradient_magnitude(arr: torch.Tensor) -> torch.Tensor:
    """Mean squared Scharr gradient magnitude (no sqrt) of (..., H, W)."""
    g = scharr_grads(arr)
    return (g[..., 0] ** 2 + g[..., 1] ** 2).mean(dim=(-2, -1))


def compute_mean_squared_error(
    arr_1: torch.Tensor, arr_2: torch.Tensor
) -> torch.Tensor:
    return ((arr_1 - arr_2) ** 2).mean(dim=(-2, -1))


def iwe_divergence(iwe: torch.Tensor) -> torch.Tensor:
    """Mean |divergence| of the IWE gradient field (anti-collapse)."""
    g = scharr_grads(iwe)  # (..., H, W, 2)
    div_x = divergence_filter(g[..., 0])
    div_y = divergence_filter(g[..., 1])
    return torch.abs(div_x + div_y).mean(dim=(-2, -1))
