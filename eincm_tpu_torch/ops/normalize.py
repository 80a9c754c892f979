"""Min-max normalization (reference: src/utils/img_utils.py:24-25)."""

from __future__ import annotations

import sys

import torch

EPSN = sys.float_info.epsilon


def normalize_to_unit_range(arr: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each (H, W) image of `arr` (..., H, W) to [0, 1]
    with an epsilon-guarded denominator.

    `amin`/`amax` share the gradient evenly among tied extrema, as JAX's
    min/max reductions do.
    """
    lo = torch.amin(arr, dim=(-2, -1), keepdim=True)
    hi = torch.amax(arr, dim=(-2, -1), keepdim=True)
    return (arr - lo) / (hi - lo + EPSN)
