"""Min-max normalization and tiling (reference: src/utils/img_utils.py:24-25,
105-120)."""

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


def extract_tiles(arr: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """Split a 2-D array into non-overlapping tiles in row-major order ->
    (n_tiles, tile_h, tile_w). Rows and columns that do not fill a whole
    tile are dropped, as the reference's integer-division tiling does."""
    h, w = arr.shape
    nh, nw = h // tile_h, w // tile_w
    tiles = arr[: nh * tile_h, : nw * tile_w].reshape(nh, tile_h, nw, tile_w)
    return tiles.permute(0, 2, 1, 3).reshape(nh * nw, tile_h, tile_w)
