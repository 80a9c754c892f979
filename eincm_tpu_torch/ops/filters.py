"""3x3 image filters (Scharr gradients, blur, divergence) as shift-and-add stencils.

The reference applies 3x3 kernels as a true convolution with zero padding
(src/utils/img_utils.py:414-432). As in eincm_tpu/ops/filters.py, each
filter is 9 shifted slices of the zero-padded image, scaled and summed in a
fixed order: exact elementwise f32/f64 arithmetic, with no convolution
library in the loss (cuDNN would run it in TF32 by default on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Scharr-optimized Sobel kernels (reference: src/utils/img_utils.py:417-418).
SCHARR_GX = np.array(
    [[3.0, 0.0, -3.0], [10.0, 0.0, -10.0], [3.0, 0.0, -3.0]]
)
SCHARR_GY = np.array(
    [[3.0, 10.0, 3.0], [0.0, 0.0, 0.0], [-3.0, -10.0, -3.0]]
)
# Divergence kernel (reference: src/eincm/regularizers.py:50).
DIV_KERNEL = np.array(
    [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]]
)
# 3x3 binomial blur (reference: src/utils/img_utils.py:430).
BLUR_KERNEL = np.array(
    [[1 / 16, 1 / 8, 1 / 16], [1 / 8, 1 / 4, 1 / 8], [1 / 16, 1 / 8, 1 / 16]]
)
_EPSN = float(np.finfo(np.float64).eps)


def _conv2d_same(image: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """True 2-D convolution of (..., H, W) images with K 3x3 kernels,
    zero-padded SAME -> (K, ..., H, W).

    The kernel flip of a convolution happens on the numpy constant; terms
    are added in the same order as eincm_tpu/ops/filters.py:_conv2d_same.
    """
    h, w = image.shape[-2:]
    p = F.pad(image, (1, 1, 1, 1))
    flipped = kernels[:, ::-1, ::-1]
    outs = []
    for k in flipped:
        acc = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                c = float(k[dy + 1, dx + 1])
                if c == 0.0:
                    continue
                term = c * p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
                acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else torch.zeros_like(image))
    return torch.stack(outs)


def scharr_grads(image: torch.Tensor) -> torch.Tensor:
    """Scharr image gradients of (..., H, W), stacked (..., H, W, 2) =
    (I_x, I_y). Reference: src/utils/img_utils.py:414-425."""
    g = _conv2d_same(image, np.stack([SCHARR_GX, SCHARR_GY]))
    return torch.movedim(g, 0, -1)


def gaussian_blur_3x3(image: torch.Tensor) -> torch.Tensor:
    """3x3 binomial blur of (..., H, W). Reference:
    src/utils/img_utils.py:428-432."""
    return _conv2d_same(image, BLUR_KERNEL[None])[0]


def divergence_filter(field: torch.Tensor) -> torch.Tensor:
    """Apply the divergence kernel to (..., H, W) fields (SAME padding)."""
    return _conv2d_same(field, DIV_KERNEL[None])[0]


def gradient_magnitude(image: torch.Tensor) -> torch.Tensor:
    """Scharr gradient magnitude of each (H, W) image of (..., H, W),
    min-max normalized to [0, 1]. Reference: src/utils/img_utils.py:435-449."""
    g = scharr_grads(image)
    mag = torch.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2)
    lo = torch.amin(mag, dim=(-2, -1), keepdim=True)
    hi = torch.amax(mag, dim=(-2, -1), keepdim=True)
    return (mag - lo) / (hi - lo + _EPSN)
