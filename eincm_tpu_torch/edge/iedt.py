"""Inverse exponential distance transforms (IEDT) of edge maps.

Carried over from eincm_tpu/edge/iedt.py. The exact Euclidean distance
transform is the native C++ one (Meijster) where the library is built, as
in the JAX package, and scipy's otherwise (the EDT is unique):
- `eincm_inv_exp_dist_transform` (src/utils/img_utils.py:229-233):
  exponential saturation of the EDT, then inverted unit-range
  normalization.
- `rtef_iedt` (src/utils/img_utils.py:236-410): the RTEF distance-surface
  formulations (linear / linear-bound / logarithmic / exponential) on the
  EDT, normalized, inverted.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.ndimage import distance_transform_edt

from eincm_tpu_torch.native import vision as _native

EPSN = sys.float_info.epsilon


def _exact_edt(not_edge: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance to the nearest edge pixel."""
    if _native.available():
        return _native.exact_edt(~not_edge)
    return distance_transform_edt(not_edge)


def _normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - arr.min()) / (arr.max() - arr.min() + EPSN)


def eincm_inv_exp_dist_transform(edge_img: np.ndarray, alpha: float = 6) -> np.ndarray:
    """1 - normalize(1 - exp(-EDT / alpha)): 1 on edges, decaying away."""
    edt = _exact_edt(~edge_img.astype(bool))
    exp_dt = 1.0 - np.exp(-edt / alpha)
    return 1.0 - _normalize(exp_dt)


def rtef_iedt(
    edge_img: np.ndarray,
    dist_surf_saturation_distance: float | None = None,
    alpha: float | None = None,
    formulation: str = "exponential",
) -> np.ndarray:
    """RTEF-style inverse distance surface of a binary edge image.

    Args:
        dist_surf_saturation_distance: saturation distance d_sat (default 6).
        alpha: exponential decay constant (default d_sat / 5.541).
        formulation: 'linear' | 'linear-bound' | 'logarithmic' | 'exponential'.
    """
    assert edge_img.ndim == 2, "need a 2-D binary edge image"
    vals = np.unique(edge_img.astype(int))
    assert len(vals) <= 2 and 0 in vals, "need a 2-D binary edge image"

    d_sat = (
        dist_surf_saturation_distance
        if dist_surf_saturation_distance is not None
        else 6.0
    )
    a = alpha if alpha is not None else d_sat / 5.541

    surf = _exact_edt(~edge_img.astype(bool)).astype(np.float64)
    if formulation == "linear":
        pass
    elif formulation == "linear-bound":
        surf = np.minimum(surf, d_sat)
    elif formulation == "logarithmic":
        surf = np.log(surf + 1.0)
    elif formulation == "exponential":
        surf = 1.0 - np.exp(-surf / a)
    else:
        raise NotImplementedError(f"formulation {formulation!r}")

    return 1.0 - _normalize(surf)


def rtef_inv_exp_dist_transform(
    edge_img: np.ndarray,
    dist_surf_saturation_distance: float | None = None,
    alpha_iedt: float | None = None,
    formulation: str = "exponential",
) -> np.ndarray:
    """Signature-compatible wrapper (reference: img_utils.py:223-226)."""
    return rtef_iedt(edge_img, dist_surf_saturation_distance, alpha_iedt, formulation)
