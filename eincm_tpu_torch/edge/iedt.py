"""Inverse exponential distance transform (IEDT) of an edge map.

Carried over from eincm_tpu/edge/iedt.py (reference:
src/utils/img_utils.py:229-233) with scipy's exact Euclidean distance
transform; the native C++ transform is not carried over.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.ndimage import distance_transform_edt

EPSN = sys.float_info.epsilon


def _normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - arr.min()) / (arr.max() - arr.min() + EPSN)


def eincm_inv_exp_dist_transform(edge_img: np.ndarray, alpha: float = 6) -> np.ndarray:
    """1 - normalize(1 - exp(-EDT / alpha)): 1 on edges, decaying away."""
    edt = distance_transform_edt(~edge_img.astype(bool))
    exp_dt = 1.0 - np.exp(-edt / alpha)
    return 1.0 - _normalize(exp_dt)
