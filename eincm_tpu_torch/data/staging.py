"""Datasample staging: raw loader dict -> fixed-shape window on a device.

Port of the solver half of eincm_tpu/data/staging.py (reference:
src/experiments/e00/exp_mgr.py:278-376): timestamps normalized to the eval
span, per-frame edge extraction, and padding of the events to a fixed
count with NaN (padding contributes nothing to any splat or mask). The
port's splat scatters with atomics, so events need no row or tile order.
The host-side evaluation data (eval-event subset, GT flow) comes with the
EVAL slice.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from eincm_tpu_torch.edge.pipeline import extract_edges
from eincm_tpu_torch.models.pyramid import WindowSample

EPSN = sys.float_info.epsilon


def stage_datasample(
    datasample: Dict,
    device,
    edge_fn: Optional[Callable] = None,
    pad_to: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> WindowSample:
    """Stage one raw loader sample onto `device`.

    Args:
        datasample: loader dict ('events', 'images', 'image_ts', and
            'eval_ts' or 'eval_ts_us').
        device: where the window's tensors go.
        edge_fn: images -> (n_imgs, H, W) edge maps; defaults to Canny with
            Gaussian smoothing, no preprocessing.
        pad_to: pad events to this fixed count with NaNs.
    """
    ev = datasample["events"]
    xs = np.asarray(ev["x"], np.float64)
    ys = np.asarray(ev["y"], np.float64)
    ts = np.asarray(ev["t"], np.float64)
    images = np.asarray(datasample["images"], np.float64)
    image_ts = np.asarray(datasample["image_ts"], np.float64)
    key = "eval_ts_us" if "eval_ts_us" in datasample else "eval_ts"
    start_time, end_time = np.asarray(datasample[key], np.float64)

    # normalize all timestamps to the eval span (exp_mgr.py:321-327)
    span = end_time - start_time + EPSN
    ts_n = (ts - start_time) / span
    image_ts_n = (image_ts - start_time) / span

    if edge_fn is None:
        edge_fn = lambda ims: extract_edges(ims, preprocess=False)
    edges = edge_fn(images)

    if pad_to is not None and len(xs) < pad_to:
        fill = np.full(pad_to - len(xs), np.nan)
        xs = np.concatenate([xs, fill])
        ys = np.concatenate([ys, fill])
        ts_n = np.concatenate([ts_n, fill])

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return WindowSample(
        xs=up(xs), ys=up(ys), ts=up(ts_n), edges=up(edges), edge_ts=up(image_ts_n)
    )
