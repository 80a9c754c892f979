"""Datasample staging: raw loader dict -> fixed-shape window on a device.

Port of eincm_tpu/data/staging.py (reference:
src/experiments/e00/exp_mgr.py:278-376): timestamps normalized to the eval
span, the eval-consistent event subset when the optimization window was
padded beyond the eval span, per-frame edge extraction, and padding of the
events to a fixed count with NaN (padding contributes nothing to any
splat or mask). The solver's inputs go to the device; the evaluation data
stays on the host. The port's splat scatters with atomics, so events need
no row or tile order.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from eincm_tpu_torch.edge.pipeline import extract_edges
from eincm_tpu_torch.models.pyramid import WindowSample

EPSN = sys.float_info.epsilon


class StagedSample(NamedTuple):
    """A window on its device plus host-side evaluation data."""

    window: WindowSample  # solver inputs (normalized times, edges)
    images: np.ndarray  # (n_imgs, H, W) float64, min-max normalized
    eval_events: Dict[str, np.ndarray]  # eval-consistent event subset
    gt_flow: Optional[np.ndarray]  # (H, W, 2) or None
    polarities: np.ndarray  # (E,) bool, padded with False like the events
    t_ref: float
    eval_ts: tuple  # (start, end) raw units
    eval_ts_units: str  # 'us' or 's'
    file_idx: Optional[int]
    n_event_deficiency: int


def _normalize_img(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    return (img - img.min()) / (img.max() - img.min() + EPSN)


def stage_datasample(
    datasample: Dict,
    device,
    edge_fn: Optional[Callable] = None,
    preprocess: bool = True,
    pad_to: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> StagedSample:
    """Stage one raw loader sample, its window onto `device`.

    Args:
        datasample: loader dict ('events' with 'x', 'y', 't', 'p';
            'images', 'image_ts', 'eval_ts' or 'eval_ts_us', and optionally
            'flow_gt', 'file_idx', 'n_event_deficiency').
        device: where the window's tensors go.
        edge_fn: images -> (n_imgs, H, W) edge maps; defaults to Canny with
            Gaussian smoothing.
        preprocess: the default edge function's frame preprocessing
            (NL-means, CLAHE, sharpening, bilateral), on by default as in
            the JAX package.
        pad_to: pad events to this fixed count with NaNs.
    """
    ev = datasample["events"]
    xs = np.asarray(ev["x"], np.float64)
    ys = np.asarray(ev["y"], np.float64)
    ts = np.asarray(ev["t"], np.float64)
    ps = np.asarray(ev["p"], bool)
    images = np.asarray(datasample["images"], np.float64)
    image_ts = np.asarray(datasample["image_ts"], np.float64)
    ts_units = "us" if "eval_ts_us" in datasample else "s"
    start_time, end_time = np.asarray(
        datasample["eval_ts_us" if ts_units == "us" else "eval_ts"], np.float64
    )
    gt_flow = datasample.get("flow_gt")
    gt_flow = None if gt_flow is None else np.asarray(gt_flow, np.float64)
    file_idx = datasample.get("file_idx")
    deficiency = int(datasample.get("n_event_deficiency") or 0)

    # eval-consistent event subset (exp_mgr.py:301-315): when the window was
    # padded (deficiency > 0) the eval set is the interior [start, end] span
    if deficiency > 0:
        i0, i1 = np.searchsorted(ts, [start_time, end_time])
        sl = slice(max(0, i0 + 1), min(len(xs), i1 - 1))
    else:
        sl = slice(None)
    eval_events = {"x": xs[sl], "y": ys[sl], "t": ts[sl], "p": ps[sl]}

    # normalize all timestamps to the eval span (exp_mgr.py:321-327)
    span = end_time - start_time + EPSN
    ts_n = (ts - start_time) / span
    image_ts_n = (image_ts - start_time) / span
    eval_events["t"] = (eval_events["t"] - start_time) / span

    images_pp = np.stack([_normalize_img(im) for im in images])
    if edge_fn is None:
        edge_fn = lambda ims: extract_edges(ims, preprocess=preprocess)
    edges = edge_fn(images)

    if pad_to is not None and len(xs) < pad_to:
        pad = pad_to - len(xs)
        fill = np.full(pad, np.nan)
        xs = np.concatenate([xs, fill])
        ys = np.concatenate([ys, fill])
        ts_n = np.concatenate([ts_n, fill])
        ps = np.concatenate([ps, np.zeros(pad, bool)])

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return StagedSample(
        window=WindowSample(
            xs=up(xs), ys=up(ys), ts=up(ts_n), edges=up(edges), edge_ts=up(image_ts_n)
        ),
        images=images_pp,
        eval_events=eval_events,
        gt_flow=gt_flow,
        polarities=ps,
        t_ref=0.0,
        eval_ts=(float(start_time), float(end_time)),
        eval_ts_units=ts_units,
        file_idx=None if file_idx is None else int(file_idx),
        n_event_deficiency=deficiency,
    )
