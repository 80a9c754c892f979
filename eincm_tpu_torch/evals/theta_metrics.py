"""Full per-window metric bundle for a solved theta field.

Port of eincm_tpu/evals/theta_metrics.py (reference:
src/evaluations/theta_eval.py:14-95, `evaluate_theta_array`): the loss as
the reference's evaluation computes it, FWL, the IWE variance and, with
ground truth, the sparse flow errors, with the reference's `evals` keys
and log strings. All device work is queued first; the small scalar and
per-reference bundle then crosses to the host in ONE transfer
(`utils/host.py:to_host`). The per-event arrays (the warped coordinates of
`loss_objectives`) stay on the device.

On the card one evaluation launches the splat forward twice: once for all
references' IWEs, once for the reference-0 re-splat of `iwe_var`.
`prepare_eval_inputs` launches it once more per window, for the
zero-warp statistics that every evaluation of that window then reuses.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from eincm_tpu_torch.evals.flow_metrics import sparse_flow_error
from eincm_tpu_torch.models.loss import (
    LossParams,
    WindowStatics,
    compute_loss_objectives,
    compute_window_statics,
)
from eincm_tpu_torch.models.objectives import compute_variance, per_pix_theta_to_flow
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.ops.splat import events_to_pdf_frame
from eincm_tpu_torch.utils import host

_BUCKET = 8192

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int64: np.int64}


def _eval_bundle(
    theta_array: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    edges: torch.Tensor,
    edge_ts: torch.Tensor,
    gt_flow: Optional[torch.Tensor],
    err_mask: Optional[torch.Tensor],
    pvec: Sequence,
    wstat: WindowStatics,
    sensor_size: Tuple[int, int],
) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """The evaluation on the device -> (small bundle, loss objectives).

    `pvec` holds (alpha, beta, gamma, delta). The means over references
    are UNWEIGHTED, as in the reference's evaluation
    (src/evaluations/theta_eval.py:27-42), whose solver loss weights them
    (losses.py:176-193): with several references this loss differs from
    the optimized objective on purpose.
    """
    objs = compute_loss_objectives(
        theta_array, xs, ys, ts, edges, edge_ts, sensor_size, window_statics=wstat
    )
    mean_rel_contrast = objs["rel_contrasts"].mean()
    mean_rel_corr = objs["rel_correlations"].mean()
    mean_rel_iwe_div = objs["rel_iwe_divergences"].mean()
    tot_var = objs["theta_total_variation"]
    loss = (
        pvec[0] * (-mean_rel_contrast)
        + pvec[1] * (-mean_rel_corr)
        + pvec[2] * tot_var
        + pvec[3] * mean_rel_iwe_div
    )
    # the reference re-splats the ref-0 warped events for iwe_var
    # (src/evaluations/theta_eval.py:25-43)
    iwe = events_to_pdf_frame(objs["warped_xs"][0], objs["warped_ys"][0], sensor_size)
    small: Dict = {
        "loss": loss,
        "iwe_var": compute_variance(iwe),
        "mean_rel_contrast": mean_rel_contrast,
        "mean_rel_corr": mean_rel_corr,
        "theta_tot_var": tot_var,
        "theta_div": objs["theta_divergence"],
        "fwl": objs["flow_warp_losses"][0],
        "mean_rel_iwe_div": mean_rel_iwe_div,
        "rel_iwe_divergences": objs["rel_iwe_divergences"],
        "rel_contrasts": objs["rel_contrasts"],
        "rel_correlations": objs["rel_correlations"],
        "flow_warp_losses": objs["flow_warp_losses"],
        "multi_ref_weights": objs["multi_ref_weights"],
    }
    if gt_flow is not None:
        pred_flow = per_pix_theta_to_flow(theta_array, xs, ys, ts)
        small["flow_errors"] = sparse_flow_error(pred_flow, gt_flow, err_mask)
    return small, objs


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _to_host(small: Dict) -> Dict:
    """The bundle as numpy arrays of each tensor's dtype and shape, in one
    device -> host transfer (every value exact in float64)."""
    leaves = list(_leaves(small))
    flat = torch.cat([t.reshape(-1).to(torch.float64) for _, t in leaves])
    vals = host.to_host(flat)
    out: Dict = {}
    i = 0
    for path, t in leaves:
        n = t.numel()
        arr = np.asarray(vals[i : i + n], _NP_DTYPES[t.dtype]).reshape(tuple(t.shape))
        i += n
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


@torch.no_grad()
def eval_window_small(
    theta_coarse: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    edges: torch.Tensor,
    edge_ts: torch.Tensor,
    gt_flow: Optional[torch.Tensor],
    err_mask: Optional[torch.Tensor],
    pvec: Sequence,
    sensor_size: Tuple[int, int],
    has_gt: bool,
    has_mask: bool,
    upscale_method: str,
) -> Dict:
    """One window's small bundle, on the device, from the solver's coarse
    level-0 theta: scaled to the sensor here, the window statics computed
    inline, the per-event objectives dropped (the building block of a
    batched evaluation)."""
    theta_full = scale_theta_to_sensor_size(theta_coarse, sensor_size, upscale_method)
    wstat = compute_window_statics(xs, ys, edges, sensor_size)
    small, _ = _eval_bundle(
        theta_full, xs, ys, ts, edges, edge_ts,
        gt_flow if has_gt else None, err_mask if has_mask else None,
        pvec, wstat, sensor_size,
    )
    return small


def format_eval_result(
    small: Dict, sensor_size: Tuple[int, int], has_gt: bool
) -> Tuple[str, str, Dict]:
    """The reference-parity strings and `evals` dict of one window's
    host-resident small bundle (theta_eval.py:44-93). Pops `flow_errors`
    from `small`: pass a per-window copy."""
    evals: Dict = {}
    acc_eval_str = ""
    if has_gt:
        fe = small.pop("flow_errors")
        evals.update({k: v for k, v in fe["errors"].items()})
        evals.update({k: v for k, v in fe["counts"].items()})
        evals["n_pixels"] = sensor_size[0] * sensor_size[1]
        e, c = fe["errors"], fe["counts"]
        acc_eval_str = (
            f', AEE(↓): {float(e["AEE"]):8.6f}, AREE(↓): {float(e["AREE"]):8.6f}, '
            + ", ".join(
                f'A{n}PE(↓): {float(e[f"A{n}PE"]):8.6f}' for n in (1, 2, 3, 5, 10, 20)
            )
            + f', | n_pixels:{evals["n_pixels"]:,}, n_gt_mask:{int(c["n_gt"]):,}, '
            + f'n_event_mask:{int(c["n_pred"]):,}, n_ee: {int(c["n_ee"]):,}\n'
        )

    time_str = f'[{time.strftime("%Y-%m-%d %H:%M:%S")}]'
    eval_str = (
        f'total_loss(↓): {float(small["loss"]):8.6f}, '
        f'iwe_var(↑): {float(small["iwe_var"]):8.6f}, '
        f'mean_rel_contrast(↑): {float(small["mean_rel_contrast"]):8.6f}, '
        f'mean_rel_corr(↑): {float(small["mean_rel_corr"]):8.6f}, '
        f'theta_tot_var(↓): {float(small["theta_tot_var"]):8.6f}, '
        f'theta_div(↓): {float(small["theta_div"]):8.6f}, '
        f'mean_rel_iwe_div(↓): {float(small["mean_rel_iwe_div"]):8.6f}, '
        f'FWL(↑): {float(small["fwl"]):8.6f}'
        f"{acc_eval_str}"
    )
    evals.update(small)
    return time_str, eval_str, evals


def _bucket_pad_events(eval_xs, eval_ys, eval_ts, dtype):
    """NaN-pad eval events to a multiple of 8192 (idempotent), in `dtype`.

    Padded events are sanitized away by every consumer; padded arrays (a
    multiple of 8192, the right dtype) pass through unchanged, so a
    window's events are padded once and threaded through every evaluation
    with the statics computed over them."""
    e = eval_xs.shape[0]
    bucket = max(_BUCKET, -(-e // _BUCKET) * _BUCKET)
    xs, ys, ts = (a.to(dtype) for a in (eval_xs, eval_ys, eval_ts))
    if e < bucket:
        fill = torch.full((bucket - e,), float("nan"), dtype=dtype, device=xs.device)
        xs, ys, ts = (torch.cat([a, fill]) for a in (xs, ys, ts))
    return xs, ys, ts


@torch.no_grad()
def prepare_eval_inputs(
    eval_xs: torch.Tensor,
    eval_ys: torch.Tensor,
    eval_ts: torch.Tensor,
    edges: torch.Tensor,
    sensor_size: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
):
    """Pad one window's eval events and compute its zero-warp statistics
    once -> (padded xs, ys, ts, window statics), to thread into repeated
    `evaluate_theta_array` calls over the same window. The events' device
    is the evaluation's."""
    xs, ys, ts = _bucket_pad_events(eval_xs, eval_ys, eval_ts, dtype)
    return xs, ys, ts, compute_window_statics(xs, ys, edges, sensor_size)


@torch.no_grad()
def evaluate_theta_array(
    theta_array: torch.Tensor,
    eval_xs: torch.Tensor,
    eval_ys: torch.Tensor,
    eval_ts: torch.Tensor,
    edges: torch.Tensor,
    edge_ts: torch.Tensor,
    gt_flow: Optional[torch.Tensor],
    params: LossParams,
    sensor_size: Tuple[int, int],
    err_eval_event_mask: Optional[torch.Tensor] = None,
    window_statics: Optional[WindowStatics] = None,
) -> Tuple[str, str, Dict, Dict]:
    """Evaluate a full-sensor theta (H, W, 2) over one window, on the
    device its tensors lie on.

    Returns (time_str, eval_str, evals, loss_objectives) like the
    reference: `evals` holds numpy values, `loss_objectives` stays on the
    device. `window_statics` (from `prepare_eval_inputs`, with its padded
    events) reuses the zero-warp statistics across evaluations of one
    window.
    """
    dtype = theta_array.dtype
    eval_xs, eval_ys, eval_ts = _bucket_pad_events(eval_xs, eval_ys, eval_ts, dtype)
    if window_statics is None:
        window_statics = compute_window_statics(eval_xs, eval_ys, edges, sensor_size)
    pvec = (params.alpha, params.beta, params.gamma, params.delta)
    small, loss_obj = _eval_bundle(
        theta_array, eval_xs, eval_ys, eval_ts, edges, edge_ts,
        gt_flow, err_eval_event_mask, pvec, window_statics, sensor_size,
    )
    small = _to_host(small)
    time_str, eval_str, evals = format_eval_result(small, sensor_size, gt_flow is not None)
    return time_str, eval_str, evals, loss_obj
