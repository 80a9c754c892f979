"""Sparse optical-flow error metrics (AEE / AREE / N-PE).

Port of eincm_tpu/evals/flow_metrics.py (reference evaluator:
src/evaluations/flow_eval.py:14-75). Where the reference gathers the valid
pixels by boolean indexing, every statistic here is a masked reduction over
the full (H, W) grid: a boolean index would make the host wait for the
device to learn the result's size.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import torch

EPSN = sys.float_info.epsilon

N_PIXEL_THRESHOLDS = (1, 2, 3, 5, 10, 20)


def _norm(flow: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((flow * flow).sum(dim=-1))


def _valid_mask(flow: torch.Tensor) -> torch.Tensor:
    """Valid = no infinite channel and a nonzero norm (flow_eval.py:31-45;
    a NaN norm is not > 0)."""
    finite = ~torch.isinf(flow[..., 0]) & ~torch.isinf(flow[..., 1])
    return finite & (_norm(flow) > 0)


def sparse_flow_error(
    pred_flow: torch.Tensor,
    gt_flow: torch.Tensor,
    event_mask: Optional[torch.Tensor] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Masked endpoint-error statistics between predicted and GT flow.

    Args:
        pred_flow: (H, W, 2) predicted displacements.
        gt_flow: (H, W, 2) ground-truth displacements.
        event_mask: optional (H, W) bool, restricts the evaluation to
            event pixels.

    Returns:
        {'errors': {AEE, AREE, A{1,2,3,5,10,20}PE}, 'counts': {n_ee,
        n_pred, n_gt}}, the reference's schema; the counts are integer
        tensors.
    """
    dtype = pred_flow.dtype
    mask_pred = _valid_mask(pred_flow)
    if event_mask is not None:
        mask_pred = mask_pred & event_mask
    mask_gt = _valid_mask(gt_flow)
    mask = mask_pred & mask_gt

    zero = torch.zeros((), dtype=dtype, device=pred_flow.device)
    epe = _norm(torch.where(mask[..., None], pred_flow - gt_flow, zero))  # 0 outside
    gt_norm = _norm(torch.where(mask[..., None], gt_flow, zero))
    rel_epe = epe / (gt_norm + EPSN)

    n_ee = mask.sum()
    denom = torch.clamp_min(n_ee, 1).to(dtype)
    errs = {
        "AEE": torch.where(mask, epe, zero).sum() / denom,
        "AREE": torch.where(mask, rel_epe, zero).sum() / denom,
    }
    for n in N_PIXEL_THRESHOLDS:
        errs[f"A{n}PE"] = (
            (mask & (epe > n)).sum().to(dtype) * 100.0 / (n_ee.to(dtype) + EPSN)
        )
    cnts = {"n_ee": n_ee, "n_pred": mask_pred.sum(), "n_gt": mask_gt.sum()}
    return {"errors": errs, "counts": cnts}
