"""The one place where the solve and the evaluation read a tensor on the host.

Every device -> host transfer of `models/bfgs.py` (Armijo probes, Wolfe
trials, the status bits of each iteration) and of `evals/theta_metrics.py`
(the small bundle of one evaluation) goes through `to_host`, so the count a
solve reports (`SolveResult.n_host_syncs`) can be held against a counter
wrapped around this function.
"""

from __future__ import annotations

import torch


def to_host(t: torch.Tensor) -> list:
    """`t`'s values as (nested) Python numbers: one device -> host copy,
    which waits for the work queued before it."""
    return t.tolist()
