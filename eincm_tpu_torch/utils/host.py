"""The one place where the solve and the evaluation read a tensor on the host.

Every device -> host transfer of `models/bfgs.py` (Armijo probes, Wolfe
trials, the status bits of each iteration), of `evals/theta_metrics.py`
(the small bundle of one evaluation) and of the experiment manager (a
solve's record, the armijo rescue's anomaly check) goes through `to_host`,
so the count a solve reports (`SolveResult.n_host_syncs`) can be held
against the counter `host.reads` that it keeps (`utils/profiling.py`),
beside `host.read_wait_ns`, the host ns spent waiting in it. Each read is
an `eincm.read` span in a profiler's trace.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from eincm_tpu_torch.utils import profiling

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int64: np.int64}


@profiling.spanned("eincm.read", "host.reads", "host.read_wait_ns")
def to_host(t: torch.Tensor) -> list:
    """`t`'s values as (nested) Python numbers: one device -> host copy,
    which waits for the work queued before it."""
    return t.tolist()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def tree_to_host(tree: Dict) -> Dict:
    """A nested dict of tensors (float32, float64 or int64, on one device)
    as the same dict of numpy arrays of each tensor's dtype and shape, in
    one `to_host` transfer (every value exact in float64)."""
    leaves = list(_leaves(tree))
    if not leaves:
        return {}
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for _, t in leaves])
    vals = to_host(flat)
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
