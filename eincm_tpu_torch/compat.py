"""Carry state between the JAX package and the port, as numpy arrays.

The tests use these so that both packages solve the same problem from the
same prior; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import (
    HandoverSettings,
    SolverConfig,
    WindowSample,
)


def theta_pyramid_from_numpy(pyr: Sequence) -> Tuple[torch.Tensor, ...]:
    """A theta pyramid of arrays (finest first) -> CPU tensors of their
    dtype (`make_window_solver` moves them to its device)."""
    return tuple(torch.as_tensor(np.array(t)) for t in pyr)


def window_sample_from_numpy(xs, ys, ts, edges, edge_ts, device) -> WindowSample:
    """A window of arrays -> a `WindowSample` of tensors on `device`."""
    return WindowSample(
        *(torch.as_tensor(np.array(a), device=device) for a in (xs, ys, ts, edges, edge_ts))
    )


def solver_config_from_dict(d: Mapping) -> SolverConfig:
    """`dataclasses.asdict` of an eincm_tpu `SolverConfig` -> the port's."""
    d = dict(d)
    ho = dict(d["handover"])
    ho["solve_handover_for_levels"] = tuple(ho["solve_handover_for_levels"])
    d["handover"] = HandoverSettings(**ho)
    d["params"] = LossParams(**d["params"])
    d["sensor_size"] = tuple(d["sensor_size"])
    for key in ("theta_opt_maxiters", "handover_opt_maxiters", "pyramid_bases"):
        if d.get(key) is not None:
            d[key] = tuple(d[key])
    return SolverConfig(**d)
