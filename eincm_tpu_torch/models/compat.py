"""jaxopt-style compatibility wrappers over the port's solvers.

Port of eincm_tpu/models/compat.py. The reference drives its solves
through `jaxopt.ScipyMinimize` / `jaxopt.ScipyBoundedMinimize`
(src/eincm/solver.py:165-183) — host-side scipy with a hand-patched jaxopt
for callbacks. These wrappers give code written against that API a drop-in
path onto the port's BFGS / golden-section solvers
(`eincm_tpu_torch.models.bfgs`), whose tensors stay on their device:

    solver = ScipyMinimize(fun=loss, method="BFGS", maxiter=40,
                           options={"gtol": 1e-4}, has_aux=True)
    res = solver.run(x0, *loss_args)
    res.params, res.state.fun_val, res.state.success, res.state.iter_num

Differences from jaxopt, by design:
  - the solve runs on `init_params`' device when it is a tensor, else on
    the `device` field ("cuda" unless the caller asks for another); the
    host reads are `minimize_bfgs`'s, counted in `state.n_host_syncs`, and
    ScipyBoundedMinimize's one read of (w, f) for its `success`, both
    through `utils/host.py:to_host`;
  - `callback` is accepted but executed AFTER the solve over the recorded
    trajectory (post-hoc, one call per iterate) instead of per-iteration
    from inside scipy;
  - only method="BFGS" (ScipyMinimize) and the 1-D bounded case
    (ScipyBoundedMinimize, matching the reference's handover solve) are
    provided — the only configurations the reference uses;
  - `jit` is accepted and ignored: it compiles the solve in the JAX
    package, and the port has no trace to compile.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from eincm_tpu_torch.models.bfgs import (
    minimize_bfgs,
    minimize_bounded_scalar,
    value_and_grad,
)
from eincm_tpu_torch.utils import host


class OptStep(NamedTuple):
    """jaxopt-compatible result pair."""

    params: Any
    state: Any


class _IntermediateResult(NamedTuple):
    """Mimics scipy's callback payload (reference callbacks read .x/.fun,
    src/eincm/callbacks.py:131-132)."""

    x: torch.Tensor
    fun: torch.Tensor


class _State(NamedTuple):
    """ScipyBoundedMinimize's state (the JAX package's `_State`)."""

    fun_val: torch.Tensor
    success: bool
    iter_num: int


def _solve_device(init_params, device) -> torch.device:
    """`init_params`' device when it is a tensor, else `device`."""
    if isinstance(init_params, torch.Tensor):
        return init_params.device
    return torch.device(device)


@dataclass
class ScipyMinimize:
    """Stand-in for jaxopt.ScipyMinimize (method='BFGS') on `minimize_bfgs`
    (strong Wolfe, the JAX package's defaults)."""

    fun: Callable
    method: str = "BFGS"
    maxiter: int = 100
    tol: Optional[float] = None
    jit: bool = True
    has_aux: bool = False
    options: dict = field(default_factory=dict)
    callback: Optional[Callable] = None
    device: Any = "cuda"

    def __post_init__(self):
        # raised, not asserted, so that `python -O` keeps the check
        if self.method.upper() != "BFGS":
            raise AssertionError(
                f"only BFGS is provided (got {self.method!r}) — the reference "
                "uses no other method"
            )

    def run(self, init_params, *args, **kwargs) -> OptStep:
        x0 = torch.as_tensor(init_params, device=_solve_device(init_params, self.device))
        shape = x0.shape

        def value(flat):
            out = self.fun(flat.reshape(shape), *args, **kwargs)
            return out[0] if self.has_aux else out

        gtol = float(self.options.get("gtol", self.tol or 1e-5))
        record = self.callback is not None or self.options.get(
            "return_all", False
        )
        out = minimize_bfgs(
            value_and_grad(value),
            x0.reshape(-1),
            maxiter=self.maxiter,
            gtol=gtol,
            record_history=record,
            fun=value,
        )
        if record:
            res, hist = out
        else:
            res, hist = out, None
        if self.callback is not None:
            for k in range(hist.n):
                self.callback(
                    _IntermediateResult(
                        x=hist.xs[k].reshape(shape), fun=hist.fs[k]
                    )
                )
        # scipy's options={'return_all': True} exposes allvecs on the result;
        # here the recorded trajectory lands on the solver object
        self.history = hist
        state = res._replace(x=res.x.reshape(shape))
        return OptStep(params=state.x, state=state)


@dataclass
class ScipyBoundedMinimize:
    """Stand-in for jaxopt.ScipyBoundedMinimize for the 1-D bounded solve
    the reference performs on the handover weight (src/eincm/solver.py:
    302-347), on `minimize_bounded_scalar`. `run(init, bounds, *args)`
    follows the jaxopt calling convention; `init` is ignored (the
    bracketing method needs no start point) but for its device when it is
    a tensor. `fun` takes a 0-dim float32 tensor on that device."""

    fun: Callable
    method: str = "L-BFGS-B"
    maxiter: int = 30
    jit: bool = True
    has_aux: bool = False
    options: dict = field(default_factory=dict)
    callback: Optional[Callable] = None
    device: Any = "cuda"

    def run(
        self,
        init_params,
        bounds: Tuple[float, float],
        *args,
        **kwargs,
    ) -> OptStep:
        lo, hi = bounds
        lo = float(torch.as_tensor(lo).reshape(()))
        hi = float(torch.as_tensor(hi).reshape(()))

        def value(w):
            out = self.fun(w, *args, **kwargs)
            return out[0] if self.has_aux else out

        record = self.callback is not None
        out = minimize_bounded_scalar(
            value, (lo, hi), maxiter=self.maxiter, record_history=record,
            device=_solve_device(init_params, self.device),
        )
        if record:
            (w, f), hist = out
            for k in range(hist.n):
                self.callback(_IntermediateResult(x=hist.xs[k], fun=hist.fs[k]))
        else:
            w, f = out

        # Honest state instead of an unconditional success=True: the
        # golden-section solve always performs its full probe schedule
        # (iter_num = maxiter bracketing steps), and "success" means the
        # solve produced a finite optimum inside the bounds — the only
        # failure mode a derivative-free bracketing method has (a scipy
        # L-BFGS-B failure signal has no analogue here).
        w_f, f_f = host.to_host(torch.stack([w.double(), f.double()]))
        success = math.isfinite(f_f) and lo <= w_f <= hi
        return OptStep(
            params=w,
            state=_State(fun_val=f, success=success, iter_num=self.maxiter),
        )
