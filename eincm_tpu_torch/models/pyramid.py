"""Coarse-to-fine multi-level EINCM solve of one event window.

Port of eincm_tpu/models/pyramid.py (reference: the
`MultipleLevelEINCMSolver`, src/eincm/solver.py:10-384). The window
statics are computed once per window and shared by every level, attempt
and handover evaluation; each level runs BFGS with the reference's retry
loop; at the levels in `solve_handover_for_levels` the blend weight with
the prior is solved by golden section. State is explicit: priors go in,
results come out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from eincm_tpu_torch.models.bfgs import (
    BFGSResult,
    minimize_bfgs,
    minimize_bounded_scalar,
    value_and_grad,
)
from eincm_tpu_torch.models.loss import (
    LossParams,
    LossStatics,
    WindowStatics,
    compute_window_statics,
    solver_loss,
)
from eincm_tpu_torch.ops.resize import downscale_theta, upscale_theta


class WindowSample(NamedTuple):
    """One staged event window (src/eincm/solver.py:185-194)."""

    xs: torch.Tensor  # (E,)
    ys: torch.Tensor  # (E,)
    ts: torch.Tensor  # (E,) normalized to [0, 1]
    edges: torch.Tensor  # (n_refs, H, W)
    edge_ts: torch.Tensor  # (n_refs,)


@dataclass(frozen=True)
class HandoverSettings:
    """Reference: handover_settings dict, src/eincm/solver.py:30-52,87-101."""

    use_handover: bool = True
    solve_handover_for_levels: Tuple[int, ...] = ()
    use_downscaled_finest_priors: bool = True
    clip_solved_handover: bool = False
    clip_solved_handover_limits: Tuple[float, float] = (0.0, 1.0)
    alpha_handover: float = 0.5
    handover_limits: Tuple[float, float] = (0.0, 1.0)
    init_handover_weight: float = 0.5
    # >= 3 seeds the golden-section weight solve with a uniform grid over
    # the limits (robust to multi-modal handover landscapes); 0 disables
    handover_grid_probes: int = 0


_NOT_PORTED = {
    "armijo_interpolate": "quadratic-interpolated backtracking",
    "collect_intermediate": "per-iteration trajectories",
    "progress_heartbeat": "per-iteration loss printing",
    "compute_prior_loss": "the prior-loss anomaly signal of the armijo rescue",
}


@dataclass(frozen=True)
class SolverConfig:
    """Static configuration of the multi-level solve; the fields and
    defaults of eincm_tpu's `SolverConfig`. `theta_ftol` is None here, as
    in the library it ports (the experiment default 1e-5 is set by
    callers)."""

    n_pyr_lvls: int
    sensor_size: Tuple[int, int]
    params: LossParams
    theta_opt_maxiters: Tuple[int, ...]  # per level (index = level)
    handover_opt_maxiters: Tuple[int, ...] = ()
    theta_gtol: float = 1e-5
    n_extra_attempts: Dict[int, int] = field(default_factory=dict)
    pyramid_bases: Tuple[int, ...] | None = None
    pyramid_upscale_method: str = "repeat"
    pyramid_downscale_method: str = "bilinear"
    scale_to_sensor_size_method: str = "bilinear"
    handover: HandoverSettings = field(default_factory=HandoverSettings)
    # value-only probe budget per iteration; None -> 6 for 'armijo'
    max_ls_evals: Optional[int] = None
    line_search: str = "armijo"
    armijo_interpolate: bool = False
    theta_ftol: Optional[float] = None
    theta_ftol_patience: int = 2
    collect_intermediate: bool = False
    progress_heartbeat: bool = False
    compute_prior_loss: bool = False

    def __post_init__(self):
        if self.line_search != "armijo":
            raise NotImplementedError(
                f"line_search={self.line_search!r}: only 'armijo' is ported"
            )
        for name, what in _NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(f"{name} ({what}) is not ported")
        bases = self.pyramid_bases
        if bases is None:
            bases = (2,) * (self.n_pyr_lvls - 1)
            object.__setattr__(self, "pyramid_bases", tuple(bases))
        if len(self.theta_opt_maxiters) != self.n_pyr_lvls:
            raise ValueError("theta_opt_maxiters needs one entry per level")
        if len(bases) != self.n_pyr_lvls - 1:
            raise ValueError("pyramid_bases needs n_pyr_lvls - 1 entries")
        if not self.handover_opt_maxiters:
            object.__setattr__(
                self, "handover_opt_maxiters", (15,) * self.n_pyr_lvls
            )
        if self.max_ls_evals is None:
            object.__setattr__(self, "max_ls_evals", 6)

    def base_between(self, fine_lvl: int) -> int:
        """Scale factor between level `fine_lvl` and `fine_lvl + 1`
        (reference indexing: src/eincm/solver.py:143-151,247-248,288-289)."""
        return self.pyramid_bases[-fine_lvl - 1]

    def level_shape(self, lvl: int) -> Tuple[int, int]:
        h = w = 1
        for fine in range(lvl, self.n_pyr_lvls - 1):
            b = self.base_between(fine)
            h *= b
            w *= b
        return (h, w)

    @property
    def loss_statics(self) -> LossStatics:
        return LossStatics(
            sensor_size=self.sensor_size,
            n_pyr_lvls=self.n_pyr_lvls,
            scale_to_sensor_size_method=self.scale_to_sensor_size_method,
        )

    def zero_pyramid(
        self, dtype=torch.float32, *, device
    ) -> Tuple[torch.Tensor, ...]:
        """All-zero theta pyramid on `device`, finest (level 0) first."""
        return tuple(
            torch.zeros((*self.level_shape(l), 2), dtype=dtype, device=device)
            for l in range(self.n_pyr_lvls)
        )


class SolveResult(NamedTuple):
    """Mirror of the reference solve() output (src/eincm/solver.py:259-267)."""

    prior_theta_pyr: Tuple[torch.Tensor, ...]
    pre_opt_theta_pyr: Tuple[torch.Tensor, ...]
    pre_handover_theta_pyr: Tuple[torch.Tensor, ...]
    final_theta_pyr: Tuple[torch.Tensor, ...]
    theta_opt_states: Tuple[BFGSResult, ...]
    final_handover_weights: Tuple[torch.Tensor, ...]
    n_host_syncs: int = 0  # device -> host transfers of the whole solve


def _solve_theta_level(
    cfg: SolverConfig,
    lvl: int,
    theta0: torch.Tensor,
    sample: WindowSample,
    wstat: WindowStatics,
) -> Tuple[torch.Tensor, BFGSResult]:
    """BFGS at one pyramid level, with the reference's retry loop."""
    shape = theta0.shape
    statics = cfg.loss_statics

    def fun(flat):
        return solver_loss(
            flat.reshape(shape), sample.xs, sample.ys, sample.ts,
            sample.edges, sample.edge_ts, cfg.params, lvl, statics, wstat,
        )

    res = minimize_bfgs(
        value_and_grad(fun),
        theta0.reshape(-1),
        maxiter=cfg.theta_opt_maxiters[lvl],
        gtol=cfg.theta_gtol,
        max_ls_evals=cfg.max_ls_evals,
        n_extra_attempts=cfg.n_extra_attempts.get(lvl, 0),
        line_search=cfg.line_search,
        fun=fun,
        ftol=cfg.theta_ftol,
        ftol_patience=cfg.theta_ftol_patience,
    )
    return res.x.reshape(shape), res


def _solve_handover_weight(
    cfg: SolverConfig,
    lvl: int,
    prior_theta: torch.Tensor,
    theta: torch.Tensor,
    sample: WindowSample,
    wstat: WindowStatics,
) -> torch.Tensor:
    """Golden-section solve of the blend weight at one level. For levels
    > 0 the weight is solved one level finer with the upscaled optimized
    theta (reference: src/eincm/solver.py:311-335)."""
    ho = cfg.handover
    loss_lvl = lvl - 1 if lvl > 0 else lvl
    maxiter = cfg.handover_opt_maxiters[loss_lvl]

    def fun(w):
        theta_ho = w * prior_theta + (1.0 - w) * theta
        return solver_loss(
            theta_ho, sample.xs, sample.ys, sample.ts, sample.edges,
            sample.edge_ts, cfg.params, loss_lvl, cfg.loss_statics, wstat,
        )

    w_star, _ = minimize_bounded_scalar(
        fun, ho.handover_limits, maxiter=maxiter,
        n_grid_probes=ho.handover_grid_probes, device=theta.device,
    )
    if ho.clip_solved_handover:
        w_star = torch.clamp(w_star, *ho.clip_solved_handover_limits)
    return w_star


def stage_prior_pyramid(
    cfg: SolverConfig, prior_pyr: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Optionally rebuild coarse priors by downscaling the finest prior
    (reference: src/eincm/solver.py:283-289)."""
    prior = list(prior_pyr)
    if cfg.handover.use_downscaled_finest_priors:
        for lvl in range(1, cfg.n_pyr_lvls):
            prior[lvl] = downscale_theta(
                prior[lvl - 1],
                base=cfg.base_between(lvl - 1),
                method=cfg.pyramid_downscale_method,
            )
    return tuple(prior)


def solve_window(
    cfg: SolverConfig,
    sample: WindowSample,
    prior_pyr: Sequence[torch.Tensor],
    is_first_sample: bool,
) -> SolveResult:
    """Full coarse-to-fine solve of one event window (reference:
    src/eincm/solver.py:197-267). The first window skips handover."""
    n = cfg.n_pyr_lvls
    ho = cfg.handover
    wstat = compute_window_statics(
        sample.xs, sample.ys, sample.edges, cfg.sensor_size
    )
    with torch.no_grad():
        prior = stage_prior_pyramid(cfg, prior_pyr)

    pre_opt: list = [None] * n
    opt: list = [None] * n
    final: list = [None] * n
    opt_states: list = [None] * n
    weights: list = [None] * n
    pre_opt[n - 1] = prior[n - 1]

    for lvl in reversed(range(n)):
        opt[lvl], opt_states[lvl] = _solve_theta_level(
            cfg, lvl, pre_opt[lvl], sample, wstat
        )
        with torch.no_grad():
            if is_first_sample or not ho.use_handover:
                weights[lvl] = torch.tensor(
                    ho.init_handover_weight, dtype=opt[lvl].dtype,
                    device=opt[lvl].device,
                )
                final[lvl] = opt[lvl]
            else:
                if lvl in ho.solve_handover_for_levels:
                    if lvl > 0:
                        prior_for_solve = prior[lvl - 1]
                        theta_for_solve = upscale_theta(
                            opt[lvl],
                            base=cfg.base_between(lvl - 1),
                            method=cfg.pyramid_upscale_method,
                        )
                    else:
                        prior_for_solve = prior[lvl]
                        theta_for_solve = opt[lvl]
                    w = _solve_handover_weight(
                        cfg, lvl, prior_for_solve, theta_for_solve, sample, wstat
                    )
                else:
                    w = torch.tensor(
                        ho.alpha_handover, dtype=opt[lvl].dtype,
                        device=opt[lvl].device,
                    )
                weights[lvl] = w
                final[lvl] = w * prior[lvl] + (1.0 - w) * opt[lvl]
            if lvl > 0:
                pre_opt[lvl - 1] = upscale_theta(
                    final[lvl],
                    base=cfg.base_between(lvl - 1),
                    method=cfg.pyramid_upscale_method,
                )

    return SolveResult(
        prior_theta_pyr=tuple(prior),
        pre_opt_theta_pyr=tuple(pre_opt),
        pre_handover_theta_pyr=tuple(opt),
        final_theta_pyr=tuple(final),
        theta_opt_states=tuple(opt_states),
        final_handover_weights=tuple(weights),
        n_host_syncs=sum(s.n_host_syncs for s in opt_states),
    )


def make_window_solver(cfg: SolverConfig, device):
    """(sample, prior_pyr, is_first) -> SolveResult, solving on `device`.

    The sample must already lie on `device` (see `data.staging`); the prior
    pyramid is moved there explicitly.
    """
    device = torch.device(device)

    def run(
        sample: WindowSample, prior_pyr: Sequence[torch.Tensor], is_first: bool
    ) -> SolveResult:
        for t in sample:
            if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index
            ):
                raise ValueError(
                    f"sample tensor on {t.device}, solver on {device}"
                )
        prior = tuple(p.to(device) for p in prior_pyr)
        return solve_window(cfg, sample, prior, is_first_sample=is_first)

    return run
