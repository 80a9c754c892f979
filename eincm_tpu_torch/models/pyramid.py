"""Coarse-to-fine multi-level EINCM solve of one event window.

Port of eincm_tpu/models/pyramid.py (reference: the
`MultipleLevelEINCMSolver`, src/eincm/solver.py:10-384). The window
statics are computed once per window and shared by every level, attempt
and handover evaluation; each level runs BFGS with the reference's retry
loop; at the levels in `solve_handover_for_levels` the blend weight with
the prior is solved by golden section. State is explicit: priors go in,
results come out. Under a profiler the solve is an `eincm.window` span
holding `eincm.statics` and one `eincm.level<l>` a level, each with its
BFGS and its `eincm.handover` (`utils/profiling.py`). The solver that
`make_window_solver` builds on the card evaluates the loss through CUDA
graphs (`models/graphs.py`); `solve_window` without them runs eager.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from eincm_tpu_torch.models.bfgs import (
    BFGSHistory,
    BFGSResult,
    minimize_bfgs,
    minimize_bounded_scalar,
)
from eincm_tpu_torch.models.graphs import LossGraphs, loss_functions
from eincm_tpu_torch.models.loss import (
    LossParams,
    LossStatics,
    WindowStatics,
    compute_window_statics,
)
from eincm_tpu_torch.ops.resize import downscale_theta, upscale_theta
from eincm_tpu_torch.utils import profiling


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
    # line-search budget per iteration; None resolves by line search: 6
    # value-only probes for 'armijo', 10 bracket+zoom trials for 'wolfe'
    max_ls_evals: Optional[int] = None
    # 'armijo' (value-only probes) or 'wolfe' (strong Wolfe, scipy-parity)
    line_search: str = "armijo"
    # 'armijo' only: quadratic-interpolated backtracking instead of halving
    armijo_interpolate: bool = False
    theta_ftol: Optional[float] = None
    theta_ftol_patience: int = 2
    # record per-iteration (theta, loss) trajectories per level, and the
    # golden section's probes where a handover weight is solved
    collect_intermediate: bool = False
    # print each iteration's loss per level (no extra host sync)
    progress_heartbeat: bool = False
    # emit SolveResult.prior_loss_lvl0, the armijo rescue's anomaly signal:
    # one level-0 loss evaluation per non-first window
    compute_prior_loss: bool = False

    def __post_init__(self):
        if self.line_search not in ("armijo", "wolfe"):
            raise ValueError(f"line_search {self.line_search!r}")
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
            object.__setattr__(
                self, "max_ls_evals", 6 if self.line_search == "armijo" else 10
            )

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
    theta_histories: Tuple[BFGSHistory, ...] = ()  # per level, when collected
    # per level, when collected: the golden section's probes where the
    # weight was solved (an empty history, n = 0, on a first window), else
    # None
    handover_histories: Tuple = ()
    # loss of the prior's level-0 theta under this window's objective (+inf
    # on a first window or without compute_prior_loss): a level-0 optimum
    # worse than it is anomalous (the manager's armijo -> wolfe rescue)
    prior_loss_lvl0: Optional[torch.Tensor] = None
    n_host_syncs: int = 0  # device -> host transfers of the whole solve


def _solve_theta_level(
    cfg: SolverConfig,
    lvl: int,
    theta0: torch.Tensor,
    sample: WindowSample,
    wstat: WindowStatics,
    graphs: Optional[LossGraphs] = None,
) -> Tuple[torch.Tensor, BFGSResult, Optional[BFGSHistory]]:
    """BFGS at one pyramid level, with the reference's retry loop."""
    shape = theta0.shape
    fun, fun_and_grad = loss_functions(
        cfg.params, lvl, cfg.loss_statics, shape, sample, wstat, graphs
    )

    heartbeat = None
    if cfg.progress_heartbeat:
        def heartbeat(k, f):
            print(f"  [lvl {lvl}] iter {int(k):3d}  loss {float(f):.6f}")

    out = minimize_bfgs(
        fun_and_grad,
        theta0.reshape(-1),
        maxiter=cfg.theta_opt_maxiters[lvl],
        gtol=cfg.theta_gtol,
        max_ls_evals=cfg.max_ls_evals,
        n_extra_attempts=cfg.n_extra_attempts.get(lvl, 0),
        record_history=cfg.collect_intermediate,
        line_search=cfg.line_search,
        armijo_interpolate=cfg.armijo_interpolate,
        fun=fun,
        heartbeat_fn=heartbeat,
        ftol=cfg.theta_ftol,
        ftol_patience=cfg.theta_ftol_patience,
    )
    res, hist = out if cfg.collect_intermediate else (out, None)
    return res.x.reshape(shape), res, hist


@profiling.spanned("eincm.handover")
def _solve_handover_weight(
    cfg: SolverConfig,
    lvl: int,
    prior_theta: torch.Tensor,
    theta: torch.Tensor,
    sample: WindowSample,
    wstat: WindowStatics,
    graphs: Optional[LossGraphs] = None,
) -> Tuple[torch.Tensor, Optional[BFGSHistory]]:
    """Golden-section solve of the blend weight at one level, with its
    probe history when collected. For levels > 0 the weight is solved one
    level finer with the upscaled optimized theta (reference:
    src/eincm/solver.py:311-335)."""
    ho = cfg.handover
    loss_lvl = lvl - 1 if lvl > 0 else lvl
    maxiter = cfg.handover_opt_maxiters[loss_lvl]
    loss, _ = loss_functions(
        cfg.params, loss_lvl, cfg.loss_statics, theta.shape, sample, wstat, graphs
    )

    def fun(w):
        return loss((w * prior_theta + (1.0 - w) * theta).reshape(-1))

    out = minimize_bounded_scalar(
        fun, ho.handover_limits, maxiter=maxiter,
        record_history=cfg.collect_intermediate,
        n_grid_probes=ho.handover_grid_probes, device=theta.device,
    )
    (w_star, _), hist = out if cfg.collect_intermediate else (out, None)
    if ho.clip_solved_handover:
        w_star = torch.clamp(w_star, *ho.clip_solved_handover_limits)
    return w_star, hist


@profiling.spanned("eincm.statics")
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


@profiling.spanned("eincm.window")
def solve_window(
    cfg: SolverConfig,
    sample: WindowSample,
    prior_pyr: Sequence[torch.Tensor],
    is_first_sample: bool,
    graphs: Optional[LossGraphs] = None,
) -> SolveResult:
    """Full coarse-to-fine solve of one event window (reference:
    src/eincm/solver.py:197-267). The first window skips handover. With
    `graphs` the loss is evaluated through its CUDA graphs, bound to this
    window."""
    n = cfg.n_pyr_lvls
    ho = cfg.handover
    with profiling.annotate("eincm.statics"):
        wstat = compute_window_statics(
            sample.xs, sample.ys, sample.edges, cfg.sensor_size
        )
        if graphs is not None:
            graphs.bind(sample, wstat)
    with torch.no_grad():
        prior = stage_prior_pyramid(cfg, prior_pyr)
        if is_first_sample or not cfg.compute_prior_loss:
            prior_loss0 = torch.full(
                (), float("inf"), dtype=prior[0].dtype, device=prior[0].device
            )
        else:
            loss0, _ = loss_functions(
                cfg.params, 0, cfg.loss_statics, prior[0].shape, sample, wstat, graphs
            )
            prior_loss0 = loss0(prior[0].reshape(-1))

    pre_opt: list = [None] * n
    opt: list = [None] * n
    final: list = [None] * n
    opt_states: list = [None] * n
    weights: list = [None] * n
    histories: list = [None] * n
    ho_histories: list = [None] * n
    pre_opt[n - 1] = prior[n - 1]

    def scalar(v, like):
        return torch.full((), v, dtype=like.dtype, device=like.device)

    for lvl in reversed(range(n)):
        with profiling.annotate(f"eincm.level{lvl}"):
            opt[lvl], opt_states[lvl], histories[lvl] = _solve_theta_level(
                cfg, lvl, pre_opt[lvl], sample, wstat, graphs
            )
            with torch.no_grad():
                if is_first_sample or not ho.use_handover:
                    weights[lvl] = scalar(ho.init_handover_weight, opt[lvl])
                    final[lvl] = opt[lvl]
                    if (
                        cfg.collect_intermediate
                        and ho.use_handover
                        and lvl in ho.solve_handover_for_levels
                    ):
                        # an empty history of the solved one's shape, so that
                        # first and later windows' results have one structure
                        maxiter = cfg.handover_opt_maxiters[max(lvl - 1, 0)]
                        cap = max(2, ho.handover_grid_probes) + 2 + maxiter
                        dev = opt[lvl].device
                        ho_histories[lvl] = BFGSHistory(
                            xs=torch.zeros((cap,), dtype=torch.float32, device=dev),
                            fs=torch.zeros((cap,), dtype=opt[lvl].dtype, device=dev),
                            n=0,
                        )
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
                        w, ho_histories[lvl] = _solve_handover_weight(
                            cfg, lvl, prior_for_solve, theta_for_solve, sample, wstat,
                            graphs,
                        )
                    else:
                        w = scalar(ho.alpha_handover, opt[lvl])
                    weights[lvl] = w
                    final[lvl] = w * prior[lvl] + (1.0 - w) * opt[lvl]
                if lvl > 0:
                    pre_opt[lvl - 1] = upscale_theta(
                        final[lvl],
                        base=cfg.base_between(lvl - 1),
                        method=cfg.pyramid_upscale_method,
                    )

    collected = cfg.collect_intermediate
    return SolveResult(
        prior_theta_pyr=tuple(prior),
        pre_opt_theta_pyr=tuple(pre_opt),
        pre_handover_theta_pyr=tuple(opt),
        final_theta_pyr=tuple(final),
        theta_opt_states=tuple(opt_states),
        final_handover_weights=tuple(weights),
        theta_histories=tuple(histories) if collected else (),
        handover_histories=tuple(ho_histories) if collected else (),
        prior_loss_lvl0=prior_loss0,
        # every device -> host read of the solve is a BFGS one: the prior
        # loss, the golden section and the histories stay on the device
        n_host_syncs=sum(s.n_host_syncs for s in opt_states),
    )


def make_window_solver(cfg: SolverConfig, device):
    """(sample, prior_pyr, is_first) -> SolveResult, solving on `device`.

    The sample must already lie on `device` (see `data.staging`); the prior
    pyramid is moved there explicitly. On a CUDA device the solver keeps
    the CUDA graphs of its loss (`models/graphs.py`, as `run.graphs`).
    """
    device = torch.device(device)
    graphs = LossGraphs() if device.type == "cuda" else None

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
        return solve_window(cfg, sample, prior, is_first_sample=is_first, graphs=graphs)

    run.graphs = graphs
    return run
