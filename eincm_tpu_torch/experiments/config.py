"""Experiment configuration: typed dataclasses + YAML + dotted overrides.

Port of eincm_tpu/experiments/config.py (which replaces the reference's
hydra/omegaconf stack, src/experiments/e00/configs/**) with the same
dataclasses, fields and defaults, so `to_dict()` gives the JAX package's
keys and values and each package reads the other's artifacts. YAML is read
by `utils/yaml_lite.py` (no PyYAML on the card's machine).

What the port does not run raises `NotImplementedError` instead of giving
a different run: a `jax_config` flag other than `jax_enable_x64` (naming
the flag), and more than one `distributed.local_device_ids` (one device
per process). The solver switches `splat_impl`, `interp_impl`,
`splat_multiref_stacked` and `scan_levels` choose between implementations
of one function in the JAX package; the port has one of each, so they are
accepted and ignored. So are `jax_config={jax_enable_x64: ...}` (the
reference's default: the JAX package's solve casts its inputs to float32
and its results do not depend on the flag; the port's dtypes are its own)
and `compilation_cache_dir` (the XLA compilation cache: the port compiles
no XLA programs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import HandoverSettings, SolverConfig
from eincm_tpu_torch.parallel.distributed import DistributedConfig, check_local_device_ids
from eincm_tpu_torch.utils import yaml_lite


# the jax_config flags the port takes and ignores (module docstring)
IGNORED_JAX_FLAGS = ("jax_enable_x64",)


@dataclass
class DatasetConfig:
    kind: str = "synthetic"  # synthetic | ecd | mvsec | dsec
    root_dir: str = ""
    sequence_name: str = "synthetic"
    des_n_events: int = 8192
    sensor_size: Tuple[int, int] = (64, 64)
    delta_idx: int = 1  # MVSEC/ECD image-timestamp stride ("dt")
    data_split: str = "test"  # DSEC
    extended: bool = False  # DSEC extended eval timestamps
    load_more_images: bool = False  # MVSEC multi-reference
    use_new_pruning_limits: bool = False  # MVSEC
    prefer_latest_events: bool = True
    # synthetic-only
    n_windows: int = 4
    velocity: Tuple[float, float] = (3.0, -2.0)
    seed: int = 0
    shear: float = 0.0  # vx(y) slope; requires velocity[1] == 0

    def make_loader(self):
        if self.kind == "synthetic":
            from eincm_tpu_torch.data.synthetic import SyntheticDataLoader

            return SyntheticDataLoader(
                sensor_size=tuple(self.sensor_size),
                n_windows=self.n_windows,
                des_n_events=self.des_n_events,
                velocity=tuple(self.velocity),
                prefer_latest_events=self.prefer_latest_events,
                seed=self.seed,
                shear=self.shear,
            )
        if self.kind == "ecd":
            from eincm_tpu_torch.data.ecd import ECDDataLoader

            return ECDDataLoader(
                self.root_dir, self.sequence_name, self.des_n_events,
                self.delta_idx, self.prefer_latest_events,
            )
        if self.kind == "mvsec":
            from eincm_tpu_torch.data.mvsec import MVSECDataLoader

            return MVSECDataLoader(
                self.root_dir, self.sequence_name, self.delta_idx,
                self.des_n_events, self.load_more_images,
                self.use_new_pruning_limits, self.prefer_latest_events,
            )
        if self.kind == "dsec":
            from eincm_tpu_torch.data.dsec import DSECDataLoader

            return DSECDataLoader(
                self.root_dir, self.sequence_name, self.des_n_events,
                self.data_split, self.extended, self.prefer_latest_events,
                sensor_size=tuple(self.sensor_size),
            )
        raise ValueError(f"unknown dataset kind {self.kind!r}")


@dataclass
class EdgeConfig:
    """Edge extraction settings (reference: configs/edge_extraction/*.yaml)."""

    enable_image_preprocessing: bool = True
    canny_aperture: int = 3
    canny_th1: float = 30.0
    canny_th2: float = 80.0
    smoothen_method: str = "gaussian"  # gaussian | eincm_iedt | rtef_iedt
    smoothen_k_size: float = 1.0
    smoothen_sigma: float = 1.0
    iedt_alpha: float = 6.0
    rtef_d_sat: float = 6.0
    rtef_formulation: str = "exponential"
    preprocess_kwargs: Dict[str, Any] = field(default_factory=dict)

    def make_edge_fn(self):
        from eincm_tpu_torch.edge import pipeline as ep

        if self.smoothen_method == "gaussian":
            smoothen = lambda e: ep.smoothen_edges(
                e, self.smoothen_k_size, self.smoothen_sigma
            )
        elif self.smoothen_method == "eincm_iedt":
            smoothen = lambda e: ep.eincm_inv_exp_dist_transform(
                e, self.iedt_alpha
            )
        elif self.smoothen_method == "rtef_iedt":
            smoothen = lambda e: ep.rtef_inv_exp_dist_transform(
                e, self.rtef_d_sat, None, self.rtef_formulation
            )
        else:
            raise ValueError(self.smoothen_method)

        return lambda images: ep.extract_edges(
            images,
            preprocess=self.enable_image_preprocessing,
            smoothen_fn=smoothen,
            canny_th1=self.canny_th1,
            canny_th2=self.canny_th2,
            canny_aperture=self.canny_aperture,
            preprocess_kwargs=self.preprocess_kwargs,
        )


@dataclass
class SolverSettings:
    """Reference: configs/main.yaml solver_params + pyramid settings."""

    n_pyr_lvls: int = 5
    pyramid_bases: Optional[Tuple[int, ...]] = None
    theta_miniter: int = 10
    theta_maxiter: int = 25
    handover_miniter: int = 5
    handover_maxiter: int = 15
    use_growing_maxiters: bool = True
    maxiters_grow_order: float = 1.0
    theta_gtol: float = 1e-4
    n_extra_attempts: Dict[int, int] = field(default_factory=dict)
    pyramid_upscale_method: str = "repeat"
    pyramid_downscale_method: str = "bilinear"
    scale_theta_to_sensor_size_method: str = "bilinear"
    # line-search evaluation budget; None resolves by line search (6 for
    # 'armijo', 10 for 'wolfe'); the armijo rescue's Wolfe re-solve pins
    # >= 10
    max_ls_evals: Optional[int] = None
    line_search: str = "armijo"  # 'armijo' | 'wolfe' (strong Wolfe)
    # quadratic-interpolated backtracking for 'armijo'
    armijo_interpolate: bool = False
    # noise-floor stop: end a level after theta_ftol_patience consecutive
    # iterations with relative loss improvement <= theta_ftol. The
    # experiment default; the library's SolverConfig default stays None
    theta_ftol: Optional[float] = 1e-5
    theta_ftol_patience: int = 2
    # armijo tail safeguard (serial path): a window whose level-0 optimum
    # ends worse than keeping the prior window's theta (or hit NaN) is
    # re-solved with strong Wolfe, and the better result kept
    armijo_rescue: bool = True
    # per-iteration (theta, loss) trajectories; phases.eval_intermediate
    # needs them
    collect_intermediate: bool = False
    # print each iteration's loss during a solve
    progress_heartbeat: bool = False
    # accepted and ignored: they choose between implementations of one
    # function in the JAX package, and the port has one of each
    splat_impl: str = "pallas_banded"
    splat_multiref_stacked: bool = False
    interp_impl: str = "pallas"
    scan_levels: bool = True

    def growing_maxiters(self, miniter: int, maxiter: int) -> Tuple[int, ...]:
        """Per-level iteration budgets: maxiter at the finest level (p=0),
        miniter at the coarsest (p=1). Reference: exp_mgr.py:169-187
        (`prepare_maxiters`)."""
        out = []
        for lvl in range(self.n_pyr_lvls):
            if self.n_pyr_lvls == 1:
                p = 0.0
            else:
                p = lvl / (self.n_pyr_lvls - 1)
            o = self.maxiters_grow_order
            if self.use_growing_maxiters:
                out.append(int(np.ceil(miniter * p**o + maxiter * (1 - p) ** o)))
            else:
                out.append(maxiter)
        return tuple(out)


@dataclass
class PhaseSettings:
    solve: bool = True
    eval: bool = True
    plot: bool = False
    n_repeat_solve: int = 1
    run_idx_range: Optional[Tuple[int, int]] = None
    # multiple [start, end) ranges (the reference's outdoor_day1 'split'
    # range mode, exp_mgr.py:261-265)
    run_idx_ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    # mid-sequence checkpoint cadence; 0 (or >= 100) disables
    checkpoint_every_percent: float = 25.0
    # parallel-mode super-step checkpointing cadence. None (default) keeps
    # the whole-sequence single-batch schedule. Enabling it changes the
    # parallel solve's numerics slightly, toward the sequential schedule:
    # each super-step's first window gets the previous super-step's exact
    # final theta as its prior (a knob of its own for that reason)
    parallel_checkpoint_every_percent: Optional[float] = None
    delete_checkpoints_at_end: bool = True
    run_from_checkpoint: Optional[str] = None
    # solve all windows over the window mesh (parallel/batch.py: the ranks
    # of the process group, or this process alone)
    parallel_windows: bool = False
    # 'two_pass': all windows without priors, then re-solved with the
    # neighbour's pass-1 result; 'sequence_shard': contiguous chunks per rank
    # with the exact in-chunk handover chain and a boundary prior exchange
    parallel_mode: str = "two_pass"
    # evaluate every recorded level-0 BFGS iterate during EVAL (reference
    # callbacks.py:140-149); needs solver.collect_intermediate
    eval_intermediate: bool = False
    # eager per-window EVAL/PLOT inside the solve loop (exp_mgr.py:646-656)
    # with their every-N gates; the standalone phases still run
    eager_eval: bool = False
    eager_eval_every: int = 1
    eager_plot: bool = False
    eager_plot_every: int = 1
    # the EVAL phase over the window mesh (no prior chain at eval time);
    # serial when eval_intermediate is set
    parallel_eval: bool = False
    # windows evaluated per rank per chunk (bounds device memory)
    parallel_eval_windows_per_device: int = 4


@dataclass
class ExperimentConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    edge: EdgeConfig = field(default_factory=EdgeConfig)
    solver: SolverSettings = field(default_factory=SolverSettings)
    handover: HandoverSettings = field(default_factory=HandoverSettings)
    phases: PhaseSettings = field(default_factory=PhaseSettings)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    alpha: float = 60.0
    beta: float = 60.0
    gamma: float = 0.0
    delta: float = 0.0
    output_dir: str = "outputs"
    experiment_name: str = "eincm"
    seed: int = 0
    # the JAX package's jax.config flags and XLA compilation cache: only
    # jax_enable_x64 and the cache are taken here, with no effect
    jax_config: Dict[str, Any] = field(default_factory=dict)
    # matplotlib rcParams applied before the PLOT phase (reference:
    # src/experiments/e00/__main__.py:29-31)
    mpl_rcparams: Dict[str, Any] = field(default_factory=dict)
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        self.check_runnable()

    def check_runnable(self):
        """Raise for settings the port does not run."""
        check_local_device_ids(self.distributed)
        others = [k for k in self.jax_config if k not in IGNORED_JAX_FLAGS]
        if others:
            raise NotImplementedError(
                f"jax_config: {', '.join(map(str, others))}: JAX flags other than "
                f"{', '.join(IGNORED_JAX_FLAGS)} have no meaning in the PyTorch port"
            )

    @property
    def loss_params(self) -> LossParams:
        return LossParams(self.alpha, self.beta, self.gamma, self.delta)

    def solver_config(self) -> SolverConfig:
        s = self.solver
        return SolverConfig(
            n_pyr_lvls=s.n_pyr_lvls,
            sensor_size=tuple(self.dataset.sensor_size),
            params=self.loss_params,
            theta_opt_maxiters=s.growing_maxiters(s.theta_miniter, s.theta_maxiter),
            handover_opt_maxiters=s.growing_maxiters(
                s.handover_miniter, s.handover_maxiter
            ),
            theta_gtol=s.theta_gtol,
            n_extra_attempts=dict(s.n_extra_attempts),
            pyramid_bases=(
                tuple(s.pyramid_bases) if s.pyramid_bases is not None else None
            ),
            pyramid_upscale_method=s.pyramid_upscale_method,
            pyramid_downscale_method=s.pyramid_downscale_method,
            scale_to_sensor_size_method=s.scale_theta_to_sensor_size_method,
            handover=self.handover,
            max_ls_evals=s.max_ls_evals,
            line_search=s.line_search,
            armijo_interpolate=s.armijo_interpolate,
            theta_ftol=s.theta_ftol,
            theta_ftol_patience=s.theta_ftol_patience,
            collect_intermediate=s.collect_intermediate
            or self.phases.eval_intermediate,
            progress_heartbeat=s.progress_heartbeat,
        )

    # ------------------------------------------------------------- serialize

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExperimentConfig":
        sub = {
            "dataset": DatasetConfig,
            "edge": EdgeConfig,
            "solver": SolverSettings,
            "handover": HandoverSettings,
            "phases": PhaseSettings,
            "distributed": DistributedConfig,
        }

        def build(tp, val):
            fields = {f.name for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in val.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {k!r} for {tp.__name__}")
                nested = sub.get(k) if tp is cls else None
                kwargs[k] = build(nested, v) if nested and isinstance(v, dict) else v
            return tp(**kwargs)

        return build(cls, d)


def _parse_value(s: str) -> Any:
    """An override's value as the JAX package reads it: `yaml.safe_load`,
    the raw string where that fails, and bare scientific notation ('1e-5',
    a string in YAML 1.1) recovered as a float."""
    try:
        v = yaml_lite.loads(s)
    except yaml_lite.YAMLSyntaxError:
        return s
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            pass
    return v


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply `a.b.c=value` style command-line overrides (hydra-like)."""
    d = cfg.to_dict()
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        val = _parse_value(raw)
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown config path {key!r}")
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key {key!r}")
        node[parts[-1]] = val
    return ExperimentConfig.from_dict(d)


def load_config(path: Optional[str] = None, overrides=()) -> ExperimentConfig:
    """Load a YAML config (or defaults) and apply overrides."""
    if path is None:
        cfg = ExperimentConfig()
    else:
        cfg = ExperimentConfig.from_dict(yaml_lite.load(path) or {})
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
