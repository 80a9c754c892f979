"""Shared benchmark workloads: the MVSEC-scale solve-latency harness, the
DSEC-scale solve and warp+splat throughput workloads, and the batched solve
over the window mesh.

Port of eincm_tpu/utils/benchmarks.py, with its names and constants. One
definition of each workload, so that the studies (`eincm_tpu_torch/
scripts/`), `utils/workloads.py` and `chip_smoke.py` can never drift apart.

Honesty of the workload: windows are staged from loaders whose ground-truth
velocity ROTATES by ``rotate_deg`` per window at constant speed. With a
constant-velocity sequence every window of the handover chain shares one
optimum, so from the second round on each solve would start at its
solution. With rotation, the prior entering window k is always
~``rotate_deg`` away from window k's optimum: every solve in every round
does the same bounded adaptation work, the sequential steady state on a
scene whose flow varies smoothly.

Reference tuning reproduced: run.sh:41-72 / configs/mvsec_indoor.yaml:
256x336 sensor, 30k events a window, 5 pyramid levels, growing maxiters
(40, 33, 25, 18, 10), gtol 1e-4, extra attempts at levels 0/1, the
handover weight solved at level 0, Armijo line search, 2 reference edge
maps (Canny + EINCM IEDT).

What differs from the JAX package:

- every `build_*` function takes `device` (keyword, default "cuda"; a CUDA device
  without CUDA raises, nothing falls back to the CPU);
- `interp_impl` and `splat_impl` select nothing: the port has one interp
  and one splat. The JAX package's names (xla, pallas, pallas_banded,
  pallas_banded2d, None) are accepted and ignored, any other raises;
- events are staged in loader order, as the port's experiments stage
  them. The JAX benches row-sort (MVSEC) or tile-sort (DSEC) them and pad
  to the banded kernels' chunk; the port's splat needs no event order, so
  it ports neither sort. The throughput bench draws the same seed-0
  uniform 1.5M events and keeps them in draw order;
- each `one_round` ends in one host read (`utils/host.py:to_host`), which
  waits for the queued work, so its clock covers the device's work.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from eincm_tpu_torch.utils import host

MVSEC_H, MVSEC_W = 256, 336
MVSEC_N_EVENTS = 30_000
_SPEED = 5.0  # |V| px per window

DSEC_H, DSEC_W = 480, 640
DSEC_N_EVENTS = 1_500_000
DSEC_N_REFS = 2
_DSEC_SPEED = 7.2  # |V| px per window
_DSEC_SEED = 3

# the JAX package's implementation names: each selects the port's one
# interp or splat
_IMPL_NAMES = (None, "xla", "pallas", "pallas_banded", "pallas_banded2d")


def _check_impl(what: str, name) -> None:
    if name not in _IMPL_NAMES:
        raise ValueError(f"unknown {what} {name!r}: the JAX package's names are "
                         f"{_IMPL_NAMES[1:]} (the port has one {what.split('_')[0]})")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"benchmark on {device}, but CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def _sync(t: torch.Tensor) -> float:
    """One host read of `t`'s sum: it waits for the work queued before it."""
    return host.to_host(t.sum())


def _default_edge_cfg():
    from eincm_tpu_torch.experiments.config import EdgeConfig

    return EdgeConfig(enable_image_preprocessing=False, smoothen_method="eincm_iedt")


def _staged_windows(sensor, n_events, n_features, speed, phi0, seeds, angles, edge_cfg,
                    device):
    """One synthetic window per (seed, angle): the loader's window 0 at
    velocity speed * (cos, sin)(phi0 + angle), staged on `device`."""
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader

    edge_fn = (_default_edge_cfg() if edge_cfg is None else edge_cfg).make_edge_fn()
    samples, vels = [], []
    for seed, angle in zip(seeds, angles):
        phi = phi0 + angle
        vel = (speed * np.cos(phi), speed * np.sin(phi))
        dl = SyntheticDataLoader(sensor_size=sensor, n_windows=1, des_n_events=n_events,
                                 velocity=vel, n_features=n_features, seed=seed)
        dl.get_ready()
        samples.append(stage_datasample(dl[0], device, edge_fn=edge_fn, preprocess=False,
                                        pad_to=n_events))
        vels.append(vel)
    return samples, vels


def stage_mvsec_samples(indices: Sequence[int], rotate_deg: float = 15.0, edge_cfg=None,
                        *, device="cuda"):
    """The MVSEC-scale windows `indices` of the rotating sequence (window k:
    seed 1 + k, 180 features, GT velocity rotated k * rotate_deg from the
    (4, -3) direction at |V| = 5 px), as StagedSamples on `device`.

    Returns (staged samples, exact GT velocities (vx, vy))."""
    return _staged_windows(
        (MVSEC_H, MVSEC_W), MVSEC_N_EVENTS, 180, _SPEED, np.arctan2(-3.0, 4.0),
        [1 + k for k in indices], [np.deg2rad(rotate_deg) * k for k in indices],
        edge_cfg, _device(device))


def stage_mvsec_windows(n_windows: int = 6, rotate_deg: float = 15.0, edge_cfg=None, *,
                        device="cuda"):
    """Stage ``n_windows`` MVSEC-scale windows whose GT velocity rotates
    ``rotate_deg`` per window at constant speed (see module docstring).

    ``edge_cfg`` (an `experiments.config.EdgeConfig`, or anything with
    `make_edge_fn()`) overrides the default Canny + IEDT edges: the
    edge-sensitivity study perturbs it (`scripts/edge_sensitivity.py`).

    Returns (staged windows, exact GT velocities (vx, vy))."""
    samples, vels = stage_mvsec_samples(range(n_windows), rotate_deg, edge_cfg, device=device)
    return [s.window for s in samples], vels


def stage_dsec_samples(n_windows: int = 4, rotate_deg: float = 15.0, *, device="cuda"):
    """The DSEC-scale windows of `build_dsec_solve_bench` (window k: seed
    3 + k, 700 features, 1.5M events, GT velocity rotated k * rotate_deg from
    the (6, -4) direction at |V| = 7.2 px), as StagedSamples on `device`.

    Returns (staged samples, exact GT velocities (vx, vy))."""
    return _staged_windows(
        (DSEC_H, DSEC_W), DSEC_N_EVENTS, 700, _DSEC_SPEED, np.arctan2(-4.0, 6.0),
        [_DSEC_SEED + k for k in range(n_windows)],
        [np.deg2rad(rotate_deg) * k for k in range(n_windows)], None, _device(device))


def mvsec_config_kwargs() -> Dict:
    """The MVSEC tuning's SolverConfig fields, with the shipped experiment
    default theta_ftol=1e-5 (override {"theta_ftol": None} for the
    reference's retry semantics)."""
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.models.pyramid import HandoverSettings

    return dict(
        n_pyr_lvls=5,
        sensor_size=(MVSEC_H, MVSEC_W),
        params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(40, 33, 25, 18, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1, 1: 1},
        handover=HandoverSettings(use_handover=True, solve_handover_for_levels=(0,)),
        theta_ftol=1e-5,
    )


def dsec_config_kwargs() -> Dict:
    """The DSEC production tuning's SolverConfig fields (run.sh:99-121:
    alpha 2000, beta 4000, the MVSEC schedule otherwise)."""
    from eincm_tpu_torch.models.loss import LossParams

    kw = mvsec_config_kwargs()
    kw.update(sensor_size=(DSEC_H, DSEC_W),
              params=LossParams(alpha=2000.0, beta=4000.0, gamma=0.0, delta=0.0))
    return kw


def _config(kwargs: Dict, solver_overrides: Optional[Dict]):
    from eincm_tpu_torch.models.pyramid import SolverConfig

    # overrides REPLACE base fields
    kwargs.update(solver_overrides or {})
    return SolverConfig(**kwargs)


def _chain_bench(windows: List, cfg, device):
    """(one_round, warmup result) of a handover chain over `windows`:
    window 0 solved once as the seed, window 1 once more as the warmup;
    each round solves windows 1.. from the same seed and returns seconds
    per window."""
    from eincm_tpu_torch.models.pyramid import make_window_solver

    solver = make_window_solver(cfg, device)
    res0 = solver(windows[0], cfg.zero_pyramid(device=device), is_first=True)
    _sync(res0.final_theta_pyr[0])
    res = solver(windows[1], res0.final_theta_pyr, is_first=False)
    _sync(res.final_theta_pyr[0])
    seed_pyr = res0.final_theta_pyr
    n = len(windows)

    def one_round() -> float:
        prior = seed_pyr
        t0 = time.perf_counter()
        for k in range(1, n):
            prior = solver(windows[k], prior, is_first=False).final_theta_pyr
        _sync(prior[0])  # one read per round
        return (time.perf_counter() - t0) / (n - 1)

    return one_round, res


def build_mvsec_solve_bench(
    interp_impl: Optional[str] = None,
    rotate_deg: float = 15.0,
    n_windows: int = 6,
    solver_overrides: Optional[Dict] = None,
    *,
    device="cuda",
):
    """Build the chained-window solve benchmark.

    Returns ``(one_round, res)`` where ``one_round()`` solves windows
    1..n_windows-1 as a handover chain seeded from window 0's solved
    result (one host read per round) and returns seconds per window;
    ``res`` is the warmup window's SolveResult for diagnostics.

    Every round re-runs the SAME chain from the SAME seed, so each measured
    solve's prior is always exactly ``rotate_deg`` away from its optimum.
    ``solver_overrides`` are extra SolverConfig fields for paired A/Bs of
    solver knobs (e.g. ``{"armijo_interpolate": True}``).
    """
    _check_impl("interp_impl", interp_impl)
    device = _device(device)
    staged, _ = stage_mvsec_windows(n_windows, rotate_deg, device=device)
    return _chain_bench(staged, _config(mvsec_config_kwargs(), solver_overrides), device)


def build_parallel_solve_bench(
    n_windows: int = 8,
    rotate_deg: float = 15.0,
    solver_overrides: Optional[Dict] = None,
    *,
    device="cuda",
):
    """The batched solve through the data-parallel path
    (`parallel/batch.py:solve_window_batch_sharded`, first-sample
    semantics: the parallel schedules' pass 1) on a mesh of
    `process_count()` ranks shrunk until it divides ``n_windows``: one rank
    solves all windows one after another; over several, each member its
    chunk, and the other ranks take the whole result.

    Windows are the MVSEC solve bench's (rotating GT velocity); each rank
    stages only its own. Returns ``(one_round, res)``: ``one_round()`` ->
    seconds per window, ``res`` the batched warmup result.
    """
    from eincm_tpu_torch.parallel.batch import (
        make_window_mesh,
        solve_window_batch_sharded,
        stack_windows,
    )
    from eincm_tpu_torch.parallel.distributed import process_count

    device = _device(device)
    n_dev = process_count()
    while n_windows % n_dev:
        n_dev -= 1
    mesh = make_window_mesh(n_dev, device=device)
    chunk = n_windows // mesh.size
    batch = None
    if mesh.member:
        mine = range(mesh.rank * chunk, (mesh.rank + 1) * chunk)
        samples, _ = stage_mvsec_samples(mine, rotate_deg, device=device)
        batch = stack_windows([s.window for s in samples])
    cfg = _config(mvsec_config_kwargs(), solver_overrides)

    res = solve_window_batch_sharded(cfg, batch, mesh, is_first=True)
    _sync(res.final_theta_pyr[0])

    def one_round() -> float:
        t0 = time.perf_counter()
        r = solve_window_batch_sharded(cfg, batch, mesh, is_first=True)
        _sync(r.final_theta_pyr[0])
        return (time.perf_counter() - t0) / n_windows

    one_round.mesh = mesh
    return one_round, res


def build_dsec_solve_bench(
    n_windows: int = 4,
    rotate_deg: float = 15.0,
    splat_impl: str = "pallas_banded2d",
    solver_overrides: Optional[Dict] = None,
    *,
    device="cuda",
):
    """Build the DSEC-scale chained-window solve benchmark (full production
    tuning, run.sh:99-121: 480x640, 1.5M events a window, alpha=2000
    beta=4000, growing maxiters 40..10, extra attempts at levels 0/1,
    handover solved at level 0).

    Same steady-state rationale as the MVSEC harness (module docstring).
    Returns ``(one_round, res)`` where ``one_round()`` solves windows
    1..n_windows-1 as a handover chain from window 0's solved seed and
    returns seconds per window.
    """
    _check_impl("splat_impl", splat_impl)
    device = _device(device)
    samples, _ = stage_dsec_samples(n_windows, rotate_deg, device=device)
    return _chain_bench([s.window for s in samples],
                        _config(dsec_config_kwargs(), solver_overrides), device)


def throughput_inputs(device) -> Dict[str, torch.Tensor]:
    """The throughput bench's inputs: 1.5M uniform integer events at
    480x640 drawn from seed 0 (draw order), 2 reference times, theta
    N(0, 4) on 16x16 cells."""
    h, w = DSEC_H, DSEC_W
    rng = np.random.default_rng(0)
    xs = rng.integers(0, w, DSEC_N_EVENTS).astype(np.float32)
    ys = rng.integers(0, h, DSEC_N_EVENTS).astype(np.float32)
    ts = rng.uniform(0, 1, DSEC_N_EVENTS).astype(np.float32)
    t_refs = np.linspace(0, 1, DSEC_N_REFS).astype(np.float32)
    theta = rng.normal(0, 4, (16, 16, 2)).astype(np.float32)
    return {k: torch.as_tensor(v, device=device)
            for k, v in dict(xs=xs, ys=ys, ts=ts, t_refs=t_refs, theta=theta).items()}


def warp_splat(inp: Dict[str, torch.Tensor], seed: float) -> torch.Tensor:
    """One iteration of the throughput workload: coarse theta -> bilinear
    interp + warp to each reference -> IWE splat; the IWEs' sum. `seed`
    shifts the warped xs by seed * 1e-6 px, as the JAX bench does."""
    from eincm_tpu_torch.ops.splat import splat_multi_ref
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    wx, wy = warp_events_multi_ref_coarse(inp["theta"], inp["xs"], inp["ys"], inp["ts"],
                                          inp["t_refs"], (DSEC_H, DSEC_W))
    return splat_multi_ref(wx + seed * 1e-6, wy, (DSEC_H, DSEC_W)).sum()


def build_dsec_throughput_bench(
    interp_impl: Optional[str] = None,
    splat_impl: str = "pallas_banded2d",
    *,
    device="cuda",
):
    """Build the DSEC-scale warp+splat throughput workload: 480x640
    sensor, 1.5M events, 2 reference times (run.sh:99-121
    des_n_events=1500000), the solver's hot path: coarse theta -> bilinear
    interp + warp -> splat per reference.

    Returns ``one_round()`` -> seconds per warp+splat iteration (10
    iterations, one host read). Events per iteration = DSEC_N_EVENTS *
    DSEC_N_REFS.
    """
    _check_impl("interp_impl", interp_impl)
    _check_impl("splat_impl", splat_impl)
    inp = throughput_inputs(_device(device))
    with torch.no_grad():
        _sync(warp_splat(inp, 0.0))

    @torch.no_grad()
    def one_round() -> float:
        iters = 10
        t0 = time.perf_counter()
        acc = torch.zeros((), device=inp["xs"].device)
        for i in range(iters):
            acc = acc + warp_splat(inp, float(i))
        _sync(acc)  # one read per round
        return (time.perf_counter() - t0) / iters

    return one_round


def solve_diag_str(res) -> str:
    """One-line diagnostic proving the measured windows do real work.

    `total_iters` counts across retry attempts, the honest iteration count
    (`iter_num` alone is the LAST attempt only: at the shipped tuning the
    first attempt at levels 0/1 often exhausts maxiter and the extra-attempt
    retry fires, reference src/eincm/solver.py:218-239). A batched result
    (`build_parallel_solve_bench`) reports its first window.
    """
    states = res.theta_opt_states
    first = lambda v: v.reshape(-1)[0].item() if isinstance(v, torch.Tensor) else v
    iters = [int(first(s.total_iters)) for s in states]
    attempts = [int(first(s.n_attempts)) for s in states]
    probes = sum(int(first(s.n_fun_evals)) - int(first(s.total_iters)) for s in states)
    th0 = res.final_theta_pyr[0]
    th0 = th0.reshape(-1, *th0.shape[-3:])[0].detach().cpu().numpy().reshape(-1, 2).mean(0)
    return (
        f"total_iters/level={iters} (sum {sum(iters)}) "
        f"attempts/level={attempts} ls_probes={probes} "
        f"f0={float(first(states[0].fun_val)):.4f} "
        f"theta0_mean={th0}"
    )
