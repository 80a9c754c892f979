"""Shared workloads: the MVSEC-scale handover chain and a DSEC-scale window.

The workloads of `utils/benchmarks.py` (the port of eincm_tpu/utils/
benchmarks.py, which defines them) with their knobs fixed: the MVSEC chain
is MVSEC_N_WINDOWS windows rotating MVSEC_ROTATE_DEG per window, the DSEC
window that bench's window 0. The MVSEC chain reproduces the reference
tuning (run.sh:41-72, configs/mvsec_indoor.yaml): 256x336 sensor, 30k
events per window, 5 pyramid levels with growing maxiters (40, 33, 25, 18,
10), gtol 1e-4, extra attempts at levels 0/1, the handover weight solved at
level 0, Canny + EINCM-IEDT edges of 2 reference frames. Every solve in the
chain starts MVSEC_ROTATE_DEG from its optimum: the steady state of a scene
whose flow drifts.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Tuple

import torch

from eincm_tpu_torch.data.staging import StagedSample
from eincm_tpu_torch.models.pyramid import SolveResult, SolverConfig, WindowSample
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.ops.splat import make_event_mask
from eincm_tpu_torch.utils import benchmarks
from eincm_tpu_torch.utils.benchmarks import (  # noqa: F401  (re-exported)
    DSEC_H,
    DSEC_N_EVENTS,
    DSEC_W,
    MVSEC_H,
    MVSEC_N_EVENTS,
    MVSEC_W,
)

MVSEC_N_WINDOWS = 6
MVSEC_ROTATE_DEG = 15.0


def stage_mvsec_samples(
    device,
) -> Tuple[List[StagedSample], List[Tuple[float, float]]]:
    """Stage the MVSEC_N_WINDOWS windows of the chain (seeds 1..6, 180
    features) whose GT velocity rotates MVSEC_ROTATE_DEG per window.

    Returns (staged samples, their windows on `device`; exact GT
    velocities (vx, vy))."""
    return benchmarks.stage_mvsec_samples(range(MVSEC_N_WINDOWS), MVSEC_ROTATE_DEG,
                                          device=device)


def stage_mvsec_windows(
    device,
) -> Tuple[List[WindowSample], List[Tuple[float, float]]]:
    """`stage_mvsec_samples`' windows on `device` and GT velocities."""
    samples, vels = stage_mvsec_samples(device)
    return [s.window for s in samples], vels


def mvsec_solver_config() -> SolverConfig:
    """The MVSEC tuning of `utils/benchmarks.py`, with the shipped
    experiment default theta_ftol=1e-5."""
    return SolverConfig(**benchmarks.mvsec_config_kwargs())


def stage_dsec_sample(device) -> StagedSample:
    """One DSEC-scale window: 480x640, 1.5M events on 700 features, 2
    reference frames (`benchmarks.build_dsec_solve_bench`'s window 0)."""
    samples, _ = benchmarks.stage_dsec_samples(1, device=device)
    return samples[0]


def stage_dsec_window(device) -> WindowSample:
    """`stage_dsec_sample`'s window on `device`."""
    return stage_dsec_sample(device).window


@torch.no_grad()
def aee_at_events(
    theta0: torch.Tensor,
    sample: WindowSample,
    velocity: Tuple[float, float],
    sensor_size: Tuple[int, int],
) -> float:
    """Mean endpoint error at pixels with events between the level-0 theta
    scaled to the sensor and the window's constant GT velocity (px)."""
    flow = scale_theta_to_sensor_size(theta0, sensor_size, "bilinear")
    gt = torch.tensor(velocity, dtype=flow.dtype, device=flow.device)
    epe = torch.linalg.norm(flow - gt, dim=-1)
    mask = make_event_mask(sample.xs, sample.ys, sensor_size)
    return float(epe[mask].mean())


def solve_chain(
    solver, cfg: SolverConfig, windows: List[WindowSample], vels
) -> Iterator[Tuple[SolveResult, dict]]:
    """Solve `windows` as one handover chain from a zero prior, window 0 as
    the first window. Yields each window's result and a record of it: wall
    ms (host clock, ending in a device sync), AEE, the AEE of its prior kept
    as it came (the stale-prior control), per-level iterations and
    statuses, loss evaluations, host syncs and the level-0 handover weight."""
    device = windows[0].xs.device
    prior = cfg.zero_pyramid(device=device)
    for k, (window, vel) in enumerate(zip(windows, vels)):
        prior_aee = aee_at_events(prior[0], window, vel, cfg.sensor_size)
        _sync(device)
        t0 = time.perf_counter()
        res = solver(window, prior, is_first=(k == 0))
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        prior = res.final_theta_pyr
        states = res.theta_opt_states
        yield res, {
            "window": k,
            "ms": ms,
            "aee": aee_at_events(prior[0], window, vel, cfg.sensor_size),
            "prior_aee": prior_aee,
            "iters": [s.total_iters for s in states],
            "statuses": [s.status for s in states],
            "evals": sum(s.n_fun_evals for s in states),
            "host_syncs": res.n_host_syncs,
            "w0": float(res.final_handover_weights[0]),
        }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
