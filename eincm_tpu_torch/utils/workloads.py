"""Shared workloads: the MVSEC-scale handover chain and a DSEC-scale window.

The same workloads as eincm_tpu/utils/benchmarks.py. The MVSEC chain
reproduces the reference tuning (run.sh:41-72, configs/mvsec_indoor.yaml):
256x336 sensor, 30k events per window, 5 pyramid levels with growing
maxiters (40, 33, 25, 18, 10), gtol 1e-4, extra attempts at levels 0/1,
the handover weight solved at level 0, Canny + EINCM-IEDT edges of 2
reference frames. The ground-truth velocity rotates by MVSEC_ROTATE_DEG
per window at constant speed, so every solve in the chain starts that far
from its optimum: the steady state of a scene whose flow drifts.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

from eincm_tpu_torch.data.staging import StagedSample, stage_datasample
from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
from eincm_tpu_torch.edge.pipeline import iedt_edge_fn
from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import (
    HandoverSettings,
    SolveResult,
    SolverConfig,
    WindowSample,
)
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.ops.splat import make_event_mask

MVSEC_H, MVSEC_W = 256, 336
MVSEC_N_EVENTS = 30_000
MVSEC_N_WINDOWS = 6
MVSEC_ROTATE_DEG = 15.0
_SPEED = 5.0  # |V| px per window

DSEC_H, DSEC_W = 480, 640
DSEC_N_EVENTS = 1_500_000
DSEC_SEED = 3


def stage_mvsec_samples(
    device,
) -> Tuple[List[StagedSample], List[Tuple[float, float]]]:
    """Stage the MVSEC_N_WINDOWS windows of the chain (seeds 1..6, 180
    features) whose GT velocity rotates MVSEC_ROTATE_DEG per window.

    Returns (staged samples, their windows on `device`; exact GT
    velocities (vx, vy))."""
    phi0 = np.arctan2(-3.0, 4.0)
    edge_fn = iedt_edge_fn()
    samples, vels = [], []
    for k in range(MVSEC_N_WINDOWS):
        phi = phi0 + np.deg2rad(MVSEC_ROTATE_DEG) * k
        vel = (_SPEED * np.cos(phi), _SPEED * np.sin(phi))
        dl = SyntheticDataLoader(
            sensor_size=(MVSEC_H, MVSEC_W),
            n_windows=1,
            des_n_events=MVSEC_N_EVENTS,
            velocity=vel,
            n_features=180,
            seed=1 + k,
        )
        dl.get_ready()
        samples.append(
            stage_datasample(dl[0], device, edge_fn=edge_fn, pad_to=MVSEC_N_EVENTS)
        )
        vels.append(vel)
    return samples, vels


def stage_mvsec_windows(
    device,
) -> Tuple[List[WindowSample], List[Tuple[float, float]]]:
    """`stage_mvsec_samples`' windows on `device` and GT velocities."""
    samples, vels = stage_mvsec_samples(device)
    return [s.window for s in samples], vels


def mvsec_solver_config() -> SolverConfig:
    """The MVSEC tuning of eincm_tpu/utils/benchmarks.py, with the shipped
    experiment default theta_ftol=1e-5."""
    return SolverConfig(
        n_pyr_lvls=5,
        sensor_size=(MVSEC_H, MVSEC_W),
        params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(40, 33, 25, 18, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1, 1: 1},
        handover=HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0,)
        ),
        theta_ftol=1e-5,
    )


def stage_dsec_sample(device) -> StagedSample:
    """One DSEC-scale window: 480x640, 1.5M events on 700 features, 2
    reference frames (eincm_tpu/utils/benchmarks.py:build_dsec_solve_bench)."""
    speed = 7.2
    phi = np.arctan2(-4.0, 6.0)
    dl = SyntheticDataLoader(
        sensor_size=(DSEC_H, DSEC_W),
        n_windows=1,
        des_n_events=DSEC_N_EVENTS,
        velocity=(speed * np.cos(phi), speed * np.sin(phi)),
        n_features=700,
        seed=DSEC_SEED,
    )
    dl.get_ready()
    return stage_datasample(
        dl[0], device, edge_fn=iedt_edge_fn(), pad_to=DSEC_N_EVENTS
    )


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
