"""Verification drive: a full pyramid solve on synthetic events.

    python -m eincm_tpu_torch.examples.synthetic_recovery [--device cuda]

The port of examples/synthetic_recovery.py: dots moving with a constant
velocity V, edge maps splatted from the dots' positions at t = 0 and 1, a
5-level solve of the window (first-sample semantics) and of the same
window again with its result as the prior (handover at level 0). Prints
the solve times, each level's BFGS state, the level-0 theta's mean against
V and the AEE at the event pixels of the upscaled flow. Runs on the CUDA
device by default (the hand-written kernels); `--device cpu` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import (
    HandoverSettings,
    SolverConfig,
    WindowSample,
    make_window_solver,
)
from eincm_tpu_torch.ops.filters import gaussian_blur_3x3
from eincm_tpu_torch.ops.normalize import normalize_to_unit_range
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.ops.splat import events_to_pdf_frame

H = W = 64
V = np.array([3.0, -2.0])  # px per unit time (x, y)


def make_window(device, seed=7, n_feat=60, n_ev=8192):
    """(WindowSample on `device`, event xs, event ys) of the dot scene."""
    rng = np.random.default_rng(seed)
    feat = rng.uniform(8, 48, size=(n_feat, 2))  # (x0, y0)
    ts = rng.uniform(0, 1, n_ev).astype(np.float32)
    which = rng.integers(0, n_feat, n_ev)
    xs = np.round(feat[which, 0] + V[0] * ts).astype(np.float32)  # integer pixels
    ys = np.round(feat[which, 1] + V[1] * ts).astype(np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def edge_map(t):
        m = events_to_pdf_frame(f32(feat[:, 0] + V[0] * t), f32(feat[:, 1] + V[1] * t), (H, W))
        return normalize_to_unit_range(gaussian_blur_3x3(m))

    sample = WindowSample(
        xs=f32(xs), ys=f32(ys), ts=f32(ts),
        edges=torch.stack([edge_map(0.0), edge_map(1.0)]),
        edge_ts=f32([0.0, 1.0]),
    )
    return sample, xs, ys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))

    sample, xs, ys = make_window(device)
    cfg = SolverConfig(
        n_pyr_lvls=5,
        sensor_size=(H, W),
        params=LossParams(alpha=60.0, beta=0.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(25, 20, 15, 10, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1},
        handover=HandoverSettings(use_handover=True, solve_handover_for_levels=(0,)),
    )
    solver = make_window_solver(cfg, device)

    def timed(prior, is_first):
        t0 = time.perf_counter()
        res = solver(sample, prior, is_first)
        float(res.final_theta_pyr[0].sum())  # the solve is done on the host's clock
        return res, time.perf_counter() - t0

    res, t1 = timed(cfg.zero_pyramid(device=device), True)
    print(f"first-window solve (incl. kernel build): {t1:.2f}s")
    res2, t2 = timed(res.final_theta_pyr, False)
    print(f"second-window solve (with handover): {t2:.2f}s")

    theta0 = res.final_theta_pyr[0].cpu().numpy()  # (16, 16, 2) coarse field
    print("level-0 theta mean:", theta0.reshape(-1, 2).mean(0), " GT:", V)
    for lvl, st in enumerate(res.theta_opt_states):
        print(f"  lvl{lvl}: iters={st.iter_num} f={float(st.fun_val):.4f} "
              f"success={st.success} status={st.status} nev={st.n_fun_evals}")

    full = scale_theta_to_sensor_size(res.final_theta_pyr[0], (H, W)).cpu().numpy()
    err = np.linalg.norm(full[ys.astype(int), xs.astype(int)] - V[None, :], axis=-1)
    aee = float(err.mean())
    print(f"AEE at event pixels: {aee:.3f} px  (|V| = {np.linalg.norm(V):.2f})")
    print("handover weights:", [float(w) for w in res2.final_handover_weights])
    return aee


if __name__ == "__main__":
    main()
