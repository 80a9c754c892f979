"""Probe: does quadratic-interpolated Armijo backtracking cut probe count?

Port of scripts/armijo_interp_probe.py. Plain halving shrinks alpha 2x per
failed probe; scipy's `scalar_search_armijo` jumps to the minimizer of the
quadratic through (0, f0), slope dphi0 and the failed (alpha, f), shrinking
up to 10x when badly overshot. Fewer probes are fewer forward passes, IF
the accepted steps stay as good (same final loss and iteration count).

Protocol (paired, MVSEC scale, rotating-velocity windows, level-0 chains,
the harness of hessian_warmstart_probe.py): solve each window from the
SAME init (the previous baseline solution) with halving (H) and with
interpolated (Q) backtracking; compare iterations, loss evaluations, final
loss and wall clock; on the card also the full-pyramid window solve of the
MVSEC bench with each.

    python -m eincm_tpu_torch.scripts.armijo_interp_probe [--device cuda] [--out FILE]

Prints the JAX script's table, then one JSON line (`windows`: one record a
window with the table's columns). Readings on the H100: PERF.md.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

N_WINDOWS = 6
MAXITER = 40
GTOL = 1e-4


def probe_config(maxiter: int = MAXITER):
    """The JAX script's SolverConfig: MVSEC tuning, `maxiter` at every level."""
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.models.pyramid import SolverConfig
    from eincm_tpu_torch.utils.benchmarks import MVSEC_H, MVSEC_W

    return SolverConfig(
        n_pyr_lvls=5,
        sensor_size=(MVSEC_H, MVSEC_W),
        params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(maxiter,) * 5,
    )


def level0_objective(cfg, sample, wstat):
    """flat theta -> the level-0 solver_loss of `sample`."""
    from eincm_tpu_torch.models.loss import solver_loss

    shape = (*cfg.level_shape(0), 2)
    statics = cfg.loss_statics

    def fun_only(flat):
        return solver_loss(flat.reshape(shape), sample.xs, sample.ys, sample.ts, sample.edges,
                           sample.edge_ts, cfg.params, 0, statics, wstat)

    return fun_only


def solve_lvl0(cfg, x0, sample, wstat, interp, *, maxiter=MAXITER, gtol=GTOL):
    """One level-0 Armijo BFGS solve from `x0`, halving or interpolated."""
    from eincm_tpu_torch.models.bfgs import minimize_bfgs, value_and_grad

    fun_only = level0_objective(cfg, sample, wstat)
    return minimize_bfgs(
        value_and_grad(fun_only), x0, maxiter=maxiter, gtol=gtol,
        max_ls_evals=cfg.max_ls_evals, line_search="armijo", fun=fun_only,
        armijo_interpolate=interp,
    )


def probe(*, device="cuda", n_windows=N_WINDOWS, maxiter=MAXITER, gtol=GTOL, rounds=3,
          full_bench: Optional[bool] = None, bench_rounds=5,
          solver_overrides: Optional[Dict] = None) -> Dict:
    """The JAX script's protocol; prints its table and returns the JSON
    line's dict. `full_bench` (default: on the card) adds the MVSEC
    bench's window solve with each backtracking (`solver_overrides` go to
    that bench)."""
    from eincm_tpu_torch.models.loss import compute_window_statics
    from eincm_tpu_torch.utils import host
    from eincm_tpu_torch.utils.benchmarks import (
        MVSEC_H,
        MVSEC_W,
        build_mvsec_solve_bench,
        solve_diag_str,
        stage_mvsec_windows,
    )

    cfg = probe_config(maxiter)
    d = int(np.prod(cfg.level_shape(0))) * 2
    staged, _ = stage_mvsec_windows(n_windows, rotate_deg=15.0, device=device)
    dev = staged[0].xs.device
    wstats = [compute_window_statics(s.xs, s.ys, s.edges, cfg.sensor_size) for s in staged]
    solve = lambda x0, k, interp: solve_lvl0(cfg, x0, staged[k], wstats[k], interp,
                                             maxiter=maxiter, gtol=gtol)

    # the baseline chain defines the shared inits
    base = []
    x = torch.zeros((d,), dtype=staged[0].xs.dtype, device=dev)
    for k in range(n_windows):
        r = solve(x, k, False)
        base.append(r)
        x = r.x

    print(f"# lvl-0 armijo halving (H) vs interpolated (Q), {MVSEC_H}x{MVSEC_W}, "
          f"{staged[0].xs.shape[0]} events, gtol {gtol}, maxiter {maxiter}, "
          f"15 deg/window rotation")
    print(f"{'win':>3} {'it_H':>5} {'ev_H':>5} {'it_Q':>5} {'ev_Q':>5} "
          f"{'f_H':>12} {'f_Q':>12} {'dtheta_max':>10}")
    rows = []
    tot = np.zeros(4, np.int64)
    for k in range(1, n_windows):
        r_h = base[k]
        r_q = solve(base[k - 1].x, k, True)
        dth = host.to_host((r_q.x - r_h.x).abs().max())
        row = {"win": k, "it_H": int(r_h.total_iters), "ev_H": int(r_h.n_fun_evals),
               "it_Q": int(r_q.total_iters), "ev_Q": int(r_q.n_fun_evals),
               "f_H": float(r_h.fun_val), "f_Q": float(r_q.fun_val), "dtheta_max": dth}
        rows.append(row)
        print(f"{k:>3} {row['it_H']:>5} {row['ev_H']:>5} {row['it_Q']:>5} {row['ev_Q']:>5} "
              f"{row['f_H']:>12.6f} {row['f_Q']:>12.6f} {dth:>10.4f}")
        tot += [row["it_H"], row["ev_H"], row["it_Q"], row["ev_Q"]]
    pct = lambda a, b: 100 * (b - a) / max(a, 1)
    print(f"TOT iters H={tot[0]} Q={tot[2]} ({pct(tot[0], tot[2]):+.0f}%)  "
          f"evals H={tot[1]} Q={tot[3]} ({pct(tot[1], tot[3]):+.0f}%)")
    out = {"windows": rows, "tot": {"iters_H": int(tot[0]), "iters_Q": int(tot[2]),
                                    "evals_H": int(tot[1]), "evals_Q": int(tot[3])}}

    # paired wall clock over the chain (one read per pass)
    for tag, interp in (("halving", False), ("interp", True)):
        samples = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            xx = base[0].x
            for k in range(1, n_windows):
                xx = solve(xx, k, interp).x
            host.to_host(xx.sum())
            samples.append((time.perf_counter() - t0) / (n_windows - 1))
        out[f"lvl0_chain_p50_ms_{tag}"] = float(np.median(samples)) * 1e3
        print(f"lvl0 chain {tag}: p50 {out[f'lvl0_chain_p50_ms_{tag}']:.1f} ms/window")

    # the full-pyramid window solve on the MVSEC bench workload
    if full_bench if full_bench is not None else dev.type == "cuda":
        for tag, interp in (("halving", False), ("interp", True)):
            one_round, res = build_mvsec_solve_bench(
                n_windows=n_windows,
                solver_overrides={**(solver_overrides or {}), "armijo_interpolate": interp},
                device=dev)
            samples = sorted(one_round() for _ in range(bench_rounds))
            out[f"window_solve_p50_ms_{tag}"] = float(np.median(samples)) * 1e3
            out[f"window_solve_best_ms_{tag}"] = samples[0] * 1e3
            print(f"window solve {tag}: p50 {out[f'window_solve_p50_ms_{tag}']:.1f} ms "
                  f"(best {samples[0] * 1e3:.1f})  [{solve_diag_str(res)}]")
    return out


def main(argv=None):
    from eincm_tpu_torch.scripts.armijo_rescue_validation import parse_args, print_json

    args = parse_args(argv, __doc__, None)
    print_json(probe(device=args.device), args.out)


if __name__ == "__main__":
    main()
