"""Probe: is the BFGS inverse Hessian transferable across event windows?

Port of scripts/hessian_warmstart_probe.py. A sequential solve chains
windows through the theta prior, but every window's BFGS restarts from
H = I. If the loss curvature at the optimum is similar window to window,
warm-starting H from the previous window's final inverse Hessian could cut
iterations (`minimize_bfgs(h0=..., return_h_inv=True)`).

Protocol (paired, MVSEC scale, rotating-velocity windows): solve the
level-0 objective of each window k from the SAME init (window k-1's
baseline solution) twice, H0 = I (I) and H0 = window k-1's final H (H),
and compare iterations, loss evaluations and final loss; then the wall
clock of both chains.

    python -m eincm_tpu_torch.scripts.hessian_warmstart_probe [--device cuda] [--out FILE]

Prints the JAX script's table, then one JSON line (`windows`: one record a
window with the table's columns). Readings on the H100: PERF.md.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from eincm_tpu_torch.scripts.armijo_interp_probe import level0_objective, probe_config

N_WINDOWS = 6
MAXITER = 40
GTOL = 1e-4
LINE_SEARCH = "armijo"  # shipped default


def solve_lvl0(cfg, x0, h0, sample, wstat, *, maxiter=MAXITER, gtol=GTOL,
               line_search=LINE_SEARCH):
    """One level-0 BFGS solve from (x0, H0): (result, final inverse Hessian)."""
    from eincm_tpu_torch.models.bfgs import minimize_bfgs, value_and_grad

    fun_only = level0_objective(cfg, sample, wstat)
    return minimize_bfgs(
        value_and_grad(fun_only), x0, maxiter=maxiter, gtol=gtol,
        max_ls_evals=cfg.max_ls_evals, line_search=line_search, fun=fun_only,
        h0=h0, return_h_inv=True,
    )


def probe(*, device="cuda", n_windows=N_WINDOWS, maxiter=MAXITER, gtol=GTOL,
          rounds=3) -> Dict:
    """The JAX script's protocol; prints its table and returns the JSON
    line's dict."""
    from eincm_tpu_torch.models.loss import compute_window_statics
    from eincm_tpu_torch.utils import host
    from eincm_tpu_torch.utils.benchmarks import MVSEC_H, MVSEC_W, stage_mvsec_windows

    cfg = probe_config(maxiter)
    d = int(np.prod(cfg.level_shape(0))) * 2
    staged, _ = stage_mvsec_windows(n_windows, rotate_deg=15.0, device=device)
    dev, dt = staged[0].xs.device, staged[0].xs.dtype
    wstats = [compute_window_statics(s.xs, s.ys, s.edges, cfg.sensor_size) for s in staged]
    solve = lambda x0, h0, k: solve_lvl0(cfg, x0, h0, staged[k], wstats[k], maxiter=maxiter,
                                         gtol=gtol)
    eye = torch.eye(d, dtype=dt, device=dev)

    # the baseline chain: each window from the previous baseline solution, H = I
    base_res, base_h = [], []
    x = torch.zeros((d,), dtype=dt, device=dev)
    for k in range(n_windows):
        r, h = solve(x, eye, k)
        base_res.append(r)
        base_h.append(h)
        x = r.x

    # the warm variant: same inits, H0 = the previous window's final inverse Hessian
    print(f"# lvl-0 {LINE_SEARCH} solves, {MVSEC_H}x{MVSEC_W}, {staged[0].xs.shape[0]} "
          f"events, gtol {gtol}, maxiter {maxiter}, 15 deg/window rotation")
    print(f"{'win':>3} {'it_I':>5} {'ev_I':>5} {'it_H':>5} {'ev_H':>5} "
          f"{'f_I':>12} {'f_H':>12} {'dtheta_max':>10}")
    rows = []
    tot = np.zeros(4, np.int64)
    for k in range(1, n_windows):
        r_i = base_res[k]
        r_h, _ = solve(base_res[k - 1].x, base_h[k - 1], k)
        dth = host.to_host((r_h.x - r_i.x).abs().max())
        row = {"win": k, "it_I": int(r_i.total_iters), "ev_I": int(r_i.n_fun_evals),
               "it_H": int(r_h.total_iters), "ev_H": int(r_h.n_fun_evals),
               "f_I": float(r_i.fun_val), "f_H": float(r_h.fun_val), "dtheta_max": dth}
        rows.append(row)
        print(f"{k:>3} {row['it_I']:>5} {row['ev_I']:>5} {row['it_H']:>5} {row['ev_H']:>5} "
              f"{row['f_I']:>12.6f} {row['f_H']:>12.6f} {dth:>10.4f}")
        tot += [row["it_I"], row["ev_I"], row["it_H"], row["ev_H"]]
    pct = lambda a, b: 100 * (b - a) / max(a, 1)
    print(f"TOT iters I={tot[0]} H={tot[2]} ({pct(tot[0], tot[2]):+.0f}%)  "
          f"evals I={tot[1]} H={tot[3]} ({pct(tot[1], tot[3]):+.0f}%)")
    out = {"windows": rows, "tot": {"iters_I": int(tot[0]), "iters_H": int(tot[2]),
                                    "evals_I": int(tot[1]), "evals_H": int(tot[3])}}

    # paired wall clock over the chain (one read per pass)
    for tag, use_warm in (("identity", False), ("warm", True)):
        samples = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            xx = base_res[0].x
            hh = base_h[0] if use_warm else eye
            for k in range(1, n_windows):
                r, h = solve(xx, hh, k)
                xx = r.x
                hh = h if use_warm else eye
            host.to_host(xx.sum())
            samples.append((time.perf_counter() - t0) / (n_windows - 1))
        out[f"lvl0_chain_p50_ms_{tag}"] = float(np.median(samples)) * 1e3
        print(f"lvl0 chain {tag}: p50 {out[f'lvl0_chain_p50_ms_{tag}']:.1f} ms/window")
    return out


def main(argv=None):
    from eincm_tpu_torch.scripts.armijo_rescue_validation import parse_args, print_json

    args = parse_args(argv, __doc__, None)
    print_json(probe(device=args.device), args.out)


if __name__ == "__main__":
    main()
