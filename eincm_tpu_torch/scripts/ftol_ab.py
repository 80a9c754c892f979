"""Paired A/B: noise-floor (ftol) termination against the reference's
retry semantics.

Port of scripts/ftol_ab.py. `theta_ftol` (SolverConfig / bfgs.minimize_bfgs)
declares the f32 noise floor after ftol_patience consecutive below-floor
relative improvements (status 4, never retried), where the reference's
semantics burn max_ls_evals probes proving no step improves and then retry
levels 0/1.

Protocol:
  1. accuracy: the armijo_rescue_validation 10-window MVSEC-scale chain
     (Canny + IEDT edges, rescue on) at ftol in {None, 1e-6, 1e-5}: AEE per
     window, rescue counts, wall time;
  2. latency: paired interleaved p50 on the shared MVSEC bench workload
     and the DSEC-scale chained-solve workload (utils/benchmarks.py).

    python -m eincm_tpu_torch.scripts.ftol_ab [--device cuda] [--out DIR] [--skip-accuracy] [--skip-dsec]

Readings on the H100: PERF.md.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np

from eincm_tpu_torch.scripts import armijo_rescue_validation as arv

FTOLS = (None, 1e-6, 1e-5)
OUT = "/tmp/eincm_ftol_ab"


def tag(ftol):
    return "none" if ftol is None else f"{ftol:.0e}"


def run_accuracy(ftol, out_root, *, device="cuda", n_windows=arv.N_WINDOWS,
                 overrides: Optional[Dict] = None):
    cfg = arv.make_cfg(f"ftol_{tag(ftol)}", "armijo", True, out_root, n_windows=n_windows,
                       overrides=overrides)
    cfg.solver.theta_ftol = ftol
    return arv.run_cfg(cfg, device)


def study(out_root=OUT, *, device="cuda", skip_accuracy=False, skip_dsec=False,
          n_windows=arv.N_WINDOWS, overrides: Optional[Dict] = None, rounds=5,
          mvsec_windows=6, dsec_rounds=2, dsec_windows=4,
          solver_overrides: Optional[Dict] = None) -> Dict:
    """The JAX script's protocol; the JSON line's dict. `overrides` go to
    the accuracy runs' config, `solver_overrides` to the benches'."""
    from eincm_tpu_torch.utils.benchmarks import (
        build_dsec_solve_bench,
        build_mvsec_solve_bench,
        solve_diag_str,
    )

    res = {}
    for ftol in (() if skip_accuracy else FTOLS):
        aees, (n_att, n_app), solve_s = run_accuracy(
            ftol, out_root, device=device, n_windows=n_windows, overrides=overrides)
        t = tag(ftol)
        res[f"aee_{t}"] = [round(a, 4) for a in aees]
        res[f"aee_mean_{t}"] = round(float(np.mean(aees)), 4)
        res[f"aee_worst_{t}"] = round(float(np.max(aees)), 4)
        res[f"rescues_{t}"] = [n_att, n_app]
        res[f"solve_s_{t}"] = round(solve_s, 2)
        print(f"# accuracy ftol={t}: mean {res[f'aee_mean_{t}']}", file=sys.stderr)

    # paired MVSEC-scale latency, interleaved rounds
    extra = dict(solver_overrides or {})
    one_rounds = {}
    for ftol in FTOLS:
        one_round, diag = build_mvsec_solve_bench(
            n_windows=mvsec_windows, solver_overrides={**extra, "theta_ftol": ftol},
            device=device)
        one_rounds[ftol] = one_round
        print(f"# mvsec ftol={tag(ftol)} diag: {solve_diag_str(diag)}", file=sys.stderr)
    samples = {f: [] for f in FTOLS}
    for _ in range(rounds):
        for f in FTOLS:
            samples[f].append(one_rounds[f]())
    for f in FTOLS:
        res[f"mvsec_p50_ms_{tag(f)}"] = round(float(np.median(samples[f])) * 1e3, 1)
    print("# mvsec p50: " + json.dumps(
        {k: v for k, v in res.items() if k.startswith("mvsec_p50")}),
        file=sys.stderr, flush=True)
    if skip_dsec:
        return res

    # paired DSEC-scale latency (None against the best candidate), fewer rounds
    dsec_rounds_fn = {}
    for ftol in (None, 1e-6):
        one_round, diag = build_dsec_solve_bench(
            n_windows=dsec_windows, solver_overrides={**extra, "theta_ftol": ftol},
            device=device)
        dsec_rounds_fn[ftol] = one_round
        print(f"# dsec ftol={tag(ftol)} diag: {solve_diag_str(diag)}", file=sys.stderr)
    dsec_samples = {f: [] for f in dsec_rounds_fn}
    for _ in range(dsec_rounds):
        for f in dsec_rounds_fn:
            dsec_samples[f].append(dsec_rounds_fn[f]())
    for f in dsec_rounds_fn:
        res[f"dsec_p50_ms_{tag(f)}"] = round(float(np.median(dsec_samples[f])) * 1e3, 0)
    print("# dsec p50: " + json.dumps(
        {k: v for k, v in res.items() if k.startswith("dsec_p50")}),
        file=sys.stderr, flush=True)

    if "aee_none" in res:
        for f in FTOLS[1:]:
            d = np.asarray(res[f"aee_{tag(f)}"]) - np.asarray(res["aee_none"])
            res[f"daee_mean_{tag(f)}"] = round(float(d.mean()), 4)
            res[f"daee_worst_{tag(f)}"] = round(float(d.max()), 4)
    return res


def main(argv=None):
    args = arv.parse_args(argv, __doc__, OUT, ("--skip-accuracy", "--skip-dsec"))
    print(json.dumps(study(args.out, device=args.device, skip_accuracy=args.skip_accuracy,
                           skip_dsec=args.skip_dsec)))


if __name__ == "__main__":
    main()
