"""Paired A/B: max_ls_evals 10 against 6, a cheaper line-search failure?

Port of scripts/ls_evals_ab.py. Every pyramid level can end on line-search
exhaustion at the f32 noise floor, each such end burning `max_ls_evals`
value probes; a smaller cap shortens those bursts, IF accuracy holds (a cap
of 6 can no longer accept steps below alpha1 / 2^5), so the chain AEE is
validated with it.

Protocol:
  1. accuracy: the armijo_rescue_validation harness (10-window MVSEC-scale
     synthetic chain, Canny + IEDT edges, rescue on) at cap 10 and 6: AEE
     per window, rescue counts, solve wall time;
  2. latency: build_mvsec_solve_bench paired p50, interleaved rounds.

    python -m eincm_tpu_torch.scripts.ls_evals_ab [--device cuda] [--out DIR]

Readings on the H100: PERF.md.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np

from eincm_tpu_torch.scripts import armijo_rescue_validation as arv

CAPS = (10, 6)
OUT = "/tmp/eincm_lscap_ab"


def run_accuracy(cap: int, out_root: str, *, device="cuda", n_windows=arv.N_WINDOWS,
                 overrides: Optional[Dict] = None):
    cfg = arv.make_cfg(f"lscap_{cap}", "armijo", True, out_root, n_windows=n_windows,
                       overrides=overrides)
    cfg.solver.max_ls_evals = cap
    return arv.run_cfg(cfg, device)


def study(out_root=OUT, *, device="cuda", n_windows=arv.N_WINDOWS,
          overrides: Optional[Dict] = None, rounds=5, mvsec_windows=6,
          solver_overrides: Optional[Dict] = None) -> Dict:
    """The JAX script's protocol; the JSON line's dict."""
    from eincm_tpu_torch.utils.benchmarks import build_mvsec_solve_bench, solve_diag_str

    res = {}
    for cap in CAPS:
        aees, (n_att, n_app), solve_s = run_accuracy(
            cap, out_root, device=device, n_windows=n_windows, overrides=overrides)
        res[f"aee_{cap}"] = [round(a, 4) for a in aees]
        res[f"aee_mean_{cap}"] = round(float(np.mean(aees)), 4)
        res[f"aee_worst_{cap}"] = round(float(np.max(aees)), 4)
        res[f"rescues_{cap}"] = [n_att, n_app]
        res[f"solve_s_{cap}"] = round(solve_s, 2)

    # paired latency on the shared bench workload, interleaved rounds
    one_rounds = {}
    for cap in CAPS:
        one_round, diag_res = build_mvsec_solve_bench(
            n_windows=mvsec_windows,
            solver_overrides={**(solver_overrides or {}), "max_ls_evals": cap}, device=device)
        one_rounds[cap] = one_round
        print(f"# cap={cap} diag: {solve_diag_str(diag_res)}", file=sys.stderr)
    samples = {cap: [] for cap in CAPS}
    for _ in range(rounds):
        for cap in CAPS:
            samples[cap].append(one_rounds[cap]())
    for cap in CAPS:
        res[f"p50_ms_{cap}"] = round(float(np.median(samples[cap])) * 1e3, 1)

    d = np.asarray(res[f"aee_{CAPS[1]}"]) - np.asarray(res[f"aee_{CAPS[0]}"])
    res["daee_mean"] = round(float(d.mean()), 4)
    res["daee_worst"] = round(float(d.max()), 4)
    return res


def main(argv=None):
    args = arv.parse_args(argv, __doc__, OUT)
    print(json.dumps(study(args.out, device=args.device)))


if __name__ == "__main__":
    main()
