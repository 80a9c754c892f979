"""Armijo tail-safeguard validation on the MVSEC-scale chain.

Port of scripts/armijo_rescue_validation.py. Four variants of the
experiment over a 10-window synthetic sequence (sequential handover chain,
Canny + IEDT edges), per-window AEE against the exact GT:

  wolfe            strong Wolfe everywhere (scipy-parity semantics)
  armijo           shipped default, rescue disabled
  armijo_rescue    shipped default (solver.armijo_rescue on)
  armijo_interp    quadratic-interpolated backtracking, rescue on

Prints one JSON line with per-window AEEs, worst-window deltas against
wolfe, the rescue counts and the solve wall times.

    python -m eincm_tpu_torch.scripts.armijo_rescue_validation [--device cuda] [--out DIR]

The JAX script sets `solver.splat_impl = "pallas_banded"`, which selects
nothing in the port (one splat); every other field is the JAX script's.
Readings on the H100: PERF.md.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np

OUT = "/tmp/eincm_rescue_val"
N_WINDOWS = 10
VARIANTS = (
    ("wolfe", "wolfe", False, False),
    ("armijo", "armijo", False, False),
    ("armijo_rescue", "armijo", True, False),
    ("armijo_interp", "armijo", True, True),
)


def apply_overrides(cfg, overrides: Optional[Dict]):
    """Set dotted config fields, e.g. {"dataset.sensor_size": (32, 32)}."""
    for key, value in (overrides or {}).items():
        *path, name = key.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part)
        if not hasattr(node, name):
            raise AttributeError(f"no config field {key}")
        setattr(node, name, value)
    return cfg


def make_cfg(tag, line_search, rescue, out_root, interp=False, *, n_windows=N_WINDOWS,
             overrides: Optional[Dict] = None):
    """The JAX script's experiment config (`n_windows` solved, one more
    loaded: the last window is boundary-deficient), then `overrides`."""
    from eincm_tpu_torch.experiments.config import ExperimentConfig
    from eincm_tpu_torch.models.pyramid import HandoverSettings

    cfg = ExperimentConfig()
    cfg.experiment_name = tag
    cfg.output_dir = out_root
    cfg.dataset.kind = "synthetic"
    cfg.dataset.sensor_size = (256, 336)
    cfg.dataset.des_n_events = 30_000
    cfg.dataset.n_windows = n_windows + 1  # last window is boundary-deficient; skip it
    cfg.dataset.velocity = (4.0, -3.0)
    cfg.alpha, cfg.beta = 20.0, 35.0
    cfg.edge.enable_image_preprocessing = False
    cfg.edge.smoothen_method = "eincm_iedt"
    cfg.solver.n_pyr_lvls = 5
    cfg.solver.theta_maxiter = 40
    cfg.solver.theta_miniter = 10
    cfg.solver.theta_gtol = 1e-4
    cfg.solver.n_extra_attempts = {0: 1, 1: 1}
    cfg.solver.line_search = line_search
    cfg.solver.armijo_rescue = rescue
    cfg.solver.armijo_interpolate = interp
    cfg.handover = HandoverSettings(use_handover=True, solve_handover_for_levels=(0,))
    cfg.phases.run_idx_range = (0, n_windows)
    cfg.phases.eval = True
    cfg.phases.plot = False
    cfg.phases.checkpoint_every_percent = 0
    return apply_overrides(cfg, overrides)


def run_cfg(cfg, device):
    """SOLVE (timed, host clock ending in the solve's last read) and EVAL of
    `cfg`: (AEE per solved window, (rescue attempts, rescues applied),
    solve seconds)."""
    from eincm_tpu_torch.experiments.manager import EINCMExperiment

    exp = EINCMExperiment(cfg, device=device)
    t0 = time.perf_counter()
    exp.run_solver()
    solve_s = time.perf_counter() - t0
    exp.run_eval()
    n = cfg.phases.run_idx_range[1]
    aees = [float(np.asarray(exp.eval_results[f"datasample_idx_{i}"]["evals"]["AEE"]))
            for i in range(n)]
    return aees, (exp.n_rescue_attempts, exp.n_rescued), solve_s


def run(tag, line_search, rescue, out_root, interp=False, *, device="cuda",
        n_windows=N_WINDOWS, overrides: Optional[Dict] = None):
    return run_cfg(make_cfg(tag, line_search, rescue, out_root, interp, n_windows=n_windows,
                            overrides=overrides), device)


def study(out_root=OUT, *, device="cuda", n_windows=N_WINDOWS,
          overrides: Optional[Dict] = None) -> Dict:
    """The four variants; the JSON line's dict."""
    res = {}
    for tag, ls, rescue, interp in VARIANTS:
        aees, (n_attempts, n_applied), solve_s = run(
            tag, ls, rescue, out_root, interp, device=device, n_windows=n_windows,
            overrides=overrides)
        res[f"aee_{tag}"] = [round(a, 4) for a in aees]
        res[f"aee_mean_{tag}"] = round(float(np.mean(aees)), 4)
        res[f"n_rescue_attempts_{tag}"] = n_attempts
        res[f"n_rescued_{tag}"] = n_applied
        res[f"solve_s_{tag}"] = round(solve_s, 2)
    for tag in ("armijo", "armijo_rescue", "armijo_interp"):
        d = np.asarray(res[f"aee_{tag}"]) - np.asarray(res["aee_wolfe"])
        res[f"daee_mean_{tag}"] = round(float(d.mean()), 4)
        res[f"daee_worst_{tag}"] = round(float(d.max()), 4)
    return res


def parse_args(argv, doc: str, out: str, flags=()):
    """The studies' command line: --device, --out and `flags` (switches)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=out, help=f"output path (default {out})")
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    return ap.parse_args(argv)


def print_json(res: Dict, path: Optional[str] = None) -> None:
    """Print `res` as one JSON line, also written to `path` when given."""
    line = json.dumps(res)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    print(line)


def main(argv=None):
    args = parse_args(argv, __doc__, OUT)
    print(json.dumps(study(args.out, device=args.device)))


if __name__ == "__main__":
    main()
