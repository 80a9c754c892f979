"""Time and profile the MVSEC handover chain on one GPU.

    python3 -m eincm_tpu_torch.utils.chain_profile [--out FILE]

Solves the 6-window chain of `workloads` N_RUNS times, each from a zero
prior, then solves one handover window (window 1 from window 0's result)
under `torch.profiler`. Prints, and writes as JSON to `--out`:

- per run, the mean AEE of windows 1..5 and every window's record
  (`workloads.solve_chain`), the stale-prior control included;
- over the handover windows (1..5) of all runs, the window ms median,
  quartiles, p90 and range;
- for the profiled window: wall ms, device ms (the summed duration of its
  kernels, copies and fills, which run one at a time on one stream), the
  device's idle share, the number of device operations and the ops with
  the most device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from eincm_tpu_torch.models.pyramid import make_window_solver
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.utils import workloads as wl
from eincm_tpu_torch.utils.profiling import card as card_name

# 100 handover windows: enough for a p90, and for the spread of the chain
# AEE that the card's atomics cause
N_RUNS = 20


def _profile_window(solver, cfg, windows, vels) -> dict:
    from torch.profiler import ProfilerActivity, profile

    res0, _ = next(wl.solve_chain(solver, cfg, windows, vels))
    prior = res0.final_theta_pyr
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solver(windows[1], prior, is_first=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "device_ops": sum(n for n, _ in by_name.values()),
        "evals": sum(s.n_fun_evals for s in res.theta_opt_states),
        "host_syncs": res.n_host_syncs,
        "top_device_ops": [
            {"name": name[:90], "calls": n, "ms": ms} for name, (n, ms) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("outputs/chain_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_name()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    windows, vels = wl.stage_mvsec_windows(device)
    cfg = wl.mvsec_solver_config()
    solver = make_window_solver(cfg, device)

    runs = []
    for r in range(N_RUNS):
        recs = [rec for _, rec in wl.solve_chain(solver, cfg, windows, vels)]
        mean_aee = float(np.mean([w["aee"] for w in recs[1:]]))
        runs.append({"mean_aee": mean_aee, "windows": recs})
        print(f"run {r}: mean AEE 1-5 {mean_aee:.4f} px  "
              f"per window {[round(w['aee'], 4) for w in recs]}  "
              f"ms {[round(w['ms'], 1) for w in recs]}  "
              f"syncs {[w['host_syncs'] for w in recs]}")
    ms = np.array([w["ms"] for run in runs for w in run["windows"][1:]])
    window_ms = {
        "n": int(ms.size),
        "median": float(np.median(ms)),
        "q25": float(np.percentile(ms, 25)),
        "q75": float(np.percentile(ms, 75)),
        "p90": float(np.percentile(ms, 90)),
        "min": float(ms.min()),
        "max": float(ms.max()),
    }
    aees = [run["mean_aee"] for run in runs]
    stale = [w["prior_aee"] for run in runs for w in run["windows"][1:]]
    print(f"mean AEE 1-5 over {len(runs)} runs: min {min(aees):.4f}  "
          f"median {float(np.median(aees)):.4f}  max {max(aees):.4f} px; "
          f"stale-prior control {float(np.mean(stale)):.4f} px")
    print(f"handover window ms: {json.dumps(window_ms)}")

    prof = _profile_window(solver, cfg, windows, vels)
    print(f"profiled handover window: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.2f} ms, idle {100 * prof['idle_share']:.1f}%, "
          f"{prof['device_ops']} device ops, {prof['evals']} evals, "
          f"{prof['host_syncs']} host syncs")
    for op in prof["top_device_ops"]:
        print(f"  {op['ms']:8.3f} ms  {op['calls']:6d}  {op['name']}")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "runs": runs, "window_ms": window_ms,
        "stale_prior_aee": float(np.mean(stale)), "profile": prof,
    }, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
