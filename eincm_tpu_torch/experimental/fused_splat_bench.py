"""The fused warp+splat kernels against the production two-kernel path.

    python3 -m eincm_tpu_torch.experimental.fused_splat_bench [--out FILE]

The port of scripts/fused_splat_bench.py. At the DSEC scale (1.5M events
with row-sorted ys on a 480x640 sensor, 2 reference times t_refs =
linspace(0, 1, 2), a 16x16 theta drawn N(0, 4); numpy seed 0) it runs the
forward IWE by three paths and the parts of the first:

- A: the production path, interp (kernel 1) -> displacement -> splat
  (kernel 3), all refs at once; `warp_only`, `splat_only` and
  `interp_only` are its parts;
- B: interp (kernel 1), then `fused_warp_splat_frame` (kernel 7) per ref;
- C: `fully_fused_warp_splat_frame` (kernel 8) per ref.

Before any timing it holds B and C against A: B within 1e-3 max abs (the
JAX bench's bound), C within TOL_C_REL of max |A|. C samples theta with
kernel 1's own arithmetic, so only the order of the atomic sums differs
(the JAX bench needed 2.0 abs for its in-kernel interp). Then it times
each path with CUDA events (`utils/profiling.cuda_ms`) and prints the card
and one JSON line of ms. It exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from eincm_tpu_torch.experimental.splat_fused import (
    fully_fused_warp_splat_frame,
    fused_warp_splat_frame,
)
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops.interp import interp_theta_at_events
from eincm_tpu_torch.ops.splat import splat_multi_ref
from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse
from eincm_tpu_torch.utils.profiling import card, cuda_ms

SENSOR = (480, 640)
N_EVENTS = 1_500_000
N_REFS = 2
TOL_B_ABS = 1e-3
# relative to max |A|: the same f32 arithmetic as A, summed by atomics in
# another order (chip_smoke.py's TOL_ATOMIC)
TOL_C_REL = 1e-5


def make_inputs(device) -> dict:
    """The JAX bench's inputs, drawn in its order from numpy seed 0."""
    H, W = SENSOR
    rng = np.random.default_rng(0)
    ys = np.sort(rng.uniform(0, H - 1, N_EVENTS)).astype(np.float32)
    xs = rng.uniform(0, W - 1, N_EVENTS).astype(np.float32)
    ts = rng.uniform(0, 1, N_EVENTS).astype(np.float32)
    theta = rng.normal(0, 4, (16, 16, 2)).astype(np.float32)
    t_refs = np.linspace(0, 1, N_REFS).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return {
        "xs": t(xs), "ys": t(ys), "ts": t(ts),
        "xi": t(np.round(xs)), "yi": t(np.round(ys)),
        "theta": t(theta), "t_refs": t(t_refs),
        "t_ref_values": [float(v) for v in t_refs],
    }


def paths(inp: dict) -> dict:
    """name -> callable of no arguments, for each path and part."""
    xs, ys, ts, xi, yi = (inp[k] for k in ("xs", "ys", "ts", "xi", "yi"))
    theta, t_refs, t_vals = inp["theta"], inp["t_refs"], inp["t_ref_values"]

    def warp_only():
        return warp_events_multi_ref_coarse(theta, xs, ys, ts, t_refs, SENSOR)

    wx0, wy0 = (a.contiguous() for a in warp_only())

    def path_a():
        return splat_multi_ref(*warp_only(), SENSOR)

    def path_b():
        th = interp_theta_at_events(theta, xs, ys, SENSOR)
        thx, thy = th[:, 0].contiguous(), th[:, 1].contiguous()
        out = [fused_warp_splat_frame(xi, yi, ts, thx, thy, t, SENSOR) for t in t_vals]
        return torch.stack([f for f, _ in out]), torch.stack([ok for _, ok in out])

    def path_c():
        out = [fully_fused_warp_splat_frame(xi, yi, ts, theta, t, SENSOR) for t in t_vals]
        return torch.stack([f for f, _ in out]), torch.stack([ok for _, ok in out])

    return {
        "path_a_two_kernel": path_a,
        "warp_only": warp_only,
        "splat_only": lambda: splat_multi_ref(wx0, wy0, SENSOR),
        "interp_only": lambda: interp_theta_at_events(theta, xs, ys, SENSOR),
        "path_b_fused": path_b,
        "path_c_fully_fused": path_c,
    }


def check_agreement(fns: dict) -> dict:
    """Run A, B and C once; raise unless B and C agree with A."""
    frames_a = fns["path_a_two_kernel"]()
    frames_b, oks_b = fns["path_b_fused"]()
    frames_c, oks_c = fns["path_c_fully_fused"]()
    if not (bool(oks_b.all()) and bool(oks_c.all())):
        raise AssertionError("a fused path returned ok False")
    scale = float(frames_a.abs().max())
    err_b = float((frames_b - frames_a).abs().max())
    err_c = float((frames_c - frames_a).abs().max())
    print(f"agreement: B max abs {err_b:.3e} (limit {TOL_B_ABS:.0e}), "
          f"C max abs {err_c:.3e} rel {err_c / scale:.3e} (limit {TOL_C_REL:.0e}), "
          f"max |A| {scale:.4e}")
    if not err_b <= TOL_B_ABS:
        raise AssertionError(f"path B disagrees with A: {err_b}")
    if not err_c <= TOL_C_REL * scale:
        raise AssertionError(f"path C disagrees with A: {err_c / scale}")
    return {"err_b_abs": err_b, "err_c_abs": err_c, "err_c_rel": err_c / scale,
            "max_frame": scale}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_splat_bench: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = card()
    print(f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    with torch.no_grad():
        fns = paths(make_inputs(device))
        res = {"card": name, "n_events": N_EVENTS, "n_refs": N_REFS,
               **check_agreement(fns)}
        res["ms"] = {k: cuda_ms(fn) for k, fn in fns.items()}
    for k, v in res["ms"].items():
        print(f"{k}: {v:.4f} ms")
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(name)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
