"""MVSEC-scale loss-evaluation breakdown: where does a value and gradient go?

Port of scripts/mvsec_loss_breakdown.py. At MVSEC scale (256x336, 30k
events, 2 refs) an evaluation splats only 60k events, so it is dominated by
per-call fixed costs, not event throughput. This times each stage of one
evaluation on window 0 of the MVSEC bench:

  - full solver_loss value and gradient, and value only (a BFGS
    iteration's and a line-search probe's cost);
  - warp (coarse-grid interp + displacement) fwd and fwd+bwd;
  - splat fwd and fwd+bwd (the port has one splat: one row; the JAX script
    times its row-banded and full-height kernels);
  - the post-splat loss chain (normalize, MSE corr, Scharr contrast,
    combine) fwd and fwd+bwd.

Each stage is fed a seed-perturbed input (seed * 1e-6), as the JAX script
does. The two packages' figures do not measure the same thing: the JAX
script runs 200 evaluations inside one `lax.fori_loop` dispatch, so its
ms per call excludes host dispatch; here 200 calls are dispatched from the
host with one sync at the end (`ms`: host clock, dispatch included), and
`device_ms` is the device time of the same calls from CUDA events
(`utils/profiling.py:cuda_ms`; None off the card).

    python -m eincm_tpu_torch.scripts.mvsec_loss_breakdown [--device cuda] [--out FILE]

Prints one line per stage and a JSON line of every stage's times. Readings
on the H100: PERF.md.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from eincm_tpu_torch.models.loss import LossParams

PARAMS = LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0)


def best_of(fn: Callable[[float], torch.Tensor], rounds=5, iters=200) -> Dict:
    """Best round of `iters` seed-perturbed calls, one sync per round: ms
    per call on the host clock (dispatch included); on the card also the
    device ms per call from CUDA events."""
    from eincm_tpu_torch.utils import host

    host.to_host(fn(0.0))  # warm-up + sync
    best = float("inf")
    for r in range(rounds):
        t0 = time.perf_counter()
        acc = fn(r * iters + 1.0)
        for i in range(1, iters):
            acc = acc + fn(r * iters + 1.0 + i)
        host.to_host(acc)
        best = min(best, (time.perf_counter() - t0) / iters)
    out = {"ms": best * 1e3, "device_ms": None}
    if acc.device.type == "cuda":
        from eincm_tpu_torch.utils.profiling import cuda_ms

        out["device_ms"] = cuda_ms(lambda: fn(0.5), reps=20)
    return out


def make_inputs(window, cfg, rng=None) -> Dict[str, torch.Tensor]:
    """theta N(0, 0.5) at level 0, then the warp's and the splat's
    cotangents N(0, 1), drawn from seed 0 in the JAX script's order, in
    the window's dtype and on its device."""
    rng = np.random.default_rng(0) if rng is None else rng
    h, w = cfg.sensor_size
    n_refs, n_ev = window.edges.shape[0], window.xs.shape[0]
    dev, dt = window.xs.device, window.xs.dtype
    arrays = dict(
        theta=rng.normal(0, 0.5, (*cfg.level_shape(0), 2)).astype(np.float32),
        cot_e=rng.normal(0, 1, (2, n_refs, n_ev)).astype(np.float32),
        cot_f=rng.normal(0, 1, (n_refs, h, w)).astype(np.float32),
    )
    return {k: torch.as_tensor(v, device=dev).to(dt) for k, v in arrays.items()}


def stages(window, cfg, inp: Dict[str, torch.Tensor], params: LossParams = PARAMS) -> Dict:
    """{stage: {variant: seed -> scalar tensor}}: the JAX script's stages,
    each the scalar its jitted function returns (a value, or a value plus
    its gradient's sum)."""
    from eincm_tpu_torch.models.loss import (
        EPSN,
        compute_weights_for_multi_reference,
        compute_window_statics,
        solver_loss,
    )
    from eincm_tpu_torch.models.objectives import (
        compute_mean_gradient_magnitude,
        compute_mean_squared_error,
    )
    from eincm_tpu_torch.ops.normalize import normalize_to_unit_range
    from eincm_tpu_torch.ops.splat import splat_multi_ref
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    w = window
    hw = tuple(cfg.sensor_size)
    statics = cfg.loss_statics
    wstats = compute_window_statics(w.xs, w.ys, w.edges, hw)
    theta, cot_e, cot_f = inp["theta"], inp["cot_e"], inp["cot_f"]

    def value_plus_grad(f, x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach() + g.sum()

    def loss_of(th):
        return solver_loss(th, w.xs, w.ys, w.ts, w.edges, w.edge_ts, params, 0, statics, wstats)

    def warp(th):
        return warp_events_multi_ref_coarse(th, w.xs, w.ys, w.ts, w.edge_ts, hw)

    def warp_dot(th):
        wx, wy = warp(th)
        return (wx * cot_e[0]).sum() + (wy * cot_e[1]).sum()

    with torch.no_grad():
        wx, wy = warp(theta)
        iwes = splat_multi_ref(wx, wy, hw)
    # float32 weights, as the JAX script's
    mrw = torch.as_tensor(compute_weights_for_multi_reference(w.edges.shape[0]),
                          dtype=torch.float32).to(theta.device, theta.dtype)

    def chain(iw):
        niwes = torch.stack([normalize_to_unit_range(f) for f in iw])
        corrs = -torch.stack([compute_mean_squared_error(e, n) for e, n in zip(w.edges, niwes)])
        contrasts = torch.stack([compute_mean_gradient_magnitude(f) for f in iw])
        rel_corrs = (mrw * corrs) / (wstats.zero_corrs + EPSN)
        rel_contrasts = (mrw * contrasts) / (wstats.zero_contrast + EPSN)
        return params.alpha * (-rel_contrasts.mean()) + params.beta * (-rel_corrs.mean())

    def no_grad(f):
        def g(s):
            with torch.no_grad():
                return f(s)
        return g

    zero = lambda s: torch.tensor(s * 1e-6, dtype=theta.dtype, device=theta.device)
    return {
        "solver_loss": {
            "value_only": no_grad(lambda s: loss_of(theta + s * 1e-6)),
            "value_and_grad": lambda s: value_plus_grad(loss_of, theta + s * 1e-6),
        },
        "warp": {
            "fwd": no_grad(lambda s: sum(x.sum() for x in warp(theta + s * 1e-6))),
            "fwd_bwd": lambda s: value_plus_grad(warp_dot, theta + s * 1e-6),
        },
        "splat": {
            "fwd": no_grad(lambda s: splat_multi_ref(wx + s * 1e-6, wy, hw).sum()),
            "fwd_bwd": lambda s: value_plus_grad(
                lambda d: (splat_multi_ref(wx + d, wy, hw) * cot_f).sum(), zero(s)),
        },
        "post_splat_chain": {
            "fwd": no_grad(lambda s: chain(iwes + s * 1e-6)),
            "fwd_bwd": lambda s: value_plus_grad(lambda d: chain(iwes + d), zero(s)),
        },
    }


def breakdown(*, device="cuda", rounds=5, iters=200) -> Dict:
    """Every stage's `best_of` on window 0 of the MVSEC bench; prints the
    JAX script's lines (host ms) as it goes."""
    from eincm_tpu_torch.models.pyramid import SolverConfig
    from eincm_tpu_torch.utils.benchmarks import MVSEC_H, MVSEC_W, stage_mvsec_windows

    staged, _ = stage_mvsec_windows(n_windows=1, device=device)
    w = staged[0]
    cfg = SolverConfig(n_pyr_lvls=5, sensor_size=(MVSEC_H, MVSEC_W), params=PARAMS,
                       theta_opt_maxiters=(40, 33, 25, 18, 10))
    fns = stages(w, cfg, make_inputs(w, cfg))
    res = {name: {v: best_of(f, rounds, iters) for v, f in variants.items()}
           for name, variants in fns.items()}
    ms = lambda name, v: res[name][v]["ms"]
    print(f"solver_loss      value-only {ms('solver_loss', 'value_only'):.3f} ms   "
          f"value&grad {ms('solver_loss', 'value_and_grad'):.3f} ms")
    print(f"warp             fwd {ms('warp', 'fwd'):.3f} ms   "
          f"fwd+bwd {ms('warp', 'fwd_bwd'):.3f} ms")
    print(f"splat            fwd {ms('splat', 'fwd'):.3f} ms   "
          f"fwd+bwd {ms('splat', 'fwd_bwd'):.3f} ms")
    print(f"post-splat chain fwd {ms('post_splat_chain', 'fwd'):.3f} ms   "
          f"fwd+bwd {ms('post_splat_chain', 'fwd_bwd'):.3f} ms")
    for v, full in (("fwd", "value_only"), ("fwd_bwd", "value_and_grad")):
        res[f"sum_of_stages_{v}_ms"] = sum(ms(n, v) for n in ("warp", "splat",
                                                            "post_splat_chain"))
    print(f"# sum of stages: fwd {res['sum_of_stages_fwd_ms']:.3f} ms vs full value-only "
          f"{ms('solver_loss', 'value_only'):.3f} ms;  fwd+bwd "
          f"{res['sum_of_stages_fwd_bwd_ms']:.3f} ms vs full value&grad "
          f"{ms('solver_loss', 'value_and_grad'):.3f} ms")
    return res


def main(argv=None):
    from eincm_tpu_torch.scripts.armijo_rescue_validation import parse_args, print_json

    args = parse_args(argv, __doc__, None)
    print_json(breakdown(device=args.device), args.out)


if __name__ == "__main__":
    main()
