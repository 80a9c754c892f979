"""Edge-pipeline sensitivity study.

Port of scripts/edge_sensitivity.py. The reference's edge maps are OpenCV
outputs (src/utils/img_utils.py:152-206); the port's are independent
implementations. This bounds the accuracy risk: perturb each
edge-extraction knob by the magnitude an OpenCV-against-ours deviation
could plausibly produce (Canny thresholds +-25%, IEDT alpha +-25%, Gaussian
smoothing sigma +-25%, preprocessing on/off, and structural perturbations
of the binary edge map) and measure the AEE of each on the MVSEC-scale
rotating chain solved with the full shipped pipeline.

    python -m eincm_tpu_torch.scripts.edge_sensitivity [--device cuda] [--out FILE]

Prints one JSON line: per variant, the AEE per window, mean, worst, wall
seconds and the mean's difference from the baseline. Readings on the H100:
PERF.md.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np


def perturbed_edge_cfg(base, kind, seed=7):
    """Wrap a config's edge_fn with a STRUCTURAL perturbation of the binary
    edge map before smoothing, the model of a cv2-against-ours Canny
    deviation (a few boundary pixels differing):
      drop10   remove a random 10% of edge pixels
      add5     add spurious edge pixels (5% of the edge count)
      shift1   translate the whole edge map by 1 px
    """
    from eincm_tpu_torch.edge import pipeline as ep

    cfg = dataclasses.replace(base)
    inner_smoothen = (
        (lambda e: ep.eincm_inv_exp_dist_transform(e, cfg.iedt_alpha))
        if cfg.smoothen_method == "eincm_iedt"
        else (lambda e: ep.smoothen_edges(e, cfg.smoothen_k_size, cfg.smoothen_sigma))
    )
    rng = np.random.default_rng(seed)

    def perturb(edge):
        e = np.asarray(edge) > 0
        if kind == "drop10":
            mask = rng.uniform(size=e.shape) < 0.10
            e = e & ~mask
        elif kind == "add5":
            n_add = max(1, int(e.sum() * 0.05))
            ys = rng.integers(0, e.shape[0], n_add)
            xs = rng.integers(0, e.shape[1], n_add)
            e = e.copy()
            e[ys, xs] = True
        elif kind == "shift1":
            e = np.roll(e, (1, 1), axis=(0, 1))
        else:
            raise ValueError(kind)
        return e.astype(np.float64)

    EPSN = sys.float_info.epsilon

    def edge_fn(images):
        # the pipeline with the perturbation between Canny and smoothing
        # (as edge.pipeline.extract_edges)
        out = []
        for img in images:
            if cfg.enable_image_preprocessing:
                img = ep.preprocess_image(img, **(cfg.preprocess_kwargs or {}))
            edges = ep.image_to_edge(img, cfg.canny_aperture, cfg.canny_th1, cfg.canny_th2)
            sm = np.asarray(inner_smoothen(perturb(edges)), np.float64)
            out.append((sm - sm.min()) / (sm.max() - sm.min() + EPSN))
        return np.stack(out)

    class _Cfg:
        def make_edge_fn(self):
            return edge_fn

    return _Cfg()


def solve_chain_aee(edge_cfg, n_windows=6, *, device="cuda",
                    solver_overrides: Optional[Dict] = None):
    """Solve an MVSEC-scale rotating-velocity chain with the given edge
    pipeline; return per-window AEE at event pixels against the exact GT."""
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.models.pyramid import (
        HandoverSettings,
        SolverConfig,
        make_window_solver,
    )
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
    from eincm_tpu_torch.utils import benchmarks

    h, w = benchmarks.MVSEC_H, benchmarks.MVSEC_W
    staged, vels = benchmarks.stage_mvsec_windows(n_windows, edge_cfg=edge_cfg, device=device)
    kw = dict(
        n_pyr_lvls=5,
        sensor_size=(h, w),
        params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(40, 33, 25, 18, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1, 1: 1},
        handover=HandoverSettings(use_handover=True, solve_handover_for_levels=(0,)),
    )
    kw.update(solver_overrides or {})
    cfg = SolverConfig(**kw)
    solver = make_window_solver(cfg, staged[0].xs.device)
    prior = cfg.zero_pyramid(device=staged[0].xs.device)
    aees = []
    for k, (win, vel) in enumerate(zip(staged, vels)):
        res = solver(win, prior, is_first=(k == 0))
        prior = res.final_theta_pyr
        full = scale_theta_to_sensor_size(res.final_theta_pyr[0], (h, w), "bilinear")
        full = full.cpu().numpy()
        xs, ys = win.xs.cpu().numpy(), win.ys.cpu().numpy()
        keep = np.isfinite(xs)
        ix = np.clip(xs[keep].astype(int), 0, w - 1)
        iy = np.clip(ys[keep].astype(int), 0, h - 1)
        err = np.linalg.norm(full[iy, ix] - np.asarray(vel)[None, :], axis=-1)
        aees.append(float(err.mean()))
    return aees


def variants() -> Dict:
    """The JAX script's variants, by name."""
    from eincm_tpu_torch.experiments.config import EdgeConfig

    base = EdgeConfig(enable_image_preprocessing=False, smoothen_method="eincm_iedt")
    return {
        "baseline": base,
        # Canny thresholds +-25% (reference MVSEC-outdoor run.sh:84: 30/80)
        "canny_-25%": dataclasses.replace(base, canny_th1=22.5, canny_th2=60.0),
        "canny_+25%": dataclasses.replace(base, canny_th1=37.5, canny_th2=100.0),
        # IEDT alpha +-25% (reference default 6.0, img_utils.py:229-233)
        "iedt_alpha_-25%": dataclasses.replace(base, iedt_alpha=4.5),
        "iedt_alpha_+25%": dataclasses.replace(base, iedt_alpha=7.5),
        # Gaussian smoothing instead of IEDT, sigma +-25% around 1.0
        "gauss_sigma_0.75": dataclasses.replace(base, smoothen_method="gaussian",
                                                smoothen_sigma=0.75),
        "gauss_sigma_1.0": dataclasses.replace(base, smoothen_method="gaussian",
                                               smoothen_sigma=1.0),
        "gauss_sigma_1.25": dataclasses.replace(base, smoothen_method="gaussian",
                                                smoothen_sigma=1.25),
        # the full preprocessing chain on (NL-means + CLAHE + sharpen + bilateral)
        "preprocess_on": dataclasses.replace(base, enable_image_preprocessing=True),
        # structural edge perturbations
        "edges_drop10%": perturbed_edge_cfg(base, "drop10"),
        "edges_add5%": perturbed_edge_cfg(base, "add5"),
        "edges_shift1px": perturbed_edge_cfg(base, "shift1"),
    }


def study(*, device="cuda", n_windows=6, names: Optional[Sequence[str]] = None,
          solver_overrides: Optional[Dict] = None) -> Dict:
    """Every variant (or those in `names`, "baseline" always); the JSON
    line's dict."""
    res = {}
    for name, cfg in variants().items():
        if names is not None and name != "baseline" and name not in names:
            continue
        t0 = time.perf_counter()
        aees = solve_chain_aee(cfg, n_windows, device=device, solver_overrides=solver_overrides)
        res[name] = {
            "aee_per_window": [round(a, 4) for a in aees],
            "aee_mean": round(float(np.mean(aees)), 4),
            "aee_worst": round(float(np.max(aees)), 4),
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(f"# {name}: mean {res[name]['aee_mean']} worst {res[name]['aee_worst']}",
              file=sys.stderr, flush=True)
    base_mean = res["baseline"]["aee_mean"]
    for name in res:
        res[name]["daee_vs_baseline"] = round(res[name]["aee_mean"] - base_mean, 4)
    return res


def main(argv=None):
    from eincm_tpu_torch.scripts.armijo_rescue_validation import parse_args, print_json

    args = parse_args(argv, __doc__, None)
    print_json(study(device=args.device), args.out)


if __name__ == "__main__":
    main()
