"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero):

1. set-up: card name and power limit, torch and CUDA versions, and the
   nvcc build of every kernel in eincm_tpu_torch/csrc;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   MVSEC shape (16x16 theta, 30k events x 2 refs, 256x336) and the DSEC
   shape (1.5M events x 2 refs, 480x640), edge cases included, with the
   time of both from CUDA events;
3. the main path: a 6-window MVSEC-scale handover chain through
   `make_window_solver`, checked against the ground-truth flow, with every
   kernel's launch counter read around the chain;
4. one DSEC-scale `solver_loss` value and gradient with the kernels (on the
   card) against the plain versions (on CPU tensors).

The last lines are the card as nvidia-smi names it, one JSON object of
per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# tolerances, as max |kernel - plain| <= tol * max |plain|:
# atomics reorder the float sums of splat fwd and interp bwd, and the
# reordering grows with the number of events summed into one entry
TOL_ATOMIC = 1e-5
# interp fwd and splat bwd sum a fixed handful of terms per output
TOL_GATHER = 1e-6
TOL_DSEC_LOSS = 1e-4  # relative loss difference, card kernels vs CPU plain
# px, mean over MVSEC chain windows 1..5 (|V| = 5 px): the JAX package's
# own reading on this chain (0.30 px in float32 on CPU,
# tests/test_torch_mvsec_chain.py) plus the 0.05 px band the CPU tests
# hold the port's chain to. Atomics make each run on the card differ.
# Keeping each window's prior as it came scores ~1.5 px, zero flow 5 px.
MAX_MEAN_AEE = 0.35
OK_STATUSES = {0, 1, 2, 4}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device ms of fn() over `reps` back-to-back calls, after a
    warm-up. The card first sleeps for longer than the host needs to
    enqueue the calls, so the events time the device work, not the host's
    launch rate (at 30k events a kernel is shorter than its launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4 * reps * host_s, 2.0) * 2e9))  # ~2 GHz clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_err(kernel: torch.Tensor, plain: torch.Tensor, tol: float, what: str):
    """max |kernel - plain| over entries, NaN where the plain one is NaN."""
    kernel, plain = kernel.detach(), plain.detach()
    nk, npl = torch.isnan(kernel), torch.isnan(plain)
    if not torch.equal(nk, npl):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    k, p = kernel[~npl].double(), plain[~npl].double()
    err = float((k - p).abs().max()) if k.numel() else 0.0
    scale = float(p.abs().max()) if p.numel() else 0.0
    ok = err <= tol * scale
    print(f"  {what}: max|d| {err:.3e}  max|ref| {scale:.3e}  "
          f"rel {err / max(scale, 1e-30):.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


EDGE_XY = [  # (x, y) cases the CPU tests cover
    (-1e4, -1e4), (float("nan"), 5.0), (5.0, float("nan")), (2.5, 3.5),
    (0.0, 0.0), (-0.5, -0.5), (-1.0, 2.0), (-1.5, 2.0), (-2.0, 3.0),
    (1e10, 3.0), (-1e10, 3.0), (float("inf"), 4.0), (4.0, -float("inf")),
]


def with_edges(xs, ys, H, W):
    ex = [x for x, _ in EDGE_XY] + [W - 1.0, W - 0.5, W + 0.0, W + 0.5, W + 1.5]
    ey = [y for _, y in EDGE_XY] + [H - 1.0, H - 0.5, H + 0.0, H + 0.5, H + 1.5]
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=xs.device)
    return torch.cat([xs, t(ex)]), torch.cat([ys, t(ey)])


def check_kernels(tag, window, theta, sensor, rows):
    """Phase 2 at one shape; appends per-kernel results to `rows`."""
    from eincm_tpu_torch.models.loss import _sanitize_events
    from eincm_tpu_torch.ops.interp import (
        interp_bwd_cuda, interp_fwd_cuda, interp_theta_at_events_plain,
    )
    from eincm_tpu_torch.ops.splat_kernel import (
        splat_bwd_cuda, splat_fwd_cuda, splat_plain,
    )
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    H, W = sensor
    xs, ys, ts = _sanitize_events(window.xs, window.ys, window.ts)
    E = xs.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"[kernels] {tag}: theta {tuple(theta.shape)}, {E} events x "
          f"{window.edge_ts.shape[0]} refs, sensor {H}x{W}")
    res = {}

    # interp at the unwarped event coordinates, edge cases appended
    ex, ey = with_edges(xs, ys, H, W)
    out_k = interp_fwd_cuda(theta, ex, ey, sensor)
    torch.cuda.synchronize()
    out_p = interp_theta_at_events_plain(theta, ex, ey, sensor)
    res["interp_fwd"] = (
        max_err(out_k, out_p, TOL_GATHER, "interp_fwd"),
        cuda_ms(lambda: interp_fwd_cuda(theta, xs, ys, sensor)),
        cuda_ms(lambda: interp_theta_at_events_plain(theta, xs, ys, sensor)),
    )
    # the backward is compared without the NaN events, which poison
    # different subsets of entries in the two versions
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda")
    d_k = interp_bwd_cuda(g, bx, by, tuple(theta.shape), sensor)
    torch.cuda.synchronize()
    th = theta.detach().clone().requires_grad_(True)
    out = interp_theta_at_events_plain(th, bx, by, sensor)
    (d_p,) = torch.autograd.grad(out, th, g, retain_graph=True)
    g_main = torch.randn(E, 2, generator=gen, device="cuda")
    out_main = interp_theta_at_events_plain(th, xs, ys, sensor)
    res["interp_bwd"] = (
        max_err(d_k, d_p, TOL_ATOMIC, "interp_bwd"),
        cuda_ms(lambda: interp_bwd_cuda(g_main, xs, ys, tuple(theta.shape), sensor)),
        cuda_ms(lambda: torch.autograd.grad(out_main, th, g_main, retain_graph=True)),
    )

    # splat at the warped coordinates of the real window, edge cases appended
    wx, wy = warp_events_multi_ref_coarse(theta, xs, ys, ts, window.edge_ts, sensor)
    R = wx.shape[0]
    ew = [with_edges(wx[r], wy[r], H, W) for r in range(R)]
    wxe = torch.stack([a for a, _ in ew]).contiguous()
    wye = torch.stack([b for _, b in ew]).contiguous()
    f_k = splat_fwd_cuda(wxe, wye, sensor)
    torch.cuda.synchronize()
    wxr = wxe.clone().requires_grad_(True)
    wyr = wye.clone().requires_grad_(True)
    f_p = splat_plain(wxr, wyr, sensor)
    G = torch.randn(R, H, W, generator=gen, device="cuda")
    dx_k, dy_k = splat_bwd_cuda(wxe, wye, G, sensor)
    torch.cuda.synchronize()
    dx_p, dy_p = torch.autograd.grad(f_p, (wxr, wyr), G)
    wx, wy = wx.contiguous(), wy.contiguous()
    wxm, wym = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
    f_main = splat_plain(wxm, wym, sensor)
    res["splat_fwd"] = (
        max_err(f_k, f_p, TOL_ATOMIC, "splat_fwd"),
        cuda_ms(lambda: splat_fwd_cuda(wx, wy, sensor)),
        cuda_ms(lambda: splat_plain(wx, wy, sensor)),
    )
    res["splat_bwd"] = (
        max(max_err(dx_k, dx_p, TOL_GATHER, "splat_bwd dwx"),
            max_err(dy_k, dy_p, TOL_GATHER, "splat_bwd dwy")),
        cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor)),
        cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G, retain_graph=True)),
    )
    for name, (err, ms, plain_ms) in res.items():
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows.setdefault(name, {})[tag] = (err, ms, plain_ms)


def gt_theta(vel, shape, device):
    th = torch.empty((*shape, 2), dtype=torch.float32, device=device)
    th[..., 0], th[..., 1] = vel
    return th


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    from eincm_tpu_torch.models.loss import (
        LossParams, LossStatics, compute_window_statics, solver_loss,
    )
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils import workloads as wl

    # full-f32 matmuls (resize, BFGS); the port's filters use no convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # ---- 1. set-up --------------------------------------------------------
    card = nvidia_smi()
    print(f"[setup] {card}")
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    print("[setup] TF32 off for matmul and cuDNN")
    build_s = _build.build_all()
    print(f"[setup] built {sorted(p.stem for p in _build.CSRC.glob('*.cu'))} "
          f"with nvcc for sm_90a in {build_s:.2f} s")

    # ---- 2. kernels vs plain -----------------------------------------------
    t0 = time.perf_counter()
    mvsec, vels = wl.stage_mvsec_windows(device)
    print(f"[stage] 6 MVSEC windows in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dsec = wl.stage_dsec_window(device)
    print(f"[stage] DSEC window in {time.perf_counter() - t0:.2f} s")
    rows: dict = {}
    check_kernels("mvsec", mvsec[0], gt_theta(vels[0], (16, 16), device),
                  (wl.MVSEC_H, wl.MVSEC_W), rows)
    dsec_vel = (7.2 * math.cos(math.atan2(-4.0, 6.0)),
                7.2 * math.sin(math.atan2(-4.0, 6.0)))
    check_kernels("dsec", dsec, gt_theta(dsec_vel, (16, 16), device),
                  (wl.DSEC_H, wl.DSEC_W), rows)

    # ---- 3. main path: the MVSEC handover chain ----------------------------
    cfg = wl.mvsec_solver_config()
    solver = make_window_solver(cfg, device)
    _build.reset_launch_counts()
    aees = []
    for res, rec in wl.solve_chain(solver, cfg, mvsec, vels):
        k = rec["window"]
        for th in res.final_theta_pyr:
            if not bool(torch.isfinite(th).all()):
                raise AssertionError(f"window {k}: non-finite theta")
        if not set(rec["statuses"]) <= OK_STATUSES:
            raise AssertionError(f"window {k}: statuses {rec['statuses']}")
        aees.append(rec["aee"])
        print(f"[chain] window {k}: {rec['ms']:.1f} ms  AEE {rec['aee']:.4f} px  "
              f"(prior kept: {rec['prior_aee']:.4f})  iters/level {rec['iters']}  "
              f"statuses {rec['statuses']}  evals {rec['evals']}  "
              f"host syncs {rec['host_syncs']}  w0 {rec['w0']:.4f}")
    launches = _build.launch_counts()
    mean_aee = float(np.mean(aees[1:]))
    print(f"[chain] mean AEE windows 1-5: {mean_aee:.4f} px (limit {MAX_MEAN_AEE})")
    print(f"[chain] kernel launches during the chain: {launches}")
    if not mean_aee <= MAX_MEAN_AEE:
        raise AssertionError(f"mean AEE {mean_aee} > {MAX_MEAN_AEE}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- 4. DSEC-scale loss: kernels on the card vs plain on CPU -----------
    sensor = (wl.DSEC_H, wl.DSEC_W)
    params = LossParams(alpha=2000.0, beta=4000.0)
    statics = LossStatics(sensor, 5)
    gen = torch.Generator().manual_seed(1)
    theta = gt_theta(dsec_vel, (16, 16), "cpu") + 0.5 * torch.randn(16, 16, 2, generator=gen)
    out = {}
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], sensor)
        th = theta.to(dev).requires_grad_(True)
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        out[dev.type] = (float(loss.detach()), grad.cpu())
    (lk, gk), (lp, gp) = out["cuda"], out["cpu"]
    rel = abs(lk - lp) / abs(lp)
    grel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"[dsec loss] kernels {lk:.7f}  plain {lp:.7f}  rel {rel:.3e} "
          f"(limit {TOL_DSEC_LOSS:.0e})  grad max rel {grel:.3e}")
    if not rel <= TOL_DSEC_LOSS:
        raise AssertionError("DSEC-scale loss: kernels disagree with plain")

    sources = {"interp": "eincm_tpu_torch/csrc/interp.cu",
               "splat": "eincm_tpu_torch/csrc/splat.cu"}
    replaces = {
        "interp_fwd": "eincm_tpu/ops/interp_pallas.py:197",
        "interp_bwd": "eincm_tpu/ops/interp_pallas.py:239",
        "splat_fwd": "eincm_tpu/ops/splat_banded.py:374",
        "splat_bwd": "eincm_tpu/ops/splat_banded.py:491",
    }
    also = {
        "splat_fwd": "eincm_tpu/ops/splat_pallas.py:127",
        "splat_bwd": "eincm_tpu/ops/splat_pallas.py:194",
    }
    kernels = []
    for name, by_tag in rows.items():
        (err, ms, plain_ms), d = by_tag["mvsec"], by_tag["dsec"]
        entry = {
            "name": name, "route": "cuda",
            "source": sources[name.split("_")[0]],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(err, d[0]), "ms": ms, "plain_ms": plain_ms,
            "dsec_ms": d[1], "dsec_plain_ms": d[2],
        }
        if name in also:
            entry["also_replaces"] = also[name]
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
