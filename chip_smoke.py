"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero):

1. set-up: card name and power limit, torch and CUDA versions, and the
   nvcc build of every kernel in eincm_tpu_torch/csrc (one nvcc per
   source, all started together; `-Xptxas -v`'s registers, shared memory
   and spills for the splat and the dense interp), and the splat forward's
   slab plan at both shapes;
2. each CUDA kernel of the solve against its plain PyTorch version on the
   card, at the MVSEC shape (16x16 theta, 30k events x 2 refs, 256x336)
   and the DSEC shape (1.5M events x 2 refs, 480x640), edge cases
   included, with the time of both and of one PyTorch library call that
   computes the same function, from CUDA events;
3. the measurement kernels (fused warp+splat, fully fused warp+splat,
   dense-layout interp) against their plain versions at the MVSEC shape
   (staged window 0, GT theta, both refs) and the DSEC shape of the fused
   bench (1.5M row-sorted events, theta N(0, 4)), timed the same way; then
   their main path, the fused bench's paths A, B and C and the dense
   interp's comparison with the production interp, with every kernel's
   launch counter read around it;
4. the main path of the solve: a 6-window MVSEC-scale handover chain
   through `make_window_solver`, checked against the ground-truth flow,
   with the launch counters read around the chain;
5. one DSEC-scale `solver_loss` value and gradient with the kernels (on
   the card) against the plain versions (on CPU tensors).

Every kernel's time stands beside its bound: the least time the card could
take for the same work, the longer of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s (H100 SXM data sheet).

The last lines are the card as nvidia-smi names it, one JSON object of
per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from eincm_tpu_torch.utils.profiling import card as nvidia_smi
from eincm_tpu_torch.utils.profiling import cuda_ms

# tolerances, as max |kernel - plain| <= tol * max |plain|:
# atomics reorder the float sums of splat fwd, interp bwd and the fused
# warp+splat, and the reordering grows with the number of events summed
# into one entry
TOL_ATOMIC = 1e-5
# interp fwd, splat bwd and the dense interp sum a fixed handful of terms
# per output (the dense interp's `highest` is 3xTF32, within ~2^-21 of f32
# per term)
TOL_GATHER = 1e-6
TOL_DSEC_LOSS = 1e-4  # relative loss difference, card kernels vs CPU plain
# px, mean over MVSEC chain windows 1..5 (|V| = 5 px): the JAX package's
# own reading on this chain (0.30 px in float32 on CPU,
# tests/test_torch_mvsec_chain.py) plus the 0.05 px band the CPU tests
# hold the port's chain to. Atomics make each run on the card differ.
# Keeping each window's prior as it came scores ~1.5 px, zero flow 5 px.
MAX_MEAN_AEE = 0.35
OK_STATUSES = {0, 1, 2, 4}

CHAIN_KERNELS = ("interp_fwd", "interp_bwd", "splat_fwd", "splat_bwd")
BENCH_KERNELS = ("fused_warp_splat", "fully_fused_warp_splat", "interp_dense")
SOURCES = {
    "interp_fwd": "eincm_tpu_torch/csrc/interp.cu",
    "interp_bwd": "eincm_tpu_torch/csrc/interp.cu",
    "splat_fwd": "eincm_tpu_torch/csrc/splat.cu",
    "splat_bwd": "eincm_tpu_torch/csrc/splat.cu",
    "fused_warp_splat": "eincm_tpu_torch/csrc/fused.cu",
    "fully_fused_warp_splat": "eincm_tpu_torch/csrc/fused.cu",
    "interp_dense": "eincm_tpu_torch/csrc/interp_dense.cu",
}
REPLACES = {
    "interp_fwd": "eincm_tpu/ops/interp_pallas.py:197",
    "interp_bwd": "eincm_tpu/ops/interp_pallas.py:239",
    "splat_fwd": "eincm_tpu/ops/splat_banded.py:374",
    "splat_bwd": "eincm_tpu/ops/splat_banded.py:491",
    "fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:449",
    "fully_fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:345",
    "interp_dense": "scripts/interp_kernel_proto.py:124",
}
ALSO_REPLACES = {
    "splat_fwd": "eincm_tpu/ops/splat_pallas.py:127",
    "splat_bwd": "eincm_tpu/ops/splat_pallas.py:194",
}

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per event (per event and ref for a splat), counted from
# the kernels' arithmetic with an exp as one operation:
# - interp weights, per axis 15: place u (3), floor, two triangle weights
#   (4 each), their sum, a clamp and two divisions;
# - the bilinear contraction: 2 channels x (4 products + 3 sums);
# - its backward: 4 taps x 2 channels x (2 products + 1 sum);
# - the warp: ts - t_ref, 2 products, 2 differences;
# - the splat: 2 roundings, 5 per Gaussian tap (2 per row and column) and a
#   product and a sum per texel;
# - the splat backward: 6 taps (30), 6 q g(q), and two 3x3 contractions of
#   3 x (3 products + 2 sums) + 3 products + 2 sums (20 each).
OPS_INTERP_WEIGHTS = 30
OPS_INTERP_CONTRACT = 14
OPS_INTERP_BWD = 30 + 24
OPS_WARP = 5
OPS_SPLAT_BWD = 30 + 6 + 40


def ops_splat(hw: int) -> int:
    n = 2 * hw + 1
    return 2 + 2 * n * 5 + 2 * n * n


def ops_dense(h: int, w: int) -> int:
    """The dense interp's own f32 operations per event in mode `highest`,
    on h, w padded to 8: weights of every cell (4 ops, a sum and a division
    each), then 2 channels x wp x hp products and sums and 2 x wp more.
    Not its bound: the function is kernel 1's, whose work bounds both."""
    hp, wp = max(8, -(-h // 8) * 8), max(8, -(-w // 8) * 8)
    return 6 + 6 * (hp + wp) + 4 * wp * hp + 4 * wp


def bound(n_bytes: float, n_ops: float):
    """(least ms, what bounds it) on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def record(rows, name, tag, err, ms, plain_ms, n_bytes, n_ops, library_ms, **extra):
    bound_ms, bound_by = bound(n_bytes, n_ops)
    rows.setdefault(name, {})[tag] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, **extra,
    }
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), library {lib}")


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


def in_sensor(xs, ys, H, W):
    """Events whose rounded coordinates lie on the sensor."""
    rx, ry = torch.round(xs), torch.round(ys)
    return (rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1)


# ---- library yardsticks: one PyTorch call for a kernel's function ---------

def grid_sample_interp(theta, xs, ys, sensor):
    """interp fwd as `F.grid_sample(padding_mode="border",
    align_corners=False)` at the rounded coordinates: the same sample for
    in-sensor events; an event off the sensor (the -1e4 sentinel) samples
    theta's border there and 0 in the kernel. Returns (call, (E, 2) out)."""
    H, W = sensor
    img = theta.permute(2, 0, 1)[None].contiguous()  # (1, 2, h, w)
    gx = (torch.round(xs) + 0.5) * (2.0 / W) - 1.0
    gy = (torch.round(ys) + 0.5) * (2.0 / H) - 1.0
    grid = torch.stack([gx, gy], -1)[None, None]  # (1, 1, E, 2)
    call = lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=False
    )
    return call, call()[0, :, 0, :].T


def splat_planes(wx, wy, sensor):
    """The splat's dense separable weight planes, as the TPU formulates it:
    U (R, H, E) holds each event's 3 row taps, V (R, E, W) its 3 column
    taps, so the frames are U @ V. The backward's yardstick is the two
    products U^T G and V G^T it needs; the row sums with the derivative
    taps that follow them are left out."""
    from eincm_tpu_torch.ops.splat_kernel import _gauss1d

    R, E = wx.shape
    H, W = sensor
    d = torch.tensor([-1.0, 0.0, 1.0], device=wx.device)
    zero = torch.zeros((), device=wx.device)
    rows = torch.round(wy)[..., None] + d  # (R, E, 3)
    cols = torch.round(wx)[..., None] + d
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    gy = torch.where(vr, _gauss1d(torch.where(vr, rows - wy[..., None], zero)), zero)
    gx = torch.where(vc, _gauss1d(torch.where(vc, cols - wx[..., None], zero)), zero)
    U = torch.zeros((R, H, E), device=wx.device)
    U.scatter_add_(1, torch.where(vr, rows, zero).long().transpose(1, 2),
                   gy.transpose(1, 2).contiguous())
    V = torch.zeros((R, E, W), device=wx.device)
    V.scatter_add_(2, torch.where(vc, cols, zero).long(), gx)
    return U, V


# ---- phase 2 ----------------------------------------------------------------

def check_kernels(tag, window, theta, sensor, rows):
    """Phase 2 at one shape; adds per-kernel results to `rows`."""
    from eincm_tpu_torch.models.loss import _sanitize_events
    from eincm_tpu_torch.ops.interp import (
        _axis_weights, interp_bwd_cuda, interp_fwd_cuda,
        interp_theta_at_events_plain,
    )
    from eincm_tpu_torch.ops.splat_kernel import (
        splat_bwd_cuda, splat_fwd_cuda, splat_plain,
    )
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    H, W = sensor
    h, w, _ = theta.shape
    xs, ys, ts = _sanitize_events(window.xs, window.ys, window.ts)
    E = xs.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"[kernels] {tag}: theta {tuple(theta.shape)}, {E} events x "
          f"{window.edge_ts.shape[0]} refs, sensor {H}x{W}")

    # interp at the unwarped event coordinates, edge cases appended
    ex, ey = with_edges(xs, ys, H, W)
    out_k = interp_fwd_cuda(theta, ex, ey, sensor)
    torch.cuda.synchronize()
    out_p = interp_theta_at_events_plain(theta, ex, ey, sensor)
    err = max_err(out_k, out_p, TOL_GATHER, "interp_fwd")
    lib_call, lib_out = grid_sample_interp(theta, xs, ys, sensor)
    ins = in_sensor(xs, ys, H, W)
    print(f"  grid_sample vs interp_fwd: max|d| in-sensor "
          f"{float((lib_out[ins] - out_k[:E][ins]).abs().max()):.3e}, off-sensor "
          f"{float((lib_out[~ins] - out_k[:E][~ins]).abs().max()) if bool((~ins).any()) else 0.0:.3e}")
    lib_interp_ms = cuda_ms(lib_call)
    record(rows, "interp_fwd", tag, err,
           cuda_ms(lambda: interp_fwd_cuda(theta, xs, ys, sensor)),
           cuda_ms(lambda: interp_theta_at_events_plain(theta, xs, ys, sensor)),
           16 * E + 8 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           lib_interp_ms)
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
    uy = _axis_weights(ys, h, h, float(h) / H, True)  # dense (E, h) weights
    vx = _axis_weights(xs, w, w, float(w) / W, True)
    record(rows, "interp_bwd", tag, max_err(d_k, d_p, TOL_ATOMIC, "interp_bwd"),
           cuda_ms(lambda: interp_bwd_cuda(g_main, xs, ys, tuple(theta.shape), sensor)),
           cuda_ms(lambda: torch.autograd.grad(out_main, th, g_main, retain_graph=True)),
           16 * E + 8 * h * w, OPS_INTERP_BWD * E,
           cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main)))
    del uy, vx

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
    err = max_err(f_k, f_p, TOL_ATOMIC, "splat_fwd")
    U, V = splat_planes(wx, wy, sensor)
    f_ref = f_main.detach()
    print(f"  bmm(U, V) vs splat_fwd: rel "
          f"{float((torch.bmm(U, V) - f_ref).abs().max() / f_ref.abs().max()):.3e}")
    reps = 3 if E > 100_000 else 10  # the yardsticks take tens of ms there
    record(rows, "splat_fwd", tag, err,
           cuda_ms(lambda: splat_fwd_cuda(wx, wy, sensor)),
           cuda_ms(lambda: splat_plain(wx, wy, sensor)),
           8 * R * E + 4 * R * H * W, ops_splat(1) * R * E,
           cuda_ms(lambda: torch.bmm(U, V), reps))
    Ut = U.transpose(1, 2)
    record(rows, "splat_bwd", tag,
           max(max_err(dx_k, dx_p, TOL_GATHER, "splat_bwd dwx"),
               max_err(dy_k, dy_p, TOL_GATHER, "splat_bwd dwy")),
           cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor)),
           cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G, retain_graph=True)),
           16 * R * E + 4 * R * H * W, OPS_SPLAT_BWD * R * E,
           cuda_ms(lambda: (torch.bmm(Ut, G), torch.bmm(V, G.transpose(1, 2))), reps))
    return lib_interp_ms


# ---- phase 3 ----------------------------------------------------------------

def check_bench_kernels(tag, xs, ys, ts, t_refs, theta, sensor, rows, lib_interp_ms):
    """Phase 3 at one shape: the fused warp+splat kernels and the dense
    interp against their plain versions; adds results to `rows`."""
    from eincm_tpu_torch.experimental import interp_proto as ip
    from eincm_tpu_torch.experimental import splat_fused as sf
    from eincm_tpu_torch.ops.interp import interp_fwd_cuda

    H, W = sensor
    h, w, _ = theta.shape
    E = xs.shape[0]
    print(f"[fused] {tag}: theta {tuple(theta.shape)}, {E} events, t_refs "
          f"{t_refs}, sensor {H}x{W}")
    xi, yi = torch.round(xs), torch.round(ys)
    exi, eyi = with_edges(xi, yi, H, W)
    ets = torch.cat([ts, torch.full((exi.shape[0] - E,), 0.5, device=ts.device)])
    th = interp_fwd_cuda(theta, exi, eyi, sensor)
    ethx, ethy = th[:, 0].contiguous(), th[:, 1].contiguous()
    thx, thy = ethx[:E], ethy[:E]
    e7, e8 = [], []
    for t in t_refs:
        for ws in (3, 5):
            k = sf.fused_warp_splat_cuda(exi, eyi, ets, ethx, ethy, t, sensor, ws)
            torch.cuda.synchronize()
            p = sf.fused_warp_splat_frame_plain(exi, eyi, ets, ethx, ethy, t, sensor, ws)
            e7.append(max_err(k, p, TOL_ATOMIC, f"fused_warp_splat t_ref {t} window {ws}"))
            k = sf.fully_fused_warp_splat_cuda(exi, eyi, ets, theta, t, sensor, ws)
            torch.cuda.synchronize()
            p = sf.fully_fused_warp_splat_frame_plain(exi, eyi, ets, theta, t, sensor, ws)
            e8.append(max_err(k, p, TOL_ATOMIC,
                              f"fully_fused_warp_splat t_ref {t} window {ws}"))
    t0 = t_refs[0]
    record(rows, "fused_warp_splat", tag, max(e7),
           cuda_ms(lambda: sf.fused_warp_splat_cuda(xi, yi, ts, thx, thy, t0, sensor)),
           cuda_ms(lambda: sf.fused_warp_splat_frame_plain(xi, yi, ts, thx, thy, t0, sensor)),
           20 * E + 4 * H * W, (OPS_WARP + ops_splat(1)) * E, None)
    record(rows, "fully_fused_warp_splat", tag, max(e8),
           cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(xi, yi, ts, theta, t0, sensor)),
           cuda_ms(lambda: sf.fully_fused_warp_splat_frame_plain(xi, yi, ts, theta, t0, sensor)),
           12 * E + 8 * h * w + 4 * H * W,
           (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT + OPS_WARP + ops_splat(1)) * E, None)

    ex, ey = with_edges(xs, ys, H, W)
    e9 = []
    for mode in ip.MODES:
        k = ip.interp_dense_cuda(theta, ex, ey, sensor, mode)
        torch.cuda.synchronize()
        p = ip.interp_dense_plain(theta, ex, ey, sensor, mode)
        e9.append(max_err(k, p, TOL_GATHER, f"interp_dense {mode}"))
    # `highest` is 3xTF32 on the tensor cores, within ~2^-21 of f32 per
    # term: held to kernel 1 within TOL_GATHER, not bitwise
    ins = in_sensor(xs, ys, H, W)
    xin, yin = xs[ins].contiguous(), ys[ins].contiguous()
    max_err(ip.interp_dense_cuda(theta, xin, yin, sensor, "highest"),
            interp_fwd_cuda(theta, xin, yin, sensor), TOL_GATHER,
            f"interp_dense highest vs interp_fwd, {xin.shape[0]} in-sensor events")
    record(rows, "interp_dense", tag, max(e9),
           cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "highest")),
           cuda_ms(lambda: ip.interp_dense_plain(theta, xs, ys, sensor, "highest")),
           16 * E + 8 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           lib_interp_ms,
           dot3_ms=cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "dot3")),
           bf16_ms=cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "bf16")),
           layout_ops_ms=ops_dense(h, w) * E / F32_OPS_PER_S * 1e3)


def gt_theta(vel, shape, device):
    th = torch.empty((*shape, 2), dtype=torch.float32, device=device)
    th[..., 0], th[..., 1] = vel
    return th


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    from eincm_tpu_torch.experimental import fused_splat_bench as fb
    from eincm_tpu_torch.experimental import interp_proto as ip
    from eincm_tpu_torch.models.loss import (
        LossParams, LossStatics, _sanitize_events, compute_window_statics,
        solver_loss,
    )
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.ops.splat_kernel import plan_splat
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
    build_s = _build.build_all(verbose=("splat", "interp_dense"))
    print(f"[setup] built {sorted(p.stem for p in _build.CSRC.glob('*.cu'))} "
          f"with nvcc for sm_90a in {build_s:.2f} s (ptxas report above for the "
          f"splat and the dense interp)")

    # ---- 2. the solve's kernels vs plain -------------------------------------
    t0 = time.perf_counter()
    mvsec, vels = wl.stage_mvsec_windows(device)
    print(f"[stage] 6 MVSEC windows in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dsec = wl.stage_dsec_window(device)
    print(f"[stage] DSEC window in {time.perf_counter() - t0:.2f} s")
    rows: dict = {}
    mvsec_sensor, dsec_sensor = (wl.MVSEC_H, wl.MVSEC_W), (wl.DSEC_H, wl.DSEC_W)
    for tag, win, sensor in (("mvsec", mvsec[0], mvsec_sensor), ("dsec", dsec, dsec_sensor)):
        R, E = win.edge_ts.shape[0], win.xs.shape[0]
        print(f"[plan] splat fwd at {tag}, {R} refs x {E} events: "
              f"{plan_splat(R, E, *sensor)}")
    mvsec_theta = gt_theta(vels[0], (16, 16), device)
    lib_ms = {"mvsec": check_kernels("mvsec", mvsec[0], mvsec_theta, mvsec_sensor, rows)}
    dsec_vel = (7.2 * math.cos(math.atan2(-4.0, 6.0)),
                7.2 * math.sin(math.atan2(-4.0, 6.0)))
    lib_ms["dsec"] = check_kernels("dsec", dsec, gt_theta(dsec_vel, (16, 16), device),
                                   dsec_sensor, rows)
    torch.cuda.empty_cache()

    # ---- 3. the measurement kernels, and the fused bench's paths -----------
    w0 = mvsec[0]
    xs, ys, ts = _sanitize_events(w0.xs, w0.ys, w0.ts)
    check_bench_kernels("mvsec", xs, ys, ts, [float(t) for t in w0.edge_ts.cpu()],
                        mvsec_theta, mvsec_sensor, rows, lib_ms["mvsec"])
    with torch.no_grad():
        bench_in = fb.make_inputs(device)
        check_bench_kernels("dsec", bench_in["xs"], bench_in["ys"], bench_in["ts"],
                            bench_in["t_ref_values"], bench_in["theta"], fb.SENSOR,
                            rows, lib_ms["dsec"])
        fns = fb.paths(bench_in)
        proto_in = ip.make_inputs(device)
        print("[fused] main path: the fused bench's paths A, B, C, then the dense "
              "interp against kernel 1 (1.5M events, 480x640)")
        _build.reset_launch_counts()
        fb.check_agreement(fns)
        ip.compare_with_kernel1(*proto_in)
        torch.cuda.synchronize()
        bench_launches = _build.launch_counts()
    print(f"[fused] kernel launches on that path: {bench_launches}")
    missing = [k for k in BENCH_KERNELS if bench_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the fused path: {missing}")
    del fns, bench_in, proto_in
    torch.cuda.empty_cache()

    # ---- 4. main path of the solve: the MVSEC handover chain ---------------
    cfg = wl.mvsec_solver_config()
    solver = make_window_solver(cfg, device)
    _build.reset_launch_counts()
    aees, evals = [], 0
    for res, rec in wl.solve_chain(solver, cfg, mvsec, vels):
        k = rec["window"]
        for th in res.final_theta_pyr:
            if not bool(torch.isfinite(th).all()):
                raise AssertionError(f"window {k}: non-finite theta")
        if not set(rec["statuses"]) <= OK_STATUSES:
            raise AssertionError(f"window {k}: statuses {rec['statuses']}")
        aees.append(rec["aee"])
        evals += rec["evals"]
        print(f"[chain] window {k}: {rec['ms']:.1f} ms  AEE {rec['aee']:.4f} px  "
              f"(prior kept: {rec['prior_aee']:.4f})  iters/level {rec['iters']}  "
              f"statuses {rec['statuses']}  evals {rec['evals']}  "
              f"host syncs {rec['host_syncs']}  w0 {rec['w0']:.4f}")
    chain_launches = _build.launch_counts()
    mean_aee = float(np.mean(aees[1:]))
    print(f"[chain] mean AEE windows 1-5: {mean_aee:.4f} px (limit {MAX_MEAN_AEE})")
    print(f"[chain] kernel launches during the chain: {chain_launches}; "
          f"{evals} loss evaluations")
    if not mean_aee <= MAX_MEAN_AEE:
        raise AssertionError(f"mean AEE {mean_aee} > {MAX_MEAN_AEE}")
    missing = [k for k in CHAIN_KERNELS if chain_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- 5. DSEC-scale loss: kernels on the card vs plain on CPU -----------
    params = LossParams(alpha=2000.0, beta=4000.0)
    statics = LossStatics(dsec_sensor, 5)
    gen = torch.Generator().manual_seed(1)
    theta = gt_theta(dsec_vel, (16, 16), "cpu") + 0.5 * torch.randn(16, 16, 2, generator=gen)
    out = []  # (loss, grad) with the kernels, then with the plain versions
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
        th = theta.to(dev).requires_grad_(True)
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        out.append((float(loss.detach()), grad.cpu()))
    (lk, gk), (lp, gp) = out
    rel = abs(lk - lp) / abs(lp)
    grel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"[dsec loss] kernels {lk:.7f}  plain {lp:.7f}  rel {rel:.3e} "
          f"(limit {TOL_DSEC_LOSS:.0e})  grad max rel {grel:.3e}")
    if not rel <= TOL_DSEC_LOSS:
        raise AssertionError("DSEC-scale loss: kernels disagree with plain")

    launches = {**{k: chain_launches[k] for k in CHAIN_KERNELS},
                **{k: bench_launches[k] for k in BENCH_KERNELS}}
    kernels = []
    for name in SOURCES:
        m, d = rows[name]["mvsec"], rows[name]["dsec"]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"], d["max_abs_err"]),
            **{k: v for k, v in m.items() if k != "max_abs_err"},
            **{f"dsec_{k}": v for k, v in d.items() if k != "max_abs_err"},
        }
        if name in CHAIN_KERNELS:
            entry["launches_per_loss_eval"] = launches[name] / evals
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
