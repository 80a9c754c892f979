"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero):

1. set-up: card name and power limit, torch and CUDA versions, and the
   nvcc build of every kernel in eincm_tpu_torch/csrc (one nvcc per
   source, all started together; `-Xptxas -v`'s registers, shared memory
   and spills for the interp, the splat, the fused warp+splat and the dense
   interp), and the launch plans of the splat forward, the splat backward
   and the fully fused warp+splat at both shapes;
2. each CUDA kernel of the solve against its plain PyTorch version on the
   card, at the MVSEC shape (16x16 theta, 30k events x 2 refs, 256x336)
   and the DSEC shape (1.5M events x 2 refs, 480x640), edge cases
   included, with the time of both and of one PyTorch library call that
   computes the same function, from CUDA events; the splat forward and
   both backward kernels also with a 5x5 window, with events up to 2.5
   rows off every slab edge; and both interp kernels at every grid the
   chain solves (1x1 to 16x16) and at 128x128, which is above the sizes
   their shared-memory designs take, with unaligned views, each timed
   beside its bound and its library call, the backward twice for bitwise
   equal results; and both kernels of the splat backward (one
   event per thread, and four in a row as float4s), the stream kernel
   bitwise the gather kernel's and bitwise the same twice, each timed, with
   the one the plan chooses at that shape in the row; and the direct
   kernels (float64, and the wrap-compat splat in float32 and float64)
   against the plain versions in the same precision, the float64 ones
   timed beside their bound and library call;
3. the measurement kernels (fused warp+splat, fully fused warp+splat,
   dense-layout interp) against their plain versions at the MVSEC shape
   (staged window 0, GT theta, both refs) and the DSEC shape of the fused
   bench (1.5M row-sorted events, theta N(0, 4)), timed the same way; both
   kernels of kernels 7 and 8 (scatter and cluster) at window sizes 3 and
   5, with windows on every edge of the cluster's tiles, and each cluster
   kernel with every event on one texel (its counters wrap); then their
   main path, the fused bench's paths A, B and C and the dense
   interp's comparison with the production interp, with every kernel's
   launch counter read around it;
4. the main path of the solve: a 6-window MVSEC-scale handover chain
   through `make_window_solver`, checked against the ground-truth flow,
   with the launch counters read around the chain;
5. one DSEC-scale `solver_loss` value and gradient with the kernels (on
   the card, its splat backward through the stream kernel) against the
   plain versions (on CPU tensors); in float64 on the card (the direct
   kernels, with the launch counters read around it) against float64 on
   the CPU, printed beside the float32 kernel loss with their relative
   gap; and with the wrap-compat switch on (float32: the interp kernels
   and the direct splat) against the CPU's;
6. [wolfe] the armijo rescue's configuration (strong Wolfe, 10 trials, the
   histories and the prior loss on) over the same 6-window MVSEC chain:
   statuses, finite theta, the prior loss (+inf on window 0 only), each
   level's history against its solve, the level-0 handover history, kernels
   1-4 launched, the chain AEE against the JAX package's Wolfe reading,
   and one window's host syncs read by the sync debug mode against the
   count the solver reports;
7. [eval] the EVAL path (`prepare_eval_inputs` + `evaluate_theta_array`)
   at DSEC (GT + noise theta, as phase 5) and on each Wolfe window's final
   theta, on the card against the CPU: every value of `evals`, the counts
   exactly, the splat forward launched once to prepare and twice per
   evaluation, the eval's ms per call and its host syncs.

Every kernel's time stands beside its bound: the least time the card could
take for the same work, the longer of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s (float64: 34 TFLOP/s; H100 SXM data sheet).

The last lines are the card as nvidia-smi names it, one JSON object of
per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
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
# atomics reorder the float sums of splat fwd, the fused warp+splat and
# interp bwd above 16x16, and the reordering grows with the number of events
# summed into one entry
TOL_ATOMIC = 1e-5
# interp fwd, splat bwd and the dense interp sum a fixed handful of terms
# per output (the dense interp's `highest` is 3xTF32, within ~2^-21 of f32
# per term)
TOL_GATHER = 1e-6
# interp bwd against the plain version's float32 terms summed in float64
# (`interp_bwd_plain`): a block's sums are exact (fixed point) or short f32
# sums (registers), and the blocks' partial grids are added in f32 in a
# fixed order. The float-atomic kernel of the large grids keeps TOL_ATOMIC.
TOL_INTERP_BWD = 1e-6
TOL_DSEC_LOSS = 1e-4  # relative loss difference, card kernels vs CPU plain
TOL_F64 = 1e-12  # float64 on the card vs on the CPU: the same plain versions
# px, mean over MVSEC chain windows 1..5 (|V| = 5 px): the JAX package's
# own reading on this chain (0.30 px in float32 on CPU,
# tests/test_torch_mvsec_chain.py) plus the 0.05 px band the CPU tests
# hold the port's chain to. Atomics make each run on the card differ.
# Keeping each window's prior as it came scores ~1.5 px, zero flow 5 px.
MAX_MEAN_AEE = 0.35
# px, the same bound for the armijo rescue's strong-Wolfe configuration:
# the JAX package's Wolfe reading on this chain (WOLFE_JAX_AEE px in float32
# on CPU, tests/test_torch_mvsec_chain.py[wolfe]) plus the same 0.05 px band
WOLFE_JAX_AEE = 0.3181  # the port's own: 0.3099 px
MAX_WOLFE_AEE = WOLFE_JAX_AEE + 0.05
OK_STATUSES = {0, 1, 2, 4}
# The eval, card against CPU: every value of `evals` within TOL_DSEC_LOSS
# relative, the A{n}PE rates also within one pixel's share (100 / n_ee %)
# absolute, since they count pixels whose endpoint error passes a
# threshold and a pixel within the last bits of one may count on one side
# and not on the other (a rate of 0 has no relative room); the AEE within:
TOL_EVAL_AEE = 1e-5  # relative

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
    "interp_direct_fwd": "eincm_tpu_torch/csrc/direct.cu",
    "interp_direct_bwd": "eincm_tpu_torch/csrc/direct.cu",
    "splat_direct_fwd": "eincm_tpu_torch/csrc/direct.cu",
    "splat_direct_bwd": "eincm_tpu_torch/csrc/direct.cu",
}
# the float64 and wrap-compat routes of kernels 1-6 (the JAX package runs
# these calls on XLA instead of its Pallas kernels)
DIRECT_KERNELS = ("interp_direct_fwd", "interp_direct_bwd", "splat_direct_fwd",
                  "splat_direct_bwd")
REPLACES = {
    "interp_fwd": "eincm_tpu/ops/interp_pallas.py:197",
    "interp_bwd": "eincm_tpu/ops/interp_pallas.py:239",
    "splat_fwd": "eincm_tpu/ops/splat_banded.py:374",
    "splat_bwd": "eincm_tpu/ops/splat_banded.py:491",
    "fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:449",
    "fully_fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:345",
    "interp_dense": "scripts/interp_kernel_proto.py:124",
    "interp_direct_fwd": "eincm_tpu/ops/interp_pallas.py:197",
    "interp_direct_bwd": "eincm_tpu/ops/interp_pallas.py:239",
    "splat_direct_fwd": "eincm_tpu/ops/splat_pallas.py:127",
    "splat_direct_bwd": "eincm_tpu/ops/splat_pallas.py:194",
}
ALSO_REPLACES = {
    "splat_fwd": "eincm_tpu/ops/splat_pallas.py:127",
    "splat_bwd": "eincm_tpu/ops/splat_pallas.py:194",
    "splat_direct_fwd": "eincm_tpu/ops/splat_banded.py:374",
    "splat_direct_bwd": "eincm_tpu/ops/splat_banded.py:491",
}

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # outside the tensor cores
# f32 operations per event (per event and ref for a splat), counted from
# the kernels' arithmetic with an exp as one operation:
# - interp weights, per axis 15: place u (3), floor, two triangle weights
#   (4 each), their sum, a clamp and two divisions;
# - the bilinear contraction: 2 channels x (4 products + 3 sums);
# - its backward: 4 taps x 2 channels x (2 products + 1 sum);
# - the warp: ts - t_ref, 2 products, 2 differences;
# - the splat: 2 roundings, 5 per Gaussian tap (2 per row and column) and a
#   product and a sum per texel;
# - the splat backward: 2n taps (5 each), 2n q g(q), and two n x n
#   contractions of n x (n products + n - 1 sums) + n products + n - 1 sums,
#   n = 2 hw + 1 (3: 30 + 6 + 40).
OPS_INTERP_WEIGHTS = 30
OPS_INTERP_CONTRACT = 14
OPS_INTERP_BWD = 30 + 24
OPS_WARP = 5


def ops_splat(hw: int) -> int:
    n = 2 * hw + 1
    return 2 + 2 * n * 5 + 2 * n * n


def ops_splat_bwd(hw: int) -> int:
    n = 2 * hw + 1
    return 2 * n * 5 + 2 * n + 2 * (n * (2 * n - 1) + 2 * n - 1)


def ops_dense(h: int, w: int) -> int:
    """The dense interp's own f32 operations per event in mode `highest`,
    on h, w padded to 8: weights of every cell (4 ops, a sum and a division
    each), then 2 channels x wp x hp products and sums and 2 x wp more.
    Not its bound: the function is kernel 1's, whose work bounds both."""
    hp, wp = max(8, -(-h // 8) * 8), max(8, -(-w // 8) * 8)
    return 6 + 6 * (hp + wp) + 4 * wp * hp + 4 * wp


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least ms, what bounds it) on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def record(rows, name, tag, err, ms, plain_ms, n_bytes, n_ops, library_ms,
           ops_per_s=F32_OPS_PER_S, **extra):
    bound_ms, bound_by = bound(n_bytes, n_ops, ops_per_s)
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


def slab_edge_events(tile_rows, H, W, device, seed):
    """(x, y) of events on and around every edge between slabs of
    `tile_rows` rows: their windows straddle two blocks' shared memory (a
    5x5 window's up to 2.5 rows off the edge)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    edges = torch.arange(tile_rows, H, tile_rows, dtype=torch.float32, device=device)
    offs = torch.tensor([-2.5, -2.0, -1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0, 1.5,
                         2.0, 2.4], device=device)
    y = (edges[:, None] + offs[None, :]).reshape(-1)
    x = torch.rand(y.shape[0], generator=gen, device=device) * (W - 1)
    return x, y


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
    taps that follow them are left out. In the coordinates' dtype."""
    from eincm_tpu_torch.ops.splat_kernel import _gauss1d

    R, E = wx.shape
    H, W = sensor
    d = torch.tensor([-1.0, 0.0, 1.0], dtype=wx.dtype, device=wx.device)
    zero = torch.zeros((), dtype=wx.dtype, device=wx.device)
    rows = torch.round(wy)[..., None] + d  # (R, E, 3)
    cols = torch.round(wx)[..., None] + d
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    gy = torch.where(vr, _gauss1d(torch.where(vr, rows - wy[..., None], zero)), zero)
    gx = torch.where(vc, _gauss1d(torch.where(vc, cols - wx[..., None], zero)), zero)
    U = torch.zeros((R, H, E), dtype=wx.dtype, device=wx.device)
    U.scatter_add_(1, torch.where(vr, rows, zero).long().transpose(1, 2),
                   gy.transpose(1, 2).contiguous())
    V = torch.zeros((R, E, W), dtype=wx.dtype, device=wx.device)
    V.scatter_add_(2, torch.where(vc, cols, zero).long(), gx)
    return U, V


# ---- phase 2 ----------------------------------------------------------------

INTERP_GRIDS = ((1, 1), (2, 2), (4, 4), (8, 8), (16, 16))  # the chain's levels
LARGE_GRID = (128, 128)  # theta not staged (fwd), float atomics (bwd)


def check_interp_grids(tag, xs, ys, sensor, rows):
    """Both interp kernels at each grid against the plain version, timed
    beside their bound and library call; results under `by_grid`."""
    from eincm_tpu_torch.ops import interp as ti

    H, W = sensor
    E = xs.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    ex, ey = with_edges(xs, ys, H, W)
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda")
    g_main = g[:E].contiguous()
    by_grid = {"interp_fwd": {}, "interp_bwd": {}}
    for h, w in INTERP_GRIDS + (LARGE_GRID,):
        name = f"{h}x{w}"
        theta = 3.0 * torch.randn(h, w, 2, generator=gen, device="cuda")
        p_fwd = ti.plan_interp(E, h, w)
        p_bwd = ti.plan_interp(E, h, w, True)
        print(f"[interp] {tag} {name}: fwd {p_fwd.mode}, {p_fwd.blocks} x {p_fwd.threads}; "
              f"bwd {p_bwd.mode}, {p_bwd.blocks} x {p_bwd.threads}, {p_bwd.slices} slices")
        out_p = ti.interp_theta_at_events_plain(theta, ex, ey, sensor)
        err_f = 0.0
        # whole, and as views that start 4 and 12 bytes into a 16-byte line
        # (in groups of four from the first aligned event, and one by one)
        for off in (0, 1, 3):
            for grouped in (True, False):
                vx, vy = ex[off:], ey[off:]
                plan = ti.plan_interp(vx.shape[0], h, w, grouped=grouped, offsets=(
                    ti.float_offset(vx), ti.float_offset(vy), 0))  # a new output
                out_k = ti.interp_fwd_cuda(theta, vx, vy, sensor, plan)
                torch.cuda.synchronize()
                what = f"interp_fwd {name} +{off} {'groups' if grouped else 'single'}"
                err_f = max(err_f, max_err(out_k, out_p[off:], TOL_GATHER, what))
                if not torch.equal(out_k[fin[off:]], out_p[off:][fin[off:]]):
                    raise AssertionError(f"{what}: not bitwise the plain version's")
        d_p = ti.interp_bwd_plain(g, bx, by, (h, w, 2), sensor, torch.float64)
        tol = TOL_ATOMIC if p_bwd.mode == "float" else TOL_INTERP_BWD
        err_b = 0.0
        for off in (0, 1, 3):
            for grouped in (True, False):
                vx, vy, vg = bx[off:], by[off:], g[off:]
                plan = ti.plan_interp(vx.shape[0], h, w, True, tuple(
                    map(ti.float_offset, (vx, vy, vg))), grouped=grouped)
                d_k = ti.interp_bwd_cuda(vg, vx, vy, (h, w, 2), sensor, plan)
                d_again = ti.interp_bwd_cuda(vg, vx, vy, (h, w, 2), sensor, plan)
                torch.cuda.synchronize()
                ref = d_p if off == 0 else ti.interp_bwd_plain(
                    vg, vx, vy, (h, w, 2), sensor, torch.float64)
                what = f"interp_bwd {name} +{off} {'groups' if grouped else 'single'}"
                err_b = max(err_b, max_err(d_k, ref, tol, what))
                if plan.mode != "float" and not torch.equal(d_k, d_again):
                    raise AssertionError(f"{what}: two runs differ")
        n_bytes = 16 * E + 8 * h * w
        lib_call, _ = grid_sample_interp(theta, xs, ys, sensor)
        uy = ti._axis_weights(ys, h, h, float(h) / H, True)  # dense (E, h) weights
        vx = ti._axis_weights(xs, w, w, float(w) / W, True)
        reps = 3 if E * h > 10_000_000 else 10  # the large grid's einsum takes ms
        for kernel, err, ms, ops, lib in (
            ("interp_fwd", err_f,
             cuda_ms(lambda: ti.interp_fwd_cuda(theta, xs, ys, sensor)),
             OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT, cuda_ms(lib_call)),
            ("interp_bwd", err_b,
             cuda_ms(lambda: ti.interp_bwd_cuda(g_main, xs, ys, (h, w, 2), sensor)),
             OPS_INTERP_BWD,
             cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main), reps)),
        ):
            bound_ms, bound_by = bound(n_bytes, ops * E)
            by_grid[kernel][name] = {
                "max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib,
                "mode": (p_fwd if kernel == "interp_fwd" else p_bwd).mode,
            }
            print(f"  {kernel} {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), library {lib:.4f} ms")
        del uy, vx
    for kernel, grids in by_grid.items():
        rows[kernel][tag]["by_grid"] = grids


def check_kernels(tag, window, theta, sensor, rows):
    """Phase 2 at one shape; adds per-kernel results to `rows`."""
    from eincm_tpu_torch.models.loss import _sanitize_events
    from eincm_tpu_torch.ops.interp import (
        _axis_weights, interp_bwd_cuda, interp_bwd_plain, interp_fwd_cuda,
        interp_theta_at_events_plain,
    )
    from eincm_tpu_torch.ops.splat_kernel import (
        plan_splat, plan_splat_bwd, splat_bwd_cuda, splat_fwd_cuda, splat_plain,
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
    d_p = interp_bwd_plain(g, bx, by, tuple(theta.shape), sensor, torch.float64)
    th = theta.detach().clone().requires_grad_(True)
    g_main = torch.randn(E, 2, generator=gen, device="cuda")
    out_main = interp_theta_at_events_plain(th, xs, ys, sensor)
    uy = _axis_weights(ys, h, h, float(h) / H, True)  # dense (E, h) weights
    vx = _axis_weights(xs, w, w, float(w) / W, True)
    record(rows, "interp_bwd", tag, max_err(d_k, d_p, TOL_INTERP_BWD, "interp_bwd"),
           cuda_ms(lambda: interp_bwd_cuda(g_main, xs, ys, tuple(theta.shape), sensor)),
           cuda_ms(lambda: torch.autograd.grad(out_main, th, g_main, retain_graph=True)),
           16 * E + 8 * h * w, OPS_INTERP_BWD * E,
           cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main)))
    del uy, vx
    check_interp_grids(tag, xs, ys, sensor, rows)

    # splat at the warped coordinates of the real window, edge cases appended
    wx, wy = warp_events_multi_ref_coarse(theta, xs, ys, ts, window.edge_ts, sensor)
    R = wx.shape[0]
    p_bwd = plan_splat_bwd(R, E, H, W)
    sx, sy = slab_edge_events(plan_splat(R, E, H, W).tile_rows, H, W, wx.device, 3)
    ew = [with_edges(torch.cat([wx[r], sx]), torch.cat([wy[r], sy]), H, W) for r in range(R)]
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
    # both backward kernels, whichever the plan chooses at this shape: on the
    # window's events (float4s) and with the edge cases and the slab-edge
    # events appended (no multiple of 4 events: no float4s); the stream
    # kernel bitwise the gather kernel's, and bitwise the same twice
    by_kernel = {}
    for what, (ax, ay) in (("window", (wx, wy)), ("edge cases", (wxe, wye))):
        n = ax.shape[1]
        plans = {k: plan_splat_bwd(R, n, H, W, k) for k in ("gather", "stream")}
        out = {k: splat_bwd_cuda(ax, ay, G, sensor, plan=p) for k, p in plans.items()}
        again = splat_bwd_cuda(ax, ay, G, sensor, plan=plans["stream"])
        torch.cuda.synchronize()
        for k in (0, 1):
            if not torch.equal(out["stream"][k], out["gather"][k]):
                raise AssertionError(f"splat_bwd {what}: the stream kernel is not bitwise "
                                     f"the gather kernel's")
            if not torch.equal(out["stream"][k], again[k]):
                raise AssertionError(f"splat_bwd {what}: two runs of the stream kernel differ")
        print(f"  splat_bwd {what}: {plans['stream']}: bitwise the gather kernel's, and the "
              f"same twice")
        if what == "window":
            by_kernel = {k: cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor, plan=p))
                         for k, p in plans.items()}
    print(f"  splat_bwd at {tag}: the plan chooses {p_bwd.kernel}; gather "
          f"{by_kernel['gather']:.4f} ms, stream {by_kernel['stream']:.4f} ms")
    record(rows, "splat_bwd", tag,
           max(max_err(dx_k, dx_p, TOL_GATHER, "splat_bwd dwx"),
               max_err(dy_k, dy_p, TOL_GATHER, "splat_bwd dwy"),
               max_err(out["stream"][0], dx_p, TOL_GATHER, "splat_bwd stream dwx"),
               max_err(out["stream"][1], dy_p, TOL_GATHER, "splat_bwd stream dwy")),
           cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor)),
           cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G, retain_graph=True)),
           16 * R * E + 4 * R * H * W, ops_splat_bwd(1) * R * E,
           cuda_ms(lambda: (torch.bmm(Ut, G), torch.bmm(V, G.transpose(1, 2))), reps),
           kernel=p_bwd.kernel, gather_ms=by_kernel["gather"],
           stream_ms=by_kernel["stream"])
    check_splat_window5(tag, wx, wy, wxe, wye, G, sensor, rows)
    del U, V, Ut
    check_direct(tag, theta, xs, ys, wx, wy, wxe, wye, G, sensor, rows)
    return lib_interp_ms


def check_splat_window5(tag, wx, wy, wxe, wye, G, sensor, rows):
    """The splat forward and both backward kernels with a 5x5 window, on
    the window's events with the edge cases and the slab-edge events
    appended: the forward within TOL_ATOMIC of the plain version, both
    backward kernels within TOL_GATHER and bitwise equal to each other; the
    times at window 5 beside their bounds, under `window5_*` in the rows
    of window 3."""
    from eincm_tpu_torch.ops.splat_kernel import (
        plan_splat_bwd, splat_bwd_cuda, splat_fwd_cuda, splat_plain,
    )

    H, W = sensor
    R, E = wx.shape
    f_k = splat_fwd_cuda(wxe, wye, sensor, 5)
    torch.cuda.synchronize()
    wxr, wyr = wxe.clone().requires_grad_(True), wye.clone().requires_grad_(True)
    f_p = splat_plain(wxr, wyr, sensor, 5)
    err_f = max_err(f_k, f_p, TOL_ATOMIC, "splat_fwd window 5")
    dx_p, dy_p = torch.autograd.grad(f_p, (wxr, wyr), G)
    n = wxe.shape[1]
    out = {k: splat_bwd_cuda(wxe, wye, G, sensor, 5, plan_splat_bwd(R, n, H, W, k))
           for k in ("gather", "stream")}
    torch.cuda.synchronize()
    for k in (0, 1):
        if not torch.equal(out["stream"][k], out["gather"][k]):
            raise AssertionError("splat_bwd window 5: the stream kernel is not bitwise the "
                                 "gather kernel's")
    print("  splat_bwd window 5: the stream kernel is bitwise the gather kernel's")
    err_b = max(max_err(out[k][i], ref, TOL_GATHER, f"splat_bwd window 5 {k} {what}")
                for k in out for i, (what, ref) in enumerate((("dwx", dx_p), ("dwy", dy_p))))
    fwd_ms = cuda_ms(lambda: splat_fwd_cuda(wx, wy, sensor, 5))
    bwd_ms = cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor, 5))
    for name, err, ms, n_bytes, ops in (
        ("splat_fwd", err_f, fwd_ms, 8 * R * E + 4 * R * H * W, ops_splat(2) * R * E),
        ("splat_bwd", err_b, bwd_ms, 16 * R * E + 4 * R * H * W, ops_splat_bwd(2) * R * E),
    ):
        bound_ms, bound_by = bound(n_bytes, ops)
        row = rows[name][tag]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(window5_ms=ms, window5_bound_ms=bound_ms, window5_bound_by=bound_by)
        print(f"  {name} window 5: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


def check_direct(tag, theta, xs, ys, wx, wy, wxe, wye, G, sensor, rows):
    """The direct kernels of csrc/direct.cu against the plain versions in
    the same precision, with the edge cases and slab-edge events: the
    float64 interp fwd and bwd and the splat fwd and bwd within TOL_F64,
    the wrap-compat splat in float32 (TOL_ATOMIC forward, TOL_GATHER
    backward) and float64 (TOL_F64) at windows 3 and 5; then the float64
    kernels at the window's shape timed beside their plain version, bound
    (float64 operations over F64_OPS_PER_S) and library call, in float64."""
    from eincm_tpu_torch.ops import interp as ti
    from eincm_tpu_torch.ops import splat_kernel as sk

    H, W = sensor
    h, w, _ = theta.shape
    E = xs.shape[0]
    R = wx.shape[0]
    f64 = torch.float64
    gen = torch.Generator(device="cuda").manual_seed(6)
    th64 = theta.to(f64)
    ex, ey = (t.to(f64) for t in with_edges(xs, ys, H, W))
    err_if = max_err(ti.interp_direct_fwd_cuda(th64, ex, ey, sensor),
                     ti.interp_theta_at_events_plain(th64, ex, ey, sensor), TOL_F64,
                     "interp_direct_fwd float64")
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda", dtype=f64)
    err_ib = max_err(ti.interp_direct_bwd_cuda(g, bx, by, (h, w, 2), sensor),
                     ti.interp_bwd_plain(g, bx, by, (h, w, 2), sensor), TOL_F64,
                     "interp_direct_bwd float64")
    err_sf = err_sb = 0.0
    for dtype in (torch.float32, f64):
        ax, ay = wxe.to(dtype).contiguous(), wye.to(dtype).contiguous()
        Gd = G.to(dtype)
        for wrap in (False, True) if dtype == f64 else (True,):
            for ws in (3, 5):
                what = f"{dtype} window {ws}{' wrap' if wrap else ''}"
                ar, br = ax.clone().requires_grad_(True), ay.clone().requires_grad_(True)
                f_p = sk.splat_plain(ar, br, sensor, ws, wrap=wrap)
                f_k = sk.splat_direct_fwd_cuda(ax, ay, sensor, ws, wrap)
                d_p = torch.autograd.grad(f_p, (ar, br), Gd)
                d_k = sk.splat_direct_bwd_cuda(ax, ay, Gd, sensor, ws, wrap)
                torch.cuda.synchronize()
                tol_f, tol_b = (TOL_F64, TOL_F64) if dtype == f64 else (TOL_ATOMIC, TOL_GATHER)
                err_sf = max(err_sf, max_err(f_k, f_p, tol_f, f"splat_direct_fwd {what}"))
                for k, p, n in zip(d_k, d_p, ("dwx", "dwy")):
                    err_sb = max(err_sb, max_err(k, p, tol_b, f"splat_direct_bwd {what} {n}"))
    # times at the window's own shape, in float64
    x64, y64 = xs.to(f64), ys.to(f64)
    g_main = torch.randn(E, 2, generator=gen, device="cuda", dtype=f64)
    thr = th64.clone().requires_grad_(True)
    out_main = ti.interp_theta_at_events_plain(thr, x64, y64, sensor)
    lib_call, _ = grid_sample_interp(th64, x64, y64, sensor)
    record(rows, "interp_direct_fwd", tag, err_if,
           cuda_ms(lambda: ti.interp_direct_fwd_cuda(th64, x64, y64, sensor)),
           cuda_ms(lambda: ti.interp_theta_at_events_plain(th64, x64, y64, sensor)),
           32 * E + 16 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           cuda_ms(lib_call), F64_OPS_PER_S)
    uy = ti._axis_weights(y64, h, h, float(h) / H, True)
    vx = ti._axis_weights(x64, w, w, float(w) / W, True)
    record(rows, "interp_direct_bwd", tag, err_ib,
           cuda_ms(lambda: ti.interp_direct_bwd_cuda(g_main, x64, y64, (h, w, 2), sensor)),
           cuda_ms(lambda: torch.autograd.grad(out_main, thr, g_main, retain_graph=True)),
           32 * E + 16 * h * w, OPS_INTERP_BWD * E,
           cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main)), F64_OPS_PER_S)
    del uy, vx, out_main
    wx64, wy64 = wx.to(f64), wy.to(f64)
    G64 = G.to(f64)
    wxm, wym = wx64.clone().requires_grad_(True), wy64.clone().requires_grad_(True)
    f_main = sk.splat_plain(wxm, wym, sensor)
    U, V = splat_planes(wx64, wy64, sensor)
    reps = 3 if E > 100_000 else 10
    record(rows, "splat_direct_fwd", tag, err_sf,
           cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx64, wy64, sensor)),
           cuda_ms(lambda: sk.splat_plain(wx64, wy64, sensor)),
           16 * R * E + 8 * R * H * W, ops_splat(1) * R * E,
           cuda_ms(lambda: torch.bmm(U, V), reps), F64_OPS_PER_S,
           wrap_f32_ms=cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx, wy, sensor, 3, True)))
    Ut = U.transpose(1, 2)
    record(rows, "splat_direct_bwd", tag, err_sb,
           cuda_ms(lambda: sk.splat_direct_bwd_cuda(wx64, wy64, G64, sensor)),
           cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G64, retain_graph=True)),
           32 * R * E + 8 * R * H * W, ops_splat_bwd(1) * R * E,
           cuda_ms(lambda: (torch.bmm(Ut, G64), torch.bmm(V, G64.transpose(1, 2))), reps),
           F64_OPS_PER_S,
           wrap_f32_ms=cuda_ms(lambda: sk.splat_direct_bwd_cuda(wx, wy, G, sensor, 3, True)))
    del U, V, Ut, f_main
    torch.cuda.empty_cache()


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
    p8 = sf.card_plan(E, H, W, h, w)
    print(f"[plan] fully fused warp+splat at {tag}: {p8}")
    tiles = sf.plan_fused(E, H, W, h, w, "cluster")
    # events on every edge between the cluster's tiles, once at each
    # reference time, where they are not displaced
    sx, sy = slab_edge_events(tiles.tile_rows, H, W, xs.device, 4)
    n_slab = sx.shape[0]
    exi, eyi = with_edges(torch.cat([xi] + [torch.round(sx)] * len(t_refs)),
                          torch.cat([yi] + [torch.round(sy)] * len(t_refs)), H, W)
    ets = torch.cat([ts] + [torch.full((n_slab,), t, device=ts.device) for t in t_refs]
                    + [torch.full((exi.shape[0] - E - n_slab * len(t_refs),), 0.5,
                                  device=ts.device)])
    th = interp_fwd_cuda(theta, exi, eyi, sensor)
    ethx, ethy = th[:, 0].contiguous(), th[:, 1].contiguous()
    thx, thy = ethx[:E], ethy[:E]
    p7 = sf.card_plan(E, H, W, 0, 0)
    print(f"[plan] fused warp+splat (kernel 7) at {tag}: {p7}")
    e7, e8 = [], []
    for t in t_refs:
        for ws in (3, 5):
            p = sf.fused_warp_splat_frame_plain(exi, eyi, ets, ethx, ethy, t, sensor, ws)
            # both of kernel 7's kernels, whichever the plan chooses here
            for kernel in ("scatter", "cluster"):
                plan = sf.plan_fused(exi.shape[0], H, W, 0, 0, kernel)
                k = sf.fused_warp_splat_cuda(exi, eyi, ets, ethx, ethy, t, sensor, ws, plan)
                torch.cuda.synchronize()
                e7.append(max_err(k, p, TOL_ATOMIC,
                                  f"fused_warp_splat {kernel} t_ref {t} window {ws}"))
            p = sf.fully_fused_warp_splat_frame_plain(exi, eyi, ets, theta, t, sensor, ws)
            # both of kernel 8's kernels, whichever the plan chooses here
            for kernel in ("scatter", "cluster"):
                plan = sf.plan_fused(exi.shape[0], H, W, h, w, kernel)
                k = sf.fully_fused_warp_splat_cuda(exi, eyi, ets, theta, t, sensor, ws, plan)
                torch.cuda.synchronize()
                e8.append(max_err(k, p, TOL_ATOMIC,
                                  f"fully_fused_warp_splat {kernel} t_ref {t} window {ws}"))
    t0 = t_refs[0]
    by_kernel = {
        kernel: cuda_ms(lambda: sf.fused_warp_splat_cuda(
            xi, yi, ts, thx, thy, t0, sensor, 3, sf.plan_fused(E, H, W, 0, 0, kernel)))
        for kernel in ("scatter", "cluster")}
    print(f"  fused_warp_splat at {tag}: the plan chooses {p7.kernel}; scatter "
          f"{by_kernel['scatter']:.4f} ms, cluster {by_kernel['cluster']:.4f} ms")
    record(rows, "fused_warp_splat", tag, max(e7),
           cuda_ms(lambda: sf.fused_warp_splat_cuda(xi, yi, ts, thx, thy, t0, sensor)),
           cuda_ms(lambda: sf.fused_warp_splat_frame_plain(xi, yi, ts, thx, thy, t0, sensor)),
           20 * E + 4 * H * W, (OPS_WARP + ops_splat(1)) * E, None,
           kernel=p7.kernel, scatter_ms=by_kernel["scatter"], cluster_ms=by_kernel["cluster"],
           window5_ms=cuda_ms(lambda: sf.fused_warp_splat_cuda(
               xi, yi, ts, thx, thy, t0, sensor, 5)))
    by_kernel = {
        kernel: cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(
            xi, yi, ts, theta, t0, sensor, 3, sf.plan_fused(E, H, W, h, w, kernel)))
        for kernel in ("scatter", "cluster")}
    print(f"  fully_fused_warp_splat at {tag}: the plan chooses {p8.kernel}; scatter "
          f"{by_kernel['scatter']:.4f} ms, cluster {by_kernel['cluster']:.4f} ms")
    record(rows, "fully_fused_warp_splat", tag, max(e8),
           cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(xi, yi, ts, theta, t0, sensor)),
           cuda_ms(lambda: sf.fully_fused_warp_splat_frame_plain(xi, yi, ts, theta, t0, sensor)),
           12 * E + 8 * h * w + 4 * H * W,
           (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT + OPS_WARP + ops_splat(1)) * E, None,
           kernel=p8.kernel, scatter_ms=by_kernel["scatter"], cluster_ms=by_kernel["cluster"],
           window5_ms=cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(
               xi, yi, ts, theta, t0, sensor, 5)))

    # the worst contention, and the counters' wrap: 40k events inside one
    # texel on a tile edge, kept there by a zero theta (kernel 8) or zero
    # velocities (kernel 7), through both cluster kernels; against the
    # plain version in f64
    gen = torch.Generator(device=xs.device).manual_seed(5)
    ox = 300.2 + 0.2 * torch.rand(40_000, generator=gen, device=xs.device)
    oy = tiles.tile_rows - 0.1 + 0.2 * torch.rand(40_000, generator=gen, device=xs.device)
    ot = torch.rand(40_000, generator=gen, device=xs.device)
    zero = torch.zeros_like(theta)
    zv = torch.zeros_like(ox)
    for ws in (3, 5):
        p = sf.fully_fused_warp_splat_frame_plain(
            ox.double(), oy.double(), ot.double(), zero.double(), 0.0, sensor, ws)
        if not float(p.max()) > 256.0:
            raise AssertionError("the one-texel case does not wrap a counter")
        k = sf.fully_fused_warp_splat_cuda(ox, oy, ot, zero, 0.0, sensor, ws,
                                           sf.plan_fused(40_000, H, W, h, w, "cluster"))
        torch.cuda.synchronize()
        max_err(k, p, TOL_ATOMIC,
                f"fully_fused_warp_splat every event on one texel, window {ws}")
        k = sf.fused_warp_splat_cuda(ox, oy, ot, zv, zv, 0.0, sensor, ws,
                                     sf.plan_fused(40_000, H, W, 0, 0, "cluster"))
        torch.cuda.synchronize()
        max_err(k, p, TOL_ATOMIC, f"fused_warp_splat every event on one texel, window {ws}")

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


def count_syncs(fn):
    """(fn(), the synchronizing CUDA operations it made, {file:line: count}
    of the innermost lines of this repository that made them), read with
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import collections
    import os
    import traceback
    import warnings

    root = os.path.dirname(os.path.realpath(__file__))  # the path imports resolve to
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            path, line = [(os.path.realpath(f.filename), f.lineno)
                          for f in traceback.extract_stack()[:-1]  # not this frame
                          if os.path.realpath(f.filename).startswith(root)][-1]
            where[f"{os.path.relpath(path, root)}:{line}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # the first switch to "warn" in a process reports itself as a sync
        warnings.showwarning = lambda *args, **kw: None
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(where)


def eval_both(tag, theta_full, staged, params, sensor, device):
    """`prepare_eval_inputs` + `evaluate_theta_array` of a full-sensor theta
    over a staged sample's eval events and GT, on `device` and then on the
    CPU, the launch counters read around each call; the first's values held
    to the CPU's. Returns the first's (evals, ms per evaluation, ms to
    prepare, host syncs of one evaluation)."""
    from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, prepare_eval_inputs
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils.profiling import timed

    ev = staged.eval_events
    out = []
    for dev in (device, torch.device("cpu")):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        ex, ey, et = f32(ev["x"]), f32(ev["y"]), f32(ev["t"])
        edges, edge_ts = staged.window.edges.to(dev), staged.window.edge_ts.to(dev)
        gt, th = f32(staged.gt_flow), theta_full.to(dev)
        prep = lambda: prepare_eval_inputs(ex, ey, et, edges, sensor, dtype=th.dtype)
        evaluate = lambda: evaluate_theta_array(
            th, exs, eys, ets, edges, edge_ts, gt, params, sensor, window_statics=wstat)
        _build.reset_launch_counts()
        exs, eys, ets, wstat = prep()
        prep_launches = _build.launch_counts()
        _build.reset_launch_counts()
        _, eval_str, evals, _ = evaluate()
        eval_launches = _build.launch_counts()
        out.append(evals)
        if len(out) > 1:
            continue
        if dev.type == "cuda" and (prep_launches["splat_fwd"], eval_launches["splat_fwd"]) != (1, 2):
            raise AssertionError(f"[eval] {tag}: splat_fwd launched {prep_launches} to "
                                 f"prepare, {eval_launches} per evaluation; not 1 and 2")
        prep_s, _ = timed(prep, iters=3)
        eval_s, _ = timed(evaluate, iters=5)
        syncs = None
        if dev.type == "cuda":
            _, syncs, where = count_syncs(evaluate)
            if syncs != 1:
                raise AssertionError(f"[eval] {tag}: {syncs} host syncs per evaluation, "
                                     f"not the one transfer of its bundle: {where}")
        print(f"[eval] {tag}: {eval_str.strip()}")
        print(f"[eval] {tag}: {eval_s * 1e3:.3f} ms per evaluation, prepare "
              f"{prep_s * 1e3:.3f} ms; launches: prepare {prep_launches['splat_fwd']} "
              f"splat_fwd, evaluation {dict((n, c) for n, c in eval_launches.items() if c)}; "
              f"{syncs} host sync(s) per evaluation")
        first = (evals, eval_s * 1e3, prep_s * 1e3, syncs)
    k, p = out
    counts = ("n_ee", "n_pred", "n_gt", "n_pixels")
    for key in counts:
        if int(k[key]) != int(p[key]):
            raise AssertionError(f"[eval] {tag}: {key} card {k[key]}, CPU {p[key]}")
    worst = 0.0
    for key, ref in p.items():
        if key in counts:
            continue
        ref, got = np.asarray(ref, np.float64), np.asarray(k[key], np.float64)
        atol = 100.0 / max(int(p["n_ee"]), 1) if key[0] == "A" and key.endswith("PE") else 0.0
        err = np.abs(got - ref)
        if not np.all(err <= TOL_DSEC_LOSS * np.abs(ref) + atol):
            raise AssertionError(f"[eval] {tag}: {key} card {got}, CPU {ref}")
        worst = max(worst, float(np.max(err / np.maximum(np.abs(ref), 1e-30))))
    aee_rel = abs(float(k["AEE"]) - float(p["AEE"])) / max(abs(float(p["AEE"])), 1e-30)
    if not aee_rel <= TOL_EVAL_AEE:
        raise AssertionError(f"[eval] {tag}: AEE card {k['AEE']}, CPU {p['AEE']}")
    print(f"[eval] {tag}: card vs CPU, every value within {TOL_DSEC_LOSS:.0e} relative "
          f"(worst {worst:.3e}), AEE rel {aee_rel:.3e}, counts equal "
          f"(n_ee {int(k['n_ee'])}, n_pred {int(k['n_pred'])}, n_gt {int(k['n_gt'])})")
    return first


def wolfe_chain(cfg, windows, vels, device):
    """Phase 6: the chain under the armijo rescue's configuration, each
    window checked (see the module docstring), then window 1 again under
    the sync debug mode. Returns (results, launches, evaluations, record)."""
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils import workloads as wl

    wcfg = dataclasses.replace(cfg, line_search="wolfe", max_ls_evals=10,
                               collect_intermediate=True, compute_prior_loss=True)
    solver = make_window_solver(wcfg, device)
    ho_cap = 2 + 2 + wcfg.handover_opt_maxiters[0]  # bounds, 2 interior, 1 a step
    _build.reset_launch_counts()
    seen = _build.launch_counts()
    aees, ms, evals, results, per_window = [], [], 0, [], []
    for res, rec in wl.solve_chain(solver, wcfg, windows, vels):
        k = rec["window"]
        now = _build.launch_counts()
        rec["launches_per_eval"] = {n: (now[n] - seen[n]) / rec["evals"] for n in CHAIN_KERNELS}
        seen = now
        for th in res.final_theta_pyr:
            if not bool(torch.isfinite(th).all()):
                raise AssertionError(f"[wolfe] window {k}: non-finite theta")
        if not set(rec["statuses"]) <= OK_STATUSES:
            raise AssertionError(f"[wolfe] window {k}: statuses {rec['statuses']}")
        prior_loss = float(res.prior_loss_lvl0)
        if (prior_loss == math.inf) != (k == 0) or math.isnan(prior_loss):
            raise AssertionError(f"[wolfe] window {k}: prior loss {prior_loss}")
        for lvl, (h, st) in enumerate(zip(res.theta_histories, res.theta_opt_states)):
            if h.n != st.total_iters or float(h.fs[h.n - 1]) != float(st.fun_val):
                raise AssertionError(f"[wolfe] window {k} level {lvl}: history n {h.n}, "
                                     f"last loss {float(h.fs[h.n - 1])}; the solve's "
                                     f"{st.total_iters}, {float(st.fun_val)}")
        ho = res.handover_histories[0]
        if ho.n != (0 if k == 0 else ho_cap) or ho.xs.shape != (ho_cap,):
            raise AssertionError(f"[wolfe] window {k}: handover history n {ho.n}, "
                                 f"{tuple(ho.xs.shape)} (capacity {ho_cap})")
        aees.append(rec["aee"])
        ms.append(rec["ms"])
        evals += rec["evals"]
        results.append(res)
        rec["prior_loss"] = prior_loss
        per_window.append(rec)
        print(f"[wolfe] window {k}: {rec['ms']:.1f} ms  AEE {rec['aee']:.4f} px  iters/level "
              f"{rec['iters']}  statuses {rec['statuses']}  evals {rec['evals']}  host syncs "
              f"{rec['host_syncs']}  prior loss {prior_loss:.6f}  launches per evaluation "
              f"{ {n: round(v, 4) for n, v in rec['launches_per_eval'].items()} }")
    launches = _build.launch_counts()
    mean_aee = float(np.mean(aees[1:]))
    print(f"[wolfe] mean AEE windows 1-5: {mean_aee:.4f} px (limit {MAX_WOLFE_AEE}; JAX on "
          f"CPU {WOLFE_JAX_AEE}); kernel launches {launches}; {evals} loss evaluations; "
          f"window ms median of 1-5 {float(np.median(ms[1:])):.1f}")
    if not mean_aee <= MAX_WOLFE_AEE:
        raise AssertionError(f"[wolfe] mean AEE {mean_aee} > {MAX_WOLFE_AEE}")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"[wolfe] kernels not launched: {missing}")
    row = {"windows": per_window, "mean_aee": mean_aee, "median_ms": float(np.median(ms[1:]))}
    if device.type == "cuda":
        # window 1 again from window 0's result: every synchronizing
        # operation of the solve, read by the sync debug mode, against the
        # count the solver reports
        res1, syncs, where = count_syncs(
            lambda: solver(windows[1], results[0].final_theta_pyr, False))
        print(f"[wolfe] window 1 again: {syncs} synchronizing operations seen, n_host_syncs "
              f"{res1.n_host_syncs}; made at {where}")
        if syncs != res1.n_host_syncs:
            raise AssertionError("[wolfe] the solve synchronizes where it does not count it")
        row["sync_check"] = {"seen": syncs, "n_host_syncs": res1.n_host_syncs, "where": where}
    return results, launches, evals, row


def gt_theta(vel, shape, device):
    th = torch.empty((*shape, 2), dtype=torch.float32, device=device)
    th[..., 0], th[..., 1] = vel
    return th


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)
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
    from eincm_tpu_torch.ops.splat import set_splat_wrap_compat
    from eincm_tpu_torch.ops.splat_kernel import plan_splat, plan_splat_bwd
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
    build_s = _build.build_all(verbose=("interp", "splat", "fused", "interp_dense", "direct"))
    print(f"[setup] built {sorted(p.stem for p in _build.CSRC.glob('*.cu'))} "
          f"with nvcc for sm_90a in {build_s:.2f} s (ptxas report above)")

    # ---- 2. the solve's kernels vs plain -------------------------------------
    t0 = time.perf_counter()
    mvsec_staged, vels = wl.stage_mvsec_samples(device)
    mvsec = [s.window for s in mvsec_staged]
    print(f"[stage] 6 MVSEC windows in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dsec_staged = wl.stage_dsec_sample(device)
    dsec = dsec_staged.window
    print(f"[stage] DSEC window in {time.perf_counter() - t0:.2f} s")
    rows: dict = {}
    mvsec_sensor, dsec_sensor = (wl.MVSEC_H, wl.MVSEC_W), (wl.DSEC_H, wl.DSEC_W)
    for tag, win, sensor in (("mvsec", mvsec[0], mvsec_sensor), ("dsec", dsec, dsec_sensor)):
        R, E = win.edge_ts.shape[0], win.xs.shape[0]
        print(f"[plan] splat fwd at {tag}, {R} refs x {E} events: "
              f"{plan_splat(R, E, *sensor)}")
        print(f"[plan] splat bwd at {tag}: {plan_splat_bwd(R, E, *sensor)}")
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
    aees, evals, chain_recs = [], 0, []
    for res, rec in wl.solve_chain(solver, cfg, mvsec, vels):
        k = rec["window"]
        chain_recs.append(rec)
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
    _build.reset_launch_counts()
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
        th = theta.to(dev).requires_grad_(True)
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        out.append((float(loss.detach()), grad.cpu()))
    dsec_launches = _build.launch_counts()
    print(f"[dsec loss] kernel launches: {dsec_launches}; its splat backward runs "
          f"the {plan_splat_bwd(dsec.edge_ts.shape[0], dsec.xs.shape[0], *dsec_sensor).kernel} kernel")
    (lk, gk), (lp, gp) = out
    rel = abs(lk - lp) / abs(lp)
    grel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"[dsec loss] kernels {lk:.7f}  plain {lp:.7f}  rel {rel:.3e} "
          f"(limit {TOL_DSEC_LOSS:.0e})  grad max rel {grel:.3e}")
    if not rel <= TOL_DSEC_LOSS:
        raise AssertionError("DSEC-scale loss: kernels disagree with plain")
    # float64: the direct kernels on the card (routed by dtype), the
    # launch counters read around it, against the plain versions on the CPU
    out64 = []
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev, torch.float64) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
        th = theta.to(dev, torch.float64).requires_grad_(True)
        _build.reset_launch_counts()
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            f64_launches = _build.launch_counts()
        if loss.dtype != torch.float64:
            raise AssertionError(f"float64 loss came out {loss.dtype}")
        out64.append((float(loss.detach()), grad.cpu()))
    (l64, g64), (l64c, g64c) = out64
    rel64 = abs(l64 - l64c) / abs(l64c)
    grel64 = float((g64 - g64c).abs().max() / g64c.abs().max())
    print(f"[dsec loss] float64 on the card {l64:.15f}  on the CPU {l64c:.15f}  rel "
          f"{rel64:.3e}, grad max rel {grel64:.3e} (limit {TOL_F64:.0e}); float32 kernels "
          f"vs float64: rel {abs(lk - l64) / abs(l64):.3e}, grad max rel "
          f"{float((gk - g64).abs().max() / g64.abs().max()):.3e}; launches {f64_launches}")
    launched = {k for k, n in f64_launches.items() if n}
    if launched != set(DIRECT_KERNELS):
        raise AssertionError(f"the float64 loss launched {sorted(launched)}, not the "
                             f"direct kernels {DIRECT_KERNELS}")
    if not (rel64 <= TOL_F64 and grel64 <= TOL_F64):
        raise AssertionError("float64 DSEC-scale loss: the card disagrees with the CPU")
    # the wrap-compat splat (float32): the interp kernels and the direct
    # splat on the card, the launch counters read around it, against the
    # plain versions on the CPU
    out_wrap = []
    set_splat_wrap_compat(True)
    try:
        for dev in (device, torch.device("cpu")):
            win = [t.to(dev) for t in dsec]
            wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
            th = theta.to(dev).requires_grad_(True)
            _build.reset_launch_counts()
            loss = solver_loss(th, *win, params, 0, statics, wstat)
            (grad,) = torch.autograd.grad(loss, th)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                wrap_launches = _build.launch_counts()
            out_wrap.append((float(loss.detach()), grad.cpu()))
    finally:
        set_splat_wrap_compat(False)
    (lw, gw), (lwc, gwc) = out_wrap
    relw = abs(lw - lwc) / abs(lwc)
    print(f"[dsec loss] wrap-compat: card {lw:.7f}  CPU {lwc:.7f}  rel {relw:.3e} (limit "
          f"{TOL_DSEC_LOSS:.0e}), grad max rel "
          f"{float((gw - gwc).abs().max() / gwc.abs().max()):.3e}; without the wrap "
          f"{lk:.7f}; launches {wrap_launches}")
    launched = {k for k, n in wrap_launches.items() if n}
    if launched != {"interp_fwd", "interp_bwd", "splat_direct_fwd", "splat_direct_bwd"}:
        raise AssertionError(f"the wrap-compat loss launched {sorted(launched)}")
    if not relw <= TOL_DSEC_LOSS:
        raise AssertionError("wrap-compat DSEC-scale loss: the card disagrees with the CPU")

    # ---- 6. [wolfe] the armijo rescue's configuration on the chain -----------
    wolfe_results, wolfe_launches, wevals, wolfe_row = wolfe_chain(cfg, mvsec, vels, device)

    # ---- 7. [eval] the EVAL path: card vs CPU -------------------------------
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    eval_rows = {}
    ev_params = LossParams(alpha=2000.0, beta=4000.0)  # phase 5's
    card_ev = eval_both("dsec", scale_theta_to_sensor_size(theta.to(device), dsec_sensor),
                        dsec_staged, ev_params, dsec_sensor, device)
    eval_rows["dsec"] = {"ms": card_ev[1], "prepare_ms": card_ev[2], "host_syncs": card_ev[3],
                         "aee": float(card_ev[0]["AEE"])}
    mv = []
    for k, (res, staged) in enumerate(zip(wolfe_results, mvsec_staged)):
        full = scale_theta_to_sensor_size(res.final_theta_pyr[0], mvsec_sensor)
        mv.append(eval_both(f"mvsec window {k}", full, staged, cfg.params, mvsec_sensor,
                            device))
    eval_rows["mvsec"] = {
        "ms": [m[1] for m in mv], "prepare_ms": [m[2] for m in mv],
        "host_syncs": [m[3] for m in mv], "aee": [float(m[0]["AEE"]) for m in mv]}
    print(f"[eval] MVSEC Wolfe windows: eval AEE {[round(a, 4) for a in eval_rows['mvsec']['aee']]}"
          f", ms per evaluation {[round(m, 3) for m in eval_rows['mvsec']['ms']]}")

    launches = {**{k: chain_launches[k] for k in CHAIN_KERNELS},
                **{k: bench_launches[k] for k in BENCH_KERNELS},
                **{k: f64_launches[k] + wrap_launches[k] for k in DIRECT_KERNELS}}
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
            entry["dsec_loss_launches"] = dsec_launches[name]
            entry["wolfe_launches"] = wolfe_launches[name]
            entry["wolfe_launches_per_loss_eval"] = wolfe_launches[name] / wevals
        if name == "splat_fwd":
            entry["eval_launches_per_call"] = 2
            entry["eval_prepare_launches"] = 1
        if name in DIRECT_KERNELS:
            entry["f64_loss_launches"] = f64_launches[name]
            entry["wrap_loss_launches"] = wrap_launches[name]
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    paths = {"card": card, "armijo": {"windows": chain_recs, "mean_aee": mean_aee,
                                      "median_ms": float(np.median([r["ms"] for r in chain_recs[1:]]))},
             "wolfe": wolfe_row, "eval": eval_rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, **paths}, f, indent=1)
    print(json.dumps({"paths": paths}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
