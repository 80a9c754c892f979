"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX. `tests/conftest.py` imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The tests marked `gpu` skip without a CUDA device. Tolerances, relative to
max |plain|: 1e-6 where each output sums a fixed handful of terms (interp
forward, splat backward, dense interp, whose `highest` is 3xTF32), 1e-5
where long sums round otherwise than the plain version's (the splat
forward's taps in units of 2^-24, summed exactly; fused warp+splat and the
interp backward above 16x16, whose atomics reorder them), 1e-6 against
the plain version's float32 terms summed in float64 for the interp
backward up to 16x16, whose own sums are exact or short.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from eincm_tpu_torch.experimental import interp_proto as tp
from eincm_tpu_torch.experimental import splat_fused as tf
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import interp as ti
from eincm_tpu_torch.ops import splat as ts
from eincm_tpu_torch.ops import splat_kernel as tk

SENSOR = (48, 64)
H, W = SENSOR
EDGE_XY = [
    (-1e4, -1e4),  # the padding sentinel
    (np.nan, 5.0), (5.0, np.nan),  # NaN events
    (2.5, 3.5), (0.5, 1.5), (-0.5, -0.5), (-1.5, 4.5),  # exact .5 ties
    (0.0, 0.0), (W - 1.0, H - 1.0), (W - 0.5, H - 0.5),  # at the edge
    (W + 0.0, 7.0), (W + 0.5, 7.0), (W + 1.5, 7.0), (7.0, H + 0.5),
    (-1.0, 2.0), (-1.49, 2.0), (-1.51, 2.0), (-2.0, 3.0),  # beyond it
    (1e10, 3.0), (-1e10, 3.0), (3.0, 1e10),
    (np.inf, 4.0), (4.0, -np.inf), (-np.inf, np.inf),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coords(rng, n, device, spread=2.0):
    xs = rng.uniform(-spread, W - 1 + spread, n)
    ys = rng.uniform(-spread, H - 1 + spread, n)
    ex, ey = np.array(EDGE_XY, np.float64).T
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return t(np.concatenate([xs, ex])), t(np.concatenate([ys, ey]))


def _close(ref, got, tol):
    ref, got = ref.detach().double().cpu(), got.detach().double().cpu()
    assert ref.shape == got.shape
    assert torch.equal(torch.isnan(ref), torch.isnan(got))
    fin = ~torch.isnan(ref)
    scale = max(float(ref[fin].abs().max()), 1e-30)
    err = float((ref[fin] - got[fin]).abs().max())
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_direct_wrappers_refuse_cpu_tensors(dtype):
    """The direct kernels' wrappers launch only on CUDA tensors; the
    routers never reach them with CPU tensors."""
    _build.reset_launch_counts()
    theta = torch.zeros(4, 4, 2, dtype=torch.float64)
    xs = torch.zeros(10, dtype=dtype)
    w = torch.zeros(2, 10, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        tk.splat_direct_fwd_cuda(w, w, SENSOR, 3, True)
    with pytest.raises(ValueError, match="CUDA"):
        tk.splat_direct_bwd_cuda(w, w, torch.zeros(2, H, W, dtype=dtype), SENSOR, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ti.interp_direct_fwd_cuda(theta, xs, xs, SENSOR)
    with pytest.raises(ValueError, match="CUDA"):
        ti.interp_direct_bwd_cuda(torch.zeros(10, 2, dtype=dtype), xs, xs, (4, 4, 2), SENSOR)
    assert set(_build.launch_counts().values()) == {0}


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 10**7])
def test_direct_launch(n):
    """One thread per event, up to 16 blocks of 256 per SM of an H100."""
    blocks, threads = _build.direct_launch(n)
    assert threads == 256 and 1 <= blocks <= 132 * 16
    assert blocks == max(1, min(-(-n // 256), 132 * 16))
    assert n <= blocks * threads or blocks == 132 * 16


@pytest.mark.parametrize(
    "case,route",
    [("splat float32", "slab"), ("splat float64", "direct"), ("splat float32 wrap", "direct"),
     ("splat float64 wrap", "direct"), ("interp float32", "interp"),
     ("interp float64", "interp direct")],
)
def test_routers_choose_the_kernels(monkeypatch, case, route):
    """Tensors off the CPU (here on the meta device, which no kernel sees)
    go to the float32 kernels, or, in float64 or with the wrap-compat
    switch, to the direct kernels; the switch is reset in a `finally`."""
    seen = []
    for cls, name in ((tk._SplatCuda, "slab"), (tk._SplatDirect, "direct"),
                      (ti._InterpCuda, "interp"), (ti._InterpDirect, "interp direct")):
        monkeypatch.setattr(cls, "apply", staticmethod(
            lambda *args, name=name: seen.append((name, args))))
    dtype = torch.float64 if "float64" in case else torch.float32
    ts.set_splat_wrap_compat("wrap" in case)
    try:
        if case.startswith("splat"):
            w = torch.zeros(2, 10, dtype=dtype, device="meta")
            ts.splat_multi_ref(w, w, SENSOR, 5)
        else:
            ti.interp_theta_at_events(torch.zeros(4, 4, 2, dtype=dtype, device="meta"),
                                      torch.zeros(10, dtype=dtype, device="meta"),
                                      torch.zeros(10, dtype=dtype, device="meta"), SENSOR)
    finally:
        ts.set_splat_wrap_compat(False)
    assert [name for name, _ in seen] == [route]
    if route == "direct":
        assert seen[0][1][2:] == (SENSOR, 5, "wrap" in case)


def test_cuda_wrappers_refuse_cpu_tensors():
    _build.reset_launch_counts()
    theta = torch.zeros(4, 4, 2)
    xs = torch.zeros(10)
    with pytest.raises(ValueError, match="CUDA"):
        ti.interp_fwd_cuda(theta, xs, xs, SENSOR)
    with pytest.raises(ValueError, match="CUDA"):
        ti.interp_bwd_cuda(torch.zeros(10, 2), xs, xs, (4, 4, 2), SENSOR)
    w = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="CUDA"):
        tk.splat_fwd_cuda(w, w, SENSOR)
    with pytest.raises(ValueError, match="CUDA"):
        tk.splat_bwd_cuda(w, w, torch.zeros(2, H, W), SENSOR)
    assert set(_build.launch_counts().values()) == {0}


def test_fused_and_dense_wrappers_refuse_cpu_tensors():
    _build.reset_launch_counts()
    theta = torch.zeros(4, 4, 2)
    xs = torch.zeros(10)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_warp_splat_cuda(xs, xs, xs, xs, xs, 0.5, SENSOR)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fully_fused_warp_splat_cuda(xs, xs, xs, theta, 0.5, SENSOR)
    with pytest.raises(ValueError, match="CUDA"):
        tp.interp_dense_cuda(theta, xs, xs, SENSOR, "dot3")
    assert set(_build.launch_counts().values()) == {0}


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """An edited csrc header names a new library, so it is rebuilt; a
    header the source does not include changes nothing."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    first = _build.library_path("k")
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a\n')
    assert _build.library_path("k") not in (first, second)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "gh,gw",
    [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16),  # the chain's levels
     (1, 4), (4, 2), (3, 5), (5, 12),  # not square: registers and fixed point
     # exact sums in one unit per launch; theta not staged from 128x128;
     # 256x256 (five bands) and 200x150 are above one block's shared memory
     (32, 32), (64, 64), (81, 81), (128, 128), (256, 256), (200, 150), (40, 72)],
)
def test_interp_kernels_match_plain(cuda, gh, gw):
    """Forward within 1e-6 and bitwise on finite events; backward within
    1e-6 of the plain version's terms summed in float64 and bitwise the same
    twice at every grid (above 16x16 also in both exact modes and with the
    events permuted). Whole tensors, views that start 4 and 12 bytes into a
    16-byte line, an event count that is no multiple of 4, in groups of four
    and one by one."""
    rng = np.random.default_rng(7)
    x, y = _coords(rng, 30_001, cuda)
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32), device=cuda)
    ref = ti.interp_theta_at_events_plain(theta, x, y, SENSOR)
    finite = torch.isfinite(x) & torch.isfinite(y)
    for off in (0, 1, 3):
        for grouped in (None, True, False):
            vx, vy = x[off:], y[off:]
            plan = ti.plan_interp(vx.shape[0], gh, gw, grouped=grouped, offsets=(
                ti.float_offset(vx), ti.float_offset(vy), 0))
            got = ti.interp_fwd_cuda(theta, vx, vy, SENSOR, plan)
            _close(ref[off:], got, 1e-6)
            assert torch.equal(ref[off:][finite[off:]], got[finite[off:]])
    # NaN events poison different subsets of dtheta in the two versions
    x, y = x[finite].contiguous(), y[finite].contiguous()
    g = torch.as_tensor(rng.normal(size=(x.shape[0], 2)).astype(np.float32), device=cuda)
    for off in (0, 1, 3):
        vx, vy, vg = x[off:], y[off:], g[off:]
        ref = ti.interp_bwd_plain(vg, vx, vy, (gh, gw, 2), SENSOR, torch.float64)
        for grouped in (None, True, False):
            plan = ti.plan_interp(vx.shape[0], gh, gw, True, tuple(
                map(ti.float_offset, (vx, vy, vg))), grouped=grouped)
            got = ti.interp_bwd_cuda(vg, vx, vy, (gh, gw, 2), SENSOR, plan)
            _close(ref, got, 1e-6)
            assert torch.equal(got, ti.interp_bwd_cuda(vg, vx, vy, (gh, gw, 2), SENSOR, plan))
            if plan.mode in ti.EXACT_MODES:
                perm = torch.as_tensor(rng.permutation(vx.shape[0]), device=cuda)
                assert torch.equal(got, ti.interp_bwd_cuda(
                    vg[perm].contiguous(), vx[perm].contiguous(), vy[perm].contiguous(),
                    (gh, gw, 2), SENSOR))
                for mode in ti.EXACT_MODES:
                    other = ti.plan_interp(vx.shape[0], gh, gw, True, tuple(
                        map(ti.float_offset, (vx, vy, vg))), mode, grouped=grouped)
                    assert torch.equal(got, ti.interp_bwd_cuda(vg, vx, vy, (gh, gw, 2),
                                                               SENSOR, other))


@pytest.mark.gpu
@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (32, 32),
                                   (256, 256)])
def test_interp_bwd_every_event_on_one_cell(cuda, gh, gw):
    """The worst contention: 20k events inside one pixel, with cotangents
    of very different sizes and a NaN and an infinite one."""
    rng = np.random.default_rng(14)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    x, y = t(rng.uniform(20.2, 20.4, 20_000)), t(rng.uniform(30.1, 30.3, 20_000))
    g = t(rng.normal(0, 1, (20_000, 2)) * 10.0 ** rng.uniform(-3, 3, (20_000, 1)))
    _close(ti.interp_bwd_plain(g, x, y, (gh, gw, 2), SENSOR, torch.float64),
           ti.interp_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR), 1e-6)
    g[5, 0], g[6, 1] = np.nan, np.inf
    got = ti.interp_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR)
    assert bool(torch.isnan(got[..., 0]).any()) and not bool(torch.isnan(got[..., 1]).any())
    assert bool(torch.isposinf(got[..., 1]).any())
    assert torch.equal(torch.isfinite(got[..., 0]), torch.isfinite(got[..., 1]))


@pytest.mark.gpu
def test_interp_wrappers_refuse_a_plan_that_does_not_fit(cuda):
    x = torch.zeros(101, device=cuda)
    theta = torch.zeros(8, 8, 2, device=cuda)
    plan = ti.plan_interp(100, 8, 8, grouped=True)  # cut for aligned tensors
    with pytest.raises(ValueError):
        ti.interp_fwd_cuda(theta, x[1:], x[1:], SENSOR, plan)


@pytest.mark.gpu
def test_splat_kernels_match_plain(cuda):
    rng = np.random.default_rng(6)
    per_ref = [_coords(rng, 30_000, cuda, spread=3.0) for _ in range(2)]
    wx = torch.stack([p[0] for p in per_ref]).contiguous()
    wy = torch.stack([p[1] for p in per_ref]).contiguous()
    wxr, wyr = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
    ref = tk.splat_plain(wxr, wyr, SENSOR)
    _close(ref, tk.splat_fwd_cuda(wx, wy, SENSOR), 1e-5)
    G = torch.as_tensor(rng.normal(size=(2, H, W)).astype(np.float32), device=cuda)
    rx, ry = torch.autograd.grad(ref, (wxr, wyr), G)
    kx, ky = tk.splat_bwd_cuda(wx, wy, G, SENSOR)
    _close(rx, kx, 1e-6)
    _close(ry, ky, 1e-6)


@pytest.mark.gpu
def test_routers_launch_the_kernels_on_cuda(cuda):
    rng = np.random.default_rng(5)
    x, y = _coords(rng, 5_000, cuda)
    fin = torch.isfinite(x) & torch.isfinite(y)
    x, y = x[fin].contiguous(), y[fin].contiguous()
    theta = torch.as_tensor(rng.normal(0, 3, (16, 16, 2)).astype(np.float32), device=cuda)

    def loss(interp, splat):
        th = theta.clone().requires_grad_(True)
        v = interp(th, x, y, SENSOR)
        iwe = splat((x - v[:, 0])[None], (y - v[:, 1])[None], SENSOR)
        val = (iwe * iwe).sum()
        (grad,) = torch.autograd.grad(val, th)
        return val, grad

    _build.reset_launch_counts()
    val_k, grad_k = loss(ti.interp_theta_at_events, ts.splat_multi_ref)
    counts = _build.launch_counts()
    solve = ("interp_fwd", "interp_bwd", "splat_fwd", "splat_bwd")
    assert {counts[k] for k in solve} == {1}
    assert sum(counts.values()) == 4  # nothing in the solve calls the others
    val_p, grad_p = loss(ti.interp_theta_at_events_plain, tk.splat_plain)
    _close(val_p, val_k, 1e-5)
    _close(grad_p, grad_k, 1e-4)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    theta = torch.zeros(16, 16, 2, device=cuda)
    xs = torch.zeros(100, device=cuda)
    # float64 takes the direct kernels (routed by dtype), which want every
    # tensor in float64; any other dtype reaches a kernel and raises
    with pytest.raises(TypeError):
        ti.interp_theta_at_events(theta.half(), xs.half(), xs.half(), SENSOR)
    with pytest.raises(TypeError):
        ts.splat_multi_ref(xs.half()[None], xs.half()[None], SENSOR)
    with pytest.raises(TypeError):
        ti.interp_theta_at_events(theta.double(), xs, xs, SENSOR)
    with pytest.raises(TypeError):
        ts.splat_multi_ref(xs.double()[None], xs[None], SENSOR)
    for ws in (1, 4, 7):  # the kernels are built for windows 3 and 5
        with pytest.raises(ValueError, match="window_size"):
            ts.splat_multi_ref(xs[None], xs[None], SENSOR, ws)
    with pytest.raises(ValueError):
        ti.interp_fwd_cuda(torch.zeros(0, 4, 2, device=cuda), xs, xs, SENSOR)
    w = torch.zeros(100, 2, device=cuda).t()  # (2, 100), not contiguous
    with pytest.raises(ValueError):
        tk.splat_fwd_cuda(w, w, SENSOR)
    with pytest.raises(ValueError):
        tk.splat_fwd_cuda(torch.zeros(2, 100, device=cuda), xs[None], SENSOR)


def _events_ts(rng, n, device):
    x, y = _coords(rng, n, device, spread=3.0)
    ts = torch.as_tensor(rng.uniform(0, 1, x.shape[0]).astype(np.float32), device=device)
    return x, y, ts


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
def test_fused_warp_splat_matches_plain(cuda, window_size):
    rng = np.random.default_rng(8)
    x, y, ts = _events_ts(rng, 30_000, cuda)
    thx = torch.as_tensor(rng.normal(0, 3, x.shape[0]).astype(np.float32), device=cuda)
    thy = torch.as_tensor(rng.normal(0, 3, x.shape[0]).astype(np.float32), device=cuda)
    for t_ref in (0.0, 0.37, 1.0):
        _close(
            tf.fused_warp_splat_frame_plain(x, y, ts, thx, thy, t_ref, SENSOR, window_size),
            tf.fused_warp_splat_cuda(x, y, ts, thx, thy, t_ref, SENSOR, window_size),
            1e-5,
        )


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize("gh,gw", [(1, 1), (16, 16), (128, 128)])
def test_fully_fused_warp_splat_matches_plain(cuda, gh, gw, window_size):
    rng = np.random.default_rng(9)
    x, y, ts = _events_ts(rng, 30_000, cuda)
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32), device=cuda)
    for t_ref in (0.0, 1.0):
        _close(
            tf.fully_fused_warp_splat_frame_plain(x, y, ts, theta, t_ref, SENSOR, window_size),
            tf.fully_fused_warp_splat_cuda(x, y, ts, theta, t_ref, SENSOR, window_size),
            1e-5,
        )


@pytest.mark.gpu
@pytest.mark.parametrize("mode", tp.MODES)
@pytest.mark.parametrize("gh,gw", [(1, 1), (5, 12), (16, 16), (128, 128)])
def test_interp_dense_matches_plain(cuda, mode, gh, gw):
    rng = np.random.default_rng(10)
    x, y = _coords(rng, 30_000, cuda)
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32), device=cuda)
    _close(
        tp.interp_dense_plain(theta, x, y, SENSOR, mode),
        tp.interp_dense_cuda(theta, x, y, SENSOR, mode),
        1e-6,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("gh,gw", [(1, 1), (16, 16), (128, 128)])
def test_interp_dense_highest_matches_interp_fwd(cuda, gh, gw):
    """Kernel 9 `highest` is 3xTF32 on the tensor cores: each product term
    is within ~2^-21 of f32 (tests/test_torch_interp_proto.py emulates the
    split), so it is held to kernel 1 within 1e-6 x max |out|, not bitwise."""
    rng = np.random.default_rng(11)
    x, y = _coords(rng, 30_000, cuda, spread=0.0)
    keep = torch.isfinite(x) & torch.isfinite(y) & (x >= -0.5) & (x < W - 0.5) \
        & (y >= -0.5) & (y < H - 0.5)
    x, y = x[keep].contiguous(), y[keep].contiguous()
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32), device=cuda)
    _close(
        ti.interp_fwd_cuda(theta, x, y, SENSOR),
        tp.interp_dense_cuda(theta, x, y, SENSOR, "highest"),
        1e-6,
    )


def _slab_window(rng, R, n, sensor, tile_rows, device, wide=False):
    """(R, E) coordinates: n uniform events per ref, the edge cases, and
    events on and around every slab edge (their windows straddle two
    slabs; `wide`: up to 2.5 rows off, for a 5x5 window), each ref in its
    own order."""
    Hs, Ws = sensor
    xs = [rng.uniform(-3, Ws + 2, n)]
    ys = [rng.uniform(-3, Hs + 2, n)]
    ex, ey = np.array(EDGE_XY, np.float64).T
    xs.append(ex)
    ys.append(ey)
    edges = np.arange(tile_rows, Hs, tile_rows, dtype=np.float64)
    offsets = (-1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0)
    for d in offsets + ((-2.5, -2.0, 1.5, 2.0, 2.4) if wide else ()):
        ys.append(edges + d)
        xs.append(rng.uniform(0, Ws - 1, edges.size))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.float32)
    order = [rng.permutation(x.size) for _ in range(R)]
    t = lambda a: torch.as_tensor(np.stack([a[o] for o in order]), device=device)
    return t(x), t(y)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize(
    "sensor,budget",
    [
        ((48, 64), tk.SMEM_MAX),  # one slab
        ((48, 64), 48 * 64 * 2),  # two slabs
        ((480, 640), tk.SMALL_BUDGET),  # DSEC in half-size tiles: 11 slabs
        ((256, 336), tk.SMEM_MAX),  # MVSEC: 2 slabs of 1 KB rows
        ((6, 70_000), tk.SMEM_MAX),  # a row wider than a tile: column slabs
    ],
    ids=["one_slab", "two_slabs", "dsec", "mvsec", "column_slabs"],
)
def test_splat_fwd_slabs_match_plain(cuda, R, sensor, budget):
    """The slab kernel against the plain splat, with the plan's own chunks
    and with seven."""
    rng = np.random.default_rng(12)
    p = tk.plan_splat(R, 30_000, *sensor, smem_budget=budget)
    wx, wy = _slab_window(rng, R, 30_000, sensor, p.tile_rows, cuda)
    p = tk.plan_splat(R, wx.shape[1], *sensor, smem_budget=budget)
    ref = tk.splat_plain(wx, wy, sensor)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, plan=p), 1e-5)
    many = dataclasses.replace(p, chunks=7)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, plan=many), 1e-5)


@pytest.mark.gpu
def test_splat_fwd_every_event_on_one_texel(cuda):
    """The worst contention: 20k events per ref inside one texel, on a slab
    edge. Compared with the plain splat in f64 (the f32 sums of 20k terms
    round by up to a few 1e-6 in any order)."""
    rng = np.random.default_rng(13)
    sensor = (480, 640)
    p = tk.plan_splat(2, 20_000, *sensor)
    row = float(p.tile_rows)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    wx = t(rng.uniform(300.2, 300.4, (2, 20_000)))
    wy = t(rng.uniform(row - 0.1, row + 0.1, (2, 20_000)))
    ref = tk.splat_plain(wx.double(), wy.double(), sensor)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("one_texel", [False, True], ids=["spread", "one_texel"])
def test_splat_fwd_bitwise_for_every_plan(cuda, one_texel):
    """The frames are exact sums, rounded to f32 once: bitwise the same from
    launch to launch and for any chunk count, also where a texel's tile
    counter wraps (20k events on one texel)."""
    rng = np.random.default_rng(14)
    sensor = (480, 640)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    if one_texel:
        wx = t(rng.uniform(300.2, 300.4, (2, 20_000)))
        wy = t(rng.uniform(80.1, 80.3, (2, 20_000)))
    else:
        wx = t(rng.uniform(-3, 643, (2, 200_000)))
        wy = t(rng.uniform(-3, 483, (2, 200_000)))
    p = tk.plan_splat(2, wx.shape[1], *sensor)
    first = tk.splat_fwd_cuda(wx, wy, sensor, plan=p)
    for chunks in (p.chunks, 1, 7, 64):
        again = tk.splat_fwd_cuda(wx, wy, sensor, plan=dataclasses.replace(p, chunks=chunks))
        assert torch.equal(again, first), chunks


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("sensor", [(48, 64), (47, 63), (5, 64), (256, 336), (480, 640)])
def test_splat_bwd_stream_is_the_gather_kernel_bitwise(cuda, R, sensor):
    """The stream kernel (four events per thread) against the gather kernel
    (bitwise: one statement sequence per event) and the plain version
    (1e-6): event counts that are and are not multiples of 4, with and
    without the float4s, several launches, views that start 4 bytes into a
    16-byte line; twice for the same bits."""
    rng = np.random.default_rng(15)
    Hs, Ws = sensor
    G = torch.as_tensor(rng.normal(size=(R, Hs, Ws)).astype(np.float32), device=cuda)
    for n in (30_001, 30_004):
        wx, wy = _slab_window(rng, R, n, sensor, 7, cuda)
        E = wx.shape[1]
        wxr, wyr = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
        rx, ry = torch.autograd.grad(tk.splat_plain(wxr, wyr, sensor), (wxr, wyr), G)
        gx, gy = tk.splat_bwd_cuda(wx, wy, G, sensor,
                                   plan=tk.plan_splat_bwd(R, E, Hs, Ws, "gather"))
        _close(rx, gx, 1e-6)
        _close(ry, gy, 1e-6)
        plan = tk.plan_splat_bwd(R, E, Hs, Ws, "stream")
        assert plan.vec == (E % 4 == 0 or R == 1)
        for p in (plan, dataclasses.replace(plan, vec=False),
                  tk.plan_splat_bwd(R, E, Hs, Ws, "stream", threads=512, blocks=3),
                  tk.plan_splat_bwd(R, E, Hs, Ws, "stream", threads=32, blocks=5000)):
            kx, ky = tk.splat_bwd_cuda(wx, wy, G, sensor, plan=p)
            assert torch.equal(kx, gx) and torch.equal(ky, gy)
            again = tk.splat_bwd_cuda(wx, wy, G, sensor, plan=p)
            assert torch.equal(again[0], kx) and torch.equal(again[1], ky)
    # one ref, as views that start 4 bytes into a 16-byte line
    flat_x, flat_y = torch.zeros(E + 1, device=cuda), torch.zeros(E + 1, device=cuda)
    flat_x[1:], flat_y[1:] = wx[0], wy[0]
    ux, uy = flat_x[1:][None], flat_y[1:][None]
    with pytest.raises(ValueError):  # float4s on arrays off a 16-byte line
        tk.splat_bwd_cuda(ux, uy, G[:1], sensor, plan=tk.plan_splat_bwd(1, E, Hs, Ws, "stream"))
    kx, ky = tk.splat_bwd_cuda(ux, uy, G[:1], sensor,
                               plan=tk.plan_splat_bwd(1, E, Hs, Ws, "stream", aligned=False))
    assert torch.equal(kx[0], gx[0]) and torch.equal(ky[0], gy[0])


@pytest.mark.gpu
def test_splat_bwd_plan_chooses_by_shape(cuda):
    """Below BWD_STREAM_EVENTS events per ref the gather kernel, from there
    on the stream kernel; an unaligned view loses the float4s, not the
    kernel; the two kernels agree bitwise."""
    rng = np.random.default_rng(16)
    sensor = (96, 128)
    G = torch.as_tensor(rng.normal(size=(2, *sensor)).astype(np.float32), device=cuda)
    assert tk.plan_splat_bwd(2, tk.BWD_STREAM_EVENTS - 4, *sensor).kernel == "gather"
    assert tk.plan_splat_bwd(2, tk.BWD_STREAM_EVENTS, *sensor).kernel == "stream"
    E = tk.BWD_STREAM_EVENTS
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    wx = t(rng.uniform(-3, sensor[1] + 2, (2, E)))
    wy = t(rng.uniform(-3, sensor[0] + 2, (2, E)))
    _build.reset_launch_counts()
    kx, ky = tk.splat_bwd_cuda(wx, wy, G, sensor)
    assert _build.launch_counts()["splat_bwd"] == 1
    ox, oy = tk.splat_bwd_cuda(wx, wy, G, sensor, plan=tk.plan_splat_bwd(2, E, *sensor, "gather"))
    assert torch.equal(kx, ox) and torch.equal(ky, oy)
    vx, vy = wx[:, 1:].contiguous(), wy[:, 1:].contiguous()  # E - 1 events a ref: no float4s
    kx, ky = tk.splat_bwd_cuda(vx, vy, G, sensor)
    assert torch.equal(kx, ox[:, 1:]) and torch.equal(ky, oy[:, 1:])


@pytest.mark.gpu
def test_splat_bwd_refuses_a_plan_that_does_not_fit(cuda):
    w = torch.zeros(2, 1001, device=cuda)
    G = torch.zeros(2, H, W, device=cuda)
    fits = tk.plan_splat_bwd(2, 1001, H, W, "stream")
    assert not fits.vec
    with pytest.raises(ValueError):  # float4s where a ref starts off a 16-byte line
        tk.splat_bwd_cuda(w, w, G, SENSOR, plan=dataclasses.replace(fits, vec=True))
    with pytest.raises(RuntimeError):  # the C side refuses a block of 48 threads
        tk.splat_bwd_cuda(w, w, G, SENSOR, plan=dataclasses.replace(fits, threads=48))
    with pytest.raises(RuntimeError):  # and 1024 threads for the stream kernel
        tk.splat_bwd_cuda(w, w, G, SENSOR, plan=dataclasses.replace(fits, threads=1024))


def _fused_events(rng, n, sensor, tile_rows, device, wide=False):
    """n uniform events, the edge cases and events on and around every slab
    edge, unsorted, with timestamps; velocities stay small enough that the
    warped windows still straddle the edges."""
    x, y = _slab_window(rng, 1, n, sensor, tile_rows, device, wide)
    ts = torch.as_tensor(rng.uniform(0, 1, x.shape[1]).astype(np.float32), device=device)
    return torch.round(x[0]).contiguous(), torch.round(y[0]).contiguous(), ts


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize("gh,gw", [(1, 1), (4, 2), (16, 16)])
@pytest.mark.parametrize(
    "sensor,S", [((48, 64), None), ((48, 64), 1), ((47, 63), 4), ((256, 336), 8),
                 ((480, 640), 8), ((1080, 1440), 8)],
)
def test_fully_fused_cluster_scatter_matches_plain(cuda, sensor, S, gh, gw, window_size):
    """Kernel 8 through the cluster's tiles: unsorted events, the sentinel,
    NaN and +-inf coordinates, windows on every slab edge; several cluster
    sizes, a sensor whose rows are no multiple of 4 texels, one that needs
    four bands of rows; the plan's chunks and three, several rounds, and
    queues so short that most events go straight into a sibling's tile."""
    rng = np.random.default_rng(17)
    Hs, Ws = sensor
    plan = tf.plan_fused(30_000, Hs, Ws, gh, gw, "cluster", cluster=S)
    x, y, ts = _fused_events(rng, 30_000, sensor, plan.tile_rows, cuda)
    E = x.shape[0]
    plan = tf.plan_fused(E, Hs, Ws, gh, gw, "cluster", cluster=S)
    theta = torch.as_tensor(rng.normal(0, 1, (gh, gw, 2)).astype(np.float32), device=cuda)
    for t_ref in (0.0, 1.0):
        ref = tf.fully_fused_warp_splat_frame_plain(x, y, ts, theta, t_ref, sensor, window_size)
        cut = functools.partial(tf.plan_fused, E, Hs, Ws, gh, gw, "cluster", S)
        plans = (plan, cut(chunks=3),
                 # three rounds of events per cluster
                 cut(chunks=1, threads=128, per_thread=-(-E // (plan.cluster * 128 * 3))),
                 # queues of 32 events: most events find theirs full
                 cut(chunks=2, per_thread=4, queue=32),
                 # the scatter kernel, which the plan chooses for so few events
                 None, tf.plan_fused(E, Hs, Ws, gh, gw, "scatter", threads=128, chunks=7))
        for p in plans:
            got = tf.fully_fused_warp_splat_cuda(x, y, ts, theta, t_ref, sensor, window_size, p)
            _close(ref, got, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
def test_fully_fused_every_event_on_one_texel(cuda, window_size):
    """The worst contention, and the counters' wrap: 40k events inside one
    texel on a slab edge (a texel's sum passes 256.0 several times), with a
    zero theta so that the warp keeps them there. Compared with the plain
    version in f64."""
    rng = np.random.default_rng(18)
    sensor = (480, 640)
    plan = tf.plan_fused(40_000, *sensor, 16, 16, "cluster")
    row = float(plan.tile_rows)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    x = t(rng.uniform(300.2, 300.4, 40_000))
    y = t(rng.uniform(row - 0.1, row + 0.1, 40_000))
    ts = t(rng.uniform(0, 1, 40_000))
    theta = torch.zeros(16, 16, 2, device=cuda)
    ref = tf.fully_fused_warp_splat_frame_plain(
        x.double(), y.double(), ts.double(), theta.double(), 0.0, sensor, window_size)
    assert float(ref.max()) > 4 * 256.0
    for p in (plan, tf.plan_fused(40_000, *sensor, 16, 16, "cluster", chunks=1), None):
        _close(ref, tf.fully_fused_warp_splat_cuda(x, y, ts, theta, 0.0, sensor, window_size, p),
               1e-5)


@pytest.mark.gpu
def test_fully_fused_refuses_a_plan_that_does_not_fit(cuda):
    xs = torch.zeros(100, device=cuda)
    theta = torch.zeros(16, 16, 2, device=cuda)
    other = tf.plan_fused(100, 96, 128, 16, 16, "cluster")  # another sensor's tiles
    with pytest.raises(ValueError):
        tf.fully_fused_warp_splat_cuda(xs, xs, xs, theta, 0.5, SENSOR, 3, other)
    fits = tf.plan_fused(100, H, W, 16, 16, "cluster")
    with pytest.raises(ValueError):
        tf.fully_fused_warp_splat_cuda(
            xs, xs, xs, theta, 0.5, SENSOR, 3, dataclasses.replace(fits, tile_rows=2))
    with pytest.raises(ValueError):
        tf.plan_fused(100, 3, 70_000, 16, 16, "cluster")  # a row wider than a tile


# ---- window 5, kernel 7 on the cluster stage, float64 on the card -----------


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize(
    "sensor,budget",
    [((48, 64), tk.SMEM_MAX), ((48, 64), 48 * 64 * 2), ((480, 640), tk.SMALL_BUDGET),
     ((256, 336), tk.SMEM_MAX), ((6, 70_000), tk.SMEM_MAX)],
    ids=["one_slab", "two_slabs", "dsec", "mvsec", "column_slabs"],
)
def test_splat_window5_kernels_match_plain(cuda, R, sensor, budget):
    """The forward at window 5 through the slabs (events up to 2.5 rows off
    every slab edge) within 1e-5 of the plain version, with the plan's
    chunks and with seven; both backward kernels within 2e-6 of the plain
    version (25 texels an event), bitwise equal to each other, with and
    without float4s, and bitwise the same twice."""
    rng = np.random.default_rng(19)
    Hs, Ws = sensor
    p = tk.plan_splat(R, 30_000, *sensor, smem_budget=budget)
    wx, wy = _slab_window(rng, R, 30_000, sensor, p.tile_rows, cuda, wide=True)
    E = wx.shape[1]
    p = tk.plan_splat(R, E, *sensor, smem_budget=budget)
    wxr, wyr = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
    ref = tk.splat_plain(wxr, wyr, sensor, 5)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, 5, p), 1e-5)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, 5, dataclasses.replace(p, chunks=7)), 1e-5)
    _close(ref, ts.splat_multi_ref(wx, wy, sensor, 5), 1e-5)
    G = torch.as_tensor(rng.normal(size=(R, Hs, Ws)).astype(np.float32), device=cuda)
    rx, ry = torch.autograd.grad(ref, (wxr, wyr), G)
    gx, gy = tk.splat_bwd_cuda(wx, wy, G, sensor, 5, tk.plan_splat_bwd(R, E, Hs, Ws, "gather"))
    _close(rx, gx, 2e-6)
    _close(ry, gy, 2e-6)
    plan = tk.plan_splat_bwd(R, E, Hs, Ws, "stream")
    for q in (plan, dataclasses.replace(plan, vec=False),
              tk.plan_splat_bwd(R, E, Hs, Ws, "stream", threads=32, blocks=5000)):
        kx, ky = tk.splat_bwd_cuda(wx, wy, G, sensor, 5, q)
        assert torch.equal(kx, gx) and torch.equal(ky, gy)
        again = tk.splat_bwd_cuda(wx, wy, G, sensor, 5, q)
        assert torch.equal(again[0], kx) and torch.equal(again[1], ky)


@pytest.mark.gpu
def test_splat_window5_router_and_autograd(cuda):
    """`splat_multi_ref(..., 5)` launches the window-5 kernels forward and
    backward, and its gradient agrees with the plain version's."""
    rng = np.random.default_rng(20)
    x, y = _coords(rng, 5_000, cuda)
    fin = torch.isfinite(x) & torch.isfinite(y)
    wx = torch.stack([x[fin], y[fin]]).contiguous()
    wy = torch.stack([y[fin], x[fin]]).contiguous()
    G = torch.as_tensor(rng.normal(size=(2, H, W)).astype(np.float32), device=cuda)
    grads = []
    _build.reset_launch_counts()
    for splat in (ts.splat_multi_ref, tk.splat_plain):
        a, b = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(splat(a, b, SENSOR, 5), (a, b), G))
    counts = _build.launch_counts()
    assert counts["splat_fwd"] == 1 and counts["splat_bwd"] == 1
    for k, p in zip(grads[0], grads[1]):
        _close(p, k, 2e-6)


def _kernel7_events(rng, n, sensor, tile_rows, device, wide=False):
    x, y, ts_ = _fused_events(rng, n, sensor, tile_rows, device, wide)
    thx = torch.as_tensor(rng.normal(0, 1, x.shape[0]).astype(np.float32), device=device)
    thy = torch.as_tensor(rng.normal(0, 1, x.shape[0]).astype(np.float32), device=device)
    return x, y, ts_, thx, thy


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize(
    "sensor,S", [((48, 64), None), ((48, 64), 1), ((47, 63), 4), ((256, 336), 8),
                 ((480, 640), 8), ((1080, 1440), 8)],
)
def test_fused_warp_splat_cluster_scatter_match_plain(cuda, sensor, S, window_size):
    """Kernel 7 through the cluster stage it shares with kernel 8, and its
    scatter kernel: unsorted events, the sentinel, NaN and +-inf
    coordinates, windows on every slab edge; the plan's chunks and three,
    three rounds, queues of 32 (most events go straight into a sibling's
    tile), four bands of rows at 1080x1440."""
    rng = np.random.default_rng(21)
    Hs, Ws = sensor
    plan = tf.plan_fused(30_000, Hs, Ws, 0, 0, "cluster", cluster=S)
    x, y, ts_, thx, thy = _kernel7_events(rng, 30_000, sensor, plan.tile_rows, cuda,
                                          wide=window_size == 5)
    E = x.shape[0]
    plan = tf.plan_fused(E, Hs, Ws, 0, 0, "cluster", cluster=S)
    assert not plan.staged
    cut = functools.partial(tf.plan_fused, E, Hs, Ws, 0, 0, "cluster", S)
    plans = (plan, cut(chunks=3),
             cut(chunks=1, threads=128, per_thread=-(-E // (plan.cluster * 128 * 3))),
             cut(chunks=2, per_thread=4, queue=32),
             None, tf.plan_fused(E, Hs, Ws, 0, 0, "scatter", threads=128, chunks=7))
    for t_ref in (0.0, 1.0):
        ref = tf.fused_warp_splat_frame_plain(x, y, ts_, thx, thy, t_ref, sensor, window_size)
        for p in plans:
            got = tf.fused_warp_splat_cuda(x, y, ts_, thx, thy, t_ref, sensor, window_size, p)
            _close(ref, got, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5])
def test_fused_warp_splat_every_event_on_one_texel(cuda, window_size):
    """Kernel 7's counters wrap: 40k events inside one texel on a slab edge,
    zero velocities; against the plain version in f64."""
    rng = np.random.default_rng(22)
    sensor = (480, 640)
    plan = tf.plan_fused(40_000, *sensor, 0, 0, "cluster")
    row = float(plan.tile_rows)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)
    x = t(rng.uniform(300.2, 300.4, 40_000))
    y = t(rng.uniform(row - 0.1, row + 0.1, 40_000))
    ts_ = t(rng.uniform(0, 1, 40_000))
    zero = torch.zeros(40_000, device=cuda)
    ref = tf.fused_warp_splat_frame_plain(
        x.double(), y.double(), ts_.double(), zero.double(), zero.double(), 0.0, sensor,
        window_size)
    assert float(ref.max()) > 4 * 256.0
    for p in (plan, tf.plan_fused(40_000, *sensor, 0, 0, "cluster", chunks=1)):
        _close(ref, tf.fused_warp_splat_cuda(x, y, ts_, zero, zero, 0.0, sensor, window_size, p),
               1e-5)


@pytest.mark.gpu
def test_fused_warp_splat_refuses_a_plan_that_does_not_fit(cuda):
    xs = torch.zeros(100, device=cuda)
    kernel8 = tf.plan_fused(100, H, W, 4, 4, "cluster")  # stages a theta
    with pytest.raises(ValueError):
        tf.fused_warp_splat_cuda(xs, xs, xs, xs, xs, 0.5, SENSOR, 3, kernel8)
    fits = tf.plan_fused(100, H, W, 0, 0, "cluster")
    with pytest.raises(ValueError):
        tf.fused_warp_splat_cuda(xs, xs, xs, xs, xs, 0.5, SENSOR, 3,
                                 dataclasses.replace(fits, tile_rows=2))
    _build.reset_launch_counts()
    tf.fused_warp_splat_cuda(xs, xs, xs, xs, xs, 0.5, SENSOR, 5, fits)
    assert _build.launch_counts()["fused_warp_splat"] == 1


@pytest.mark.gpu
def test_float64_solver_loss_on_the_card_matches_cpu(cuda):
    """A float64 window launches the direct kernels on the card (and none
    of the float32 ones) and gives the CPU's float64 loss and gradient to
    1e-12."""
    from eincm_tpu_torch.models.loss import (
        LossParams, LossStatics, compute_window_statics, solver_loss)

    rng = np.random.default_rng(23)
    n = 20_000
    arrays = (rng.uniform(-2, W + 1, n), rng.uniform(-2, H + 1, n), rng.uniform(0, 1, n),
              rng.uniform(0, 1, (2, H, W)), np.array([0.0, 1.0]))
    theta0 = rng.normal(0, 2, (8, 8, 2))
    out = []
    _build.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        xs, ys, ts_, edges, edge_ts = (torch.as_tensor(a, device=dev) for a in arrays)
        wstat = compute_window_statics(xs, ys, edges, SENSOR)
        th = torch.as_tensor(theta0, device=dev).requires_grad_(True)
        loss = solver_loss(th, xs, ys, ts_, edges, edge_ts, LossParams(20.0, 35.0, gamma=0.1),
                           0, LossStatics(SENSOR, 5), wstat)
        (grad,) = torch.autograd.grad(loss, th)
        assert loss.dtype == torch.float64 and grad.dtype == torch.float64
        out.append((float(loss.detach()), grad.cpu()))
    counts = _build.launch_counts()
    assert {k for k, n in counts.items() if n} == set(DIRECT)
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-12 * abs(lp)
    _close(gp, gk, 1e-12)


# ---- the direct kernels: float64 and the wrap-compat splat -----------------

DIRECT = ("splat_direct_fwd", "splat_direct_bwd", "interp_direct_fwd", "interp_direct_bwd")


@pytest.mark.gpu
@pytest.mark.parametrize("window_size", [3, 5, 7])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_splat_direct_kernels_match_plain(cuda, dtype, wrap, window_size):
    """The direct forward and backward against `splat_plain(..., wrap)` and
    its autograd gradient, with events off every edge (some wrap), the
    sentinel, NaN and +-inf: float64 within 1e-12, float32 within 1e-5
    (forward: taps rounded to 2^-24) and 2e-6 (backward); both bitwise the
    same twice, the forward also for other plans (its sums are exact)."""
    rng = np.random.default_rng(24)
    per_ref = [_coords(rng, 20_000, cuda, spread=4.0) for _ in range(2)]
    wx = torch.stack([p[0] for p in per_ref]).to(dtype).contiguous()
    wy = torch.stack([p[1] for p in per_ref]).to(dtype).contiguous()
    wxr, wyr = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
    ref = tk.splat_plain(wxr, wyr, SENSOR, window_size, wrap=wrap)
    f64 = dtype == torch.float64
    _build.reset_launch_counts()
    got = tk.splat_direct_fwd_cuda(wx, wy, SENSOR, window_size, wrap)
    assert got.dtype == dtype
    _close(ref, got, 1e-12 if f64 else 1e-5)
    G = torch.as_tensor(rng.normal(size=(2, H, W)), dtype=dtype, device=cuda)
    rx, ry = torch.autograd.grad(ref, (wxr, wyr), G)
    kx, ky = tk.splat_direct_bwd_cuda(wx, wy, G, SENSOR, window_size, wrap)
    _close(rx, kx, 1e-12 if f64 else 2e-6)
    _close(ry, ky, 1e-12 if f64 else 2e-6)
    assert _build.launch_counts()["splat_direct_fwd"] == 1
    assert _build.launch_counts()["splat_direct_bwd"] == 1
    assert torch.equal(got, tk.splat_direct_fwd_cuda(wx, wy, SENSOR, window_size, wrap))
    plan = tk.plan_splat(2, wx.shape[1], H, W, texel_bytes=8 if f64 else 4)
    for p in (dataclasses.replace(plan, chunks=1), dataclasses.replace(plan, chunks=7),
              tk.plan_splat(2, wx.shape[1], H, W, 4096, 8 if f64 else 4)):
        assert torch.equal(got, tk.splat_direct_fwd_cuda(wx, wy, SENSOR, window_size, wrap, p))
    again = tk.splat_direct_bwd_cuda(wx, wy, G, SENSOR, window_size, wrap)
    assert torch.equal(again[0], kx) and torch.equal(again[1], ky)


@pytest.mark.gpu
@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (4, 4), (16, 16), (5, 12), (32, 32),
                                   (128, 128), (200, 150)])
def test_interp_direct_kernels_match_plain(cuda, gh, gw):
    """The float64 direct forward and backward against the plain versions
    in float64 within 1e-12, on every grid (200x150 is above MAX_GRID),
    with the sentinel, NaN and +-inf events; 20k events on one cell too;
    both bitwise the same twice, the backward also permuted and in both
    exact modes."""
    rng = np.random.default_rng(25)
    x, y = (t.double() for t in _coords(rng, 30_001, cuda))
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)), device=cuda)
    _close(ti.interp_theta_at_events_plain(theta, x, y, SENSOR),
           ti.interp_direct_fwd_cuda(theta, x, y, SENSOR), 1e-12)
    finite = torch.isfinite(x) & torch.isfinite(y)
    x, y = x[finite].contiguous(), y[finite].contiguous()
    g = torch.as_tensor(rng.normal(size=(x.shape[0], 2)), device=cuda)
    got = ti.interp_direct_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR)
    _close(ti.interp_bwd_plain(g, x, y, (gh, gw, 2), SENSOR), got, 1e-12)
    assert torch.equal(got, ti.interp_direct_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR))
    perm = torch.as_tensor(rng.permutation(x.shape[0]), device=cuda)
    assert torch.equal(got, ti.interp_direct_bwd_cuda(g[perm].contiguous(), x[perm].contiguous(),
                                                      y[perm].contiguous(), (gh, gw, 2), SENSOR))
    for mode in ti.EXACT_MODES:
        plan = ti.plan_interp(x.shape[0], gh, gw, True, mode=mode, f64=True)
        assert torch.equal(got, ti.interp_direct_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR, plan))
    th = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)), device=cuda)
    assert torch.equal(ti.interp_direct_fwd_cuda(th, x, y, SENSOR),
                       ti.interp_direct_fwd_cuda(th, x, y, SENSOR))
    x, y = (torch.as_tensor(rng.uniform(a, a + 0.2, 20_000), device=cuda) for a in (20.2, 30.1))
    g = torch.as_tensor(rng.normal(size=(20_000, 2)), device=cuda)
    _close(ti.interp_bwd_plain(g, x, y, (gh, gw, 2), SENSOR),
           ti.interp_direct_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR), 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float64", "wrap_float32", "wrap_float64"])
def test_routers_launch_the_direct_kernels(cuda, case):
    """float64 tensors and the wrap-compat switch reach the direct kernels
    through the routers, forward and backward, with the plain versions'
    gradient; the switch is reset in a `finally`."""
    dtype = torch.float32 if case == "wrap_float32" else torch.float64
    wrap = case.startswith("wrap")
    rng = np.random.default_rng(26)
    x, y = _coords(rng, 5_000, cuda)
    fin = torch.isfinite(x) & torch.isfinite(y)
    x, y = x[fin].to(dtype).contiguous(), y[fin].to(dtype).contiguous()
    theta = torch.as_tensor(rng.normal(0, 3, (16, 16, 2)), dtype=dtype, device=cuda)

    def loss(interp, splat):
        th = theta.clone().requires_grad_(True)
        v = interp(th, x, y, SENSOR)
        iwe = splat((x - 2.0 * v[:, 0])[None], (y - 2.0 * v[:, 1])[None], SENSOR)
        val = (iwe * iwe).sum()
        return val, torch.autograd.grad(val, th)[0]

    ts.set_splat_wrap_compat(wrap)
    try:
        _build.reset_launch_counts()
        val_k, grad_k = loss(ti.interp_theta_at_events, ts.splat_multi_ref)
        counts = _build.launch_counts()
    finally:
        ts.set_splat_wrap_compat(False)
    plain_splat = lambda a, b, s: tk.splat_plain(a, b, s, wrap=wrap)
    val_p, grad_p = loss(ti.interp_theta_at_events_plain, plain_splat)
    launched = {k for k, n in counts.items() if n}
    if dtype == torch.float64:
        assert launched == set(DIRECT)
        _close(val_p, val_k, 1e-12)
        _close(grad_p, grad_k, 1e-12)
    else:
        assert launched == {"interp_fwd", "interp_bwd", "splat_direct_fwd", "splat_direct_bwd"}
        _close(val_p, val_k, 1e-5)
        _close(grad_p, grad_k, 1e-4)


# ---- the Wolfe solve and the EVAL path on the card --------------------------

def _staged(device, seed=3, sensor=(64, 80), n=20_000):
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
    from eincm_tpu_torch.edge.pipeline import iedt_edge_fn

    dl = SyntheticDataLoader(sensor_size=sensor, n_windows=2, des_n_events=n,
                             velocity=(3.0, -2.0), n_features=60, seed=seed)
    dl.get_ready()
    return stage_datasample(dl[1], device, edge_fn=iedt_edge_fn(), pad_to=n + 1000)


@pytest.mark.gpu
def test_staged_sample_window_lies_on_the_requested_device(cuda):
    staged = _staged(cuda)
    assert all(t.device.type == "cuda" for t in staged.window)
    cpu = _staged("cpu")
    for a, b in zip(staged.window, cpu.window):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())  # NaN padding included
    assert isinstance(staged.eval_events["x"], np.ndarray) and staged.gt_flow.shape == (64, 80, 2)


@pytest.mark.gpu
def test_wolfe_solve_window_on_the_card_matches_cpu_statuses(cuda):
    """A handover window under the armijo rescue's configuration (strong
    Wolfe, 10 trials, histories, prior loss) on the card and on the CPU:
    the same per-level statuses, kernels 1-4 launched, and every host sync
    counted. Few iterations and no ftol stop: near the float32 noise floor
    the last bits of the card's atomics decide between a line-search
    failure and the ftol stop, so a longer solve's statuses are a toss."""
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.models.pyramid import HandoverSettings, SolverConfig, make_window_solver

    cfg = SolverConfig(
        n_pyr_lvls=3, sensor_size=(64, 80), params=LossParams(20.0, 35.0),
        theta_opt_maxiters=(5, 4, 3), theta_gtol=1e-4, n_extra_attempts={0: 1},
        handover=HandoverSettings(solve_handover_for_levels=(0,)), line_search="wolfe",
        collect_intermediate=True, compute_prior_loss=True,
    )
    out = {}
    for dev in (cuda, torch.device("cpu")):
        staged = _staged(dev)
        prior = tuple(torch.full((*cfg.level_shape(l), 2), 1.0, device=dev).mul_(
            torch.tensor([2.5, -1.5], device=dev)) for l in range(3))
        _build.reset_launch_counts()
        res = make_window_solver(cfg, dev)(staged.window, prior, False)
        out[dev.type] = (res, _build.launch_counts())
    (rk, lk), (rp, lp) = out["cuda"], out["cpu"]
    assert [s.status for s in rk.theta_opt_states] == [s.status for s in rp.theta_opt_states]
    assert all(lk[k] > 0 for k in ("interp_fwd", "interp_bwd", "splat_fwd", "splat_bwd"))
    assert all(v == 0 for v in lp.values())
    for res in (rk, rp):
        assert res.n_host_syncs == sum(s.n_fun_evals + s.total_iters for s in res.theta_opt_states)
        assert np.isfinite(float(res.prior_loss_lvl0))
    _close(rp.final_theta_pyr[0], rk.final_theta_pyr[0], 0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_evaluate_theta_array_on_the_card_matches_cpu(cuda, dtype):
    """prepare_eval_inputs + evaluate_theta_array on the card against the
    CPU: every value within 1e-4 relative (float32; float64 1e-12), the A{n}PE
    rates within one pixel's share, the counts exactly; the splat forward
    launched once to prepare and twice per evaluation (float32), or the
    direct splat (float64)."""
    from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, prepare_eval_inputs
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    gen = torch.Generator().manual_seed(1)
    theta = torch.tensor([3.0, -2.0]) + 0.5 * torch.randn(8, 8, 2, generator=gen)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        staged = _staged(dev)
        ev = staged.eval_events
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        full = scale_theta_to_sensor_size(theta.to(dev, dtype), (64, 80))
        edges, edge_ts = staged.window.edges.to(dtype), staged.window.edge_ts.to(dtype)
        _build.reset_launch_counts()
        xs, ys, ts, ws = prepare_eval_inputs(t(ev["x"]), t(ev["y"]), t(ev["t"]), edges,
                                             (64, 80), dtype=dtype)
        prep = _build.launch_counts()
        _build.reset_launch_counts()
        _, s, evals, objs = evaluate_theta_array(
            full, xs, ys, ts, edges, edge_ts, t(staged.gt_flow), LossParams(60.0, 60.0, 0.01, 0.1),
            (64, 80), window_statics=ws)
        out[dev.type] = (evals, prep, _build.launch_counts(), objs)
    (ek, pk, lk, ok), (ep, _, _, _) = out["cuda"], out["cpu"]
    splat = "splat_fwd" if dtype == torch.float32 else "splat_direct_fwd"
    assert pk[splat] == 1 and lk[splat] == 2
    assert ok["warped_xs"].device.type == "cuda"
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for key, ref in ep.items():
        if key in ("n_ee", "n_pred", "n_gt", "n_pixels"):
            assert int(ek[key]) == int(ref), key
            continue
        atol = 100.0 / int(ep["n_ee"]) if key[0] == "A" and key.endswith("PE") else 0.0
        np.testing.assert_allclose(np.asarray(ek[key], np.float64), np.asarray(ref, np.float64),
                                   rtol=tol, atol=atol, err_msg=key)
    assert int(ek["n_ee"]) > 100
