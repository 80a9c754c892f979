"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX. `tests/conftest.py` imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The tests marked `gpu` skip without a CUDA device. Tolerances, relative to
max |plain|: 1e-6 where each output sums a fixed handful of terms (interp
forward, splat backward, dense interp, whose `highest` is 3xTF32), 1e-5
where atomics reorder long sums (splat forward, fused warp+splat, interp
backward above 16x16), 1e-6 against the plain version's float32 terms
summed in float64 for the interp backward up to 16x16, whose own sums are
exact or short.
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
     (32, 32), (128, 128)],  # float atomics; theta not staged at 128x128
)
def test_interp_kernels_match_plain(cuda, gh, gw):
    """Forward within 1e-6 and bitwise on finite events; backward within
    1e-6 of the plain version's terms summed in float64 (1e-5 for the float-atomic kernel
    of the large grids) and, below them, bitwise the same twice. Whole
    tensors, views that start 4 and 12 bytes into a 16-byte line, an event
    count that is no multiple of 4, in groups of four and one by one."""
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
            _close(ref, got, 1e-5 if plan.mode == "float" else 1e-6)
            if plan.mode != "float":
                assert torch.equal(got, ti.interp_bwd_cuda(vg, vx, vy, (gh, gw, 2), SENSOR, plan))


@pytest.mark.gpu
@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16)])
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
    with pytest.raises(TypeError):
        ti.interp_theta_at_events(theta.double(), xs.double(), xs.double(), SENSOR)
    with pytest.raises(ValueError):
        ti.interp_fwd_cuda(torch.zeros(129, 4, 2, device=cuda), xs, xs, SENSOR)
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


def _slab_window(rng, R, n, sensor, tile_rows, device):
    """(R, E) coordinates: n uniform events per ref, the edge cases, and
    events on and around every slab edge (their windows straddle two
    slabs), each ref in its own order."""
    Hs, Ws = sensor
    xs = [rng.uniform(-3, Ws + 2, n)]
    ys = [rng.uniform(-3, Hs + 2, n)]
    ex, ey = np.array(EDGE_XY, np.float64).T
    xs.append(ex)
    ys.append(ey)
    edges = np.arange(tile_rows, Hs, tile_rows, dtype=np.float64)
    for d in (-1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0):
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
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, p), 1e-5)
    many = dataclasses.replace(p, chunks=7)
    _close(ref, tk.splat_fwd_cuda(wx, wy, sensor, many), 1e-5)


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
        gx, gy = tk.splat_bwd_cuda(wx, wy, G, sensor, tk.plan_splat_bwd(R, E, Hs, Ws, "gather"))
        _close(rx, gx, 1e-6)
        _close(ry, gy, 1e-6)
        plan = tk.plan_splat_bwd(R, E, Hs, Ws, "stream")
        assert plan.vec == (E % 4 == 0 or R == 1)
        for p in (plan, dataclasses.replace(plan, vec=False),
                  tk.plan_splat_bwd(R, E, Hs, Ws, "stream", threads=512, blocks=3),
                  tk.plan_splat_bwd(R, E, Hs, Ws, "stream", threads=32, blocks=5000)):
            kx, ky = tk.splat_bwd_cuda(wx, wy, G, sensor, p)
            assert torch.equal(kx, gx) and torch.equal(ky, gy)
            again = tk.splat_bwd_cuda(wx, wy, G, sensor, p)
            assert torch.equal(again[0], kx) and torch.equal(again[1], ky)
    # one ref, as views that start 4 bytes into a 16-byte line
    flat_x, flat_y = torch.zeros(E + 1, device=cuda), torch.zeros(E + 1, device=cuda)
    flat_x[1:], flat_y[1:] = wx[0], wy[0]
    ux, uy = flat_x[1:][None], flat_y[1:][None]
    with pytest.raises(ValueError):  # float4s on arrays off a 16-byte line
        tk.splat_bwd_cuda(ux, uy, G[:1], sensor, tk.plan_splat_bwd(1, E, Hs, Ws, "stream"))
    kx, ky = tk.splat_bwd_cuda(ux, uy, G[:1], sensor,
                               tk.plan_splat_bwd(1, E, Hs, Ws, "stream", aligned=False))
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
    ox, oy = tk.splat_bwd_cuda(wx, wy, G, sensor, tk.plan_splat_bwd(2, E, *sensor, "gather"))
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
        tk.splat_bwd_cuda(w, w, G, SENSOR, dataclasses.replace(fits, vec=True))
    with pytest.raises(RuntimeError):  # the C side refuses a block of 48 threads
        tk.splat_bwd_cuda(w, w, G, SENSOR, dataclasses.replace(fits, threads=48))
    with pytest.raises(RuntimeError):  # and 1024 threads for the stream kernel
        tk.splat_bwd_cuda(w, w, G, SENSOR, dataclasses.replace(fits, threads=1024))


def _fused_events(rng, n, sensor, tile_rows, device):
    """n uniform events, the edge cases and events on and around every slab
    edge, unsorted, with timestamps; velocities stay small enough that the
    warped windows still straddle the edges."""
    x, y = _slab_window(rng, 1, n, sensor, tile_rows, device)
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
