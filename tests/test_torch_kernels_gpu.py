"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX. `tests/conftest.py` imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The tests marked `gpu` skip without a CUDA device. Tolerances, relative to
max |plain|: 1e-6 where each output sums a fixed handful of terms (interp
forward, splat backward, dense interp, whose `highest` is 3xTF32), 1e-5
where atomics reorder long sums (splat forward, interp backward, fused
warp+splat).
"""

import dataclasses

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
@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (16, 16), (128, 128)])
def test_interp_kernels_match_plain(cuda, gh, gw):
    rng = np.random.default_rng(7)
    x, y = _coords(rng, 30_000, cuda)
    theta = torch.as_tensor(rng.normal(0, 3, (gh, gw, 2)).astype(np.float32), device=cuda)
    _close(
        ti.interp_theta_at_events_plain(theta, x, y, SENSOR),
        ti.interp_fwd_cuda(theta, x, y, SENSOR),
        1e-6,
    )
    # NaN events poison different subsets of dtheta in the two versions
    fin = torch.isfinite(x) & torch.isfinite(y)
    x, y = x[fin].contiguous(), y[fin].contiguous()
    g = torch.as_tensor(rng.normal(size=(x.shape[0], 2)).astype(np.float32), device=cuda)
    th = theta.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(ti.interp_theta_at_events_plain(th, x, y, SENSOR), th, g)
    _close(ref, ti.interp_bwd_cuda(g, x, y, (gh, gw, 2), SENSOR), 1e-5)


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
