"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX. `tests/conftest.py` imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

The tests marked `gpu` skip without a CUDA device. Tolerances, relative to
max |plain|: 1e-6 where each output sums a fixed handful of terms (interp
forward, splat backward), 1e-5 where atomics reorder long sums (splat
forward, interp backward).
"""

import numpy as np
import pytest
import torch

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
    assert set(_build.launch_counts().values()) == {1}
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
