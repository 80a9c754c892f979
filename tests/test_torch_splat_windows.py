"""Splat windows other than 3 and 5: the port's plain version against the
JAX package's `events_to_pdf_frame` and its `jax.grad`, and the router's
choice of kernel on the card.

The JAX package takes any window: hw = window_size // 2, so an even window
w deposits the (2 hw + 1)^2 taps of window w + 1. On the card the slab
kernels are built for windows 3 and 5 (`WINDOW_SIZES`); every other window
goes to the direct kernels (`csrc/direct.cu`), routed by argument in
`ops/splat.py:splat_multi_ref`. Tolerances, relative to max |reference|:
float64 1e-12; float32 1e-5 for frames and 2e-6 for the coordinate
gradient (up to 81 taps per event summed in another order), as in
tests/test_torch_splat.py at window 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import splat as js
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import splat as ts
from eincm_tpu_torch.ops import splat_kernel as tk

SENSOR = (32, 48)
H, W = SENSOR
WINDOWS = [1, 4, 7, 9]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.isfinite(got).all()
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(ref - got).max()
    assert err <= tol * scale, err / scale


def _coords(rng, n_refs, n, dt):
    """(n_refs, n) coordinates over the sensor and up to 5 texels past each
    edge (a 9x9 window reaches 4), with the padding sentinel appended."""
    wx = rng.uniform(-5.0, W + 4.0, (n_refs, n))
    wy = rng.uniform(-5.0, H + 4.0, (n_refs, n))
    wx[:, -1] = wy[:, -1] = -1e4
    return wx.astype(dt), wy.astype(dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("window_size", WINDOWS)
def test_forward_matches_jax(window_size, dt):
    rng = np.random.default_rng(70 + window_size)
    wx, wy = _coords(rng, 2, 500, dt)
    with jax.enable_x64(dt == np.float64):
        ref = js.splat_multi_ref(jnp.asarray(wx), jnp.asarray(wy), SENSOR, window_size)
        one = js.events_to_pdf_frame(jnp.asarray(wx[1]), jnp.asarray(wy[1]), SENSOR,
                                     window_size)
    _build.reset_launch_counts()
    got = ts.splat_multi_ref(torch.as_tensor(wx), torch.as_tensor(wy), SENSOR, window_size)
    assert got.dtype == torch.as_tensor(wx).dtype
    tol = 1e-12 if dt == np.float64 else 1e-5
    _close(ref, got, tol)
    _close(one, ts.events_to_pdf_frame(torch.as_tensor(wx[1]), torch.as_tensor(wy[1]), SENSOR,
                                       window_size), tol)
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("window_size", WINDOWS)
def test_grad_matches_jax(window_size, dt):
    rng = np.random.default_rng(80 + window_size)
    wx, wy = _coords(rng, 2, 400, dt)
    g = rng.normal(0, 1, (2, *SENSOR)).astype(dt)
    with jax.enable_x64(dt == np.float64):
        jgx, jgy = jax.grad(
            lambda a, b: jnp.vdot(js.splat_multi_ref(a, b, SENSOR, window_size), g),
            argnums=(0, 1),
        )(jnp.asarray(wx), jnp.asarray(wy))
    tx = torch.as_tensor(wx).requires_grad_(True)
    ty = torch.as_tensor(wy).requires_grad_(True)
    gx, gy = torch.autograd.grad(
        ts.splat_multi_ref(tx, ty, SENSOR, window_size), (tx, ty), torch.as_tensor(g)
    )
    tol = 1e-12 if dt == np.float64 else 2e-6
    _close(jgx, gx, tol)
    _close(jgy, gy, tol)


@pytest.mark.parametrize("even", [2, 4, 6])
def test_even_window_takes_the_next_odd_windows_taps(even):
    """hw = window_size // 2: an even window deposits 2 hw + 1 taps a side,
    the frame of window even + 1, in both packages."""
    rng = np.random.default_rng(90 + even)
    wx, wy = _coords(rng, 1, 300, np.float64)
    t = lambda a: torch.as_tensor(a)
    got = ts.splat_multi_ref(t(wx), t(wy), SENSOR, even)
    assert torch.equal(got, ts.splat_multi_ref(t(wx), t(wy), SENSOR, even + 1))
    with jax.enable_x64(True):
        ref = js.splat_multi_ref(jnp.asarray(wx), jnp.asarray(wy), SENSOR, even)
    _close(ref, got, 1e-12)
    one = ts.events_to_pdf_frame(torch.tensor([20.2]), torch.tensor([15.0]), SENSOR, even)
    assert int((one > 0).sum()) == (even + 1) ** 2


ROUTES = [(3, torch.float32, "slab"), (5, torch.float32, "slab")] + [
    (w, torch.float32, "direct") for w in WINDOWS] + [(7, torch.float64, "direct")]


@pytest.mark.parametrize("window_size,dtype,route", ROUTES,
                         ids=[f"w{w}_{str(d)[6:]}" for w, d, _ in ROUTES])
def test_router_sends_other_windows_to_the_direct_kernels(monkeypatch, window_size, dtype,
                                                          route):
    """Off the CPU (the meta device here, which no kernel sees; a CUDA
    tensor on the card) windows 3 and 5 in float32 still reach the slab
    kernels (`_SplatCuda`), and every other window the direct kernels
    (`_SplatDirect`) without the wrap; a route by argument, not a retry."""
    seen = []
    for cls, name in ((tk._SplatCuda, "slab"), (tk._SplatDirect, "direct")):
        monkeypatch.setattr(cls, "apply", staticmethod(
            lambda *args, name=name: seen.append((name, args))))
    w = torch.zeros(2, 10, dtype=dtype, device="meta")
    ts.splat_multi_ref(w, w, SENSOR, window_size)
    assert [name for name, _ in seen] == [route]
    assert seen[0][1][2:] == ((SENSOR, window_size, False) if route == "direct"
                              else (SENSOR, window_size))
