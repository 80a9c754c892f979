"""Coarse-theta interpolation and warp: eincm_tpu_torch's plain version vs
eincm_tpu (the XLA path, and the Pallas kernel in interpret mode).

Tolerances, relative to max |reference|: float64 1e-12; float32 1e-6 for
the forward (two nonzero taps per axis, summed in the same order) and
2e-5 for the gradient (a sum over up to 3000 events per grid cell, taken
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import warp as jw
from eincm_tpu.ops.interp_pallas import interp_theta_at_events_pallas
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import interp as ti
from eincm_tpu_torch.ops import warp as tw

SENSOR = (48, 64)
EDGE_XY = [
    (-1e4, -1e4),  # the padding sentinel
    (2.5, 3.5), (0.5, 1.5), (-0.5, -0.5),  # exact .5 ties: half to even
    (0.0, 0.0), (63.0, 47.0), (63.5, 47.5), (64.0, 48.0),  # at the edge
    (-1.0, 5.0), (-2.0, 5.0), (70.0, 60.0),  # beyond it
    (1e10, 3.0), (-1e10, 3.0), (3.0, 1e10),
    (np.inf, 4.0), (4.0, -np.inf),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coords(rng, n, spread=0.0):
    H, W = SENSOR
    xs = rng.uniform(-spread, W - 1 + spread, n)
    ys = rng.uniform(-spread, H - 1 + spread, n)
    ex, ey = np.array(EDGE_XY, np.float64).T
    return np.concatenate([xs, ex]), np.concatenate([ys, ey])


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    fin = ~np.isnan(ref)
    scale = max(np.abs(ref[fin]).max(), 1e-30)
    err = np.abs(ref[fin] - got[fin]).max()
    assert err <= tol * scale, err / scale


@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (16, 16), (128, 128), (3, 5)])
def test_forward_f32_vs_xla_and_pallas(gh, gw):
    rng = np.random.default_rng(gh * 131 + gw)
    xs, ys = _coords(rng, 2000, spread=4.0)
    theta = rng.normal(0, 3, (gh, gw, 2)).astype(np.float32)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    ref_xla = jw.interp_theta_at_events(
        jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR
    )
    ref_pal = interp_theta_at_events_pallas(
        jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR, True
    )
    got = ti.interp_theta_at_events(
        torch.as_tensor(theta), torch.as_tensor(xs), torch.as_tensor(ys), SENSOR
    )
    _close(ref_xla, got, 1e-6)
    _close(ref_pal, got, 1e-6)


def test_forward_f64_vs_xla():
    rng = np.random.default_rng(1)
    xs, ys = _coords(rng, 3000, spread=4.0)
    theta = rng.normal(0, 3, (16, 16, 2))
    with jax.enable_x64(True):
        ref = jw.interp_theta_at_events(
            jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR
        )
    got = ti.interp_theta_at_events(
        torch.as_tensor(theta), torch.as_tensor(xs), torch.as_tensor(ys), SENSOR
    )
    _close(ref, got, 1e-12)


def test_sentinel_samples_zero_and_nan_propagates():
    rng = np.random.default_rng(2)
    theta = torch.as_tensor(rng.normal(0, 3, (8, 8, 2)).astype(np.float32))
    xs = torch.tensor([-1e4, np.nan, 5.0, np.inf], dtype=torch.float32)
    ys = torch.tensor([-1e4, 5.0, np.nan, 3.0], dtype=torch.float32)
    out = ti.interp_theta_at_events(theta, xs, ys, SENSOR).numpy()
    np.testing.assert_array_equal(out[0], 0.0)
    assert np.isnan(out[1]).all() and np.isnan(out[2]).all()
    np.testing.assert_array_equal(out[3], 0.0)


@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (16, 16), (128, 128)])
def test_grad_f32_vs_pallas_vjp_and_xla_grad(gh, gw):
    rng = np.random.default_rng(3 + gh)
    xs, ys = _coords(rng, 3000, spread=3.0)
    fin = np.isfinite(xs) & np.isfinite(ys)
    xs, ys = xs[fin].astype(np.float32), ys[fin].astype(np.float32)
    theta = rng.normal(0, 3, (gh, gw, 2)).astype(np.float32)
    ct = rng.normal(0, 1, (xs.shape[0], 2)).astype(np.float32)
    jx, jy, jc = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ct)
    _, vjp = jax.vjp(
        lambda t: interp_theta_at_events_pallas(t, jx, jy, SENSOR, True),
        jnp.asarray(theta),
    )
    (g_pal,) = vjp(jc)
    g_xla = jax.grad(
        lambda t: jnp.vdot(jw.interp_theta_at_events(t, jx, jy, SENSOR), jc)
    )(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    out = ti.interp_theta_at_events(th, torch.as_tensor(xs), torch.as_tensor(ys), SENSOR)
    (got,) = torch.autograd.grad(out, th, torch.as_tensor(ct))
    _close(g_pal, got, 2e-5)
    _close(g_xla, got, 2e-5)


def test_several_pallas_chunks():
    """More events than one Pallas grid step holds (65536 at 16x16)."""
    rng = np.random.default_rng(4)
    n = 70_000
    xs = rng.integers(0, SENSOR[1], n).astype(np.float32)
    ys = rng.integers(0, SENSOR[0], n).astype(np.float32)
    theta = rng.normal(0, 3, (16, 16, 2)).astype(np.float32)
    ref = interp_theta_at_events_pallas(
        jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR, True
    )
    got = ti.interp_theta_at_events(
        torch.as_tensor(theta), torch.as_tensor(xs), torch.as_tensor(ys), SENSOR
    )
    _close(ref, got, 1e-6)


def test_gather_and_full_sensor_warp_f64():
    rng = np.random.default_rng(5)
    H, W = SENSOR
    xs, ys = _coords(rng, 500)
    xs[-16:] = np.where(np.isfinite(xs[-16:]), xs[-16:], 0.0)
    ys[-16:] = np.where(np.isfinite(ys[-16:]), ys[-16:], 0.0)
    xs = np.clip(xs, -1e4, 1e4)
    ys = np.clip(ys, -1e4, 1e4)
    ts = rng.uniform(0, 1, xs.shape[0])
    refs = np.array([0.0, 0.5, 1.0])
    theta = rng.normal(0, 2, (H, W, 2))
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (theta, xs, ys, ts, refs)]
        jg = jw.gather_theta_at_events(*args[:3])
        jwx, jwy = jw.warp_events_multi_ref(*args)
    targs = [torch.as_tensor(a) for a in (theta, xs, ys, ts, refs)]
    _close(jg, tw.gather_theta_at_events(*targs[:3]), 1e-12)
    twx, twy = tw.warp_events_multi_ref(*targs)
    _close(jwx, twx, 1e-12)
    _close(jwy, twy, 1e-12)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_coarse_warp(dt):
    rng = np.random.default_rng(6)
    xs, ys = _coords(rng, 800)
    fin = np.isfinite(xs) & np.isfinite(ys)
    xs, ys = xs[fin].astype(dt), ys[fin].astype(dt)
    ts = rng.uniform(0, 1, xs.shape[0]).astype(dt)
    refs = np.array([0.0, 1.0], dt)
    theta = rng.normal(0, 2, (4, 4, 2)).astype(dt)
    with jax.enable_x64(dt == np.float64):
        jwx, jwy = jw.warp_events_multi_ref_coarse(
            *[jnp.asarray(a) for a in (theta, xs, ys, ts, refs)], SENSOR
        )
    twx, twy = tw.warp_events_multi_ref_coarse(
        *[torch.as_tensor(a) for a in (theta, xs, ys, ts, refs)], SENSOR
    )
    tol = 1e-12 if dt == np.float64 else 1e-6
    _close(jwx, twx, tol)
    _close(jwy, twy, tol)


def test_cpu_tensors_never_launch_a_kernel():
    _build.reset_launch_counts()
    theta = torch.zeros(4, 4, 2, requires_grad=True)
    xs = torch.arange(10, dtype=torch.float32)
    out = ti.interp_theta_at_events(theta, xs, xs, SENSOR)
    out.sum().backward()
    assert _build.launch_counts()["interp_fwd"] == 0
    assert _build.launch_counts()["interp_bwd"] == 0

