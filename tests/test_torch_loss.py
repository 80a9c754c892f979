"""`solver_loss` of eincm_tpu_torch vs eincm_tpu: value and gradient.

float64: relative error <= 1e-12 (value) and <= 1e-12 of max |grad|.
float32: <= 2e-6 (value) and <= 1e-5 of max |grad|: the splat and the
mean reductions sum thousands of terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.models import loss as jl
from eincm_tpu_torch.models import loss as tl
from eincm_tpu_torch.ops import _build

SENSOR = (40, 48)
LEVEL_SHAPES = {4: (1, 1), 3: (2, 2), 2: (4, 4), 1: (8, 8), 0: (16, 16)}
TOL = {np.float64: (1e-12, 1e-12), np.float32: (2e-6, 1e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(seed, n=3000, sensor=SENSOR, n_refs=2):
    rng = np.random.default_rng(seed)
    H, W = sensor
    xs = rng.integers(0, W, n).astype(np.float64)
    ys = rng.integers(0, H, n).astype(np.float64)
    ts = np.sort(rng.uniform(0, 1, n))
    xs[:40] = np.nan  # padding
    ys[:40] = np.nan
    ts[:40] = np.nan
    edges = rng.uniform(0, 1, (n_refs, H, W))
    edge_ts = np.linspace(0.0, 1.0, n_refs)
    return rng, [xs, ys, ts, edges, edge_ts]


def _both(arrays, theta, params, lvl, dt, sensor=SENSOR, method="bilinear"):
    arrays = [a.astype(dt) for a in arrays]
    theta = theta.astype(dt)
    with jax.enable_x64(dt == np.float64):
        ja = [jnp.asarray(a) for a in arrays]
        ws = jl.compute_window_statics(ja[0], ja[1], ja[3], sensor)
        st = jl.LossStatics(sensor, 5, method)
        jv, jg = jax.value_and_grad(
            lambda t: jl.solver_loss(t, *ja, jl.LossParams(**params), lvl, st, ws)
        )(jnp.asarray(theta))
        jv, jg, jws = float(jv), np.asarray(jg), [np.asarray(w) for w in ws]
    ta = [torch.as_tensor(a) for a in arrays]
    tws = tl.compute_window_statics(ta[0], ta[1], ta[3], sensor)
    th = torch.as_tensor(theta).requires_grad_(True)
    tv = tl.solver_loss(
        th, *ta, tl.LossParams(**params), lvl, tl.LossStatics(sensor, 5, method), tws
    )
    (tg,) = torch.autograd.grad(tv, th)
    return (jv, jg, jws), (float(tv.detach()), tg.numpy(), [w.numpy() for w in tws])


def _check(j, t, dt):
    (jv, jg, _), (tv, tg, _) = j, t
    tol_v, tol_g = TOL[dt]
    assert abs(jv - tv) <= tol_v * abs(jv), abs(jv - tv) / abs(jv)
    scale = np.abs(jg).max()
    assert np.abs(jg - tg).max() <= tol_g * scale, np.abs(jg - tg).max() / scale


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("lvl", [4, 3, 2, 1, 0])
def test_solver_loss_every_level(dt, lvl):
    rng, arrays = _window(lvl)
    theta = rng.normal(0, 2, (*LEVEL_SHAPES[lvl], 2))
    j, t = _both(arrays, theta, dict(alpha=20.0, beta=35.0), lvl, dt)
    _check(j, t, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize(
    "params,lvl",
    [
        (dict(alpha=20.0, beta=35.0, gamma=0.01), 0),  # TV on at level 0
        (dict(alpha=20.0, beta=35.0, gamma=0.01), 1),  # TV gated off
        (dict(alpha=20.0, beta=35.0, delta=0.5), 1),  # IWE divergence
        (dict(alpha=60.0, beta=0.0, gamma=0.001, delta=2.0), 0),
    ],
)
def test_solver_loss_regularizers(dt, params, lvl):
    rng, arrays = _window(10 + lvl)
    theta = rng.normal(0, 2, (*LEVEL_SHAPES[lvl], 2))
    j, t = _both(arrays, theta, params, lvl, dt)
    _check(j, t, dt)


@pytest.mark.parametrize("n_refs", [1, 3])
def test_solver_loss_ref_counts_f64(n_refs):
    rng, arrays = _window(20, n_refs=n_refs)
    theta = rng.normal(0, 2, (4, 4, 2))
    j, t = _both(arrays, theta, dict(alpha=20.0, beta=35.0), 2, np.float64)
    _check(j, t, np.float64)


def test_full_sensor_gather_path_f64():
    """A non-'bilinear' scaling method routes through the full-sensor
    field and the per-event gather."""
    rng, arrays = _window(21)
    theta = rng.normal(0, 2, (4, 4, 2))
    j, t = _both(arrays, theta, dict(alpha=20.0, beta=35.0), 2, np.float64,
                 method="linear")
    _check(j, t, np.float64)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_window_statics(dt):
    rng, arrays = _window(22)
    j, t = _both(arrays, rng.normal(0, 1, (1, 1, 2)),
                 dict(alpha=1.0, beta=1.0), 4, dt)
    tol = TOL[dt][0]
    for a, b in zip(j[2], t[2]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1.0)


def test_sanitize_events():
    xs = np.array([1.0, np.nan, 3.0, np.inf])
    ys = np.array([2.0, 2.0, np.nan, 1.0])
    ts = np.array([0.1, 0.2, 0.3, np.nan])
    with jax.enable_x64(True):
        ref = jl._sanitize_events(*[jnp.asarray(a) for a in (xs, ys, ts)])
    got = tl._sanitize_events(*[torch.as_tensor(a) for a in (xs, ys, ts)])
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_graft_entry_case_f32():
    """The 128x128, 16k-event case of __graft_entry__.py: loss_func's value
    and gradient (TV on at level 0) equal solver_loss's."""
    H = W = 128
    n = 16384
    rng = np.random.default_rng(0)
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    edges = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    edge_ts = np.array([0.0, 1.0], np.float32)
    theta = rng.normal(0, 1, (16, 16, 2)).astype(np.float32)
    params = dict(alpha=60.0, beta=60.0, gamma=0.001, delta=0.0)
    ja = [jnp.asarray(a) for a in (xs, ys, ts, edges, edge_ts)]
    ws = jl.compute_window_statics(ja[0], ja[1], ja[3], (H, W))
    (jv, _), jg = jax.value_and_grad(jl.loss_func, has_aux=True)(
        jnp.asarray(theta), *ja, jl.LossParams(**params), 0,
        jl.LossStatics((H, W), 5), ws,
    )
    ta = [torch.as_tensor(a) for a in (xs, ys, ts, edges, edge_ts)]
    tws = tl.compute_window_statics(ta[0], ta[1], ta[3], (H, W))
    th = torch.as_tensor(theta).requires_grad_(True)
    tv = tl.solver_loss(th, *ta, tl.LossParams(**params), 0,
                        tl.LossStatics((H, W), 5), tws)
    (tg,) = torch.autograd.grad(tv, th)
    _check((float(jv), np.asarray(jg), None), (float(tv.detach()), tg.numpy(), None), np.float32)


def test_loss_on_cpu_launches_no_kernel():
    _build.reset_launch_counts()
    rng, arrays = _window(23, n=200)
    ta = [torch.as_tensor(a.astype(np.float32)) for a in arrays]
    ws = tl.compute_window_statics(ta[0], ta[1], ta[3], SENSOR)
    th = torch.zeros(2, 2, 2, requires_grad=True)
    tl.solver_loss(th, *ta, tl.LossParams(1.0, 1.0), 3,
                   tl.LossStatics(SENSOR, 5), ws).backward()
    assert all(v == 0 for v in _build.launch_counts().values())
