"""IWE splat: eincm_tpu_torch's plain version vs eincm_tpu (the XLA matmul
path, the scatter oracle, and the Pallas kernels in interpret mode).

Tolerances, relative to max |reference|: float64 1e-12; float32 1e-5 for
frames (each texel sums up to hundreds of event taps, in another order)
and 1e-6 for the coordinate gradient (9 texels per event).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import splat as js
from eincm_tpu.ops.splat_pallas import _bwd_pallas, events_to_pdf_frame_pallas
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import splat as ts
from eincm_tpu_torch.ops import splat_kernel as tk

SENSOR = (24, 32)
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(rng, n, spread=3.0, edges=True):
    xs = rng.uniform(-spread, W - 1 + spread, n)
    ys = rng.uniform(-spread, H - 1 + spread, n)
    if edges:
        ex, ey = np.array(EDGE_XY, np.float64).T
        xs, ys = np.concatenate([xs, ex]), np.concatenate([ys, ey])
    return xs, ys


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.isfinite(got).all()
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(ref - got).max()
    assert err <= tol * scale, err / scale


def _plain(xs, ys):
    return ts.events_to_pdf_frame(torch.as_tensor(xs), torch.as_tensor(ys), SENSOR)


@pytest.mark.parametrize("n", [1, 700, 9000])  # 9000: three Pallas chunks
def test_forward_f32_vs_xla_pallas_and_scatter(n):
    rng = np.random.default_rng(n)
    xs, ys = _events(rng, n)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    got = _plain(xs, ys)
    _close(js.events_to_pdf_frame(jx, jy, SENSOR), got, 1e-5)
    _close(js.events_to_pdf_frame_scatter(jx, jy, SENSOR), got, 1e-5)
    _close(events_to_pdf_frame_pallas(jx, jy, SENSOR, 3, True), got, 1e-5)


def test_forward_f64_vs_xla_and_scatter():
    rng = np.random.default_rng(1)
    xs, ys = _events(rng, 2000)
    with jax.enable_x64(True):
        jx, jy = jnp.asarray(xs), jnp.asarray(ys)
        ref = js.events_to_pdf_frame(jx, jy, SENSOR)
        oracle = js.events_to_pdf_frame_scatter(jx, jy, SENSOR)
    got = _plain(xs, ys)
    assert got.dtype == torch.float64
    _close(ref, got, 1e-12)
    _close(oracle, ts.events_to_pdf_frame_scatter(torch.as_tensor(xs), torch.as_tensor(ys), SENSOR), 1e-12)


def test_dropped_events_deposit_nothing():
    """Sentinel, NaN, infinite and far events leave the frame untouched;
    .5 ties round half to even (2.5 -> 2, 3.5 -> 4)."""
    far = np.array([[-1e4, -1e4], [np.nan, 3.0], [np.inf, 3.0], [1e10, 2.0],
                    [3.0, -np.inf], [-2.0, 5.0], [W + 1.5, 5.0]])
    frame = _plain(far[:, 0], far[:, 1])
    assert float(frame.abs().max()) == 0.0
    tie = _plain(np.array([2.5]), np.array([3.5])).numpy()
    rows, cols = np.nonzero(tie)
    assert set(rows) == {3, 4, 5} and set(cols) == {1, 2, 3}


def test_multi_ref_vs_vmapped_xla():
    rng = np.random.default_rng(2)
    per_ref = [_events(rng, 600) for _ in range(3)]
    wx = np.stack([p[0] for p in per_ref]).astype(np.float32)
    wy = np.stack([p[1] for p in per_ref]).astype(np.float32)
    ref = js.splat_multi_ref(jnp.asarray(wx), jnp.asarray(wy), SENSOR)
    got = ts.splat_multi_ref(torch.as_tensor(wx), torch.as_tensor(wy), SENSOR)
    _close(ref, got, 1e-5)


@pytest.mark.parametrize("n", [300, 9000])
def test_grad_f32_vs_pallas_bwd_kernel(n):
    """Autograd of the plain version vs the Pallas backward kernel
    (interpret mode), edge cases included: dropped events get 0."""
    rng = np.random.default_rng(3 + n)
    xs, ys = _events(rng, n)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    g = rng.normal(0, 1, SENSOR).astype(np.float32)
    dwx, dwy = _bwd_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g), SENSOR, 3, True
    )
    dwx = np.where(np.isfinite(dwx), dwx, 0.0)
    dwy = np.where(np.isfinite(dwy), dwy, 0.0)
    tx = torch.as_tensor(xs).requires_grad_(True)
    ty = torch.as_tensor(ys).requires_grad_(True)
    frame = ts.events_to_pdf_frame(tx, ty, SENSOR)
    gx, gy = torch.autograd.grad(frame, (tx, ty), torch.as_tensor(g))
    _close(dwx, gx, 1e-6)
    _close(dwy, gy, 1e-6)
    bad = ~(np.isfinite(xs) & np.isfinite(ys))
    assert (gx.numpy()[bad] == 0).all() and (gy.numpy()[bad] == 0).all()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_grad_vs_jax_grad_of_xla_path(dt):
    rng = np.random.default_rng(4)
    xs, ys = _events(rng, 800, edges=False)
    xs, ys = xs.astype(dt), ys.astype(dt)
    g = rng.normal(0, 1, SENSOR).astype(dt)
    with jax.enable_x64(dt == np.float64):
        jgx, jgy = jax.grad(
            lambda a, b: jnp.vdot(js.events_to_pdf_frame(a, b, SENSOR), g),
            argnums=(0, 1),
        )(jnp.asarray(xs), jnp.asarray(ys))
    tx = torch.as_tensor(xs).requires_grad_(True)
    ty = torch.as_tensor(ys).requires_grad_(True)
    gx, gy = torch.autograd.grad(
        ts.events_to_pdf_frame(tx, ty, SENSOR), (tx, ty), torch.as_tensor(g)
    )
    tol = 1e-12 if dt == np.float64 else 1e-6
    _close(jgx, gx, tol)
    _close(jgy, gy, tol)


def test_event_counts_and_mask():
    rng = np.random.default_rng(5)
    xs, ys = _events(rng, 500, spread=2.0)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    jc = js.event_counts(jnp.asarray(xs), jnp.asarray(ys), SENSOR)
    jm = js.make_event_mask(jnp.asarray(xs), jnp.asarray(ys), SENSOR)
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    np.testing.assert_array_equal(np.asarray(jc), ts.event_counts(tx, ty, SENSOR).numpy())
    np.testing.assert_array_equal(np.asarray(jm), ts.make_event_mask(tx, ty, SENSOR).numpy())


def test_cpu_tensors_never_launch_a_kernel():
    _build.reset_launch_counts()
    wx = torch.rand(2, 50, requires_grad=True) * W
    wy = torch.rand(2, 50) * H
    ts.splat_multi_ref(wx, wy, SENSOR).sum().backward()
    assert _build.launch_counts()["splat_fwd"] == 0
    assert _build.launch_counts()["splat_bwd"] == 0



# ---- window 5 (the kernels are built for windows 3 and 5) -------------------


@pytest.mark.parametrize("n", [1, 700, 9000])
def test_forward_window5_f32_vs_xla_pallas_and_scatter(n):
    rng = np.random.default_rng(50 + n)
    xs, ys = _events(rng, n)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    got = ts.events_to_pdf_frame(torch.as_tensor(xs), torch.as_tensor(ys), SENSOR, 5)
    _close(js.events_to_pdf_frame(jx, jy, SENSOR, 5), got, 1e-5)
    _close(js.events_to_pdf_frame_scatter(jx, jy, SENSOR, 5), got, 1e-5)
    _close(events_to_pdf_frame_pallas(jx, jy, SENSOR, 5, True), got, 1e-5)
    _close(js.events_to_pdf_frame_scatter(jx, jy, SENSOR, 5),
           ts.events_to_pdf_frame_scatter(torch.as_tensor(xs), torch.as_tensor(ys), SENSOR, 5),
           1e-5)


def test_forward_window5_f64_vs_xla_and_multi_ref():
    rng = np.random.default_rng(51)
    per_ref = [_events(rng, 1500) for _ in range(3)]
    wx = np.stack([p[0] for p in per_ref])
    wy = np.stack([p[1] for p in per_ref])
    with jax.enable_x64(True):
        ref = js.splat_multi_ref(jnp.asarray(wx), jnp.asarray(wy), SENSOR, 5)
        one = js.events_to_pdf_frame(jnp.asarray(wx[0]), jnp.asarray(wy[0]), SENSOR, 5)
    got = ts.splat_multi_ref(torch.as_tensor(wx), torch.as_tensor(wy), SENSOR, 5)
    assert got.dtype == torch.float64
    _close(ref, got, 1e-12)
    _close(one, ts.events_to_pdf_frame(torch.as_tensor(wx[0]), torch.as_tensor(wy[0]),
                                       SENSOR, 5), 1e-12)
    # a 5x5 window reaches two texels further than a 3x3 one
    three = ts.splat_multi_ref(torch.as_tensor(wx), torch.as_tensor(wy), SENSOR)
    assert float((got - three).abs().max()) > 1e-3


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_grad_window5_vs_jax_grad(dt):
    """Autograd of the plain version at window 5 against jax.grad of the
    XLA path: float64 within 1e-12 of max |grad| (the two agree to ~1e-15),
    float32 within 2e-6 (25 texels per event, summed in another order)."""
    rng = np.random.default_rng(52)
    per_ref = [_events(rng, 800, edges=False) for _ in range(2)]
    wx = np.stack([p[0] for p in per_ref]).astype(dt)
    wy = np.stack([p[1] for p in per_ref]).astype(dt)
    g = rng.normal(0, 1, (2, *SENSOR)).astype(dt)
    with jax.enable_x64(dt == np.float64):
        jgx, jgy = jax.grad(
            lambda a, b: jnp.vdot(js.splat_multi_ref(a, b, SENSOR, 5), g),
            argnums=(0, 1),
        )(jnp.asarray(wx), jnp.asarray(wy))
    tx = torch.as_tensor(wx).requires_grad_(True)
    ty = torch.as_tensor(wy).requires_grad_(True)
    gx, gy = torch.autograd.grad(
        ts.splat_multi_ref(tx, ty, SENSOR, 5), (tx, ty), torch.as_tensor(g)
    )
    tol = 1e-12 if dt == np.float64 else 2e-6
    _close(jgx, gx, tol)
    _close(jgy, gy, tol)


@pytest.mark.parametrize("n", [300, 9000])
def test_grad_window5_f32_vs_pallas_bwd_kernel(n):
    """The Pallas backward kernel (interpret mode) at window 5, edge cases
    included: dropped events get 0."""
    rng = np.random.default_rng(53 + n)
    xs, ys = _events(rng, n)
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    g = rng.normal(0, 1, SENSOR).astype(np.float32)
    dwx, dwy = _bwd_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g), SENSOR, 5, True
    )
    dwx = np.where(np.isfinite(dwx), dwx, 0.0)
    dwy = np.where(np.isfinite(dwy), dwy, 0.0)
    tx = torch.as_tensor(xs).requires_grad_(True)
    ty = torch.as_tensor(ys).requires_grad_(True)
    frame = ts.events_to_pdf_frame(tx, ty, SENSOR, 5)
    gx, gy = torch.autograd.grad(frame, (tx, ty), torch.as_tensor(g))
    _close(dwx, gx, 2e-6)
    _close(dwy, gy, 2e-6)


def test_kernel_window_sizes():
    """The kernels are built for windows 3 and 5; the plain version takes
    any window."""
    assert tk.WINDOW_SIZES == (3, 5)
    assert [tk.half_window(w) for w in (3, 5)] == [1, 2]
    for w in (1, 4, 7):
        with pytest.raises(ValueError, match="window_size"):
            tk.half_window(w)
    wx = torch.tensor([[10.2, 5.0]])
    frame = tk.splat_plain(wx, wx, SENSOR, 7)
    assert int((frame[0] > 0).sum()) == 2 * 49 - 4  # two 7x7 windows, 4 shared


# ---- the wrap-compat splat (eincm_tpu/ops/splat.py:set_splat_wrap_compat) ---


@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_wrap_compat_vs_jax(dt, window_size):
    """With the switch on, both packages wrap taps at negative rows and
    columns onto the far edge (and still drop those past it); the oracle
    keeps dropping. Gradients agree too. The switches are reset whatever
    happens. The edge cases are the finite ones: JAX's gradient of a NaN
    event is NaN."""
    rng = np.random.default_rng(54)
    finite = np.array([e for e in EDGE_XY if np.isfinite(e).all()]).T
    per_ref = [_events(rng, 600, spread=4.0, edges=False) for _ in range(2)]
    wx = np.stack([np.concatenate([p[0], finite[0]]) for p in per_ref]).astype(dt)
    wy = np.stack([np.concatenate([p[1], finite[1]]) for p in per_ref]).astype(dt)
    g = rng.normal(0, 1, (2, *SENSOR)).astype(dt)
    tol = 1e-12 if dt == np.float64 else 1e-5
    try:
        js.set_splat_wrap_compat(True)
        ts.set_splat_wrap_compat(True)
        with jax.enable_x64(dt == np.float64):
            fn = jax.jit(lambda a, b: js.splat_multi_ref(a, b, SENSOR, window_size))
            ref = fn(jnp.asarray(wx), jnp.asarray(wy))
            jgx, jgy = jax.grad(lambda a, b: jnp.vdot(fn(a, b), g), argnums=(0, 1))(
                jnp.asarray(wx), jnp.asarray(wy))
        tx = torch.as_tensor(wx).requires_grad_(True)
        ty = torch.as_tensor(wy).requires_grad_(True)
        got = ts.splat_multi_ref(tx, ty, SENSOR, window_size)
        gx, gy = torch.autograd.grad(got, (tx, ty), torch.as_tensor(g))
        oracle = ts.events_to_pdf_frame_scatter(tx[0], ty[0], SENSOR, window_size)
    finally:
        js.set_splat_wrap_compat(False)
        ts.set_splat_wrap_compat(False)
    _close(ref, got.detach(), tol)
    _close(jgx, gx, 1e-12 if dt == np.float64 else 1e-6)
    _close(jgy, gy, 1e-12 if dt == np.float64 else 1e-6)
    dropped = ts.splat_multi_ref(torch.as_tensor(wx), torch.as_tensor(wy), SENSOR, window_size)
    assert float((got.detach() - dropped).abs().max()) > 1e-3  # some mass wrapped
    _close(dropped[0], oracle.detach(), tol)
