"""The fused warp+splat (kernels 7 and 8): eincm_tpu_torch's plain version
vs eincm_tpu/experimental/splat_fused.py's Pallas kernels in interpret
mode, on the 320x384 sensor of tests/test_splat_pallas.py, at windows 3
and 5 (the card's kernels) and 1, 4, 7 and 9 (which the card routes to
the warp and the direct splat), kernel 8 at window 7 also with every
coordinate fractional (its route samples at them as given).

Tolerances, relative to max |JAX frame|:
- kernel 7: 1e-5. Both warp with the same f32 operations; the JAX kernel
  sums the taps through a matrix product, in another order.
- kernel 8: 1e-4. Its in-kernel interp sums in another order too (a
  one-ulp velocity difference moves a tap by ~1e-7 relative); the inputs
  keep every warped coordinate >= 1e-3 from a .5 tie, so no such
  difference can flip a round().

The JAX kernels band the rows of sorted events and say with `ok` whether
the bands held every event; the port has no bands, so its `ok` is always
True and its frame is whole in any event order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.experimental import splat_fused as jf
from eincm_tpu.ops import warp as jw
from eincm_tpu.ops.splat import events_to_pdf_frame
from eincm_tpu_torch.experimental import splat_fused as tf
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops.interp import interp_theta_at_events_plain

SENSOR = (320, 384)
N_EVENTS = 16_384  # 4 chunks of 4096: each chunk's rows fit one 128-row band
T_REFS = (0.0, 1.0)
_STATIC = ("sensor_size", "window_size", "b", "interpret")
# jitted, so the second reference time reuses the first one's compile
_k7 = jax.jit(jf.fused_warp_splat_frame, static_argnames=_STATIC)
_k8 = jax.jit(jf.fully_fused_warp_splat_frame, static_argnames=_STATIC)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test workers share the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(rng, n=N_EVENTS, spread=2.0, fractional=0.05):
    """Row-sorted events around and just beyond the sensor: rounded
    coordinates, a `fractional` share of them left unrounded (the kernels
    use xi, yi as given), and a few NaN or far-off-sensor columns."""
    H, W = SENSOR
    ys = np.sort(rng.uniform(-spread, H - 1 + spread, n))
    xs = rng.uniform(-spread, W - 1 + spread, n)
    keep = rng.uniform(size=n) < fractional
    xi = np.where(keep, xs, np.round(xs))
    yi = np.where(keep, ys, np.round(ys))
    odd = rng.choice(n, 12, replace=False)
    xi[odd[:3]] = np.nan
    xi[odd[3:6]] = -1e4
    xi[odd[6:9]] = 1e10
    xi[odd[9:11]] = np.inf
    yi[odd[11]] = np.nan
    ts = rng.uniform(0, 1, n)
    return [a.astype(np.float32) for a in (xi, yi, ts)]


def _off_ties(xi, yi, ts, thx, thy):
    """Mask of events whose warped coordinates stay >= 1e-3 from a .5 tie
    at every reference time, non-finite ones included."""
    ok = np.ones(xi.shape, bool)
    for t in T_REFS:
        dt = ts - np.float32(t)
        for c in (xi - thx * dt, yi - thy * dt):
            with np.errstate(invalid="ignore"):
                d = np.abs(c - np.floor(c) - 0.5)
            ok &= ~np.isfinite(c) | (d >= 1e-3)
    return ok


def _port_velocities(theta, xi, yi):
    th = interp_theta_at_events_plain(
        torch.as_tensor(theta), torch.as_tensor(xi), torch.as_tensor(yi),
        SENSOR, round_coords=False,
    ).numpy()
    return th[:, 0], th[:, 1]


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(ref - got).max()
    assert err <= tol * scale, err / scale


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("window_size", [3, 5, 1, 4, 7, 9])
def test_fused_warp_splat_vs_pallas(window_size):
    rng = np.random.default_rng(window_size)
    xi, yi, ts = _events(rng)
    thx = rng.normal(0, 3, xi.shape).astype(np.float32)
    thy = rng.normal(0, 3, xi.shape).astype(np.float32)
    m = _off_ties(xi, yi, ts, thx, thy)
    xi, yi, ts, thx, thy = (a[m] for a in (xi, yi, ts, thx, thy))
    for t_ref in T_REFS:
        ref, ok = _k7(
            *map(jnp.asarray, (xi, yi, ts, thx, thy)), jnp.float32(t_ref),
            sensor_size=SENSOR, window_size=window_size, interpret=True,
        )
        assert bool(ok)
        got, ok_t = tf.fused_warp_splat_frame(
            *_t(xi, yi, ts, thx, thy), t_ref, SENSOR, window_size
        )
        assert bool(ok_t) and ok_t.shape == ()
        _close(ref, got, 1e-5)


@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize("gh,gw", [(1, 1), (2, 2), (16, 16)])
def test_fully_fused_warp_splat_vs_pallas(gh, gw, window_size):
    rng = np.random.default_rng(gh * 10 + window_size)
    xi, yi, ts = _events(rng)
    theta = rng.normal(0, 1, (gh, gw, 2)).astype(np.float32)
    m = _off_ties(xi, yi, ts, *_port_velocities(theta, xi, yi))
    xi, yi, ts = xi[m], yi[m], ts[m]
    for t_ref in T_REFS:
        ref, ok = _k8(
            *map(jnp.asarray, (xi, yi, ts, theta)), jnp.float32(t_ref),
            sensor_size=SENSOR, window_size=window_size, interpret=True,
        )
        assert bool(ok)
        got, ok_t = tf.fully_fused_warp_splat_frame(
            *_t(xi, yi, ts, theta), t_ref, SENSOR, window_size
        )
        assert bool(ok_t)
        _close(ref, got, 1e-4)


@pytest.mark.parametrize("window_size", [1, 4, 7, 9])
def test_fully_fused_other_windows_vs_pallas(window_size):
    """Kernel 8's plain version at windows the cluster kernels are not
    built for (the card routes them, `fully_fused_warp_splat_routed`),
    against the JAX kernel, which takes any window: 2 (w // 2) + 1 taps a
    side, an even window as the next odd one."""
    rng = np.random.default_rng(50 + window_size)
    xi, yi, ts = _events(rng)
    theta = rng.normal(0, 1, (2, 2, 2)).astype(np.float32)
    m = _off_ties(xi, yi, ts, *_port_velocities(theta, xi, yi))
    xi, yi, ts = xi[m], yi[m], ts[m]
    t_ref = T_REFS[1]
    ref, ok = _k8(
        *map(jnp.asarray, (xi, yi, ts, theta)), jnp.float32(t_ref),
        sensor_size=SENSOR, window_size=window_size, interpret=True,
    )
    assert bool(ok)
    got, ok_t = tf.fully_fused_warp_splat_frame(
        *_t(xi, yi, ts, theta), t_ref, SENSOR, window_size
    )
    assert bool(ok_t)
    _close(ref, got, 1e-4)


@pytest.mark.parametrize("gh,gw", [(2, 2), (16, 16)])
def test_fully_fused_window7_fractional_vs_pallas(gh, gw):
    """Kernel 8's plain version at window 7 (the card's route: the float32
    direct interp forward at the coordinates as given, the warp, the direct
    splat) with every xi and yi fractional, against the JAX kernel, which
    samples theta and warps at them as given."""
    rng = np.random.default_rng(70 + gh)
    xi, yi, ts = _events(rng, fractional=1.0)
    near = (np.abs(xi) < 1e3) & (np.abs(yi) < 1e3)  # all but the far and NaN columns
    assert (xi[near] != np.round(xi[near])).all() and (yi[near] != np.round(yi[near])).all()
    theta = rng.normal(0, 1, (gh, gw, 2)).astype(np.float32)
    m = _off_ties(xi, yi, ts, *_port_velocities(theta, xi, yi))
    xi, yi, ts = xi[m], yi[m], ts[m]
    for t_ref in T_REFS:
        ref, ok = _k8(
            *map(jnp.asarray, (xi, yi, ts, theta)), jnp.float32(t_ref),
            sensor_size=SENSOR, window_size=7, interpret=True,
        )
        assert bool(ok)
        got = tf.fully_fused_warp_splat_frame_plain(*_t(xi, yi, ts, theta), t_ref, SENSOR, 7)
        _close(ref, got, 1e-4)


def test_fully_fused_boundary_row_carries_mass():
    """The case of test_splat_pallas.py's band-bound regression: a
    constant +4.4 px/s vertical flow puts every event at cy = 262.6, so
    the splat window is rows 262..264 around round(cy) = 263."""
    rng = np.random.default_rng(42)
    H, W = SENSOR
    n = 512
    xi = np.round(rng.uniform(5, W - 6, n)).astype(np.float32)
    yi = np.full(n, 267.0, np.float32)
    ts = np.ones(n, np.float32)
    theta = np.zeros((16, 16, 2), np.float32)
    theta[..., 1] = 4.4
    ref, ok = jf.fully_fused_warp_splat_frame(
        *map(jnp.asarray, (xi, yi, ts, theta)), 0.0, SENSOR, interpret=True
    )
    assert bool(ok)
    got, _ = tf.fully_fused_warp_splat_frame(*_t(xi, yi, ts, theta), 0.0, SENSOR)
    assert float(got[264].sum()) > 1.0
    _close(ref, got, 1e-4)
    oracle = events_to_pdf_frame(
        jnp.asarray(xi), jnp.full((n,), 262.6, jnp.float32), SENSOR
    )
    _close(oracle, got, 1e-4)


@pytest.mark.parametrize("kernel", [7, 8])
def test_unsorted_events_match_the_two_kernel_path(kernel):
    """Shuffled events break the JAX kernels' row bands (ok False, mass
    lost); the port's frame still equals JAX's two-kernel path, the XLA
    coarse warp then the XLA splat. That path rounds the coordinates, so
    they are all whole here."""
    rng = np.random.default_rng(100 + kernel)
    xi, yi, ts = _events(rng, fractional=0.0)
    theta = rng.normal(0, 1, (16, 16, 2)).astype(np.float32)
    thx, thy = _port_velocities(theta, xi, yi)
    m = _off_ties(xi, yi, ts, thx, thy) & np.isfinite(xi) & np.isfinite(yi)
    perm = rng.permutation(int(m.sum()))
    xi, yi, ts, thx, thy = (a[m][perm] for a in (xi, yi, ts, thx, thy))
    jxi, jyi, jts, jtheta = map(jnp.asarray, (xi, yi, ts, theta))
    prev = jw.get_interp_impl()
    jw.set_interp_impl("xla")
    try:
        wx, wy = jw.warp_events_multi_ref_coarse(
            jtheta, jxi, jyi, jts, jnp.asarray(T_REFS, jnp.float32), SENSOR
        )
    finally:
        jw.set_interp_impl(prev)
    t_ref = T_REFS[1]
    if kernel == 7:
        _, ok = _k7(jxi, jyi, jts, jnp.asarray(thx), jnp.asarray(thy),
                    jnp.float32(t_ref), sensor_size=SENSOR, interpret=True)
        got, ok_t = tf.fused_warp_splat_frame(*_t(xi, yi, ts, thx, thy), t_ref, SENSOR)
    else:
        _, ok = _k8(jxi, jyi, jts, jtheta, jnp.float32(t_ref),
                    sensor_size=SENSOR, interpret=True)
        got, ok_t = tf.fully_fused_warp_splat_frame(*_t(xi, yi, ts, theta), t_ref, SENSOR)
    assert not bool(ok) and bool(ok_t)
    _close(events_to_pdf_frame(wx[1], wy[1], SENSOR), got, 1e-4)


def test_window_sizes_and_launch_counts():
    """Both plain versions take any window of 1 or more (those the kernels
    refused until the card routed them: 1, 4, 7), each the plain splat of
    the warped events; window 0 raises; the CPU launches nothing."""
    from eincm_tpu_torch.ops.splat_kernel import splat_plain

    _build.reset_launch_counts()
    xi = torch.tensor([10.0, 20.0])
    ts = torch.tensor([0.2, 0.7])
    th = torch.ones(2)
    for ws in (3, 5, 1, 4, 7):
        frame, ok = tf.fused_warp_splat_frame(xi, xi, ts, th, th, 0.5, SENSOR, ws)
        assert frame.shape == SENSOR and bool(ok)
        c = xi - th * (ts - 0.5)
        assert torch.equal(frame, splat_plain(c[None], c[None], SENSOR, ws)[0])
        frame8, _ = tf.fully_fused_warp_splat_frame(xi, xi, ts, torch.zeros(4, 4, 2), 0.5,
                                                    SENSOR, ws)
        assert torch.equal(frame8, splat_plain(xi[None], xi[None], SENSOR, ws)[0])
    for fn, args in ((tf.fused_warp_splat_frame, (xi, xi, ts, th, th)),
                     (tf.fully_fused_warp_splat_frame, (xi, xi, ts, torch.zeros(4, 4, 2)))):
        with pytest.raises(ValueError, match="window_size 0 < 1"):
            fn(*args, 0.5, SENSOR, 0)
    assert set(_build.launch_counts().values()) == {0}
