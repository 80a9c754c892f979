"""The dense-layout interp (kernel 9): eincm_tpu_torch's plain version vs
the XLA interp of eincm_tpu (the prototype's own reference) and vs the
prototype's Pallas kernel, scripts/interp_kernel_proto.py:interp_pallas,
in interpret mode.

Tolerances, relative to max |reference|:
- vs the XLA interp: `highest` 1e-6 (two nonzero taps per axis, summed in
  another order); `dot3` 1e-5 (it drops the lo.lo product, up to 2^-18 of
  each term);
- vs interp_pallas, the same function in every mode: 1e-6.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eincm_tpu.ops import warp as jw
from eincm_tpu_torch.experimental import interp_proto as tp
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import interp as ti

REPO = Path(__file__).resolve().parent.parent
SENSOR = (48, 64)
EDGE_XY = [
    (-1e4, -1e4),  # the padding sentinel
    (np.nan, 5.0), (5.0, np.nan),  # NaN events
    (2.5, 3.5), (0.5, 1.5), (-0.5, -0.5),  # exact .5 ties: half to even
    (0.0, 0.0), (63.0, 47.0), (63.5, 47.5), (64.0, 48.0),  # at the edge
    (-1.0, 5.0), (-2.0, 5.0), (70.0, 60.0),  # beyond it
    (1e10, 3.0), (-1e10, 3.0), (3.0, 1e10),
    (np.inf, 4.0), (4.0, -np.inf),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test workers share the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def xla_interp():
    """The JAX package's XLA interp; the impl switch is global to the
    worker, so the previous setting comes back afterwards."""
    prev = jw.get_interp_impl()
    jw.set_interp_impl("xla")
    try:
        yield jw.interp_theta_at_events
    finally:
        jw.set_interp_impl(prev)


@pytest.fixture(scope="module")
def proto():
    """scripts/interp_kernel_proto.py, loaded as a module without editing
    it. Its import sets the interp impl to "xla", prepends the repo to
    sys.path and may set JAX_COMPILATION_CACHE_DIR: all three are undone."""
    prev_impl = jw.get_interp_impl()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        spec = importlib.util.spec_from_file_location(
            "interp_kernel_proto", REPO / "scripts" / "interp_kernel_proto.py"
        )
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            jw.set_interp_impl(prev_impl)
        yield mod


def _coords(rng, n, spread=4.0):
    H, W = SENSOR
    xs = rng.uniform(-spread, W - 1 + spread, n)
    ys = rng.uniform(-spread, H - 1 + spread, n)
    ex, ey = np.array(EDGE_XY, np.float64).T
    return (np.concatenate([xs, ex]).astype(np.float32),
            np.concatenate([ys, ey]).astype(np.float32))


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    fin = ~np.isnan(ref)
    scale = max(np.abs(ref[fin]).max(), 1e-30)
    err = np.abs(ref[fin] - got[fin]).max()
    assert err <= tol * scale, err / scale


def _port(theta, xs, ys, mode):
    t = torch.as_tensor
    return tp.interp_dense(t(theta), t(xs), t(ys), SENSOR, mode).numpy()


@pytest.mark.parametrize("mode,tol", [("highest", 1e-6), ("dot3", 1e-5)])
@pytest.mark.parametrize("gh,gw", [(1, 1), (3, 5), (16, 16)])
def test_vs_xla_interp(xla_interp, mode, tol, gh, gw):
    rng = np.random.default_rng(gh * 17 + gw)
    xs, ys = _coords(rng, 3000)
    theta = rng.normal(0, 4, (gh, gw, 2)).astype(np.float32)
    ref = xla_interp(jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR)
    _close(ref, _port(theta, xs, ys, mode), tol)


@pytest.mark.parametrize("mode", tp.MODES)
def test_vs_the_prototype_kernel_in_interpret_mode(proto, monkeypatch, mode):
    pallas_call = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: pallas_call(*a, **{**k, "interpret": True})
    )
    rng = np.random.default_rng(11)
    xs, ys = _coords(rng, 1500)
    theta = rng.normal(0, 4, (5, 12, 2)).astype(np.float32)  # pads to 8 x 16
    ref = proto.interp_pallas(
        jnp.asarray(theta), jnp.asarray(xs), jnp.asarray(ys), SENSOR,
        mode=mode, chunk=1024,
    )
    _close(ref, _port(theta, xs, ys, mode), 1e-6)


def test_highest_equals_the_production_interp_in_sensor():
    """With exact zero terms the dense sums reduce to kernel 1's two-tap
    sums; the plain versions differ at most by the matrix product's
    rounding."""
    rng = np.random.default_rng(12)
    H, W = SENSOR
    xs = torch.as_tensor(rng.uniform(0, W - 1, 4000).astype(np.float32))
    ys = torch.as_tensor(rng.uniform(0, H - 1, 4000).astype(np.float32))
    theta = torch.as_tensor(rng.normal(0, 4, (16, 16, 2)).astype(np.float32))
    ref = ti.interp_theta_at_events_plain(theta, xs, ys, SENSOR).numpy()
    _close(ref, _port(theta, xs, ys, "highest"), 1e-6)


def test_modes_and_launch_counts():
    _build.reset_launch_counts()
    theta = torch.zeros(4, 4, 2)
    xs = torch.arange(10, dtype=torch.float32)
    for mode in tp.MODES:
        assert tp.interp_dense(theta, xs, xs, SENSOR, mode).shape == (10, 2)
    with pytest.raises(ValueError, match="mode"):
        tp.interp_dense(theta, xs, xs, SENSOR, "fast")
    assert set(_build.launch_counts().values()) == {0}


def test_bench_inputs_are_the_prototypes():
    theta, xs, ys = tp.make_inputs("cpu")
    rng = np.random.default_rng(0)
    H, W = tp.SENSOR
    np.testing.assert_array_equal(
        xs.numpy(), rng.uniform(0, W - 1, tp.N_EVENTS).astype(np.float32)
    )
    assert ys.shape == (tp.N_EVENTS,) and theta.shape == (16, 16, 2)


def _tf32(a):
    """Round float32 values to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as `cvt.rna.tf32.f32`: on the 32-bit view, add half
    of the 13 dropped bits and clear them (the sign bit is left alone)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("gh,gw", [(1, 1), (5, 12), (16, 16), (128, 128)])
def test_3xtf32_split_keeps_highest_within_1e_6(gh, gw):
    """Kernel 9's `highest` on the card: m = lo.hi + hi.lo + hi.hi with
    hi = tf32(x), lo = tf32(x - hi), exact TF32 products summed in f32, then
    the f32 contraction with vx. Emulated here, it stays within 1e-6 x
    max |out| of the f64 result, the tolerance the card's kernel is held to
    against kernel 1; a single TF32 product does not."""
    H, W = SENSOR
    rng = np.random.default_rng(100 + gh + gw)
    n = 20_000
    xs = rng.uniform(-2, W + 1, n).astype(np.float32)
    ys = rng.uniform(-2, H + 1, n).astype(np.float32)
    theta = rng.normal(0, 4, (gh, gw, 2)).astype(np.float32)
    hp, wp = tp._pad8(gh), tp._pad8(gw)

    uy = ti._axis_weights(torch.as_tensor(ys), gh, hp, gh / H, True).numpy()
    vx = ti._axis_weights(torch.as_tensor(xs), gw, wp, gw / W, True).numpy()
    thT = np.zeros((2 * wp, hp), np.float32)
    thT[:gw, :gh] = theta[..., 0].T
    thT[wp:wp + gw, :gh] = theta[..., 1].T

    def contract(m, vx):
        return np.stack([(m[:, :wp] * vx).sum(1), (m[:, wp:] * vx).sum(1)], -1)

    # the f32 weights and theta, multiplied out in f64
    f = lambda a: a.astype(np.float64)
    ref = contract(f(uy) @ f(thT).T, f(vx))
    ah, bh = _tf32(uy), _tf32(thT)
    al, bl = _tf32(uy - ah), _tf32(thT - bh)
    m3 = (f(al) @ f(bh).T + f(ah) @ f(bl).T + f(ah) @ f(bh).T).astype(np.float32)
    scale = np.abs(ref).max()
    err3 = np.abs(contract(m3, vx).astype(np.float64) - ref).max()
    assert err3 <= 1e-6 * scale, err3 / scale
    m1 = (f(ah) @ f(bh).T).astype(np.float32)
    err1 = np.abs(contract(m1, vx).astype(np.float64) - ref).max()
    assert err1 > 1e-6 * scale, err1 / scale
