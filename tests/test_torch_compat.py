"""The port's jaxopt-style wrappers (eincm_tpu_torch.models.compat) vs the
JAX package's (eincm_tpu.models.compat), on the CPU in float64.

Mirrors tests/test_bfgs.py's TestJaxoptCompat case for case (Rosenbrock
with aux, the callback trajectory, the bounded parabola, a NaN objective;
its heartbeat case, a `minimize_bfgs` option, is
tests/test_torch_bfgs.py:test_heartbeat_matches_jax) and adds a 2-D `init_params`, `options={"return_all":
True}`, `tol` without `gtol`, `has_aux` in the bounded solve, a method
other than BFGS, and both solves over each package's `solver_loss` on a
small staged window. Each case feeds the same numpy inputs to both
classes and holds the port to JAX: equal iteration counts, evaluations,
status, success and callback counts; params, losses and the callbacks'
trajectory within `atol` (1e-6 on Rosenbrock, whose valley amplifies
last-bit differences as in tests/test_torch_bfgs.py, and on the golden
section, whose probes are float32 in both packages; 1e-12 where the
trajectories agree to rounding). The `solver_loss` case is held to the
tolerance of a first window's level solve in tests/test_torch_pyramid.py
(1e-6 on theta, the same iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.models import compat as jc
from eincm_tpu_torch.models import bfgs as tb
from eincm_tpu_torch.models import compat as tc
from eincm_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _rosen_aux(x, lib):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, {"aux": x.sum()}


def _bowl(x, lib):
    return ((x - 3.0) ** 2).sum()


def _matrix(x, lib):
    # a 2 x 3 parameter with coupled rows: the shape must survive the solve
    return ((x - 1.5) ** 2).sum() + 0.3 * (x[0] * x[1]).sum() + (x[1, 2] - 0.5) ** 4


# name: (objective, x0, wrapper fields, atol, what test_bfgs.py checks)
MINIMIZE = {
    "rosenbrock_aux": (
        _rosen_aux, [-1.2, 1.0],
        dict(method="BFGS", maxiter=200, has_aux=True, options={"gtol": 1e-6}), 1e-6,
        lambda p, f, seen: np.allclose(p, [1.0, 1.0], atol=1e-3) and f < 1e-6,
    ),
    "callback_trajectory": (
        _bowl, np.zeros(4), dict(maxiter=30), 1e-12,
        lambda p, f, seen: np.allclose(p, 3.0, atol=1e-4) and (not seen or (
            len(seen) >= 2 and seen[0][0].shape == (4,) and seen[-1][1] <= seen[0][1])),
    ),
    "matrix_params": (
        _matrix, np.arange(6.0).reshape(2, 3) / 4, dict(maxiter=50), 1e-12,
        lambda p, f, seen: p.shape == (2, 3) and all(x.shape == (2, 3) for x, _ in seen),
    ),
    "return_all": (
        _bowl, np.array([0.5, -1.0, 2.0]), dict(maxiter=30, options={"return_all": True}),
        1e-12, lambda p, f, seen: np.allclose(p, 3.0, atol=1e-4),
    ),
    "tol_without_gtol": (
        _rosen_aux, [-1.2, 1.0], dict(method="bfgs", maxiter=200, has_aux=True, tol=1e-2),
        1e-6, lambda p, f, seen: f < 1e-2,
    ),
}


def _jax_minimize(name, callback):
    fun, x0, kw, _, _ = MINIMIZE[name]
    seen = []
    with jax.enable_x64(True):
        solver = jc.ScipyMinimize(
            fun=lambda x: fun(x, jnp),
            callback=(lambda r: seen.append((np.asarray(r.x), float(r.fun))))
            if callback else None,
            **kw,
        )
        res = solver.run(jnp.asarray(np.asarray(x0, np.float64)))
        state = jax.tree_util.tree_map(np.asarray, res.state)
        hist = None if solver.history is None else jax.tree_util.tree_map(
            np.asarray, solver.history)
    return np.asarray(res.params), state, seen, hist


def _port_minimize(name, callback, as_tensor):
    fun, x0, kw, _, _ = MINIMIZE[name]
    seen = []
    solver = tc.ScipyMinimize(
        fun=lambda x: fun(x, torch),
        callback=(lambda r: seen.append((_np(r.x), float(r.fun)))) if callback else None,
        **kw, **({} if as_tensor else {"device": "cpu"}),
    )
    x0 = np.asarray(x0, np.float64)
    res = solver.run(torch.as_tensor(x0) if as_tensor else x0)
    assert res.params.device.type == "cpu" and res.params.dtype == torch.float64
    return res, seen, solver.history


@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "numpy_on_cpu"])
@pytest.mark.parametrize("callback", [True, False], ids=["callback", "no_callback"])
@pytest.mark.parametrize("name", list(MINIMIZE))
def test_scipy_minimize_matches_jax(name, callback, as_tensor):
    _, _, kw, atol, expect = MINIMIZE[name]
    _build.reset_launch_counts()
    jp, js, jseen, jhist = _jax_minimize(name, callback)
    res, seen, hist = _port_minimize(name, callback, as_tensor)
    st = res.state
    assert (st.iter_num, st.total_iters, st.n_fun_evals, st.status, st.success) == (
        int(js.iter_num), int(js.total_iters), int(js.n_fun_evals), int(js.status),
        bool(js.success))
    assert res.params.shape == jp.shape and st.x.shape == jp.shape
    np.testing.assert_allclose(_np(res.params), jp, rtol=0, atol=atol)
    np.testing.assert_allclose(float(st.fun_val), float(js.fun_val), rtol=0, atol=atol)
    # the callbacks: one per recorded iterate, in order, in the params' shape
    assert len(seen) == len(jseen) == (st.total_iters if callback else 0)
    for (tx, tf), (jx, jf) in zip(seen, jseen):
        assert tx.shape == jx.shape == jp.shape
        np.testing.assert_allclose(tx, jx, rtol=0, atol=atol)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=atol)
    # the history lands on the solver when it was recorded
    recorded = callback or kw.get("options", {}).get("return_all", False)
    assert (hist is None) == (jhist is None) == (not recorded)
    if recorded:
        assert hist.n == int(jhist.n) == st.total_iters
        np.testing.assert_allclose(_np(hist.xs), jhist.xs, rtol=0, atol=atol)
        np.testing.assert_allclose(_np(hist.fs), jhist.fs, rtol=0, atol=atol)
    assert expect(_np(res.params), float(st.fun_val), seen)
    assert sum(_build.launch_counts().values()) == 0


def test_gtol_option_wins_over_tol():
    """`options["gtol"]` over `tol` over 1e-5, as in JAX: the same
    iterations as a direct `minimize_bfgs` with that gtol."""
    fun = lambda x: _rosen_aux(x, torch)[0]
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64)
    for fields, gtol in ((dict(tol=1e-2, options={"gtol": 1e-7}), 1e-7),
                         (dict(tol=1e-2), 1e-2), ({}, 1e-5)):
        res = tc.ScipyMinimize(fun=fun, maxiter=200, **fields).run(x0)
        ref = tb.minimize_bfgs(tb.value_and_grad(fun), x0, maxiter=200, gtol=gtol, fun=fun)
        assert res.state.total_iters == ref.total_iters
        assert torch.equal(res.params, ref.x)


@pytest.mark.parametrize("method", ["L-BFGS-B", "Nelder-Mead", "CG"])
def test_scipy_minimize_refuses_other_methods(method):
    """Both packages raise AssertionError with one message; the port raises
    it explicitly, so `python -O` keeps it."""
    with pytest.raises(AssertionError) as jerr:
        jc.ScipyMinimize(fun=lambda x: x, method=method)
    with pytest.raises(AssertionError) as terr:
        tc.ScipyMinimize(fun=lambda x: x, method=method)
    assert str(terr.value) == str(jerr.value)


def _parabola(w, lib):
    return (w - 0.7) ** 2


def _nan(w, lib):
    return w * lib.nan


def _parabola_aux(w, lib):
    return lib.cos(3 * w) + w, {"w": w}


# name: (objective, wrapper fields, bounds, expected success)
BOUNDED = {
    "parabola": (_parabola, dict(maxiter=40), (0.0, 1.0), True),
    "nan_objective": (_nan, dict(maxiter=10), (0.0, 1.0), False),
    "has_aux": (_parabola_aux, dict(maxiter=25, has_aux=True), (0.2, 0.9), True),
}


@pytest.mark.parametrize("callback", [True, False], ids=["callback", "no_callback"])
@pytest.mark.parametrize("name", list(BOUNDED))
def test_scipy_bounded_minimize_matches_jax(name, callback):
    """The golden section's result, honest state (success, iter_num =
    maxiter) and per-probe callbacks against JAX's within 1e-6 (float32
    probes); `init_params` is ignored by both."""
    fun, kw, bounds, success = BOUNDED[name]
    jseen, tseen = [], []
    with jax.enable_x64(True):
        jres = jc.ScipyBoundedMinimize(
            fun=lambda w: fun(w, jnp),
            callback=(lambda r: jseen.append((float(r.x), float(r.fun)))) if callback else None,
            **kw,
        ).run(0.5, bounds)
    tres = tc.ScipyBoundedMinimize(
        fun=lambda w: fun(w, torch), device="cpu",
        callback=(lambda r: tseen.append((float(r.x), float(r.fun)))) if callback else None,
        **kw,
    ).run(0.5, bounds)
    assert bool(tres.state.success) == bool(jres.state.success) == success
    assert tres.state.iter_num == int(jres.state.iter_num) == kw["maxiter"]
    assert tres.params.device.type == "cpu"
    np.testing.assert_allclose(float(tres.params), float(jres.params), atol=1e-6)
    np.testing.assert_allclose(float(tres.state.fun_val), float(jres.state.fun_val), atol=1e-6)
    assert len(tseen) == len(jseen) == ((2 + 2 + kw["maxiter"]) if callback else 0)
    np.testing.assert_allclose(np.array(tseen).reshape(-1, 2), np.array(jseen).reshape(-1, 2),
                               atol=1e-6)
    if name == "parabola":
        assert np.isclose(float(tres.params), 0.7, atol=1e-4)


def test_solve_device():
    """A tensor's device, else the `device` field, whose default is the
    card: the CPU only when the caller asks for it."""
    assert tc.ScipyMinimize(fun=abs).device == "cuda"
    assert tc.ScipyBoundedMinimize(fun=abs).device == "cuda"
    assert tc._solve_device(torch.zeros(2), "cuda") == torch.device("cpu")
    assert tc._solve_device(np.zeros(2), "cuda") == torch.device("cuda")
    assert tc._solve_device(None, "cpu") == torch.device("cpu")
    assert tc._solve_device([0.0], "meta") == torch.device("meta")


# ---- both solves over solver_loss on a small staged window ------------------

SENSOR = (32, 40)


def _staged_window():
    """A synthetic window of 400 events and 2 reference frames with IEDT
    edges, staged by the port in float64, as numpy arrays."""
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
    from eincm_tpu_torch.edge.pipeline import iedt_edge_fn

    dl = SyntheticDataLoader(sensor_size=SENSOR, n_windows=1, des_n_events=400,
                             velocity=(2.5, -1.5), n_features=12, seed=7)
    dl.get_ready()
    w = stage_datasample(dl[0], "cpu", edge_fn=iedt_edge_fn(), pad_to=400,
                         dtype=torch.float64).window
    return [t.numpy() for t in w]


@pytest.mark.parametrize("callback", [True, False], ids=["callback", "no_callback"])
def test_solver_loss_window_matches_jax(callback):
    """The reference's calling pattern over the real loss: a 4x4 theta solve
    through ScipyMinimize (has_aux, the MVSEC gtol), then the handover
    weight between a prior and that theta through ScipyBoundedMinimize,
    both packages from the same prior; the port's arguments pass through
    `run(x0, *args)` as jaxopt's do."""
    from eincm_tpu.models import loss as jl
    from eincm_tpu_torch.models import loss as tl

    arrays = _staged_window()
    prior = np.random.default_rng(3).normal(0.0, 0.5, (4, 4, 2))
    kw = dict(method="BFGS", maxiter=25, options={"gtol": 1e-4}, has_aux=True)

    def solve(loss, wrappers, as_array, dev):
        seen = []
        win = [as_array(a) for a in arrays]
        params = loss.LossParams(alpha=20.0, beta=35.0)
        statics = loss.LossStatics(SENSOR, 3)
        wstat = loss.compute_window_statics(win[0], win[1], win[3], SENSOR)

        def fun(theta, xs, ys, ts, edges, edge_ts):
            value = loss.solver_loss(theta, xs, ys, ts, edges, edge_ts, params, 0,
                                     statics, wstat)
            return value, {"level": 0}

        x0 = as_array(prior)
        res = wrappers.ScipyMinimize(
            fun=fun, callback=(lambda r: seen.append((_np(r.x), float(r.fun))))
            if callback else None, **kw, **dev).run(x0, *win)
        theta = res.params

        def handover(w):
            blend = w * x0 + (1.0 - w) * theta
            return loss.solver_loss(blend, *win, params, 0, statics, wstat)

        bres = wrappers.ScipyBoundedMinimize(fun=handover, maxiter=12, **dev).run(
            None, (0.0, 1.0))
        return (_np(theta), res.state, seen, float(bres.params), float(bres.state.fun_val),
                bool(bres.state.success))

    with jax.enable_x64(True):
        out = {"jax": solve(jl, jc, jnp.asarray, {})}
    out["port"] = solve(tl, tc, torch.as_tensor, {"device": "cpu"})
    jt, js, jseen, jw, jf, jok = out["jax"]
    tt, ts_, tseen, tw, tf, tok = out["port"]
    assert (ts_.iter_num, ts_.total_iters, ts_.n_fun_evals, ts_.status) == (
        int(js.iter_num), int(js.total_iters), int(js.n_fun_evals), int(js.status))
    assert ts_.total_iters > 3
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ts_.fun_val), float(js.fun_val), rtol=1e-9)
    assert len(tseen) == len(jseen) == (ts_.total_iters if callback else 0)
    for (tx, tfv), (jx, jfv) in zip(tseen, jseen):
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tfv, jfv, rtol=1e-9)
    assert tok and jok
    np.testing.assert_allclose(tw, jw, atol=1e-6)
    np.testing.assert_allclose(tf, jf, rtol=1e-9)
