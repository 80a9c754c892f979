"""eincm_tpu_torch's BFGS (strong Wolfe, Armijo) and golden section vs eincm_tpu.

Mirrors tests/test_bfgs.py and holds every trajectory against the JAX
package's in float64: the same iteration counts, evaluations, attempts and
status, and iterates within 1e-6 (Rosenbrock's valley amplifies last-bit
differences of the matrix products along a trajectory); the options
(interpolated Armijo, histories, heartbeat, warm starts) too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as sopt
import torch

from eincm_tpu.models import bfgs as jb
from eincm_tpu_torch.models import bfgs as tb
from eincm_tpu_torch.utils import host


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rosen(x):
    return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def _quantized(x, lib):
    q = 0.25
    return lib.round(((x - 1.0) ** 2).sum() / q) * q


PROBLEMS = {
    "quadratic": (
        lambda x, lib: 0.5 * x @ lib_mat(lib, [[3.0, 1.0], [1.0, 2.0]]) @ x
        - lib_mat(lib, [1.0, -2.0]) @ x,
        [5.0, 5.0],
    ),
    "rosenbrock": (lambda x, lib: _rosen(x), [-1.2, 1.0]),
    "nonconvex": (
        lambda x, lib: lib.sin(3 * x[0]) * lib.cos(2 * x[1]) + 0.1 * (x**2).sum(),
        [0.5, 0.5],
    ),
    "sphere4": (lambda x, lib: ((x - 2.0) ** 2).sum(), [0.0, 0.0, 0.0, 0.0]),
}


def lib_mat(lib, a):
    return lib.asarray(a, dtype=lib.float64) if lib is jnp else torch.tensor(a, dtype=torch.float64)


def _port(f, x0, line_search="armijo", **kw):
    fun = lambda x: f(x, torch)
    return tb.minimize_bfgs(
        tb.value_and_grad(fun), torch.tensor(x0, dtype=torch.float64),
        line_search=line_search, fun=fun, **kw,
    )


def _jax(f, x0, line_search="armijo", **kw):
    fun = lambda x: f(x, jnp)
    with jax.enable_x64(True):
        r = jb.minimize_bfgs(
            jax.value_and_grad(fun), jnp.asarray(x0, jnp.float64),
            line_search=line_search, fun=fun, **kw,
        )
        return jax.tree_util.tree_map(np.asarray, r)


def _same_trajectory(j, t, atol=1e-6):
    assert int(j.iter_num) == t.iter_num
    assert int(j.total_iters) == t.total_iters
    assert int(j.n_fun_evals) == t.n_fun_evals
    assert int(j.n_attempts) == t.n_attempts
    assert int(j.status) == t.status
    assert bool(j.success) == t.success
    np.testing.assert_allclose(t.x.numpy(), j.x, rtol=0, atol=atol)


KWS = pytest.mark.parametrize(
    "kw",
    [
        dict(maxiter=200, gtol=1e-5),
        dict(maxiter=3, gtol=1e-12),  # maxiter (status 1)
        dict(maxiter=200, gtol=1e-12, ftol=1e-3, ftol_patience=2),  # status 4
        dict(maxiter=2, gtol=1e-8, n_extra_attempts=2),  # retries
    ],
    ids=["gtol", "maxiter", "ftol", "retry"],
)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@KWS
def test_trajectory_matches_jax(name, kw):
    f, x0 = PROBLEMS[name]
    _same_trajectory(_jax(f, x0, **kw), _port(f, x0, **kw))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@KWS
def test_wolfe_trajectory_matches_jax(name, kw):
    """Strong Wolfe (the default line search of both packages): the
    trials counted as evaluations, as in JAX."""
    f, x0 = PROBLEMS[name]
    j, t = _jax(f, x0, "wolfe", **kw), _port(f, x0, "wolfe", **kw)
    _same_trajectory(j, t)
    assert t.total_iters > 0


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("max_ls_evals", [25, 3])
def test_armijo_interpolate_matches_jax(name, max_ls_evals):
    f, x0 = PROBLEMS[name]
    kw = dict(maxiter=60, gtol=1e-8, armijo_interpolate=True, max_ls_evals=max_ls_evals,
              n_extra_attempts=1)
    _same_trajectory(_jax(f, x0, **kw), _port(f, x0, **kw))


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
@pytest.mark.parametrize("name", ["rosenbrock", "nonconvex"])
def test_history_matches_jax(line_search, name):
    """record_history: every iteration's (x, f), capacity maxiter *
    (n_extra_attempts + 1), zero beyond n; with return_h_inv last."""
    f, x0 = PROBLEMS[name]
    kw = dict(maxiter=15, gtol=1e-10, n_extra_attempts=1, record_history=True,
              return_h_inv=True)
    jres, jhist, jh = _jax(f, x0, line_search, **kw)
    tres, thist, th = _port(f, x0, line_search, **kw)
    _same_trajectory(jres, tres)
    assert thist.n == int(jhist.n) == tres.total_iters
    assert thist.xs.shape == jhist.xs.shape == (30, len(x0))
    np.testing.assert_allclose(thist.xs.numpy(), jhist.xs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(thist.fs.numpy(), jhist.fs, rtol=0, atol=1e-6)
    assert float(thist.fs[thist.n - 1]) == float(tres.fun_val)
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_heartbeat_matches_jax(line_search):
    """The heartbeat's (iteration, loss) sequence is JAX's; it costs the
    port no host sync beyond the iteration's status transfer."""
    f, x0 = PROBLEMS["rosenbrock"]
    jbeats, tbeats = [], []
    _jax(f, x0, line_search, maxiter=20, gtol=1e-10,
         heartbeat_fn=lambda k, v: jbeats.append((int(k), float(v))))
    res = _port(f, x0, line_search, maxiter=20, gtol=1e-10,
                heartbeat_fn=lambda k, v: tbeats.append((k, v)))
    quiet = _port(f, x0, line_search, maxiter=20, gtol=1e-10)
    assert [k for k, _ in tbeats] == list(range(1, res.total_iters + 1))
    assert [k for k, _ in sorted(jbeats)] == [k for k, _ in tbeats]
    np.testing.assert_allclose([v for _, v in tbeats], [v for _, v in sorted(jbeats)],
                               rtol=0, atol=1e-6)
    assert tbeats[-1][1] == float(res.fun_val)
    assert res.n_host_syncs == quiet.n_host_syncs


def _spd(d=16, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(d, d))
    return m @ m.T + d * np.eye(d), rng.normal(size=d)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_warm_start_h0_exact_hessian_one_step(line_search):
    """With H0 = A^-1 and a unit first trial a quadratic solves in one
    iteration, identity needs several; the same counts and iterates as
    JAX (tests/test_bfgs.py:194-216)."""
    A, b = _spd()
    f = lambda x, lib: 0.5 * x @ lib_mat(lib, A) @ x - lib_mat(lib, b) @ x
    x0 = [0.0] * 16
    kw = dict(maxiter=100, gtol=1e-3)
    res_i = _port(f, x0, line_search, **kw)
    jw, jh = _jax(f, x0, line_search, h0=np.linalg.inv(A), return_h_inv=True,
                  unit_initial_step=True, **kw)
    res_w, h_fin = _port(f, x0, line_search, h0=torch.as_tensor(np.linalg.inv(A)),
                         return_h_inv=True, unit_initial_step=True, **kw)
    _same_trajectory(jw, res_w)
    assert res_w.success
    assert res_w.total_iters <= 2 < res_i.total_iters
    np.testing.assert_allclose(res_w.x.numpy(), np.linalg.solve(A, b), atol=1e-3)
    assert h_fin.shape == (16, 16)
    np.testing.assert_allclose(h_fin.numpy(), jh, rtol=0, atol=1e-9)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_warm_start_h0_nonfinite_falls_back(line_search):
    """A poisoned warm start (NaN entries) behaves like identity."""
    f = lambda x, lib: ((x - 2.0) ** 2).sum()
    bad = torch.full((3, 3), float("nan"), dtype=torch.float64)
    res = _port(f, [0.0] * 3, line_search, maxiter=50, h0=bad)
    ref = _port(f, [0.0] * 3, line_search, maxiter=50)
    assert res.success
    np.testing.assert_allclose(res.x.numpy(), 2.0, atol=1e-4)
    np.testing.assert_array_equal(res.x.numpy(), ref.x.numpy())
    assert (res.total_iters, res.n_fun_evals) == (ref.total_iters, ref.n_fun_evals)


def test_warm_start_return_combinations():
    """return_h_inv composes with record_history: (result, hist, h_inv);
    each alone gives a pair, neither the bare result."""
    f = lambda x, lib: ((x - 1.0) ** 2).sum()
    res, hist, h = _port(f, [0.0, 0.0], "wolfe", maxiter=10, record_history=True,
                         return_h_inv=True)
    assert hist.xs.shape[0] == 10 and h.shape == (2, 2) and res.success
    assert isinstance(_port(f, [0.0, 0.0], "wolfe", maxiter=10, record_history=True)[1],
                      tb.BFGSHistory)
    assert _port(f, [0.0, 0.0], "wolfe", maxiter=10, return_h_inv=True)[1].shape == (2, 2)
    assert isinstance(_port(f, [0.0, 0.0], "wolfe", maxiter=10), tb.BFGSResult)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_wolfe_host_syncs_counted(name, monkeypatch):
    """A Wolfe solve reads the host once for the initial check, once per
    trial and once per iteration (trials + iterations + 1), and every one
    of those reads goes through `utils/host.py:to_host`."""
    calls = []
    real = host.to_host
    monkeypatch.setattr(host, "to_host", lambda t: calls.append(1) or real(t))
    f, x0 = PROBLEMS[name]
    res = _port(f, x0, "wolfe", maxiter=30, gtol=1e-12, n_extra_attempts=1)
    trials = res.n_fun_evals - 1
    assert res.n_host_syncs == trials + res.total_iters + 1 == len(calls)


def test_quadratic_exact():
    f, x0 = PROBLEMS["quadratic"]
    res = _port(f, x0, maxiter=50, gtol=1e-4)
    assert res.success
    np.testing.assert_allclose(
        res.x.numpy(), np.linalg.solve([[3.0, 1.0], [1.0, 2.0]], [1.0, -2.0]), atol=1e-4
    )


def test_armijo_rosenbrock():
    res = _port(PROBLEMS["rosenbrock"][0], [-1.2, 1.0], maxiter=200, gtol=1e-4)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=5e-3)
    assert float(res.fun_val) < 1e-5
    sres = sopt.minimize(_rosen, np.array([-1.2, 1.0]), method="BFGS")
    assert float(res.fun_val) <= sres.fun + 1e-5


def test_maxiter_respected():
    res = _port(PROBLEMS["rosenbrock"][0], [-1.2, 1.0], maxiter=3, gtol=1e-12)
    assert res.iter_num <= 3 and not res.success and res.status == 1


def test_already_converged():
    res = _port(lambda x, lib: (x**2).sum(), [0.0, 0.0, 0.0], maxiter=10)
    assert res.success and res.iter_num == 0 and res.status == 0


def test_host_syncs_counted(monkeypatch):
    """One sync for the initial check, one per probe, one per iteration:
    the same count as the evaluations, every one through `to_host`."""
    calls = []
    real = host.to_host
    monkeypatch.setattr(host, "to_host", lambda t: calls.append(1) or real(t))
    res = _port(PROBLEMS["rosenbrock"][0], [-1.2, 1.0], maxiter=30, gtol=1e-12)
    assert res.n_host_syncs == res.n_fun_evals == len(calls) > res.total_iters


class TestFtolStop:
    def test_stops_early_with_status_4(self):
        f, x0 = PROBLEMS["rosenbrock"]
        base = _port(f, x0, maxiter=200, gtol=1e-12)
        res = _port(f, x0, maxiter=200, gtol=1e-12, ftol=1e-3, ftol_patience=2)
        assert res.status == 4
        assert res.total_iters < base.total_iters
        assert float(res.fun_val) < 1e-2

    def test_status4_is_terminal_no_retry(self):
        f, x0 = PROBLEMS["rosenbrock"]
        res = _port(f, x0, maxiter=200, gtol=1e-12, ftol=1e-3,
                    ftol_patience=2, n_extra_attempts=3)
        assert res.status == 4 and res.n_attempts == 1

    def test_none_preserves_reference_semantics(self):
        f = lambda x, lib: ((x - 1.0) ** 2).sum()
        a = _port(f, [0.0] * 4, maxiter=50, gtol=1e-6)
        b = _port(f, [0.0] * 4, maxiter=50, gtol=1e-6, ftol=None)
        np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
        assert a.status == b.status == 0

    @staticmethod
    def _floor(**kw):
        """The value quantizes to a coarse grid while the gradient stays
        analytic, so gtol never fires: an honest model of the f32 floor
        (float32, as in tests/test_bfgs.py)."""
        fun_j = lambda x: _quantized(x, jnp)
        fun_t = lambda x: _quantized(x, torch)
        kw = dict(maxiter=40, gtol=1e-10, max_ls_evals=6, n_extra_attempts=2, **kw)
        with jax.enable_x64(False):
            j = jb.minimize_bfgs(
                lambda x: (fun_j(x), 2.0 * (x - 1.0)),
                jnp.asarray([5.0, -4.0], jnp.float32),
                line_search="armijo", fun=fun_j, **kw,
            )
            j = jax.tree_util.tree_map(np.asarray, j)
        t = tb.minimize_bfgs(
            lambda x: (fun_t(x), 2.0 * (x - 1.0)),
            torch.tensor([5.0, -4.0], dtype=torch.float32), line_search="armijo",
            fun=fun_t, **kw,
        )
        _same_trajectory(j, t, atol=1e-5)
        return t

    def test_noise_floor_stops_without_retry(self):
        base = self._floor()
        res = self._floor(ftol=1e-9, ftol_patience=2)
        assert base.status == 2 and base.n_attempts == 3
        assert res.status == 4 and res.n_attempts <= 2
        assert res.n_fun_evals < base.n_fun_evals
        assert float(res.fun_val) == float(base.fun_val)

    def test_patience_1_clamped_to_2(self):
        p1 = self._floor(ftol=1e-9, ftol_patience=1)
        p2 = self._floor(ftol=1e-9, ftol_patience=2)
        assert p1.status == p2.status == 4
        assert p1.n_attempts == p2.n_attempts
        assert p1.n_fun_evals == p2.n_fun_evals
        np.testing.assert_array_equal(p1.x.numpy(), p2.x.numpy())


def test_line_search_arguments_checked():
    """'wolfe' is the default and needs no value-only objective; 'armijo'
    without one raises, as JAX asserts, and so does an unknown name."""
    fun = lambda x: ((x - 1.0) ** 2).sum()
    res = tb.minimize_bfgs(tb.value_and_grad(fun), torch.zeros(2, dtype=torch.float64), 20)
    assert res.success and res.n_fun_evals > 1
    with pytest.raises(ValueError):
        tb.minimize_bfgs(tb.value_and_grad(fun), torch.zeros(2), 5, line_search="armijo")
    with pytest.raises(ValueError):
        tb.minimize_bfgs(tb.value_and_grad(fun), torch.zeros(2), 5, line_search="lbfgs",
                         fun=fun)


def _two_basins(w, lib):
    return -0.5 * lib.exp(-(((w - 0.15) / 0.1) ** 2)) - 1.0 * lib.exp(
        -(((w - 0.85) / 0.02) ** 2)
    )


def _scalar_both(f, bounds, **kw):
    jx, jf = jb.minimize_bounded_scalar(lambda w: f(w, jnp), bounds, **kw)
    tx, tf = tb.minimize_bounded_scalar(lambda w: f(w, torch), bounds, device="cpu", **kw)
    np.testing.assert_allclose(float(tx), float(jx), atol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), atol=1e-6)
    return float(tx), float(tf)


class TestBoundedScalar:
    def test_parabola_interior(self):
        x, _ = _scalar_both(lambda w, lib: (w - 0.3) ** 2, (0.0, 1.0))
        assert np.isclose(x, 0.3, atol=1e-4)

    def test_minimum_at_bound(self):
        x, _ = _scalar_both(lambda w, lib: w, (0.2, 0.9))
        assert np.isclose(x, 0.2, atol=1e-4)

    @pytest.mark.parametrize("it", [0, 1, 3, 10])
    def test_endpoint_pair_consistency(self, it):
        f = lambda w, lib: -((2 * w - 1) ** 2) - 0.1 * w
        x, fx = _scalar_both(f, (0.0, 1.0), maxiter=it)
        assert np.isclose(fx, -((2 * x - 1) ** 2) - 0.1 * x, atol=1e-6)
        if it == 0:
            assert np.isclose(x, 1.0, atol=1e-6)

    def test_matches_scipy_bounded(self):
        f = lambda w, lib: lib.sin(5 * w) + 0.5 * w**2
        _, fx = _scalar_both(f, (0.0, 1.0), maxiter=40)
        sres = sopt.minimize_scalar(
            lambda w: np.sin(5 * w) + 0.5 * w**2, bounds=(0.0, 1.0), method="bounded"
        )
        assert fx <= sres.fun + 1e-5

    def test_multimodal_grid_seeding(self):
        x_plain, f_plain = _scalar_both(_two_basins, (0.0, 1.0), maxiter=40)
        assert np.isclose(x_plain, 0.15, atol=1e-2)  # the wrong basin
        x_grid, f_grid = _scalar_both(
            _two_basins, (0.0, 1.0), maxiter=40, n_grid_probes=33
        )
        assert np.isclose(x_grid, 0.85, atol=1e-3)
        assert f_grid < f_plain - 0.4
        sres = sopt.minimize(
            lambda w: float(_two_basins(w[0], np)), np.array([0.5]),
            method="L-BFGS-B", bounds=[(0.0, 1.0)],
        )
        assert f_grid < sres.fun - 0.4

    @pytest.mark.parametrize("n_grid_probes", [0, 5])
    def test_history_matches_jax(self, n_grid_probes):
        """record_history: the probes in order (grid or bounds, the two
        interior points, one per iteration) against JAX's
        (tests/test_bfgs.py:349-365)."""
        f = lambda w, lib: lib.cos(3 * w)
        kw = dict(maxiter=7, record_history=True, n_grid_probes=n_grid_probes)
        (jx, jf), jh = jb.minimize_bounded_scalar(lambda w: f(w, jnp), (0.0, 1.0), **kw)
        (tx, tf), th = tb.minimize_bounded_scalar(lambda w: f(w, torch), (0.0, 1.0),
                                                  device="cpu", **kw)
        n_init = max(2, n_grid_probes)
        assert th.n == int(jh.n) == n_init + 2 + 7 == th.xs.shape[0]
        np.testing.assert_allclose(th.xs.numpy(), np.asarray(jh.xs), atol=1e-6)
        np.testing.assert_allclose(th.fs.numpy(), np.asarray(jh.fs), atol=1e-6)
        np.testing.assert_allclose(th.xs[:n_init].numpy(), np.linspace(0, 1, n_init),
                                   atol=1e-6)
        np.testing.assert_allclose([float(tx), float(tf)], [float(jx), float(jf)], atol=1e-6)

    @pytest.mark.parametrize("it", [0, 2, 8, 30])
    def test_grid_seeding_unimodal(self, it):
        x, fx = _scalar_both(
            lambda w, lib: (w - 0.3) ** 2, (0.0, 1.0), maxiter=it, n_grid_probes=9
        )
        assert np.isclose(fx, (x - 0.3) ** 2, atol=1e-6)
        if it == 30:
            assert np.isclose(x, 0.3, atol=1e-4)
