"""The port's studies (eincm_tpu_torch/scripts/) against the JAX package's
scripts (scripts/), on the CPU.

Each study runs at a tiny size (the benches' size constants
monkeypatched, a 32x32 experiment, a few iterations) and prints the JSON
keys its JAX script prints: the JAX script's `main` is run with its solves
replaced by stand-ins to read its keys. The three scripts that print
tables keep the JAX table's columns. `armijo_rescue_validation.make_cfg`
equals the JAX one field by field apart from `solver.splat_impl`. The
probes' level-0 solves of one window match the JAX package's in float64
(the same iteration and evaluation counts, the final loss within 1e-10
relative), and `mvsec_loss_breakdown`'s stage values the JAX script's
stages to 1e-12.
"""

import importlib
import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from eincm_tpu_torch.utils import benchmarks as tb

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL_LOSS = 1e-10  # relative, float64 solves
TOL_STAGE = 1e-12  # relative, float64 stage values
TINY = {  # tests/test_benchmarks.py's overrides
    "theta_opt_maxiters": (1, 1, 1, 1, 1),
    "handover_opt_maxiters": (2, 2, 2, 2, 2),
    "n_extra_attempts": {},
}
TINY_EXP = {"dataset.sensor_size": (32, 32), "dataset.des_n_events": 1024,
            "solver.n_pyr_lvls": 3, "solver.theta_maxiter": 3, "solver.theta_miniter": 2,
            "solver.handover_maxiter": 3}
SMALL = dict(MVSEC_H=32, MVSEC_W=48, MVSEC_N_EVENTS=1500, DSEC_H=32, DSEC_W=48,
             DSEC_N_EVENTS=2000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(tb, k, v)


def jax_script(name, monkeypatch):
    """The JAX package's scripts/<name>.py as a module (it sets a default
    compilation cache directory on import: kept off here)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.syspath_prepend(str(REPO))
    return importlib.import_module(f"scripts.{name}")


def keys_of_jax_main(mod, monkeypatch, argv=()):
    """The keys of the JSON line `mod.main()` prints."""
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def fake_benches(monkeypatch):
    """The JAX benches without their solves: one_round gives 0.1 s."""
    import eincm_tpu.utils.benchmarks as jb

    for name in ("build_mvsec_solve_bench", "build_dsec_solve_bench"):
        monkeypatch.setattr(jb, name, lambda *a, **kw: ((lambda: 0.1), None))
    monkeypatch.setattr(jb, "solve_diag_str", lambda res: "")


def table_columns(name):
    """The column names of the table the JAX script prints."""
    src = (REPO / "scripts" / f"{name}.py").read_text()
    header = next(line for line in src.splitlines() if "{'win':>3}" in line)
    header += next(line for line in src.splitlines()[src.splitlines().index(header) + 1:])
    return re.findall(r"\{'(\w+)':>\d+\}", header)


# ---- the configs ------------------------------------------------------------------

def test_rescue_validation_make_cfg_matches_jax(monkeypatch, tmp_path):
    from eincm_tpu_torch.scripts import armijo_rescue_validation as arv

    jmod = jax_script("armijo_rescue_validation", monkeypatch)
    for args in (("wolfe", "wolfe", False), ("armijo_interp", "armijo", True, True)):
        j = jmod.make_cfg(*args[:3], str(tmp_path), *args[3:]).to_dict()
        t = arv.make_cfg(*args[:3], str(tmp_path), *args[3:]).to_dict()
        assert j["solver"].pop("splat_impl") == "pallas_banded"
        t["solver"].pop("splat_impl")
        assert t == j
    small = arv.make_cfg("x", "armijo", True, str(tmp_path), n_windows=3,
                         overrides={"dataset.sensor_size": (32, 32)})
    assert small.dataset.n_windows == 4 and small.phases.run_idx_range == (0, 3)
    assert small.dataset.sensor_size == (32, 32)
    with pytest.raises(AttributeError, match="solver.nope"):
        arv.make_cfg("x", "armijo", True, str(tmp_path), overrides={"solver.nope": 1})


# ---- each study at a tiny size, with the JAX script's keys ---------------------------

def test_armijo_rescue_validation_runs(monkeypatch, tmp_path):
    from eincm_tpu_torch.scripts import armijo_rescue_validation as arv

    jmod = jax_script("armijo_rescue_validation", monkeypatch)
    monkeypatch.setattr(jmod, "run", lambda *a, **kw: ([0.1] * 10, (0, 0), 1.0))
    want = keys_of_jax_main(jmod, monkeypatch)
    got = arv.study(str(tmp_path), device="cpu", n_windows=2, overrides=TINY_EXP)
    assert set(got) == set(want)
    assert all(len(got[f"aee_{t}"]) == 2 and np.isfinite(got[f"aee_{t}"]).all()
               for t, *_ in arv.VARIANTS)


def test_ftol_ab_runs(monkeypatch, tmp_path, small):
    from eincm_tpu_torch.scripts import ftol_ab

    jmod = jax_script("ftol_ab", monkeypatch)
    monkeypatch.setattr(jmod, "run_accuracy", lambda *a, **kw: ([0.1] * 10, (0, 0), 1.0))
    fake_benches(monkeypatch)
    want = keys_of_jax_main(jmod, monkeypatch)
    got = ftol_ab.study(str(tmp_path), device="cpu", n_windows=2, overrides=TINY_EXP,
                        rounds=1, mvsec_windows=2, dsec_rounds=1, dsec_windows=2,
                        solver_overrides=TINY)
    assert set(got) == set(want)
    assert got["mvsec_p50_ms_none"] > 0 and got["dsec_p50_ms_1e-06"] > 0
    assert set(keys_of_jax_main(jmod, monkeypatch, ["--skip-accuracy", "--skip-dsec"])) == {
        f"mvsec_p50_ms_{ftol_ab.tag(f)}" for f in ftol_ab.FTOLS}


def test_ls_evals_ab_runs(monkeypatch, tmp_path, small):
    from eincm_tpu_torch.scripts import ls_evals_ab

    jmod = jax_script("ls_evals_ab", monkeypatch)
    monkeypatch.setattr(jmod, "run_accuracy", lambda *a, **kw: ([0.1] * 10, (0, 0), 1.0))
    fake_benches(monkeypatch)
    want = keys_of_jax_main(jmod, monkeypatch)
    got = ls_evals_ab.study(str(tmp_path), device="cpu", n_windows=2, overrides=TINY_EXP,
                            rounds=1, mvsec_windows=2, solver_overrides=TINY)
    assert set(got) == set(want)
    assert got["p50_ms_6"] > 0 and len(got["aee_10"]) == 2


def test_edge_sensitivity_runs(monkeypatch, small):
    from eincm_tpu_torch.scripts import edge_sensitivity

    jmod = jax_script("edge_sensitivity", monkeypatch)
    monkeypatch.setattr(jmod, "solve_chain_aee", lambda cfg, n_windows=6: [0.1] * n_windows)
    want = keys_of_jax_main(jmod, monkeypatch)
    got = edge_sensitivity.study(device="cpu", n_windows=2, solver_overrides=TINY)
    assert list(got) == list(want)
    for name, rec in got.items():
        assert set(rec) == set(want[name]), name
        assert len(rec["aee_per_window"]) == 2 and np.isfinite(rec["aee_mean"])
    assert got["baseline"]["daee_vs_baseline"] == 0


def test_mvsec_loss_breakdown_runs(small):
    from eincm_tpu_torch.scripts import mvsec_loss_breakdown as mlb

    buf = io.StringIO()
    with redirect_stdout(buf):
        res = mlb.breakdown(device="cpu", rounds=1, iters=2)
    src = (REPO / "scripts" / "mvsec_loss_breakdown.py").read_text()
    for line in buf.getvalue().splitlines():  # the JAX script's lines, one splat row
        label = line.split(" fwd ")[0].split(" value-only ")[0].rstrip()
        assert label in ("solver_loss", "warp", "splat", "post-splat chain", "# sum of stages:")
        assert label.split("[")[0] in src
    assert set(res) == {"solver_loss", "warp", "splat", "post_splat_chain",
                        "sum_of_stages_fwd_ms", "sum_of_stages_fwd_bwd_ms"}
    assert all(r["ms"] > 0 and r["device_ms"] is None
               for stage in ("solver_loss", "warp", "splat", "post_splat_chain")
               for r in res[stage].values())


@pytest.mark.parametrize("name", ["armijo_interp_probe", "hessian_warmstart_probe"])
def test_probes_run(small, name):
    mod = importlib.import_module(f"eincm_tpu_torch.scripts.{name}")
    kw = dict(full_bench=True, bench_rounds=1, solver_overrides=TINY) \
        if name == "armijo_interp_probe" else {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = mod.probe(device="cpu", n_windows=2, maxiter=3, rounds=1, **kw)
    cols = table_columns(name)
    assert cols[0] == "win" and len(cols) == 8
    assert [list(r) for r in res["windows"]] == [cols]
    assert re.search(r"^\s*win\s+" + r"\s+".join(cols[1:]) + r"\s*$", buf.getvalue(), re.M)
    assert "TOT iters" in buf.getvalue()
    if name == "armijo_interp_probe":
        assert res["window_solve_p50_ms_interp"] > 0


def test_main_entry_points_parse_device_and_out(small, tmp_path, monkeypatch):
    """--device and --out; a probe's `main` (its probe cut to 2 windows)
    prints its JSON line and writes it to --out."""
    import functools

    from eincm_tpu_torch.scripts import hessian_warmstart_probe
    from eincm_tpu_torch.scripts.armijo_rescue_validation import parse_args

    monkeypatch.setattr(hessian_warmstart_probe, "probe", functools.partial(
        hessian_warmstart_probe.probe, n_windows=2, maxiter=3, rounds=1))

    a = parse_args(["--device", "cpu", "--skip-dsec"], "doc", "/tmp/x", ("--skip-dsec",))
    assert (a.device, a.out, a.skip_dsec) == ("cpu", "/tmp/x", True)
    assert parse_args([], "doc", None).device == "cuda"
    buf = io.StringIO()
    with redirect_stdout(buf):
        hessian_warmstart_probe.main(["--device", "cpu", "--out", str(tmp_path / "h.json")])
    line = buf.getvalue().strip().splitlines()[-1]
    assert (tmp_path / "h.json").read_text().strip() == line
    assert [r["win"] for r in json.loads(line)["windows"]] == [1]


# ---- float64 against the JAX package ---------------------------------------------

def _f64_window():
    """One small synthetic window, staged by the port in float64 (no NaN
    padding: the warp stage sums every warped coordinate)."""
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
    from eincm_tpu_torch.edge.pipeline import iedt_edge_fn

    dl = SyntheticDataLoader(sensor_size=(32, 40), n_windows=1, des_n_events=1500,
                             velocity=(2.0, -1.5), n_features=30, seed=3)
    dl.get_ready()
    return stage_datasample(dl[0], CPU, edge_fn=iedt_edge_fn(),
                            dtype=torch.float64).window


def _jax_level0(window, maxiter):
    """The JAX scripts' level-0 objective and config on `window`'s arrays
    (under jax.enable_x64)."""
    import jax
    import jax.numpy as jnp

    from eincm_tpu.models.loss import LossParams, compute_window_statics, solver_loss
    from eincm_tpu.models.pyramid import SolverConfig

    cfg = SolverConfig(n_pyr_lvls=5, sensor_size=(32, 40),
                       params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
                       theta_opt_maxiters=(maxiter,) * 5)
    w = {k: jnp.asarray(getattr(window, k).numpy()) for k in window._fields}
    wstat = compute_window_statics(w["xs"], w["ys"], w["edges"], cfg.sensor_size)
    shape = (*cfg.level_shape(0), 2)

    def fun_only(flat):
        return solver_loss(flat.reshape(shape), w["xs"], w["ys"], w["ts"], w["edges"],
                           w["edge_ts"], cfg.params, 0, cfg.loss_statics, wstat)

    def fun_and_grad(flat):
        loss, grad = jax.value_and_grad(fun_only)(flat)
        return loss, grad.reshape(-1)

    return cfg, fun_only, fun_and_grad


def _port_level0(window, maxiter):
    from eincm_tpu_torch.models.loss import LossParams, compute_window_statics
    from eincm_tpu_torch.models.pyramid import SolverConfig

    cfg = SolverConfig(n_pyr_lvls=5, sensor_size=(32, 40),
                       params=LossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
                       theta_opt_maxiters=(maxiter,) * 5)
    return cfg, compute_window_statics(window.xs, window.ys, window.edges, cfg.sensor_size)


def _same_solve(t, j):
    assert (t.total_iters, t.n_fun_evals, t.status) == \
        (int(j.total_iters), int(j.n_fun_evals), int(j.status))
    jf = float(j.fun_val)
    assert abs(float(t.fun_val) - jf) <= TOL_LOSS * abs(jf)


def test_armijo_interp_probe_solve_matches_jax_float64():
    import jax
    import jax.numpy as jnp

    from eincm_tpu.models.bfgs import minimize_bfgs as jax_bfgs
    from eincm_tpu_torch.scripts.armijo_interp_probe import solve_lvl0

    window = _f64_window()
    with jax.enable_x64(True):
        jcfg, fun_only, fun_and_grad = _jax_level0(window, 8)
        tcfg, wstat = _port_level0(window, 8)
        d = int(np.prod(tcfg.level_shape(0))) * 2
        for interp in (False, True):
            j = jax_bfgs(fun_and_grad, jnp.zeros((d,), jnp.float64), maxiter=8, gtol=1e-4,
                         max_ls_evals=jcfg.max_ls_evals, line_search="armijo", fun=fun_only,
                         armijo_interpolate=interp)
            t = solve_lvl0(tcfg, torch.zeros(d, dtype=torch.float64), window, wstat, interp,
                           maxiter=8)
            assert t.fun_val.dtype == torch.float64
            _same_solve(t, j)


def test_hessian_warmstart_probe_solve_matches_jax_float64():
    import jax
    import jax.numpy as jnp

    from eincm_tpu.models.bfgs import minimize_bfgs as jax_bfgs
    from eincm_tpu_torch.scripts.hessian_warmstart_probe import solve_lvl0

    window = _f64_window()
    with jax.enable_x64(True):
        jcfg, fun_only, fun_and_grad = _jax_level0(window, 6)
        tcfg, wstat = _port_level0(window, 6)
        d = int(np.prod(tcfg.level_shape(0))) * 2
        jh = jnp.eye(d, dtype=jnp.float64)
        th = torch.eye(d, dtype=torch.float64)
        jx, tx = jnp.zeros((d,), jnp.float64), torch.zeros(d, dtype=torch.float64)
        for _ in range(2):  # from H = I, then warm from the first solve's H
            j, jh = jax_bfgs(fun_and_grad, jx, maxiter=6, gtol=1e-4,
                             max_ls_evals=jcfg.max_ls_evals, line_search="armijo",
                             fun=fun_only, h0=jh, return_h_inv=True)
            t, th = solve_lvl0(tcfg, tx, th, window, wstat, maxiter=6)
            _same_solve(t, j)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-8, atol=1e-10)
            jx, tx = j.x, t.x


def test_mvsec_loss_breakdown_stages_match_jax_float64():
    """Every stage's value (value plus gradient sum) at one seed, the port's
    against the JAX script's stage definitions on the same arrays."""
    import jax
    import jax.numpy as jnp

    from eincm_tpu.models.loss import EPSN, compute_weights_for_multi_reference
    from eincm_tpu.models.loss import compute_window_statics as jstatics
    from eincm_tpu.models.loss import solver_loss as jloss
    from eincm_tpu.models.objectives import (
        compute_mean_gradient_magnitude,
        compute_mean_squared_error,
    )
    from eincm_tpu.ops.normalize import normalize_to_unit_range
    from eincm_tpu.ops.splat import splat_multi_ref
    from eincm_tpu.ops.warp import warp_events_multi_ref_coarse
    from eincm_tpu_torch.models.pyramid import SolverConfig
    from eincm_tpu_torch.scripts import mvsec_loss_breakdown as mlb

    window = _f64_window()
    tcfg = SolverConfig(n_pyr_lvls=5, sensor_size=(32, 40), params=mlb.PARAMS,
                        theta_opt_maxiters=(40, 33, 25, 18, 10))
    inp = mlb.make_inputs(window, tcfg)
    got = {(n, v): float(f(0.7)) for n, vs in mlb.stages(window, tcfg, inp).items()
           for v, f in vs.items()}
    HW = (32, 40)
    with jax.enable_x64(True):
        w = {k: jnp.asarray(getattr(window, k).numpy()) for k in window._fields}
        theta, cot_e, cot_f = (jnp.asarray(inp[k].numpy()) for k in ("theta", "cot_e", "cot_f"))
        wstats = jstatics(w["xs"], w["ys"], w["edges"], HW)
        from eincm_tpu.models.pyramid import SolverConfig as JCfg

        statics = JCfg(n_pyr_lvls=5, sensor_size=HW, params=mlb.PARAMS,
                       theta_opt_maxiters=(40, 33, 25, 18, 10)).loss_statics
        s = jnp.float64(0.7)

        def loss_of(t, s):
            return jloss(t + s * 1e-6, w["xs"], w["ys"], w["ts"], w["edges"], w["edge_ts"],
                         mlb.PARAMS, 0, statics, wstats)

        def warp(t):
            return warp_events_multi_ref_coarse(t, w["xs"], w["ys"], w["ts"], w["edge_ts"], HW)

        vg = lambda f, x: (lambda out: out[0] + out[1].sum())(jax.value_and_grad(f)(x))
        wx, wy = warp(theta)
        iwes = splat_multi_ref(wx, wy, HW)
        mrw = jnp.asarray(compute_weights_for_multi_reference(n_refs=w["edges"].shape[0]),
                          jnp.float32)

        def chain(iw):
            niwes = jax.vmap(normalize_to_unit_range)(iw)
            corrs = -jax.vmap(compute_mean_squared_error)(w["edges"], niwes)
            contrasts = jax.vmap(compute_mean_gradient_magnitude)(iw)
            rel_corrs = (mrw * corrs) / (wstats.zero_corrs + EPSN)
            rel_contrasts = (mrw * contrasts) / (wstats.zero_contrast + EPSN)
            return mlb.PARAMS.alpha * (-rel_contrasts.mean()) + mlb.PARAMS.beta * (
                -rel_corrs.mean())

        ref = {
            ("solver_loss", "value_only"): loss_of(theta, s),
            ("solver_loss", "value_and_grad"): vg(lambda t: loss_of(t, s), theta),
            ("warp", "fwd"): sum(x.sum() for x in warp(theta + s * 1e-6)),
            ("warp", "fwd_bwd"): vg(lambda t: (lambda a: jnp.vdot(a[0], cot_e[0])
                                               + jnp.vdot(a[1], cot_e[1]))(warp(t)),
                                    theta + s * 1e-6),
            ("splat", "fwd"): splat_multi_ref(wx + s * 1e-6, wy, HW).sum(),
            ("splat", "fwd_bwd"): vg(lambda d: jnp.vdot(splat_multi_ref(wx + d, wy, HW), cot_f),
                                     s * 1e-6),
            ("post_splat_chain", "fwd"): chain(iwes + s * 1e-6),
            ("post_splat_chain", "fwd_bwd"): vg(lambda d: chain(iwes + d), s * 1e-6),
        }
        ref = {k: float(v) for k, v in ref.items()}
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= TOL_STAGE * max(abs(ref[k]), 1e-300), (k, got[k], ref[k])
