"""The window solve of eincm_tpu_torch vs eincm_tpu, end to end on CPU.

64x64 sensor, 8192 events, 3 pyramid levels, alpha=20, beta=35, Canny +
IEDT edges of 2 reference frames. Both packages get the same numpy
window and the same prior (`eincm_tpu_torch.compat`).

- float64 first window: identical per-level iteration counts, attempts
  and statuses; final theta within 1e-6.
- float32 3-window handover chain: per-window AEE within +-0.05 px of
  the JAX package's (float32 trajectories drift apart along a chain, so
  the chain is held to an accuracy band, not to bits).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.models import pyramid as jp
from eincm_tpu.models.loss import LossParams as JLossParams
from eincm_tpu_torch import compat
from eincm_tpu_torch.data.staging import stage_datasample
from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
from eincm_tpu_torch.edge.pipeline import iedt_edge_fn
from eincm_tpu_torch.models import pyramid as tp
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.utils.workloads import aee_at_events

SENSOR = (64, 64)
N_EVENTS = 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n_windows, speed=3.0, rotate_deg=15.0, n_events=N_EVENTS):
    """Numpy windows whose GT velocity rotates per window."""
    edge_fn = iedt_edge_fn()
    out = []
    for k in range(n_windows):
        phi = np.arctan2(-2.0, 3.0) + np.deg2rad(rotate_deg) * k
        vel = (speed * np.cos(phi), speed * np.sin(phi))
        dl = SyntheticDataLoader(
            sensor_size=SENSOR, n_windows=1, des_n_events=n_events,
            velocity=vel, n_features=40, seed=1 + k,
        )
        dl.get_ready()
        w = stage_datasample(
            dl[0], "cpu", edge_fn=edge_fn, pad_to=n_events, dtype=torch.float64
        ).window
        out.append(([t.numpy() for t in w], vel))
    return out


def _jax_cfg(theta_ftol):
    return jp.SolverConfig(
        n_pyr_lvls=3,
        sensor_size=SENSOR,
        params=JLossParams(20.0, 35.0),
        theta_opt_maxiters=(25, 20, 15),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1, 1: 1},
        handover=jp.HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0,)
        ),
        theta_ftol=theta_ftol,
    )


def _stats(res):
    return [
        (int(s.iter_num), int(s.total_iters), int(s.n_attempts), int(s.status))
        for s in res.theta_opt_states
    ]


@pytest.mark.parametrize("theta_ftol", [None, 1e-5])
def test_first_window_f64_identical_iterations(theta_ftol):
    (arrays, _), = _windows(1)
    jcfg = _jax_cfg(theta_ftol)
    with jax.enable_x64(True):
        sample = jp.WindowSample(*[jnp.asarray(a) for a in arrays])
        jres = jp.make_window_solver(jcfg)(
            sample, jcfg.zero_pyramid(jnp.float64), True
        )
        jstats, jtheta = _stats(jres), np.asarray(jres.final_theta_pyr[0])
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    tres = tp.make_window_solver(tcfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        tcfg.zero_pyramid(torch.float64, device="cpu"),
        True,
    )
    assert _stats(tres) == jstats
    assert sum(s.total_iters for s in tres.theta_opt_states) > 3
    np.testing.assert_allclose(
        tres.final_theta_pyr[0].numpy(), jtheta, rtol=0, atol=1e-6
    )
    assert tres.n_host_syncs == sum(s.n_fun_evals for s in tres.theta_opt_states)


FINE_32 = [
    {"n_pyr_lvls": 6, "theta_opt_maxiters": (4, 3, 3, 2, 2, 2), "pyramid_bases": None},
    {"n_pyr_lvls": 5, "theta_opt_maxiters": (4, 3, 3, 2, 2), "pyramid_bases": (4, 2, 2, 2)},
]
FINE_32_IDS = ["6_levels", "bases_4222"]


@pytest.mark.parametrize("levels", FINE_32, ids=FINE_32_IDS)
def test_32x32_finest_grid_config_and_loss_match_jax(levels):
    """The two configs' pyramids level by level, and the finest level's
    float64 loss and gradient on the solve's window, against the JAX
    package's (1e-12): the path on which the card's interp backward adds
    its exact sums at 32x32."""
    from eincm_tpu.models import loss as jl
    from eincm_tpu_torch.experiments.config import load_config
    from eincm_tpu_torch.models import loss as tl

    jcfg = dataclasses.replace(_jax_cfg(None), handover_opt_maxiters=(), **levels)
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    shapes = [jcfg.level_shape(lvl) for lvl in range(jcfg.n_pyr_lvls)]
    assert shapes[0] == (32, 32)
    assert [tcfg.level_shape(lvl) for lvl in range(tcfg.n_pyr_lvls)] == shapes
    # a shipped config with the override gives the same pyramid
    override = (f"solver.n_pyr_lvls={jcfg.n_pyr_lvls}" if levels["pyramid_bases"] is None
                else "solver.pyramid_bases=[4, 2, 2, 2]")
    config = Path(__file__).resolve().parent.parent / "configs" / "dsec_test.yaml"
    cfg = load_config(str(config), [override]).solver_config()
    assert [cfg.level_shape(lvl) for lvl in range(cfg.n_pyr_lvls)] == shapes
    (arrays, _), = _windows(1, n_events=4096)
    theta = np.random.default_rng(3).normal(0, 2, (32, 32, 2))
    with jax.enable_x64(True):
        ja = [jnp.asarray(a) for a in arrays]
        ws = jl.compute_window_statics(ja[0], ja[1], ja[3], SENSOR)
        st = jl.LossStatics(SENSOR, jcfg.n_pyr_lvls)
        jv, jg = jax.value_and_grad(lambda t: jl.solver_loss(
            t, *ja, JLossParams(20.0, 35.0), 0, st, ws))(jnp.asarray(theta))
        jv, jg = float(jv), np.asarray(jg)
    ta = [torch.as_tensor(a) for a in arrays]
    tws = tl.compute_window_statics(ta[0], ta[1], ta[3], SENSOR)
    th = torch.as_tensor(theta).requires_grad_(True)
    tv = tl.solver_loss(th, *ta, tl.LossParams(20.0, 35.0), 0,
                        tl.LossStatics(SENSOR, tcfg.n_pyr_lvls), tws)
    (tg,) = torch.autograd.grad(tv, th)
    assert abs(float(tv.detach()) - jv) <= 1e-12 * abs(jv)
    assert np.abs(tg.numpy() - jg).max() <= 1e-12 * np.abs(jg).max()


# slow: the JAX package compiles a solver for each of five or six levels
# (~18 s of ~25 s a case on one core)
@pytest.mark.slow
@pytest.mark.parametrize("levels", FINE_32, ids=FINE_32_IDS)
def test_first_window_f64_32x32_finest_grid_matches_jax(levels):
    """The configs' ways to a 32x32 finest grid (`solver.n_pyr_lvls=6`,
    `solver.pyramid_bases=[4,2,2,2]`), the grids at which the card's
    interp backward takes exact sums: per-level iteration counts and
    statuses equal to the JAX package's, final theta within 1e-6 (4096
    events and few iterations a level, to keep it short)."""
    (arrays, _), = _windows(1, n_events=4096)
    # the levels' own defaults (bases of 2, 15 handover iterations a level)
    jcfg = dataclasses.replace(_jax_cfg(None), handover_opt_maxiters=(), **levels)
    assert jcfg.level_shape(0) == (32, 32)
    with jax.enable_x64(True):
        sample = jp.WindowSample(*[jnp.asarray(a) for a in arrays])
        jres = jp.make_window_solver(jcfg)(sample, jcfg.zero_pyramid(jnp.float64), True)
        jstats, jtheta = _stats(jres), np.asarray(jres.final_theta_pyr[0])
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.level_shape(0) == (32, 32)
    tres = tp.make_window_solver(tcfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        tcfg.zero_pyramid(torch.float64, device="cpu"),
        True,
    )
    assert _stats(tres) == jstats
    assert tres.final_theta_pyr[0].shape == (32, 32, 2)
    np.testing.assert_allclose(tres.final_theta_pyr[0].numpy(), jtheta, rtol=0, atol=1e-6)


def test_handover_window_f64_matches_jax():
    """A second window from the same prior, with the weight solved at
    levels 0 and 1 and a grid-seeded golden section: the same iterations,
    handover weights and theta as the JAX package."""
    wins = _windows(2)
    jcfg = dataclasses.replace(
        _jax_cfg(1e-5),
        handover=jp.HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0, 1),
            handover_grid_probes=5,
        ),
    )
    rng = np.random.default_rng(1)
    prior = [rng.normal(0, 1, (*jcfg.level_shape(l), 2)) for l in range(3)]
    arrays = wins[1][0]
    with jax.enable_x64(True):
        jres = jp.make_window_solver(jcfg)(
            jp.WindowSample(*[jnp.asarray(a) for a in arrays]),
            tuple(jnp.asarray(p) for p in prior), False,
        )
        jstats = _stats(jres)
        jw = [float(w) for w in jres.final_handover_weights]
        jtheta = np.asarray(jres.final_theta_pyr[0])
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    tres = tp.make_window_solver(tcfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        compat.theta_pyramid_from_numpy(prior), False,
    )
    assert _stats(tres) == jstats
    np.testing.assert_allclose(
        [float(w) for w in tres.final_handover_weights], jw, atol=1e-6
    )
    np.testing.assert_allclose(
        tres.final_theta_pyr[0].numpy(), jtheta, rtol=0, atol=1e-6
    )


def test_handover_chain_f32_aee_band():
    wins = _windows(3)
    jcfg = _jax_cfg(1e-5)
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    jsolve = jp.make_window_solver(jcfg)
    tsolve = tp.make_window_solver(tcfg, "cpu")
    jprior = jcfg.zero_pyramid()
    tprior = compat.theta_pyramid_from_numpy([np.asarray(p) for p in jprior])
    _build.reset_launch_counts()
    for k, (arrays, vel) in enumerate(wins):
        arrays = [a.astype(np.float32) for a in arrays]
        jres = jsolve(jp.WindowSample(*[jnp.asarray(a) for a in arrays]), jprior, k == 0)
        sample = compat.window_sample_from_numpy(*arrays, device="cpu")
        tres = tsolve(sample, tprior, k == 0)
        jprior, tprior = jres.final_theta_pyr, tres.final_theta_pyr
        jtheta = torch.as_tensor(np.array(jprior[0]))
        a_jax = aee_at_events(jtheta, sample, vel, SENSOR)
        a_port = aee_at_events(tprior[0], sample, vel, SENSOR)
        assert a_port < 0.5 * np.hypot(*vel)  # the flow is recovered
        assert abs(a_port - a_jax) <= 0.05, (k, a_port, a_jax)
        if k > 0:
            w_jax = float(jres.final_handover_weights[0])
            assert 0.0 <= float(tres.final_handover_weights[0]) <= 1.0
            assert 0.0 <= w_jax <= 1.0
    assert all(v == 0 for v in _build.launch_counts().values())


def test_staging_matches_jax():
    """The carried-over loader, edges and staging give the JAX package's
    window (its staging without the row sort)."""
    from eincm_tpu.data.staging import stage_datasample as jax_stage
    from eincm_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
    from eincm_tpu.experiments.config import EdgeConfig

    kw = dict(sensor_size=SENSOR, n_windows=2, des_n_events=N_EVENTS,
              velocity=(2.0, -1.0), n_features=30, seed=4)
    jdl, tdl = JaxLoader(**kw), SyntheticDataLoader(**kw)
    jdl.get_ready()
    tdl.get_ready()
    jedge = EdgeConfig(
        enable_image_preprocessing=False, smoothen_method="eincm_iedt"
    ).make_edge_fn()
    for i in range(2):
        ref = jax_stage(jdl[i], edge_fn=jedge, pad_to=N_EVENTS + 100).window
        got = stage_datasample(tdl[i], "cpu", edge_fn=iedt_edge_fn(),
                               pad_to=N_EVENTS + 100).window
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_stage_prior_pyramid_matches_jax():
    rng = np.random.default_rng(0)
    jcfg = _jax_cfg(None)
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    pyr = [rng.normal(0, 2, (*jcfg.level_shape(l), 2)) for l in range(3)]
    with jax.enable_x64(True):
        ref = jp.stage_prior_pyramid(jcfg, [jnp.asarray(p) for p in pyr])
        ref = [np.asarray(p) for p in ref]
    got = tp.stage_prior_pyramid(tcfg, compat.theta_pyramid_from_numpy(pyr))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)


def test_config_from_jax_dict_and_geometry():
    jcfg = _jax_cfg(1e-5)
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.max_ls_evals == jcfg.max_ls_evals == 6
    wolfe = dataclasses.replace(jcfg, line_search="wolfe", max_ls_evals=None)
    assert compat.solver_config_from_dict(dataclasses.asdict(wolfe)).max_ls_evals == 10
    assert wolfe.max_ls_evals == 10
    assert tcfg.handover_opt_maxiters == jcfg.handover_opt_maxiters
    assert [tcfg.level_shape(l) for l in range(3)] == [(4, 4), (2, 2), (1, 1)]
    assert tp.SolverConfig(1, SENSOR, tcfg.params, (5,)).theta_ftol is None


OPT_SENSOR = (24, 32)
# tests/test_solver_config_matrix.py's joint configurations (two levels),
# with more iterations so that every option does real work
OPTION_COMBOS = {
    "wolfe_clip_retry": dict(
        line_search="wolfe",
        max_ls_evals=10,
        n_extra_attempts={0: 1},
        handover=jp.HandoverSettings(
            use_handover=True,
            solve_handover_for_levels=(0, 1),
            clip_solved_handover=True,
            clip_solved_handover_limits=(0.2, 0.9),
        ),
        collect_intermediate=True,
    ),
    "armijo_all_on": dict(
        line_search="armijo",
        armijo_interpolate=True,
        max_ls_evals=4,
        handover=jp.HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0,), handover_grid_probes=4
        ),
        collect_intermediate=True,
        compute_prior_loss=True,
    ),
}


def _option_window(seed=1234, n=400):
    """A random float64 window (tests/test_solver_config_matrix.py's form)
    and a random prior pyramid of two levels."""
    rng = np.random.default_rng(seed)
    H, W = OPT_SENSOR
    arrays = [
        rng.integers(0, W, n).astype(np.float64),
        rng.integers(0, H, n).astype(np.float64),
        np.sort(rng.uniform(0, 1, n)),
        rng.uniform(0, 1, (2, H, W)),
        np.array([0.0, 1.0]),
    ]
    prior = [rng.normal(0, 1, (2, 2, 2)), rng.normal(0, 1, (1, 1, 2))]
    return arrays, prior


def _option_cfg(**kw):
    # gamma = 0: the jitted JAX solve counts the event-masked TV's nonzero
    # gradients on XLA's fused stencil, whose contracted products leave
    # residues where the flow is flat (740 pixels here against 732 eager,
    # a 1.4e-4 loss difference at level 0); the port's TV is JAX's eager one
    # (test_torch_loss.py)
    return jp.SolverConfig(
        n_pyr_lvls=2, sensor_size=OPT_SENSOR,
        params=JLossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(8, 6), theta_gtol=1e-6, **kw,
    )


def _hist(h, atol=1e-6):
    return (int(h.n), np.asarray(h.xs), np.asarray(h.fs))


@pytest.mark.parametrize("combo", sorted(OPTION_COMBOS))
def test_solver_options_window_f64_matches_jax(combo):
    """A handover window in float64 under the joint configurations: per
    level the same iterations, evaluations and statuses, the same
    trajectories and golden-section probes (within 1e-6), the same prior
    loss; the port's host syncs are its reads through `to_host`."""
    arrays, prior = _option_window()
    jcfg = _option_cfg(**OPTION_COMBOS[combo])
    with jax.enable_x64(True):
        jres = jp.make_window_solver(jcfg)(
            jp.WindowSample(*[jnp.asarray(a) for a in arrays]),
            tuple(jnp.asarray(p) for p in prior), False,
        )
        jstats = [(*st, int(s.n_fun_evals)) for st, s in zip(_stats(jres), jres.theta_opt_states)]
        jhists = [_hist(h) for h in jres.theta_histories]
        jho = [None if h is None else _hist(h) for h in jres.handover_histories]
        jprior_loss = float(jres.prior_loss_lvl0)
        jtheta = np.asarray(jres.final_theta_pyr[0])
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.max_ls_evals == jcfg.max_ls_evals
    tres = tp.make_window_solver(tcfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        compat.theta_pyramid_from_numpy(prior), False,
    )
    assert [(*st, s.n_fun_evals) for st, s in zip(_stats(tres), tres.theta_opt_states)] == jstats
    assert sum(s.total_iters for s in tres.theta_opt_states) > 4
    for j, t in zip(jhists, tres.theta_histories):
        assert t.n == j[0]
        np.testing.assert_allclose(t.xs.numpy(), j[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.fs.numpy(), j[2], rtol=0, atol=1e-6)
    for lvl, (j, t) in enumerate(zip(jho, tres.handover_histories)):
        assert (j is None) == (t is None) == (lvl not in tcfg.handover.solve_handover_for_levels)
        if t is not None:
            assert t.n == j[0] > 0
            np.testing.assert_allclose(t.xs.numpy(), j[1], rtol=0, atol=1e-6)
            np.testing.assert_allclose(t.fs.numpy(), j[2], rtol=0, atol=1e-6)
    if tcfg.compute_prior_loss:
        np.testing.assert_allclose(float(tres.prior_loss_lvl0), jprior_loss, rtol=1e-12)
    else:
        assert float(tres.prior_loss_lvl0) == jprior_loss == float("inf")
    np.testing.assert_allclose(tres.final_theta_pyr[0].numpy(), jtheta, rtol=0, atol=1e-6)


def test_every_option_on_solves_and_counts_its_host_reads(monkeypatch, capsys):
    """Wolfe with every option on constructs and solves a window; the
    heartbeat prints JAX's line per iteration and level; n_host_syncs
    equals the reads through `utils/host.py:to_host` (the single place the
    port reads a tensor on the host) and is trials + iterations + 1 per
    level; no other op reads a value on the host (`item`, a 0-dim tensor
    index, a boolean mask), which on the card would wait for the device."""
    from eincm_tpu_torch.utils import host

    calls = []
    real = host.to_host
    monkeypatch.setattr(host, "to_host", lambda t: calls.append(1) or real(t))
    arrays, prior = _option_window(seed=7)
    cfg = tp.SolverConfig(
        n_pyr_lvls=2, sensor_size=OPT_SENSOR, params=tp.LossParams(20.0, 35.0),
        theta_opt_maxiters=(5, 4), line_search="wolfe", collect_intermediate=True,
        progress_heartbeat=True, compute_prior_loss=True, armijo_interpolate=True,
        handover=tp.HandoverSettings(solve_handover_for_levels=(0,)),
    )
    assert cfg.max_ls_evals == 10
    with torch.autograd.profiler.profile() as prof:
        res = tp.make_window_solver(cfg, "cpu")(
            compat.window_sample_from_numpy(*arrays, device="cpu"),
            compat.theta_pyramid_from_numpy(prior), False,
        )
    host_reads = {"aten::_local_scalar_dense", "aten::nonzero"}
    assert [e.name for e in prof.function_events if e.name in host_reads] == []
    assert res.n_host_syncs == len(calls) == sum(
        (s.n_fun_evals - 1) + s.total_iters + 1 for s in res.theta_opt_states)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == sum(s.total_iters for s in res.theta_opt_states)
    last = res.theta_histories[0]
    assert lines[-1] == f"  [lvl 0] iter {last.n:3d}  loss {float(last.fs[last.n - 1]):.6f}"
    assert float(last.fs[last.n - 1]) == float(res.theta_opt_states[0].fun_val)
    assert np.isfinite(float(res.prior_loss_lvl0))
    assert res.handover_histories[1] is None and res.handover_histories[0].n == 4 + 15


def test_first_window_gets_empty_histories_and_no_prior_loss():
    """A first window: +inf prior loss, and an empty (n = 0) handover
    history of the solved one's shape where a weight would be solved."""
    arrays, prior = _option_window(seed=8)
    jcfg = _option_cfg(**OPTION_COMBOS["armijo_all_on"])
    cfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    res = tp.make_window_solver(cfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        cfg.zero_pyramid(torch.float64, device="cpu"), True,
    )
    assert float(res.prior_loss_lvl0) == float("inf")
    h = res.handover_histories[0]
    cap = 4 + 2 + cfg.handover_opt_maxiters[0]
    assert h.n == 0 and h.xs.shape == h.fs.shape == (cap,)
    assert h.xs.dtype == torch.float32 and h.fs.dtype == torch.float64
    assert res.handover_histories[1] is None
    assert [t.n for t in res.theta_histories] == [s.total_iters for s in res.theta_opt_states]


def test_solver_refuses_a_sample_on_another_device():
    (arrays, _), = _windows(1)
    cfg = compat.solver_config_from_dict(dataclasses.asdict(_jax_cfg(None)))
    solve = tp.make_window_solver(cfg, "meta")
    with pytest.raises(ValueError):
        solve(compat.window_sample_from_numpy(*arrays, device="cpu"),
              cfg.zero_pyramid(device="cpu"), True)


@pytest.mark.parametrize(
    "methods",
    [dict(pyramid_downscale_method="bicubic"),
     dict(pyramid_downscale_method="lanczos3", pyramid_upscale_method="bicubic",
          scale_to_sensor_size_method="bicubic")],
    ids=["downscale_bicubic", "cubic_and_lanczos_everywhere"],
)
def test_handover_window_f64_with_cubic_resizes_matches_jax(methods):
    """A handover window whose coarse priors are downscaled from the finest
    one by a cubic (or Lanczos) kernel, and in the second case upscaled and
    scaled to the sensor by the cubic kernel too: the same per-level
    iterations and statuses, handover weights and theta as the JAX
    package."""
    wins = _windows(2)
    jcfg = dataclasses.replace(_jax_cfg(1e-5), **methods)
    assert jcfg.handover.use_downscaled_finest_priors
    # (with rng(2) this window's golden section is chaotic: a change of
    # 1e-14 in the prior moves the port's own handover weight by 2e-4)
    rng = np.random.default_rng(1)
    prior = [rng.normal(0, 1, (*jcfg.level_shape(l), 2)) for l in range(3)]
    arrays = wins[1][0]
    with jax.enable_x64(True):
        jres = jp.make_window_solver(jcfg)(
            jp.WindowSample(*[jnp.asarray(a) for a in arrays]),
            tuple(jnp.asarray(p) for p in prior), False,
        )
        jstats = _stats(jres)
        jw = [float(w) for w in jres.final_handover_weights]
        jtheta = np.asarray(jres.final_theta_pyr[0])
        jprior1 = np.asarray(jres.prior_theta_pyr[1])
    tcfg = compat.solver_config_from_dict(dataclasses.asdict(jcfg))
    tres = tp.make_window_solver(tcfg, "cpu")(
        compat.window_sample_from_numpy(*arrays, device="cpu"),
        compat.theta_pyramid_from_numpy(prior), False,
    )
    np.testing.assert_allclose(tres.prior_theta_pyr[1].numpy(), jprior1, rtol=0, atol=1e-12)
    assert _stats(tres) == jstats
    assert sum(s.total_iters for s in tres.theta_opt_states) > 3
    np.testing.assert_allclose(
        [float(w) for w in tres.final_handover_weights], jw, atol=1e-6
    )
    np.testing.assert_allclose(
        tres.final_theta_pyr[0].numpy(), jtheta, rtol=0, atol=1e-6
    )
