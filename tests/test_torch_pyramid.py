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


def _windows(n_windows, speed=3.0, rotate_deg=15.0):
    """Numpy windows whose GT velocity rotates per window."""
    edge_fn = iedt_edge_fn()
    out = []
    for k in range(n_windows):
        phi = np.arctan2(-2.0, 3.0) + np.deg2rad(rotate_deg) * k
        vel = (speed * np.cos(phi), speed * np.sin(phi))
        dl = SyntheticDataLoader(
            sensor_size=SENSOR, n_windows=1, des_n_events=N_EVENTS,
            velocity=vel, n_features=40, seed=1 + k,
        )
        dl.get_ready()
        w = stage_datasample(
            dl[0], "cpu", edge_fn=edge_fn, pad_to=N_EVENTS, dtype=torch.float64
        )
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
                               pad_to=N_EVENTS + 100)
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
    assert tcfg.handover_opt_maxiters == jcfg.handover_opt_maxiters
    assert [tcfg.level_shape(l) for l in range(3)] == [(4, 4), (2, 2), (1, 1)]
    assert tp.SolverConfig(1, SENSOR, tcfg.params, (5,)).theta_ftol is None


@pytest.mark.parametrize(
    "kw",
    [
        dict(line_search="wolfe"),
        dict(collect_intermediate=True),
        dict(progress_heartbeat=True),
        dict(compute_prior_loss=True),
        dict(armijo_interpolate=True),
    ],
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        tp.SolverConfig(1, SENSOR, tp.LossParams(1.0, 1.0), (5,), **kw)


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
