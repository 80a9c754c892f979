"""The MVSEC-scale handover chain, eincm_tpu_torch vs eincm_tpu, on CPU.

The 6-window chain that `chip_smoke.py` runs on the card
(`eincm_tpu_torch.utils.workloads`: 256x336, 30k events per window, 5
levels, GT flow of 5 px rotating 15 degrees per window), solved in float32
by both packages from the same staged windows. It reads the chain AEE the
reference itself reaches, which is what the card's bound in
`chip_smoke.py` is set against. Minutes on CPU, hence `slow`:

    python -m pytest -m slow tests/test_torch_mvsec_chain.py -s
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.models import pyramid as jp
from eincm_tpu.models.loss import LossParams as JLossParams
from eincm_tpu_torch import compat
from eincm_tpu_torch.models.pyramid import make_window_solver
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.utils import workloads as wl

pytestmark = pytest.mark.slow

# the mean AEE of windows 1..5 may differ from the JAX package's by this
# much: float32 trajectories drift apart along a chain (as in
# test_torch_pyramid.py's chain band)
AEE_BAND = 0.05


def _jax_cfg():
    return jp.SolverConfig(
        n_pyr_lvls=5,
        sensor_size=(wl.MVSEC_H, wl.MVSEC_W),
        params=JLossParams(alpha=20.0, beta=35.0, gamma=0.0, delta=0.0),
        theta_opt_maxiters=(40, 33, 25, 18, 10),
        theta_gtol=1e-4,
        n_extra_attempts={0: 1, 1: 1},
        handover=jp.HandoverSettings(
            use_handover=True, solve_handover_for_levels=(0,)
        ),
        theta_ftol=1e-5,
    )


# the armijo rescue's configuration (eincm_tpu/experiments/manager.py:
# 510-514), as chip_smoke.py's [wolfe] phase solves it
WOLFE = dict(line_search="wolfe", max_ls_evals=10, collect_intermediate=True,
             compute_prior_loss=True)


@pytest.mark.parametrize("options", [{}, WOLFE], ids=["armijo", "wolfe"])
def test_mvsec_chain_f32_aee_matches_jax(options):
    jcfg = dataclasses.replace(_jax_cfg(), **options)
    cfg = dataclasses.replace(wl.mvsec_solver_config(), **options)
    assert compat.solver_config_from_dict(dataclasses.asdict(jcfg)) == cfg
    windows, vels = wl.stage_mvsec_windows("cpu")

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        _build.reset_launch_counts()
        port = [rec["aee"] for _, rec in
                wl.solve_chain(make_window_solver(cfg, "cpu"), cfg, windows, vels)]
        assert all(v == 0 for v in _build.launch_counts().values())
    finally:
        torch.set_num_threads(n)

    jsolve = jp.make_window_solver(jcfg)
    prior = jcfg.zero_pyramid()
    ref = []
    for k, (w, vel) in enumerate(zip(windows, vels)):
        res = jsolve(jp.WindowSample(*[jnp.asarray(t.numpy()) for t in w]), prior, k == 0)
        prior = res.final_theta_pyr
        theta0 = torch.as_tensor(np.array(prior[0]))
        ref.append(wl.aee_at_events(theta0, w, vel, cfg.sensor_size))

    mean_port, mean_ref = float(np.mean(port[1:])), float(np.mean(ref[1:]))
    print(f"\nMVSEC chain AEE per window, JAX {np.round(ref, 4).tolist()}, "
          f"port {np.round(port, 4).tolist()}")
    print(f"mean of windows 1-5: JAX {mean_ref:.4f} px, port {mean_port:.4f} px")
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    # both recover the flow (|V| = 5 px; keeping the prior scores ~1.3 px)
    assert max(mean_port, mean_ref) < 0.5
    assert abs(mean_port - mean_ref) <= AEE_BAND, (mean_port, mean_ref)
