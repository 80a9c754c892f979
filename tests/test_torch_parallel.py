"""The port's parallel/ (eincm_tpu_torch/parallel/) against the JAX
package's (eincm_tpu/parallel/), in one process on the CPU.

The inputs are tests/test_parallel.py's tiny configuration and batch (2
levels, 16x16, 128 events a window), made with numpy from a seed; both
packages get the same arrays. The JAX schedules run on a one-device mesh
(`make_window_mesh(1)`) or through their vmap path: none runs JAX's
`shard_map` over several virtual devices. In float32 the packages agree
within the JAX tests' own tolerance (tests/test_parallel.py:76-80); in
float64 (inside `jax.enable_x64(True)`) each schedule's first window has
the JAX package's per-level iterations and statuses and its final theta
within 1e-10. The multi-rank schedules run in tests/test_torch_distributed.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.models.loss import LossParams as JLossParams
from eincm_tpu.models.pyramid import HandoverSettings as JHandover
from eincm_tpu.models.pyramid import SolverConfig as JSolverConfig
from eincm_tpu.models.pyramid import WindowSample as JWindowSample
from eincm_tpu.parallel import batch as jpb
from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import HandoverSettings, SolverConfig, WindowSample
from eincm_tpu_torch.parallel import batch as pb

CPU = torch.device("cpu")
RTOL, ATOL = 1e-2, 5e-3  # float32, tests/test_parallel.py:76-80
TOL_F64 = 1e-10
TOL_EVAL = 1e-4  # relative, one evaluation in float32 by both packages
H = W = 16
N_EVENTS = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny solves gain nothing from threads; the suite's workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfgs(**kw):
    """tests/test_parallel.py's tiny_cfg for both packages."""
    common = dict(n_pyr_lvls=2, sensor_size=(H, W), theta_opt_maxiters=(3, 3), max_ls_evals=5)
    ho = kw.pop("handover", dict(use_handover=True, alpha_handover=0.4))
    j = JSolverConfig(params=JLossParams(alpha=10.0, beta=5.0), handover=JHandover(**ho),
                      **common, **kw)
    t = SolverConfig(params=LossParams(alpha=10.0, beta=5.0), handover=HandoverSettings(**ho),
                     **common, **kw)
    return j, t


def tiny_arrays(b, seed=0):
    """tests/test_parallel.py's tiny_batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        xs=rng.integers(0, W, (b, N_EVENTS)).astype(np.float32),
        ys=rng.integers(0, H, (b, N_EVENTS)).astype(np.float32),
        ts=rng.uniform(0, 1, (b, N_EVENTS)).astype(np.float32),
        edges=rng.uniform(0, 1, (b, 2, H, W)).astype(np.float32),
        edge_ts=np.tile(np.asarray([0.0, 1.0], np.float32), (b, 1)),
    )


def both_batches(arrays, dtype=np.float32):
    j = JWindowSample(**{k: jnp.asarray(v.astype(dtype)) for k, v in arrays.items()})
    t = WindowSample(**{k: torch.as_tensor(v.astype(dtype)) for k, v in arrays.items()})
    return j, t


def boundary_prior(cfg, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, (*cfg.level_shape(l), 2)).astype(dtype)
            for l in range(cfg.n_pyr_lvls)]


def assert_pyramids_close(jax_pyr, port_pyr, rtol=RTOL, atol=ATOL):
    for lvl, (a, b) in enumerate(zip(jax_pyr, port_pyr)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=f"level {lvl}")


# ---- float32: every schedule against the JAX package's ------------------------

def test_solve_window_batch_matches_jax():
    jcfg, tcfg = tiny_cfgs()
    jb, tb = both_batches(tiny_arrays(4))
    ref = jpb.solve_window_batch(jcfg, jb, is_first=True)
    got = pb.solve_window_batch(tcfg, tb, is_first=True)
    assert got.final_theta_pyr[0].shape == (4, *tcfg.level_shape(0), 2)
    assert_pyramids_close(ref.final_theta_pyr, got.final_theta_pyr)


@pytest.mark.parametrize("with_boundary", [False, True], ids=["first", "boundary"])
def test_two_pass_matches_jax(with_boundary):
    """mesh=None on both sides: the schedule does not depend on the mesh."""
    jcfg, tcfg = tiny_cfgs()
    jb, tb = both_batches(tiny_arrays(4))
    bp = boundary_prior(tcfg) if with_boundary else None
    ref, ref_final = jpb.two_pass_sequence_solve(
        jcfg, jb, boundary_prior=None if bp is None else [jnp.asarray(p) for p in bp])
    got, final = pb.two_pass_sequence_solve(
        tcfg, tb, boundary_prior=None if bp is None else [torch.as_tensor(p) for p in bp])
    assert_pyramids_close(ref_final, final)
    assert_pyramids_close(ref.final_handover_weights, got.final_handover_weights)
    # window 0: the carry's handover, else its whole pass-1 record
    w0 = 0.4 if with_boundary else tcfg.handover.init_handover_weight
    assert all(float(w[0]) == pytest.approx(w0) for w in got.final_handover_weights)


@pytest.mark.parametrize("with_boundary", [False, True], ids=["first", "boundary"])
def test_sequence_shard_one_member_matches_jax(with_boundary):
    jcfg, tcfg = tiny_cfgs()
    jb, tb = both_batches(tiny_arrays(4))
    bp = boundary_prior(tcfg) if with_boundary else None
    ref, ref_final = jpb.sequence_shard_solve(
        jcfg, jb, jpb.make_window_mesh(1),
        boundary_prior=None if bp is None else tuple(jnp.asarray(p) for p in bp))
    got, final = pb.sequence_shard_solve(
        tcfg, tb, pb.make_window_mesh(device=CPU),
        boundary_prior=None if bp is None else tuple(torch.as_tensor(p) for p in bp))
    assert_pyramids_close(ref_final, final)
    assert_pyramids_close(ref.prior_theta_pyr, got.prior_theta_pyr)


@pytest.mark.parametrize("with_gt", [True, False], ids=["gt_and_mask", "no_gt"])
def test_eval_batch_sharded_matches_jax(with_gt):
    from eincm_tpu_torch.evals.theta_metrics import format_eval_result

    rng = np.random.default_rng(3)
    arrays = tiny_arrays(3, seed=4)
    theta = rng.normal(0, 1.0, (3, 4, 4, 2)).astype(np.float32)
    gt = rng.normal(0, 1.0, (3, H, W, 2)).astype(np.float32) if with_gt else None
    mask = rng.uniform(0, 1, (H, W)) > 0.3 if with_gt else None
    pvec = np.asarray([10.0, 5.0, 0.1, 0.0], np.float32)
    args = [arrays[k] for k in ("xs", "ys", "ts", "edges", "edge_ts")]
    ref = jpb.eval_batch_sharded(
        jnp.asarray(theta), *map(jnp.asarray, args), None if gt is None else jnp.asarray(gt),
        None if mask is None else jnp.asarray(mask), jnp.asarray(pvec),
        jpb.make_window_mesh(1), (H, W), "bilinear")
    got = pb.eval_batch_sharded(
        torch.as_tensor(theta), *map(torch.as_tensor, args),
        None if gt is None else torch.as_tensor(gt),
        None if mask is None else torch.as_tensor(mask), torch.as_tensor(pvec),
        pb.make_window_mesh(device=CPU), (H, W), "bilinear")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    ref_leaves, got_leaves = dict(leaves(ref)), dict(leaves(got))
    assert sorted(ref_leaves) == sorted(got_leaves)
    for path, r in ref_leaves.items():
        g = got_leaves[path]
        assert isinstance(g, np.ndarray) and g.shape == np.shape(r), path
        if path[0] == "flow_errors" and path[1] == "counts":
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(path))
        else:
            np.testing.assert_allclose(g, np.asarray(r), rtol=TOL_EVAL, atol=1e-6,
                                       err_msg=str(path))
    # one window of the bundle formats as a serial evaluation does
    _, eval_str, evals = format_eval_result(pb.bundle_at(got, 1), (H, W), with_gt)
    assert ("AEE" in evals) == with_gt and "total_loss" in eval_str


# ---- float64: each schedule's first window, iterations and statuses -------------

def _first_window(res):
    return ([int(s.iter_num[0]) for s in res.theta_opt_states],
            [int(s.status[0]) for s in res.theta_opt_states],
            [np.asarray(p[0]) for p in res.final_theta_pyr])


SCHEDULES_F64 = [("batch", False), ("two_pass", False), ("two_pass", True),
                 ("sequence_shard", False), ("sequence_shard", True)]


@pytest.mark.parametrize("schedule,with_boundary", SCHEDULES_F64,
                         ids=[f"{s}-{'boundary' if b else 'first'}" for s, b in SCHEDULES_F64])
def test_first_window_f64_matches_jax(schedule, with_boundary):
    jcfg, tcfg = tiny_cfgs()
    arrays = tiny_arrays(4, seed=5)
    bp = boundary_prior(tcfg, dtype=np.float64) if with_boundary else None
    _, tb = both_batches(arrays, np.float64)
    with jax.enable_x64(True):
        jb, _ = both_batches(arrays, np.float64)
        jbp = None if bp is None else tuple(jnp.asarray(p) for p in bp)
        if schedule == "batch":
            ref = jpb.solve_window_batch(jcfg, jb, is_first=True)
        elif schedule == "two_pass":
            ref, _ = jpb.two_pass_sequence_solve(jcfg, jb, boundary_prior=jbp)
        else:
            ref, _ = jpb.sequence_shard_solve(jcfg, jb, jpb.make_window_mesh(1), boundary_prior=jbp)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    tbp = None if bp is None else tuple(torch.as_tensor(p) for p in bp)
    if schedule == "batch":
        got = pb.solve_window_batch(tcfg, tb, is_first=True)
    elif schedule == "two_pass":
        got, _ = pb.two_pass_sequence_solve(tcfg, tb, boundary_prior=tbp)
    else:
        got, _ = pb.sequence_shard_solve(tcfg, tb, pb.make_window_mesh(device=CPU),
                                         boundary_prior=tbp)
    assert got.final_theta_pyr[0].dtype == torch.float64
    r_iters, r_status, r_theta = _first_window(ref)
    g_iters, g_status, g_theta = _first_window(got)
    assert g_iters == r_iters and g_status == r_status
    for lvl, (a, b) in enumerate(zip(r_theta, g_theta)):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL_F64, err_msg=f"level {lvl}")


# ---- the batched results ---------------------------------------------------------

def test_stacked_results_round_trip():
    """result_at(stack_results(rs), i) is rs[i]: tensors equal, the host
    counters Python numbers again; a structure mismatch raises."""
    from eincm_tpu_torch.models.pyramid import make_window_solver

    _, tcfg = tiny_cfgs()
    tcfg = dataclasses.replace(tcfg, collect_intermediate=True, handover=HandoverSettings(
        use_handover=True, solve_handover_for_levels=(0,)))
    _, tb = both_batches(tiny_arrays(2, seed=6))
    solver = make_window_solver(tcfg, CPU)
    r0 = solver(pb.window_at(tb, 0), tcfg.zero_pyramid(device=CPU), True)
    r1 = solver(pb.window_at(tb, 1), r0.final_theta_pyr, False)
    stacked = pb.stack_results([r0, r1])
    assert stacked.theta_opt_states[0].iter_num.dtype == torch.int64
    assert stacked.theta_opt_states[0].success.dtype == torch.bool
    assert stacked.n_host_syncs.tolist() == [r0.n_host_syncs, r1.n_host_syncs]
    assert stacked.handover_histories[0].n.tolist() == [0, r1.handover_histories[0].n]
    for i, r in enumerate((r0, r1)):
        back = pb.result_at(stacked, i)
        flat_a, flat_b = [], []
        pb._tree_map(lambda c, t: flat_a.append(t), back)
        pb._tree_map(lambda c, t: flat_b.append(t), r)
        assert len(flat_a) == len(flat_b)
        for a, b in zip(flat_a, flat_b):
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert type(a) is type(b) and a == b
    plain = make_window_solver(dataclasses.replace(tcfg, collect_intermediate=False), CPU)(
        pb.window_at(tb, 0), tcfg.zero_pyramid(device=CPU), True)
    with pytest.raises(ValueError, match="structure"):
        pb.stack_results([r0, plain])


def test_sequence_schedules_with_collect_intermediate():
    """tests/test_parallel.py:140-171: with collect_intermediate and a
    solved handover level both schedules stack first and later windows'
    histories (window 0 records an empty one)."""
    _, tcfg = tiny_cfgs(collect_intermediate=True,
                        handover=dict(use_handover=True, solve_handover_for_levels=(0,)))
    _, tb = both_batches(tiny_arrays(8))
    res_tp, final_tp = pb.two_pass_sequence_solve(tcfg, tb)
    res_ss, final_ss = pb.sequence_shard_solve(tcfg, tb, pb.make_window_mesh(device=CPU))
    for res, final in ((res_tp, final_tp), (res_ss, final_ss)):
        assert torch.isfinite(final[0]).all()
        h0 = res.handover_histories[0]
        assert h0.xs.shape[0] == 8
        assert int(h0.n[0]) == 0 and int(h0.n[1]) > 0


def test_window_stats_record_every_solve():
    _, tcfg = tiny_cfgs()
    _, tb = both_batches(tiny_arrays(3))
    stats = []
    res, _ = pb.two_pass_sequence_solve(tcfg, tb, window_stats=stats)
    # pass 1 of windows 0-1 (window 2's pass-1 final would feed no one),
    # pass 2 of windows 1-2 (window 0 keeps pass 1)
    assert [(s["window"], s["pass"]) for s in stats] == [(0, 1), (1, 1), (1, 2), (2, 2)]
    assert [s["host_syncs"] for s in stats[2:]] == res.n_host_syncs[1:].tolist()
    assert all(s["ms"] > 0 and s["evals"] > 0 for s in stats)


@pytest.mark.parametrize("with_boundary", [False, True], ids=["first", "boundary"])
def test_two_pass_one_window_matches_jax(with_boundary):
    """One window: without a carry its pass 1 is the whole record; with
    one, only its pass 2 from the carry is solved."""
    jcfg, tcfg = tiny_cfgs()
    jb, tb = both_batches(tiny_arrays(1))
    bp = boundary_prior(tcfg) if with_boundary else None
    ref, _ = jpb.two_pass_sequence_solve(
        jcfg, jb, boundary_prior=None if bp is None else [jnp.asarray(p) for p in bp])
    stats = []
    got, _ = pb.two_pass_sequence_solve(
        tcfg, tb, boundary_prior=None if bp is None else [torch.as_tensor(p) for p in bp],
        window_stats=stats)
    assert [(s["window"], s["pass"]) for s in stats] == [(0, 2 if with_boundary else 1)]
    assert_pyramids_close(ref.final_theta_pyr, got.final_theta_pyr)
    assert_pyramids_close(ref.prior_theta_pyr, got.prior_theta_pyr)


# ---- the mesh and the configuration ------------------------------------------------

def test_make_window_mesh_rejects_oversized():
    with pytest.raises(ValueError, match="only 1 rank"):
        pb.make_window_mesh(16, device=CPU)
    assert pb.make_window_mesh(1, device=CPU) == pb.WindowMesh(1, 0, CPU)


def test_make_window_mesh_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.make_window_mesh()


def test_distributed_config_plumbing():
    """tests/test_parallel.py:223-245, and the config dict equal to the JAX
    package's."""
    from eincm_tpu.experiments.config import ExperimentConfig as JExperimentConfig
    from eincm_tpu_torch.experiments.config import ExperimentConfig
    from eincm_tpu_torch.parallel.distributed import DistributedConfig, initialize_distributed

    # disabled: a no-op that never touches the rendezvous
    assert initialize_distributed(DistributedConfig(enable=False)) is False
    d = {"distributed": {"enable": False, "coordinator_address": "localhost:1234",
                         "num_processes": 2, "process_id": 0, "local_device_ids": [0]}}
    cfg = ExperimentConfig.from_dict(d)
    assert cfg.distributed.coordinator_address == "localhost:1234"
    assert cfg.to_dict()["distributed"]["num_processes"] == 2
    assert cfg.to_dict()["distributed"] == JExperimentConfig.from_dict(d).to_dict()["distributed"]
