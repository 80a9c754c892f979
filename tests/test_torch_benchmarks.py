"""The port's benchmark functions (eincm_tpu_torch/utils/benchmarks.py)
against the JAX package's (eincm_tpu/utils/benchmarks.py), on the CPU.

The staged MVSEC windows: the same GT velocities, edge maps within 1e-6,
the same events as a multiset (the JAX staging row-sorts them, the port's
keeps loader order). The chained-solve benches run at a small sensor
(their size constants monkeypatched in both packages) with
tests/test_benchmarks.py's tiny solver overrides; the warmup window's AEE
is held within 0.05 px of the JAX bench's. One throughput frame is held
to the JAX package's warp + XLA splat. The batched bench shrinks its mesh
of 4 gloo processes to 3 for 6 windows.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eincm_tpu_torch.utils import benchmarks as tb

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SMALL = dict(MVSEC_H=48, MVSEC_W=64, MVSEC_N_EVENTS=2000)
TINY = {  # tests/test_benchmarks.py's overrides
    "theta_opt_maxiters": (1, 1, 1, 1, 1),
    "handover_opt_maxiters": (2, 2, 2, 2, 2),
    "n_extra_attempts": {},
}
TOL_AEE = 0.05  # px
TOL_FRAME = 1e-5  # x max |frame|, float32 sums in another order
DIAG = re.compile(r"total_iters/level=\[.*\] \(sum \d+\) attempts/level=\[.*\] "
                  r"ls_probes=-?\d+ f0=\S+ theta0_mean=\[.*\]")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    """Both packages' MVSEC constants at a small sensor."""
    import eincm_tpu.utils.benchmarks as jb

    for mod in (jb, tb):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def _finite_events(w):
    xs, ys, ts = (np.asarray(a, np.float64) for a in (w.xs, w.ys, w.ts))
    keep = np.isfinite(xs)
    ev = np.stack([xs[keep], ys[keep], ts[keep]], 1)
    return ev[np.lexsort((ev[:, 2], ev[:, 0], ev[:, 1]))]


def test_stage_mvsec_windows_matches_jax():
    from eincm_tpu.utils.benchmarks import stage_mvsec_windows as jax_stage

    jw, jv = jax_stage(n_windows=2, rotate_deg=15.0)
    tw, tv = tb.stage_mvsec_windows(2, 15.0, device="cpu")
    assert len(tw) == 2 and tv == jv and not np.allclose(tv[0], tv[1])
    for j, t, vel in zip(jw, tw, tv):
        assert t.xs.shape == (tb.MVSEC_N_EVENTS,) and t.xs.device == CPU
        assert t.edges.shape == (2, tb.MVSEC_H, tb.MVSEC_W)
        np.testing.assert_allclose(t.edges.numpy(), np.asarray(j.edges), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t.edge_ts.numpy(), np.asarray(j.edge_ts))
        np.testing.assert_array_equal(_finite_events(t), _finite_events(j))
        assert np.isclose(np.hypot(*vel), 5.0)


def test_default_edges_are_the_iedt_edge_fn():
    """benchmarks stages with EdgeConfig(eincm_iedt, no preprocessing), the
    JAX module's edge function; utils/workloads.py staged with
    edge.pipeline.iedt_edge_fn before: the same maps, bitwise."""
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
    from eincm_tpu_torch.edge.pipeline import iedt_edge_fn

    dl = SyntheticDataLoader(sensor_size=(64, 80), n_windows=1, des_n_events=2000,
                             velocity=(4.0, -3.0), n_features=40, seed=1)
    dl.get_ready()
    images = np.asarray(dl[0]["images"], np.float64)
    np.testing.assert_array_equal(tb._default_edge_cfg().make_edge_fn()(images),
                                  iedt_edge_fn()(images))


def test_benches_refuse_unknown_impls_and_a_missing_card():
    with pytest.raises(ValueError, match="interp_impl 'triton'"):
        tb.build_mvsec_solve_bench("triton", device="cpu")
    with pytest.raises(ValueError, match="splat_impl 'banded'"):
        tb.build_dsec_throughput_bench(splat_impl="banded", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tb.stage_mvsec_windows(1)


def _aee(theta0, window, vel, sensor):
    from eincm_tpu_torch.utils.workloads import aee_at_events

    return aee_at_events(torch.as_tensor(np.asarray(theta0)), window, vel, sensor)


def test_build_mvsec_solve_bench_matches_jax(small):
    """tests/test_benchmarks.py's tiny run through both packages' benches: dt > 0,
    the diagnostic's fields, a finite warmup solve whose AEE is within
    TOL_AEE of the JAX bench's."""
    import eincm_tpu.ops.splat as jsplat
    import eincm_tpu.utils.benchmarks as jb

    impl = jsplat.get_splat_impl()
    try:
        j_round, jres = jb.build_mvsec_solve_bench(n_windows=2, solver_overrides=TINY)
    finally:
        jsplat.set_splat_impl(impl)
    t_round, tres = tb.build_mvsec_solve_bench(n_windows=2, solver_overrides=TINY, device="cpu")
    assert t_round() > 0.0
    jd, td = jb.solve_diag_str(jres), tb.solve_diag_str(tres)
    assert DIAG.fullmatch(jd) and DIAG.fullmatch(td), (jd, td)
    assert np.isfinite(float(tres.theta_opt_states[0].fun_val))
    assert torch.isfinite(tres.final_theta_pyr[0]).all()
    windows, vels = tb.stage_mvsec_windows(2, device="cpu")
    sensor = (SMALL["MVSEC_H"], SMALL["MVSEC_W"])
    t_aee = _aee(tres.final_theta_pyr[0], windows[1], vels[1], sensor)
    j_aee = _aee(jres.final_theta_pyr[0], windows[1], vels[1], sensor)
    assert abs(t_aee - j_aee) <= TOL_AEE, (t_aee, j_aee)


def test_build_dsec_solve_bench_runs(monkeypatch):
    monkeypatch.setattr(tb, "DSEC_H", 48)
    monkeypatch.setattr(tb, "DSEC_W", 64)
    monkeypatch.setattr(tb, "DSEC_N_EVENTS", 3000)
    one_round, res = tb.build_dsec_solve_bench(n_windows=2, solver_overrides=TINY,
                                               device="cpu")
    assert one_round() > 0.0
    assert DIAG.fullmatch(tb.solve_diag_str(res))
    assert res.final_theta_pyr[0].shape == (16, 16, 2)


def test_throughput_frame_matches_jax(monkeypatch):
    """One iteration's IWEs at a small sensor: the port's interp + warp +
    splat against the JAX package's warp_events_multi_ref_coarse and XLA
    splat_multi_ref on the same draw."""
    import jax.numpy as jnp

    import eincm_tpu.ops.splat as jsplat
    from eincm_tpu.ops.warp import warp_events_multi_ref_coarse as jwarp
    from eincm_tpu_torch.ops.splat import splat_multi_ref
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    for k, v in dict(DSEC_H=48, DSEC_W=64, DSEC_N_EVENTS=20_000).items():
        monkeypatch.setattr(tb, k, v)
    inp = tb.throughput_inputs(CPU)
    sensor = (48, 64)
    wx, wy = warp_events_multi_ref_coarse(inp["theta"], inp["xs"], inp["ys"], inp["ts"],
                                          inp["t_refs"], sensor)
    got = splat_multi_ref(wx, wy, sensor).numpy()
    impl = jsplat.get_splat_impl()
    jsplat.set_splat_impl("xla")
    try:
        jx, jy = jwarp(*(jnp.asarray(inp[k].numpy()) for k in ("theta", "xs", "ys", "ts",
                                                               "t_refs")), sensor)
        ref = np.asarray(jsplat.splat_multi_ref(jx, jy, sensor))
    finally:
        jsplat.set_splat_impl(impl)
    assert got.shape == ref.shape == (2, 48, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_FRAME * np.abs(ref).max())
    one_round = tb.build_dsec_throughput_bench(device="cpu")
    assert one_round() > 0.0
    assert float(tb.warp_splat(inp, 0.0)) == pytest.approx(float(got.sum()), rel=1e-5)


def test_parallel_solve_bench_one_member(small):
    one_round, res = tb.build_parallel_solve_bench(n_windows=2, solver_overrides=TINY,
                                                   device="cpu")
    assert one_round.mesh.size == 1 and one_round() > 0.0
    assert res.final_theta_pyr[0].shape == (2, 16, 16, 2)
    assert DIAG.fullmatch(tb.solve_diag_str(res))


def test_parallel_solve_bench_shrinks_the_mesh(tmp_path, small):
    """6 windows over 4 gloo processes: a mesh of the first 3 ranks, each
    solving its 2 windows; rank 3 solves none and still returns all 6,
    equal on every rank and to the one-member solve of the same windows."""
    from test_torch_distributed import _free_port, launch

    coord = f"127.0.0.1:{_free_port()}"
    runs = launch([[sys.executable, __file__, coord, "4", str(r), str(tmp_path)]
                   for r in range(4)])
    for rc, _, err in runs:
        assert rc == 0, err[-4000:]
    reports = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in runs]
    assert [r["mesh"] for r in reports] == [[3, 0], [3, 1], [3, 2], [3, None]]
    assert [r["windows"] for r in reports] == [[0, 1], [2, 3], [4, 5], []]
    finals = [np.load(tmp_path / f"final_{r}.npy") for r in range(4)]
    assert finals[0].shape == (6, 16, 16, 2)
    for f in finals[1:]:
        np.testing.assert_array_equal(f, finals[0])
    _, one = tb.build_parallel_solve_bench(n_windows=6, solver_overrides=TINY, device="cpu")
    ref = one.final_theta_pyr[0].numpy()
    assert np.abs(finals[0] - ref).max() <= 1e-6 * np.abs(ref).max()


def worker(coord, world, rank, out):
    """One rank of test_parallel_solve_bench_shrinks_the_mesh."""
    from datetime import timedelta

    from eincm_tpu_torch.parallel import batch as pb
    from eincm_tpu_torch.parallel.distributed import DistributedConfig, initialize_distributed

    torch.set_num_threads(1)
    cfg = DistributedConfig(enable=True, coordinator_address=coord, num_processes=world,
                            process_id=rank)
    assert initialize_distributed(cfg, timeout=timedelta(seconds=180))
    for k, v in SMALL.items():
        setattr(tb, k, v)
    staged = []
    stage = tb.stage_mvsec_samples
    tb.stage_mvsec_samples = lambda idx, *a, **kw: staged.extend(idx) or stage(idx, *a, **kw)
    solved = []
    one = pb._solve_one
    pb._solve_one = lambda *a: solved.append(a[4][0]) or one(*a)
    one_round, res = tb.build_parallel_solve_bench(n_windows=6, solver_overrides=TINY,
                                                   device="cpu")
    assert sorted(set(solved)) == sorted(staged)
    assert one_round() > 0.0
    np.save(Path(out) / f"final_{rank}.npy", res.final_theta_pyr[0].numpy())
    mesh = one_round.mesh
    print(json.dumps({"mesh": [mesh.size, mesh.rank], "windows": sorted(set(solved))}))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
