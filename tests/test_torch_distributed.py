"""The port's schedules over real processes: torch.distributed with gloo
on the CPU.

Each test starts 2 or 4 processes of this file (`python
tests/test_torch_distributed.py <coordinator> <world> <rank> <job>`), each
with one torch thread, joined through `parallel/distributed.py`'s
`initialize_distributed` (a TCP rendezvous on a free 127.0.0.1 port); rank
r holds only its chunk of the windows. The results must equal the
one-member (in-process) results of the same schedule within 1e-6 relative,
with the same per-window iterations; the 4-rank sequence-sharded schedule
is held to the JAX package's `solve_window` composed in that schedule's
order. A test kills every process it started, whatever happens.
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
H = W = 16
N_EVENTS = 128
TOL_REL = 1e-6
RTOL, ATOL = 1e-2, 5e-3  # float32 against JAX, tests/test_parallel.py:76-80
TIMEOUT_S = 180


def tiny_cfg():
    """tests/test_parallel.py's tiny_cfg, for the port."""
    from eincm_tpu_torch.models.loss import LossParams
    from eincm_tpu_torch.models.pyramid import HandoverSettings, SolverConfig

    return SolverConfig(
        n_pyr_lvls=2, sensor_size=(H, W), params=LossParams(alpha=10.0, beta=5.0),
        theta_opt_maxiters=(3, 3),
        handover=HandoverSettings(use_handover=True, alpha_handover=0.4), max_ls_evals=5,
    )


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


def run_schedule(schedule, batch, mesh, stats=None):
    """One of the library's schedules, first-sample semantics, no carry."""
    from eincm_tpu_torch.parallel import batch as pb

    cfg = tiny_cfg()
    if schedule == "batch_sharded":
        return pb.solve_window_batch_sharded(cfg, batch, mesh, window_stats=stats)
    fn = pb.two_pass_sequence_solve if schedule == "two_pass" else pb.sequence_shard_solve
    return fn(cfg, batch, mesh, window_stats=stats)[0]


def summary(res) -> dict:
    """What the tests compare: every level's final theta, the per-window
    iterations, statuses and host syncs."""
    out = {f"final_{l}": p.numpy() for l, p in enumerate(res.final_theta_pyr)}
    out["iters"] = np.stack([s.iter_num.numpy() for s in res.theta_opt_states])
    out["status"] = np.stack([s.status.numpy() for s in res.theta_opt_states])
    out["host_syncs"] = res.n_host_syncs.numpy()
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the worker ----------------------------------------------------------------

def worker(coord, world, rank, job):
    """Join the group, run `job`'s schedule on this rank's chunk; rank 0
    writes the gathered result's summary to `job["out"]`."""
    torch.set_num_threads(1)
    from eincm_tpu_torch.models.pyramid import WindowSample
    from eincm_tpu_torch.parallel import batch as pb
    from eincm_tpu_torch.parallel.distributed import (
        DistributedConfig, initialize_distributed, is_multi_process)

    cfg = DistributedConfig(enable=True, coordinator_address=coord,
                            num_processes=world, process_id=rank)
    assert initialize_distributed(cfg, timeout=timedelta(seconds=TIMEOUT_S))
    assert initialize_distributed(cfg)  # a second call keeps the group
    assert is_multi_process()
    arrays = tiny_arrays(job["b"], job["seed"])
    chunk = job["b"] // world
    local = WindowSample(**{k: torch.as_tensor(v[rank * chunk : (rank + 1) * chunk])
                            for k, v in arrays.items()})
    mesh = pb.make_window_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    if job.get("die_rank") == rank:
        sys.exit(3)  # a rank dying before the exchange
    stats = []
    res = run_schedule(job["schedule"], local, mesh, stats)
    if rank == 0:
        np.savez(job["out"], **summary(res))
    print(json.dumps({"rank": rank, "windows": sorted({s["window"] for s in stats}),
                      "solves": [[s["window"], s["pass"]] for s in stats]}))


# ---- launching -------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def launch(argvs):
    """Run one process per argv; (returncode, stdout, stderr) each. A
    process still running when another has failed, or at the timeout, is
    killed."""
    procs = [subprocess.Popen(a, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argvs]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def run_ranks(world, job):
    coord = f"127.0.0.1:{_free_port()}"
    return launch([[sys.executable, __file__, coord, str(world), str(r), json.dumps(job)]
                   for r in range(world)])


def expected_solves(schedule, world, b):
    """(window, pass) of each rank's solves: nothing lockstep SPMD would
    discard. sequence_shard: rank 0 its chunk's pass 1, the last rank its
    pass 2 alone, the others both; two_pass: pass 1 of every window but the
    last, whose final would go to no rank, pass 2 of every window but 0."""
    per = b // world
    out = []
    for r in range(world):
        mine = range(r * per, (r + 1) * per)
        if schedule == "batch_sharded":
            out.append([[w, 1] for w in mine])
        elif schedule == "sequence_shard":
            out.append(([[w, 1] for w in mine] if r < world - 1 else [])
                       + ([[w, 2] for w in mine] if r > 0 else []))
        else:
            out.append([[w, 1] for w in mine if w < b - 1] + [[w, 2] for w in mine if w > 0])
    return out


def ranks_result(tmp_path, world, schedule, b=8, seed=0):
    out = tmp_path / "result.npz"
    runs = run_ranks(world, dict(schedule=schedule, b=b, seed=seed, out=str(out)))
    for rc, _, err in runs:
        assert rc == 0, err[-4000:]
    reports = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in runs]
    per = b // world
    assert [r["windows"] for r in reports] == [list(range(r * per, (r + 1) * per))
                                               for r in range(world)]
    assert [r["solves"] for r in reports] == expected_solves(schedule, world, b)
    return dict(np.load(out))


def in_process(schedule, b=8, seed=0):
    from eincm_tpu_torch.models.pyramid import WindowSample
    from eincm_tpu_torch.parallel import batch as pb

    batch = WindowSample(**{k: torch.as_tensor(v) for k, v in tiny_arrays(b, seed).items()})
    return summary(run_schedule(schedule, batch, pb.make_window_mesh(device="cpu")))


def assert_same(got, ref, windows=slice(None)):
    for key, r in ref.items():
        g = got[key]
        if key.startswith("final_"):
            g, r = g[windows], r[windows]
            scale = max(float(np.abs(r).max()), 1e-30)
            assert float(np.abs(g - r).max()) <= TOL_REL * scale, key
        elif key != "host_syncs":
            np.testing.assert_array_equal(g[:, windows], r[:, windows], err_msg=key)


# ---- the tests --------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["batch_sharded", "two_pass", "sequence_shard"])
def test_two_ranks_match_one_member(tmp_path, schedule):
    """Two ranks give the one-member results. For sequence_shard that is
    the exact sequential chain: rank 0 keeps its pass-1 chunk (the chain's
    windows 0-3), so rank 1's boundary prior is the chain's window 3."""
    got = ranks_result(tmp_path, 2, schedule)
    ref = in_process(schedule)
    assert_same(got, ref)
    if schedule != "sequence_shard":  # the same solves, so the same reads
        np.testing.assert_array_equal(got["host_syncs"], ref["host_syncs"])


def test_four_ranks_sequence_shard_matches_jax_composition(tmp_path):
    """4 ranks x 2 windows against the JAX package's solve_window composed
    in the schedule's order: pass 1 (chunk-first windows first-sample),
    each chunk's pass-1 final passed to the next, pass 2 from it, chunk 0's
    pass 1 kept. Rank 0's chunk is also the port's sequential chain."""
    import jax.numpy as jnp

    from eincm_tpu.models.loss import LossParams
    from eincm_tpu.models.pyramid import (
        HandoverSettings, SolverConfig, WindowSample, make_window_solver)

    got = ranks_result(tmp_path, 4, "sequence_shard")
    assert_same(got, in_process("sequence_shard"), windows=slice(0, 2))

    cfg = SolverConfig(
        n_pyr_lvls=2, sensor_size=(H, W), params=LossParams(alpha=10.0, beta=5.0),
        theta_opt_maxiters=(3, 3),
        handover=HandoverSettings(use_handover=True, alpha_handover=0.4), max_ls_evals=5,
    )
    arrays = tiny_arrays(8)
    win = [WindowSample(**{k: jnp.asarray(v[i]) for k, v in arrays.items()}) for i in range(8)]
    solve = make_window_solver(cfg)  # solve_window, jitted

    def chain(chunk, prior):
        out = []
        for i in (2 * chunk, 2 * chunk + 1):
            first = prior is None
            res = solve(win[i], cfg.zero_pyramid() if first else prior, first)
            prior = res.final_theta_pyr
            out.append(res)
        return out

    pass1 = [chain(c, None) for c in range(4)]
    kept = pass1[0] + [r for c in range(1, 4) for r in chain(c, pass1[c - 1][-1].final_theta_pyr)]
    for lvl in range(cfg.n_pyr_lvls):
        ref = np.stack([np.asarray(r.final_theta_pyr[lvl]) for r in kept])
        np.testing.assert_allclose(got[f"final_{lvl}"], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"level {lvl}")


def test_a_dead_rank_fails_the_run(tmp_path):
    """Rank 1 exits before the boundary exchange: rank 0 fails (gloo
    reports the closed connection) instead of waiting; nothing catches it."""
    runs = run_ranks(2, dict(schedule="sequence_shard", b=4, seed=0, die_rank=1,
                             out=str(tmp_path / "r.npz")))
    assert runs[1][0] == 3
    assert runs[0][0] != 0
    assert not (tmp_path / "r.npz").exists()


CLI = [
    "--device", "cpu", "dataset.kind=synthetic", "dataset.sensor_size=[32, 32]",
    "dataset.des_n_events=1024", "dataset.n_windows=5", "dataset.velocity=[2.0, -1.0]",
    "solver.n_pyr_lvls=3", "solver.theta_maxiter=6", "solver.theta_miniter=3",
    "solver.handover_maxiter=5", "solver.max_ls_evals=6", "alpha=60", "beta=0",
    "edge.enable_image_preprocessing=false", "phases.plot=false",
    "phases.parallel_windows=true", "phases.parallel_mode=sequence_shard",
    "phases.parallel_eval=true",
]


def test_two_rank_cli(tmp_path):
    """The CLI with explicit distributed keys on two processes: rank 0
    writes opt_results.npz with all 5 windows (padded to 6 over 2 ranks),
    eval_results.npz and scores.txt; rank 1 writes nothing. Every window
    equals a one-process run's: over two ranks sequence_shard is the exact
    chain (test_two_ranks_match_one_member)."""
    coord = f"127.0.0.1:{_free_port()}"
    dist_args = ["distributed.enable=true", f"distributed.coordinator_address={coord}",
                 "distributed.num_processes=2", "distributed.local_device_ids=[0]"]
    runs = launch([
        [sys.executable, "-m", "eincm_tpu_torch.experiments", *CLI, *dist_args,
         f"distributed.process_id={r}", f"output_dir={tmp_path / f'rank{r}'}"]
        for r in range(2)
    ])
    for rc, _, err in runs:
        assert rc == 0, err[-4000:]
    assert "process 0/2 (gloo)" in runs[0][1]
    assert not (tmp_path / "rank1").exists() or not [p for p in (tmp_path / "rank1").rglob("*")
                                                      if p.is_file()]
    out = tmp_path / "rank0" / "eincm"
    assert {p.name for p in out.iterdir() if p.is_file()} == {
        "opt_results.npz", "eval_results.npz", "scores.txt"}

    from eincm_tpu_torch.experiments.__main__ import main
    from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader

    one = main([*CLI, f"output_dir={tmp_path / 'one'}", "phases.eval=false"])
    two = EINCMOutputLoader().load_opt_results(out / "opt_results.npz")
    assert sorted(two) == sorted(one.opt_results) == [f"datasample_idx_{i}" for i in range(5)]
    for key in two:
        np.testing.assert_allclose(
            two[key]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"],
            one.opt_results[key]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"],
            rtol=TOL_REL, atol=0)
    ev = EINCMOutputLoader().load_eval_results(out / "eval_results.npz")
    assert all(np.isfinite(float(ev[k]["evals"]["AEE"])) for k in ev) and len(ev) == 5


# ---- the runtime's contract, in one process ------------------------------------------

def test_initialize_distributed_env_and_tcp(monkeypatch):
    """With every rendezvous field None the group reads torchrun's
    variables; with explicit fields, tcp://. A one-process group is not
    multi-process; a second call keeps the group; a partial rendezvous
    raises."""
    import torch.distributed as dist

    from eincm_tpu_torch.parallel.distributed import (
        DistributedConfig, initialize_distributed, is_multi_process, process_info)

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize_distributed(DistributedConfig(enable=True, num_processes=1))
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                     WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    try:
        assert initialize_distributed(DistributedConfig(enable=True)) is False
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert initialize_distributed(DistributedConfig(enable=True)) is False
        assert not is_multi_process()
        assert process_info("cpu") == "process 0/1, device cpu, 1 local / 1 global devices"
    finally:
        dist.destroy_process_group()
    try:
        cfg = DistributedConfig(enable=True, coordinator_address=f"127.0.0.1:{_free_port()}",
                                num_processes=1, process_id=0)
        assert initialize_distributed(cfg, timeout=timedelta(seconds=30)) is False
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_rank_device(monkeypatch):
    """A rank's device: the one local device id, else LOCAL_RANK, else 0;
    an explicit device as given; more than one id raises."""
    from eincm_tpu_torch.parallel.distributed import DistributedConfig, rank_device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert rank_device(DistributedConfig()) == torch.device("cuda", 0)
    assert rank_device(DistributedConfig(local_device_ids=(1,))) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device(DistributedConfig()) == torch.device("cuda", 3)
    assert rank_device(DistributedConfig(local_device_ids=[2])) == torch.device("cuda", 2)
    assert rank_device(DistributedConfig(), "cuda:1") == torch.device("cuda", 1)
    assert rank_device(DistributedConfig(local_device_ids=(1,)), "cpu") == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="one device per process"):
        rank_device(DistributedConfig(local_device_ids=(0, 1)))


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4]))
