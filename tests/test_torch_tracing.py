"""The port's spans and counters (`eincm_tpu_torch/utils/profiling.py`) on
the CPU at a tiny size: BFGS's reads by cause add up to the solve's host
syncs; `loss.evals` counts every `solver_loss` call made (the golden
section's and the prior loss's included, the `+1` of a failed Armijo
search left out); under a profiler every span appears, nested as
documented, and the solve is bitwise the one without it; without a
profiler no `RecordFunction` is made; and the benchmark's
`python_idle_pct` reads the spans' gaps."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from eincm_tpu_torch import compat
from eincm_tpu_torch.models import bfgs
from eincm_tpu_torch.models import graphs as tg
from eincm_tpu_torch.models import loss as tl
from eincm_tpu_torch.models import pyramid as tp
from eincm_tpu_torch.utils import host, profiling

REPO = Path(__file__).resolve().parent.parent
SENSOR = (24, 32)
SPANS = ("eincm.window", "eincm.statics", "eincm.level0", "eincm.level1", "eincm.bfgs",
         "eincm.linesearch", "eincm.loss", "eincm.grad", "eincm.handover", "eincm.read")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(seed=7, n=400):
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    arrays = [
        rng.integers(0, w, n).astype(np.float64),
        rng.integers(0, h, n).astype(np.float64),
        np.sort(rng.uniform(0, 1, n)),
        rng.uniform(0, 1, (2, h, w)),
        np.array([0.0, 1.0]),
    ]
    prior = [rng.normal(0, 1, (2, 2, 2)), rng.normal(0, 1, (1, 1, 2))]
    return (compat.window_sample_from_numpy(*arrays, device="cpu"),
            compat.theta_pyramid_from_numpy(prior))


def _cfg(**kw):
    return tp.SolverConfig(
        n_pyr_lvls=2, sensor_size=SENSOR, params=tp.LossParams(20.0, 35.0),
        theta_opt_maxiters=(5, 4), n_extra_attempts={0: 1}, compute_prior_loss=True,
        handover=tp.HandoverSettings(solve_handover_for_levels=(0,)), **kw,
    )


def _solve(cfg, first):
    sample, prior = _window()
    if first:
        prior = cfg.zero_pyramid(torch.float64, device="cpu")
    return tp.make_window_solver(cfg, "cpu")(sample, prior, first)


def _same(a, b):
    """Two SolveResults bitwise equal: thetas, weights, states."""
    for x, y in zip(a.final_theta_pyr + a.pre_handover_theta_pyr + a.final_handover_weights,
                    b.final_theta_pyr + b.pre_handover_theta_pyr + b.final_handover_weights):
        assert torch.equal(x, y)
    for s, t in zip(a.theta_opt_states, b.theta_opt_states):
        assert (s.status, s.iter_num, s.total_iters, s.n_fun_evals, s.n_attempts,
                s.n_host_syncs) == (t.status, t.iter_num, t.total_iters, t.n_fun_evals,
                                    t.n_attempts, t.n_host_syncs)
        assert torch.equal(s.fun_val, t.fun_val) and torch.equal(s.grad, t.grad)
    assert torch.equal(a.prior_loss_lvl0, b.prior_loss_lvl0)
    assert a.n_host_syncs == b.n_host_syncs


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
@pytest.mark.parametrize("first", [True, False], ids=["first", "handover"])
def test_bfgs_reads_by_cause_add_up_to_the_solves_host_syncs(first, line_search):
    before = profiling.counters()
    res = _solve(_cfg(line_search=line_search), first)
    spent = profiling.since(before)
    assert spent["bfgs.reads.probe"] + spent["bfgs.reads.status"] == res.n_host_syncs
    # one status read a solve and one an iteration, at every level
    assert spent["bfgs.reads.status"] == sum(s.total_iters + 1 for s in res.theta_opt_states)
    # the solve reads nothing else
    assert spent["host.reads"] == res.n_host_syncs
    assert spent["host.read_wait_ns"] > 0


@pytest.mark.parametrize("first", [True, False], ids=["first", "handover"])
def test_loss_evals_count_every_solver_loss_call(first, monkeypatch):
    """Every call of `solver_loss`, as a wrapper around it counts them:
    BFGS's probes and gradients, the golden section's probes and the prior
    loss; `loss.grad_evals` the calls that ran a backward."""
    calls = {"all": 0, "grad": 0}
    real = tl.solver_loss

    def wrapped(theta, *args):
        calls["all"] += 1
        calls["grad"] += bool(theta.requires_grad)
        return real(theta, *args)

    # the pyramid's every loss call goes through `graphs.loss_functions`
    monkeypatch.setattr(tg, "solver_loss", wrapped)
    in_handover = []
    real_ho = tp._solve_handover_weight

    def handover(*args):
        n0 = profiling.counters().get("loss.evals", 0)
        out = real_ho(*args)
        in_handover.append(profiling.counters()["loss.evals"] - n0)
        return out

    monkeypatch.setattr(tp, "_solve_handover_weight", handover)
    cfg = _cfg()
    before = profiling.counters()
    res = _solve(cfg, first)
    spent = profiling.since(before)
    assert spent["loss.evals"] == calls["all"]
    assert spent["loss.grad_evals"] == calls["grad"]
    assert spent["loss.dispatch_ns"] > 0
    n_fun = sum(s.n_fun_evals for s in res.theta_opt_states)
    golden = 2 + 2 + cfg.handover_opt_maxiters[0]
    if first:
        assert in_handover == []
        extra = 0
    else:
        assert in_handover == [golden]
        extra = golden + 1  # and the prior loss
    # n_fun_evals counts one evaluation more for every failed Armijo search
    iters = sum(s.total_iters for s in res.theta_opt_states)
    assert 0 <= n_fun + extra - spent["loss.evals"] <= iters


def test_a_failed_armijo_search_makes_no_evaluation_of_its_own():
    """c1 near 1 fails the first Armijo search; with no retry the solve
    stops there (status 2): `n_fun_evals` counts one evaluation more than
    `solver_loss` was called, and every successful search made one
    gradient."""
    sample, _ = _window()
    cfg = _cfg()
    wstat = tp.compute_window_statics(sample.xs, sample.ys, sample.edges, SENSOR)

    def fun(flat):
        return tl.solver_loss(flat.reshape(2, 2, 2), sample.xs, sample.ys, sample.ts,
                              sample.edges, sample.edge_ts, cfg.params, 0,
                              cfg.loss_statics, wstat)

    before = profiling.counters()
    x0 = torch.full((8,), 0.5, dtype=torch.float64)
    res = bfgs.minimize_bfgs(bfgs.value_and_grad(fun), x0, maxiter=5, c1=0.9999,
                             max_ls_evals=2, line_search="armijo", fun=fun)
    spent = profiling.since(before)
    assert res.status == 2 and res.n_attempts == 1
    assert spent["loss.evals"] == res.n_fun_evals - 1
    assert spent["loss.grad_evals"] == res.total_iters  # the first, then one a success
    assert spent["bfgs.reads.probe"] + spent["bfgs.reads.status"] == res.n_host_syncs


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("eincm.")]


def _inside(ev, outers):
    return any(s <= ev[1] and ev[2] <= e for _, s, e in outers)


def test_spans_appear_and_nest_under_a_profiler(tmp_path):
    cfg = _cfg()
    before = profiling.counters()
    with profiling.trace(tmp_path) as prof:
        res = _solve(cfg, False)
    spent = profiling.since(before)
    ev = _events(prof)
    names = {n for n, _, _ in ev}
    assert set(SPANS) <= names, sorted(names)
    assert names <= set(SPANS)
    by = {n: [e for e in ev if e[0] == n] for n in names}
    levels = by["eincm.level0"] + by["eincm.level1"]
    assert len(by["eincm.window"]) == 1 and len(levels) == 2
    assert all(_inside(e, by["eincm.window"]) for e in levels + by["eincm.statics"])
    # every loss in a level but one: the prior loss, in the window itself
    outside = [e for e in by["eincm.loss"] if not _inside(e, levels)]
    assert len(outside) == 1 and _inside(outside[0], by["eincm.window"])
    assert not _inside(outside[0], by["eincm.statics"])
    assert all(_inside(e, levels) for e in by["eincm.grad"] + by["eincm.bfgs"])
    assert all(_inside(e, by["eincm.bfgs"]) for e in by["eincm.linesearch"])
    assert all(_inside(e, by["eincm.level0"]) for e in by["eincm.handover"])
    assert len(by["eincm.bfgs"]) == sum(s.total_iters for s in res.theta_opt_states)
    assert len(by["eincm.read"]) == res.n_host_syncs
    assert len(by["eincm.loss"]) == spent["loss.evals"]
    assert len(by["eincm.grad"]) == spent["loss.grad_evals"]
    assert sum(_inside(e, by["eincm.handover"]) for e in by["eincm.loss"]) == 2 + 2 + 15


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_a_solve_under_the_profiler_is_bitwise_the_one_without(tmp_path, line_search):
    cfg = _cfg(line_search=line_search)
    plain = _solve(cfg, False)
    with profiling.trace(tmp_path):
        traced = _solve(cfg, False)
    _same(plain, traced)


def test_without_a_profiler_annotate_makes_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("eincm.x") is profiling.annotate("eincm.y")
    res = _solve(_cfg(), False)
    assert res.n_host_syncs > 0


def test_to_host_takes_one_argument_and_counts_its_read():
    before = profiling.counters()
    assert host.to_host(torch.tensor([1.0, 2.0])) == [1.0, 2.0]
    spent = profiling.since(before)
    assert spent["host.reads"] == 1 and spent["host.read_wait_ns"] >= 0


def test_counters_snapshot_and_reset(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", type(profiling._COUNTS)(int))
    profiling.count("a")
    profiling.count("a", 4)
    snap = profiling.counters()
    assert snap == {"a": 5}
    profiling.count("b")
    assert snap == {"a": 5}  # a snapshot, not a view
    assert profiling.since(snap) == {"a": 0, "b": 1}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_counters_lose_no_count_across_threads(monkeypatch):
    """Eight threads, each adding through `count` and a `spanned`
    function, with the interpreter switching threads every microsecond:
    no increment is lost."""
    import sys
    import threading

    monkeypatch.setattr(profiling, "_COUNTS", type(profiling._COUNTS)(int))
    fn = profiling.spanned("eincm.t", "t.calls", "t.ns")(lambda: None)

    def work():
        for _ in range(2000):
            profiling.count("t.adds")
            fn()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = profiling.counters()
    assert got["t.adds"] == got["t.calls"] == 8 * 2000


def _python_idle_pct():
    path = REPO / "benchmark" / "metrics" / "python_idle_pct.py"
    spec = importlib.util.spec_from_file_location("python_idle_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("gaps, expected", [
    ([["solve/eincm.bfgs", 0.3], ["solve/cudaMemcpyAsync", 0.5],
      ["solve/eincm.loss", 0.15], ["-/eincm.window", 0.05], ["solve/-", 0.02]], 25.0),
    ([["solve/-", 0.574], ["solve/cudaLaunchKernel", 0.42]], None),
    ([], None),
])
def test_python_idle_pct_reads_the_spans_gaps(gaps, expected):
    read = _python_idle_pct()
    run = SimpleNamespace(trace={"span_s": 2.0, "busy_s": 1.0, "idle_gaps": gaps})
    got = read(run)
    assert got == expected if expected is None else got == pytest.approx(expected)
    assert read(SimpleNamespace(trace=None)) is None
