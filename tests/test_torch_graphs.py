"""The CUDA-graph cache of the loss (`eincm_tpu_torch/models/graphs.py`) on
the CPU: a CPU solve makes no graph and gives the answer of `solve_window`
without a cache; the keys; the window's buffers and the one window shape
whose graphs are kept; a key captured at its first evaluation and
replayed after, and a replay's counts; the launch tally of a capture; the
graph's own interp arrival counter; `profiling.uncounted`. The capture and
replay themselves run only on the card (`tests/test_torch_graphs_gpu.py`);
here a stand-in graph replays the eager loss."""

import numpy as np
import pytest
import torch

from eincm_tpu_torch import compat
from eincm_tpu_torch.models import graphs as tg
from eincm_tpu_torch.models import pyramid as tp
from eincm_tpu_torch.models.loss import LossParams, LossStatics, compute_window_statics
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import interp as ti
from eincm_tpu_torch.utils import profiling

SENSOR = (24, 32)
PARAMS = LossParams(20.0, 35.0)
STATICS = LossStatics(SENSOR, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one thread: the plain splat then adds in one order, so solves repeat
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(seed=7, n=400, dtype=np.float64):
    rng = np.random.default_rng(seed)
    h, w = SENSOR
    arrays = [
        rng.integers(0, w, n).astype(dtype),
        rng.integers(0, h, n).astype(dtype),
        np.sort(rng.uniform(0, 1, n)).astype(dtype),
        rng.uniform(0, 1, (2, h, w)).astype(dtype),
        np.array([0.0, 1.0], dtype),
    ]
    prior = [rng.normal(0, 1, (2, 2, 2)), rng.normal(0, 1, (1, 1, 2))]
    return (compat.window_sample_from_numpy(*arrays, device="cpu"),
            compat.theta_pyramid_from_numpy(prior))


def _cfg(**kw):
    return tp.SolverConfig(
        n_pyr_lvls=2, sensor_size=SENSOR, params=PARAMS,
        theta_opt_maxiters=(5, 4), n_extra_attempts={0: 1}, compute_prior_loss=True,
        handover=tp.HandoverSettings(solve_handover_for_levels=(0,)), **kw,
    )


def _same(a, b):
    for x, y in zip(a.final_theta_pyr + a.pre_handover_theta_pyr + a.final_handover_weights,
                    b.final_theta_pyr + b.pre_handover_theta_pyr + b.final_handover_weights):
        assert torch.equal(x, y)
    for s, t in zip(a.theta_opt_states, b.theta_opt_states):
        assert (s.status, s.total_iters, s.n_fun_evals, s.n_host_syncs) == (
            t.status, t.total_iters, t.n_fun_evals, t.n_host_syncs)
        assert torch.equal(s.fun_val, t.fun_val) and torch.equal(s.grad, t.grad)
    assert torch.equal(a.prior_loss_lvl0, b.prior_loss_lvl0)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_a_cpu_solver_makes_no_graph_and_solves_as_solve_window(line_search):
    """The solver of a CPU device keeps no cache; three windows (a first,
    then two handovers with one event count) capture and replay nothing
    and give `solve_window`'s answer, bit for bit."""
    cfg = _cfg(line_search=line_search)
    solver = tp.make_window_solver(cfg, "cpu")
    assert solver.graphs is None
    before = profiling.counters()
    prior_a = prior_b = cfg.zero_pyramid(torch.float64, device="cpu")
    for k in range(3):
        sample, _ = _window(seed=7 + k)
        got = solver(sample, prior_a, k == 0)
        ref = tp.solve_window(cfg, sample, prior_b, k == 0)
        _same(got, ref)
        prior_a, prior_b = got.final_theta_pyr, ref.final_theta_pyr
    spent = profiling.since(before)
    assert spent.get("loss.graph_replays", 0) == 0
    assert spent.get("loss.graph_captures", 0) == 0
    assert spent["loss.evals"] > 0


def test_loss_functions_stay_eager_on_cpu_tensors_with_a_cache():
    sample, _ = _window()
    wstat = compute_window_statics(sample.xs, sample.ys, sample.edges, SENSOR)
    graphs = tg.LossGraphs()
    for window in range(3):
        graphs.bind(sample, wstat)
        value, vg = tg.loss_functions(PARAMS, 0, STATICS, (2, 2, 2), sample, wstat, graphs)
        x = torch.full((8,), 0.25, dtype=torch.float64)
        f = value(x)
        f2, g = vg(x)
        assert torch.equal(f, f2) and g.shape == (8,)
    assert graphs.n_graphs() == 0


def test_the_graph_key_holds_what_the_graph_bakes_in():
    key = lambda **kw: tg.graph_key(**{**dict(
        form=tg.GRAD, params=PARAMS, lvl=0, statics=STATICS, shape=(16, 16, 2),
        dtype=torch.float32, wrap=False), **kw})
    assert key() == key()
    # without TV the level enters nowhere: the handover's level-0 loss at a
    # finer shape shares the value graph of the level of that shape
    assert key(lvl=0) == key(lvl=3)
    tv = LossParams(20.0, 35.0, gamma=0.5)
    assert key(params=tv, lvl=0) != key(params=tv, lvl=1)
    assert key(params=tv, lvl=1) == key(params=tv, lvl=2)
    different = [key(form=tg.VALUE), key(shape=(8, 8, 2)), key(dtype=torch.float64),
                 key(wrap=True), key(params=LossParams(20.0, 35.0, delta=1.0)),
                 key(params=LossParams(21.0, 35.0)),
                 key(statics=LossStatics(SENSOR, 2, "bicubic")),
                 key(statics=LossStatics((48, 64), 2))]
    assert len({key(), *different}) == 1 + len(different)


def test_the_data_key_is_the_windows_shapes():
    a, _ = _window(n=400)
    b, _ = _window(seed=9, n=400)
    c, _ = _window(n=401)
    d, _ = _window(n=400, dtype=np.float32)
    assert tg.data_key(a) == tg.data_key(b)
    assert len({tg.data_key(a), tg.data_key(c), tg.data_key(d)}) == 3


def _bound(seed=7, n=400, dtype=np.float64):
    sample, _ = _window(seed=seed, n=n, dtype=dtype)
    return sample, compute_window_statics(sample.xs, sample.ys, sample.edges, SENSOR)


def test_a_window_of_the_same_shape_is_copied_into_the_same_buffers():
    graphs = tg.LossGraphs()
    graphs.bind(*_bound(seed=7))
    buffers = graphs._buffers
    graphs._graphs["k"], graphs._pool = "a graph", "a pool"
    sample, wstat = _bound(seed=8)
    graphs.bind(sample, wstat)
    # the graphs read these buffers: kept, holding the new window
    assert graphs._buffers is buffers
    assert graphs._graphs == {"k": "a graph"} and graphs._pool == "a pool"
    for buf, t in zip(graphs._buffers, (*sample, *wstat)):
        assert torch.equal(buf, t) and buf.data_ptr() != t.data_ptr()


@pytest.mark.parametrize("change", ["events", "frames", "dtype"])
def test_a_window_of_another_shape_drops_the_graphs_and_their_pool(change):
    graphs = tg.LossGraphs()
    graphs.bind(*_bound())
    graphs._graphs["k"], graphs._pool = "a graph", "a pool"
    if change == "events":
        sample, wstat = _bound(n=401)
    elif change == "dtype":
        sample, wstat = _bound(dtype=np.float32)
    else:
        sample, _ = _window()
        sample = sample._replace(edges=torch.cat([sample.edges, sample.edges[:1]]),
                                 edge_ts=torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64))
        wstat = compute_window_statics(sample.xs, sample.ys, sample.edges, SENSOR)
    graphs.bind(sample, wstat)
    assert graphs.n_graphs() == 0 and graphs._pool is None
    assert tg.data_key(graphs._buffers) == tg.data_key((*sample, *wstat))
    for buf, t in zip(graphs._buffers, (*sample, *wstat)):
        assert torch.equal(buf, t)


def test_uncounted_drops_this_threads_counts_only():
    import threading

    before = profiling.counters()
    with profiling.uncounted():
        profiling.count("test.uncounted")
        other = threading.Thread(target=profiling.count, args=("test.uncounted", 5))
        other.start()
        other.join()
        with profiling.uncounted():
            profiling.count("test.uncounted")
        profiling.count("test.uncounted")
    profiling.count("test.uncounted", 2)
    assert profiling.since(before)["test.uncounted"] == 7


def _fake_kernel(name):
    k = _build.Kernel("none", name, ())
    k._fn = lambda *args: 0
    return k


def test_a_capture_tallies_its_kernel_calls_and_a_replay_adds_them():
    a, b = _fake_kernel("a"), _fake_kernel("b")
    a()
    tally = {}
    with _build.tally_launches(tally):
        a(), b(), b()
    assert (a.launches, b.launches) == (1, 0)
    assert tally == {a: 1, b: 2}
    a()
    assert a.launches == 2  # counted again once the capture ends
    for _ in range(3):
        _build.add_launches(tally)
    assert (a.launches, b.launches) == (5, 6)


def test_a_graph_being_captured_has_its_own_interp_counter():
    dev = torch.device("cpu")
    stream, other = 1234567, 7654321
    shared = ti._ticket(dev, stream)
    own = torch.zeros(1, dtype=torch.int32)
    with ti.graph_ticket(stream, own):
        assert ti._ticket(dev, stream) is own
        assert ti._ticket(dev, other) is not own
    assert ti._ticket(dev, stream) is shared


class _StandIn:
    """A graph that replays by running the eager loss into its outputs."""

    def __init__(self, form, fun, x, outs):
        self.form, self.fun, self.x, self.outs = form, fun, x, outs

    def replay(self):
        with profiling.uncounted():
            out = tg.evaluate(self.form, self.fun, self.x)
        for o, v in zip(self.outs, out):
            o.copy_(v)


@pytest.mark.parametrize("form", [tg.VALUE, tg.GRAD])
def test_the_cache_binds_once_a_window_and_replays_count_as_evaluations(form, monkeypatch):
    """`functions` on the CPU with the card's capture stood in for: the
    first evaluation of a key captures it (its warm-up the answer), every
    later one replays, over the buffers of the window bound; a replay
    counted as an evaluation and a replay, its tally added to the
    launches."""
    kernel = _fake_kernel("k")
    made = []

    def capture(self, key, f, loss, x):
        static_x = x.clone()
        out = tg.evaluate(f, loss, static_x)
        with profiling.uncounted():
            outs = tuple(torch.zeros_like(t) for t in tg.evaluate(f, loss, static_x))
        self._graphs[key] = tg._Graph(_StandIn(f, loss, static_x, outs), static_x, outs,
                                      {kernel: 3}, None)
        made.append(key)
        profiling.count("loss.graph_captures")
        return out

    monkeypatch.setattr(tg.LossGraphs, "_capture", capture)
    graphs = tg.LossGraphs()
    shape = (2, 2, 2)
    rng = np.random.default_rng(3)
    xs = [torch.as_tensor(rng.normal(0, 0.5, 8)) for _ in range(3)]
    for window in range(3):
        sample, wstat = _bound(seed=11 + window)
        graphs.bind(sample, wstat)
        fns = graphs.functions(PARAMS, 0, STATICS, shape)
        fn = fns[0] if form == tg.VALUE else fns[1]
        eager = tg.loss_functions(PARAMS, 0, STATICS, shape, sample, wstat)
        ref_fn = eager[0] if form == tg.VALUE else eager[1]
        before, launches = profiling.counters(), kernel.launches
        for x in xs:
            got, ref = fn(x), ref_fn(x)
            for u, v in zip(got if form == tg.GRAD else (got,), ref if form == tg.GRAD else (ref,)):
                assert torch.equal(u, v)
        spent = profiling.since(before)
        replays = len(xs) - (window == 0)
        assert spent.get("loss.graph_replays", 0) == replays
        assert spent.get("loss.graph_captures", 0) == (window == 0)
        # every call one evaluation, replayed or captured, and its eager
        # reference another
        assert spent["loss.evals"] == 2 * len(xs)
        assert spent.get("loss.grad_evals", 0) == (2 * len(xs) if form == tg.GRAD else 0)
        assert kernel.launches - launches == 3 * replays
    assert len(made) == 1 and graphs.n_graphs() == 1
