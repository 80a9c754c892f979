"""The loss's CUDA graphs (`eincm_tpu_torch/models/graphs.py`) on the card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has no JAX. `tests/conftest.py` imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py -q

The tests skip without a CUDA device. They hold a replay to the eager
evaluation bit for bit (the value and the value-and-gradient forms at
DSEC's and MVSEC's sizes, every level's grid), a graphed solver's DSEC
handover chain to `solve_window`'s, the launch counters and the program's
counters to what the calls made, and the one window shape whose graphs a
cache keeps.
"""

import numpy as np
import pytest
import torch

from eincm_tpu_torch.models import graphs as tg
from eincm_tpu_torch.models.loss import LossParams, LossStatics, compute_window_statics
from eincm_tpu_torch.models.pyramid import WindowSample, make_window_solver, solve_window
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

# sensor, events, frames, the configuration's loss weights
SIZES = {
    "dsec": ((480, 640), 1_500_000, 3, LossParams(2000.0, 4000.0)),
    "mvsec": ((256, 336), 30_000, 2, LossParams(20.0, 35.0)),
}
SHAPES = [(1, 1, 2), (2, 2, 2), (4, 4, 2), (8, 8, 2), (16, 16, 2)]
_WINDOWS = {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _window(dev, size, dtype=torch.float32, n_events=None):
    """A window of whole-pixel events (1% NaN padding, a few off the
    sensor), sorted times, random edge frames; with its statics."""
    key = (size, dtype, n_events)
    if key not in _WINDOWS:
        (h, w), e, r, params = SIZES[size]
        e = n_events or e
        g = torch.Generator(device=dev).manual_seed(17)
        xs = torch.floor(torch.rand(e, generator=g, device=dev) * (w + 4) - 2)
        ys = torch.floor(torch.rand(e, generator=g, device=dev) * (h + 4) - 2)
        ts = torch.sort(torch.rand(e, generator=g, device=dev)).values
        pad = e // 100
        xs[-pad:], ys[-pad:], ts[-pad:] = float("nan"), float("nan"), float("nan")
        edges = torch.rand(r, h, w, generator=g, device=dev)
        edge_ts = torch.linspace(0.0, 1.0, r, device=dev)
        sample = WindowSample(*(t.to(dtype) for t in (xs, ys, ts, edges, edge_ts)))
        wstat = compute_window_statics(sample.xs, sample.ys, sample.edges, (h, w))
        _WINDOWS[key] = (sample, wstat, LossStatics((h, w), 5), params)
    return _WINDOWS[key]


def _thetas(shape, dtype, dev, n=3):
    g = torch.Generator().manual_seed(shape[0])
    return [(3.0 * torch.randn(int(np.prod(shape)), generator=g, dtype=torch.float64))
            .to(dtype).to(dev) for _ in range(n)]


def _bits(t):
    t = t.detach().reshape(-1)
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64).cpu()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("size,dtype", [("dsec", torch.float32), ("mvsec", torch.float32),
                                        ("mvsec", torch.float64)])
def test_replays_are_bitwise_the_eager_loss_and_gradient(cuda, size, dtype, shape):
    """Captured at the first evaluation of each form, replayed after, over
    two windows: every answer bitwise `solver_loss` and `value_and_grad`
    run eagerly on the window's own tensors."""
    sample, wstat, statics, params = _window(cuda, size, dtype)
    thetas = _thetas(shape, dtype, cuda)
    value, vg = tg.loss_functions(params, 0, statics, shape, sample, wstat)
    refs = [(value(x), *vg(x)) for x in thetas]
    graphs = tg.LossGraphs()
    before = profiling.counters()
    for window in range(2):
        graphs.bind(sample, wstat)
        value, vg = tg.loss_functions(params, 0, statics, shape, sample, wstat, graphs)
        for x, (f, f2, g) in zip(thetas, refs):
            _same(value(x), f)
            got_f, got_g = vg(x)
            _same(got_f, f2)
            _same(got_g, g)
    spent = profiling.since(before)
    assert graphs.n_graphs() == 2
    assert spent["loss.graph_captures"] == 2
    assert spent["loss.graph_replays"] == 2 * 2 * len(thetas) - 2


def test_a_graphed_dsec_chain_is_bitwise_the_eager_solve(cuda):
    """Three DSEC windows of 1.5M events (a first, then two handovers)
    through a graphed solver and through `solve_window` without graphs:
    each level's final theta, status, evaluations and host reads the same;
    the first window captures a value and a gradient graph a level, the
    later ones replay every evaluation."""
    from eincm_tpu_torch.utils import benchmarks as ub

    samples, _ = ub.stage_dsec_samples(3, device=cuda)
    cfg = ub._config(ub.dsec_config_kwargs(), None)
    solver = make_window_solver(cfg, cuda)
    prior_g = prior_e = cfg.zero_pyramid(device=cuda)
    spent = []
    for k, s in enumerate(samples):
        before = profiling.counters()
        got = solver(s.window, prior_g, k == 0)
        spent.append(profiling.since(before))
        ref = solve_window(cfg, s.window, prior_e, k == 0)
        for a, b in zip(got.final_theta_pyr + got.final_handover_weights,
                        ref.final_theta_pyr + ref.final_handover_weights):
            _same(a, b)
        for a, b in zip(got.theta_opt_states, ref.theta_opt_states):
            assert (a.status, a.total_iters, a.n_fun_evals, a.n_host_syncs) == (
                b.status, b.total_iters, b.n_fun_evals, b.n_host_syncs)
            _same(a.fun_val, b.fun_val)
            _same(a.grad, b.grad)
        assert got.n_host_syncs == ref.n_host_syncs
        prior_g, prior_e = got.final_theta_pyr, ref.final_theta_pyr
    assert spent[0]["loss.graph_captures"] == solver.graphs.n_graphs() == 2 * cfg.n_pyr_lvls
    for later in spent[1:]:
        assert later.get("loss.graph_captures", 0) == 0
        assert later["loss.graph_replays"] == later["loss.evals"] > 0


@pytest.mark.parametrize("form", [tg.VALUE, tg.GRAD])
def test_replays_count_their_graphs_launches(cuda, form):
    """A capture launches only its warm-up, one eager evaluation; N replays
    add N times one eager evaluation's launches; the program's counters
    count each replay as an evaluation and a replay; the graph's interp
    arrival counter is zero after them."""
    sample, wstat, statics, params = _window(cuda, "dsec")
    shape = (16, 16, 2)
    x = _thetas(shape, torch.float32, cuda, 1)[0]
    graphs = tg.LossGraphs()
    graphs.bind(sample, wstat)
    pick = lambda fns: fns[0] if form == tg.VALUE else fns[1]
    counts = []
    for fn in (pick(tg.loss_functions(params, 0, statics, shape, sample, wstat)),
               pick(tg.loss_functions(params, 0, statics, shape, sample, wstat, graphs))):
        _build.reset_launch_counts()
        fn(x)
        torch.cuda.synchronize()
        counts.append(_build.launch_counts())
    one = counts[0]
    assert one["interp_fwd"] == one["splat_fwd"] == 1
    assert counts[1] == one
    n = 7
    _build.reset_launch_counts()
    before = profiling.counters()
    for _ in range(n):
        fn(x)
    torch.cuda.synchronize()
    spent = profiling.since(before)
    assert _build.launch_counts() == {k: n * v for k, v in one.items()}
    assert spent["loss.graph_replays"] == spent["loss.evals"] == n
    assert spent.get("loss.grad_evals", 0) == (n if form == tg.GRAD else 0)
    assert spent.get("loss.graph_captures", 0) == 0
    assert spent["loss.dispatch_ns"] > 0
    (graph,) = graphs._graphs.values()
    if form == tg.GRAD:
        assert graph.tally and int(graph.ticket) == 0


def test_a_new_event_count_drops_the_graphs_and_captures_anew(cuda):
    sample, wstat, statics, params = _window(cuda, "mvsec")
    short = WindowSample(*(t[:-4] if t.dim() == 1 and t.shape[0] > 8 else t for t in sample))
    short_stat = compute_window_statics(short.xs, short.ys, short.edges, statics.sensor_size)
    x = _thetas((4, 4, 2), torch.float32, cuda, 1)[0]
    refs = [tg.loss_functions(params, 0, statics, (4, 4, 2), s, w)[0](x)
            for s, w in ((sample, wstat), (short, short_stat))]
    graphs = tg.LossGraphs()
    kinds = []
    for k, (s, w) in enumerate(((sample, wstat), (sample, wstat), (short, short_stat),
                                (short, short_stat), (sample, wstat))):
        graphs.bind(s, w)
        value, _ = tg.loss_functions(params, 0, statics, (4, 4, 2), s, w, graphs)
        n0 = profiling.counters().get("loss.graph_captures", 0)
        _same(value(x), refs[s is short])
        kinds.append(profiling.counters().get("loss.graph_captures", 0) - n0)
        assert graphs.n_graphs() == 1
    assert kinds == [1, 0, 1, 0, 1]


def test_a_capture_and_its_replays_make_no_synchronizing_operation(cuda):
    sample, wstat, statics, params = _window(cuda, "mvsec")
    shape = (16, 16, 2)
    x = _thetas(shape, torch.float32, cuda, 1)[0]
    # the eager loss once: the kernels built and loaded, their plans made
    for fn in tg.loss_functions(params, 0, statics, shape, sample, wstat):
        fn(x)
    torch.cuda.synchronize()
    graphs = tg.LossGraphs()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for window in range(2):
            graphs.bind(sample, wstat)
            for fn in tg.loss_functions(params, 0, statics, shape, sample, wstat, graphs):
                fn(x), fn(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graphs.n_graphs() == 2
