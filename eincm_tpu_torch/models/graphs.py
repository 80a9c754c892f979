"""CUDA graphs of the optimizer's loss: each evaluation replays one graph.

A window solve evaluates `solver_loss` some 200 times, and each evaluation
enqueues some 200 device ops from Python, forward and autograd's backward:
on the card the host's dispatch, not the kernels, sets the pace. A
`LossGraphs` (one per solver that `pyramid.make_window_solver` builds)
captures each form of the loss once per key into a `torch.cuda.CUDAGraph`
and then replays it:

- the value form, theta -> f: Armijo probes, the golden section, the
  prior's loss;
- the value-and-gradient form, theta -> (f, df/dtheta), the forward and
  `torch.autograd.grad`: BFGS's first point and accepted steps, Wolfe
  trials.

`bind` hands the cache a window: its tensors are copied into static
buffers, once a window (outside any graph's pool). The graphs are those of
one window shape (`data_key`: the device, shape and dtype of each of the
window's tensors, so E events, n_refs frames and the sensor); a window of
another shape drops them and their pool. Within a shape, the key
(`graph_key`) holds theta's shape and dtype, the form, the loss params,
the loss statics, whether the TV term runs (gamma != 0 at level 0) and the
wrap-compat switch of the splat. A solve of DSEC's 5 levels meets 10 keys,
each evaluated 2-40 times a window.

A key is captured the first time it is evaluated and replayed from then
on. The capture first runs the evaluation eagerly on the solver's side
stream (the warm-up that autograd's capture needs, which builds every lazy
state: the reference weights, the kernels' attributes and plans); that run
is the call's answer. Theta is copied in at each replay, and f and g are
copied out. A shape's graphs share one memory pool: they run on one
stream, never at once, and every output is copied out before the next
replay. The interp backward's arrival counter of a graph is its own
(`ops/interp.py:graph_ticket`), zero at each replay's start.

Counts: a replay counts as the evaluation it stands for (`loss.evals`,
`loss.grad_evals` for the gradient form, its host ns in
`loss.dispatch_ns`) and in `loss.graph_replays`, inside an `eincm.loss` or
`eincm.grad` span; a capture counts in `loss.graph_captures`, its warm-up
as an eager evaluation and its capture pass as none. The launch counters
(`ops/_build.py`) count nothing while a graph is captured and add the
graph's calls at each replay.

What stays eager: BFGS's own ops and its host reads, the handover blend,
and CPU tensors (`loss_functions` returns the eager closures).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from eincm_tpu_torch.models.bfgs import value_and_grad
from eincm_tpu_torch.models.loss import LossParams, LossStatics, WindowStatics, solver_loss
from eincm_tpu_torch.ops import _build, interp, splat
from eincm_tpu_torch.utils import profiling

VALUE, GRAD = "value", "grad"
N_SAMPLE = 5  # WindowSample's tensors, then WindowStatics'


def graph_key(form: str, params: LossParams, lvl: int, statics: LossStatics, shape,
              dtype: torch.dtype, wrap: bool) -> tuple:
    """What a graph of one form of the loss bakes in, beyond the window's
    shapes: the level enters only through the TV term."""
    tv = params.gamma != 0.0 and lvl <= 0
    return (form, tuple(shape), dtype, params, statics, tv, bool(wrap))


def data_key(tensors) -> tuple:
    """The device, shape and dtype of each tensor of a window."""
    return tuple((t.device, tuple(t.shape), t.dtype) for t in tensors)


def evaluate(form: str, fun: Callable, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One evaluation of `fun` at x, eager: (f,) or (f, g)."""
    if form == VALUE:
        with torch.no_grad():
            return (fun(x),)
    return value_and_grad(fun)(x)


class _Graph(NamedTuple):
    """One captured graph: its static theta, its outputs, the kernel calls
    it makes (`_build.Kernel` -> calls) and its interp arrival counter."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    outs: Tuple[torch.Tensor, ...]
    tally: Dict
    ticket: torch.Tensor


def _replay(g: _Graph, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    g.x.copy_(x)
    g.graph.replay()
    out = tuple(t.clone() for t in g.outs)
    _build.add_launches(g.tally)
    profiling.count("loss.graph_replays")
    return out


@profiling.spanned("eincm.loss", "loss.evals", "loss.dispatch_ns")
def _replay_value(g: _Graph, x: torch.Tensor) -> torch.Tensor:
    return _replay(g, x)[0]


@profiling.spanned("eincm.grad", "loss.grad_evals", "loss.dispatch_ns")
def _replay_grad(g: _Graph, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    profiling.count("loss.evals")
    return _replay(g, x)


class LossGraphs:
    """The graphs of one solver (module docstring): `bind` gives it a
    window, `functions` a level's loss of that window through it."""

    def __init__(self):
        self._dkey = None
        self._buffers = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream = None
        self._pool = None

    def bind(self, sample, wstat: WindowStatics) -> None:
        """Copy a window's tensors into the static buffers; a window of
        another shape first drops the graphs, their pool and the buffers."""
        tensors = (*sample, *wstat)
        dkey = data_key(tensors)
        if dkey != self._dkey:
            self._dkey, self._graphs, self._pool = dkey, {}, None
            self._buffers = tuple(torch.empty_like(t) for t in tensors)
        for dst, src in zip(self._buffers, tensors):
            dst.copy_(src)

    def n_graphs(self) -> int:
        return len(self._graphs)

    def functions(self, params: LossParams, lvl: int, statics: LossStatics, shape):
        """(value, value_and_grad) of a flat theta of `shape` at level
        `lvl` over the bound window."""
        sample, wstat = self._buffers[:N_SAMPLE], WindowStatics(*self._buffers[N_SAMPLE:])
        wrap = splat._SPLAT_WRAP_COMPAT

        def loss(flat):
            return solver_loss(flat.reshape(shape), *sample, params, lvl, statics, wstat)

        def call(form, replay):
            def run(x):
                key = graph_key(form, params, lvl, statics, shape, x.dtype, wrap)
                g = self._graphs.get(key)
                if g is None:
                    out = self._capture(key, form, loss, x)
                    return out[0] if form == VALUE else out
                return replay(g, x)

            return run

        return call(VALUE, _replay_value), call(GRAD, _replay_grad)

    def _capture(self, key, form, loss, x):
        dev = x.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side, main = self._stream, torch.cuda.current_stream(dev)
        static_x = x.clone()
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # the warm-up: this evaluation's answer, counted as an eager one
            out = evaluate(form, loss, static_x)
            graph, tally = torch.cuda.CUDAGraph(), {}
            with profiling.uncounted(), _build.tally_launches(tally), \
                    interp.graph_ticket(side.cuda_stream, ticket):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    outs = evaluate(form, loss, static_x)
                finally:
                    graph.capture_end()
        main.wait_stream(side)
        self._graphs[key] = _Graph(graph, static_x, outs, tally, ticket)
        profiling.count("loss.graph_captures")
        return tuple(t.clone() for t in out)


def loss_functions(params: LossParams, lvl: int, statics: LossStatics, shape, sample,
                   wstat: WindowStatics, graphs: LossGraphs = None
                   ) -> Tuple[Callable, Callable]:
    """(value, value_and_grad) of `solver_loss` at level `lvl` over one
    window, as functions of a flat theta of `shape`: through `graphs`
    (bound to this window) where it is given and the window lies on the
    card, else eager."""
    if graphs is not None and sample.xs.device.type == "cuda":
        return graphs.functions(params, lvl, statics, shape)

    def fun(flat):
        return solver_loss(flat.reshape(shape), *sample, params, lvl, statics, wstat)

    return fun, value_and_grad(fun)
