"""Multi-window batching and the sequence schedules over `torch.distributed`.

Port of eincm_tpu/parallel/batch.py. The reference is strictly sequential
over event windows (src/experiments/e00/exp_mgr.py:620); windows are
independent given their priors, so the window axis is the axis of scale.

Execution model. The JAX package is one controller over a device mesh:
`shard_map` splits the window axis, `lax.map` solves each device's windows
one after another, `lax.ppermute` moves a chunk's final theta pyramid to
the next device. The port runs one process per device (see
`parallel/distributed.py`):

- the mesh (`WindowMesh`) is the ranks of the process group, each owning
  one `torch.device`; without a process group it has one member, the
  caller's device, and makes no collective;
- **every function takes this rank's windows only**: `batch` (and
  `prior_pyrs`, `theta_coarse`, ...) hold the rank's contiguous chunk of
  the global window axis, stacked on a leading axis, and every rank passes
  a chunk of the same length. Rank r's chunk is global windows
  [r * chunk, (r + 1) * chunk): a rank never stages or holds a window it
  does not solve (the counterpart of `jax.make_array_from_process_local_
  data`). On a one-member mesh the chunk is the whole batch;
- a rank solves its windows one after another with `make_window_solver`,
  the counterpart of `lax.map` (not lockstep batches: the per-window BFGS
  trip counts are data-dependent, and lockstep batching measured 16x slower
  than sequential in the JAX package);
- `ppermute` becomes a gloo send / recv of one theta pyramid between
  neighbouring ranks (`_pass_right`), and the splices over the global
  window axis become an all-gather of the rank-local results: **every
  function returns the whole batch's result, with a leading window axis,
  on this rank's device** (each rank copies its results to the host in one
  transfer, `utils/host.py:tree_to_host`, for the gather).

Batched results (`stack_results`). Tensors of a `SolveResult` gain a
leading window axis. Its host-side counters (the int and bool fields of
`BFGSResult`, `BFGSHistory.n`, `SolveResult.n_host_syncs`) become CPU
tensors of shape (B,), int64 or bool: they were host values in each
window's result and stay on the host. `result_at` turns window i back into
a per-window `SolveResult` with Python numbers. A first window's handover
history is an empty one (n = 0), never None, so first and later windows
stack (the structure mismatch of tests/test_parallel.py:140-171 cannot
recur).

A mesh over some but not all ranks (`make_window_mesh(n)`, 1 < n < world:
the JAX package's mesh over its first n devices) is a process group of the
first n ranks, built by every rank in the same order. Its members run the
schedule among themselves, every collective over that group. A rank
outside it passes no windows (its batch is not read) and still returns the
whole batch's result, as the JAX package's single controller does: rank 0
broadcasts the members' gathered result over the world group, and every
rank, member or not, takes part in that broadcast. `make_window_mesh(1)`
stays this process alone: each rank solves what it passes, with no
collective.

Where the JAX schedules solve a window only to discard it (lockstep SPMD),
the port skips the solve: the kept results are the same. Rank 0 does not
re-solve its chunk in pass 2 (sequence_shard) or window 0 (two_pass)
without a carry; the last rank solves no pass 1 of the window whose final
pyramid would go to a next rank (its whole chunk under sequence_shard, its
last window under two_pass).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from eincm_tpu_torch.models.bfgs import BFGSHistory, BFGSResult
from eincm_tpu_torch.models.pyramid import (
    SolveResult,
    SolverConfig,
    WindowSample,
    make_window_solver,
)
from eincm_tpu_torch.parallel.distributed import (
    DistributedConfig,
    process_count,
    process_rank,
    rank_device,
)
from eincm_tpu_torch.utils import host

# ------------------------------------------------------------------ the mesh


@dataclass(frozen=True)
class WindowMesh:
    """The window axis' mesh: `size` ranks of the process group (all of
    them, the first `size` of them, or this process alone), this process
    being `rank` among them (None outside them), solving on `device`.
    `group` is the members' process group (None: the world's); `world`
    is the number of ranks that take the result (> size for a sub-mesh)."""

    size: int
    rank: Optional[int]
    device: torch.device
    group: Optional[object] = None
    world: int = 1

    @property
    def member(self) -> bool:
        return self.rank is not None

    def all_gather(self, obj) -> list:
        """Every member's `obj` (pickled: host values only), in rank order.
        Runs under the process group's timeout."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def share(self, obj):
        """The members' `obj` on every rank: on a sub-mesh rank 0 broadcasts
        it over the world group (host values only); members keep their own."""
        if self.world <= self.size:
            return obj
        box = [obj if process_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return obj if self.member else box[0]


def make_window_mesh(n_devices: Optional[int] = None, device=None) -> WindowMesh:
    """1-D mesh over the window (data-parallel) axis.

    Spans every rank of the process group (one member without one) by
    default; `n_devices=1` gives this process alone; 1 < n_devices < world
    the first n_devices ranks, whose process group every rank builds here
    (call it on every rank, in the same order). `device` is this rank's
    device, by default its CUDA device as `distributed.rank_device` picks
    it (a CUDA device without CUDA raises: nothing falls back to the CPU).
    """
    world = process_count()
    if n_devices is not None and not 1 <= n_devices <= world:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {world} "
            f"rank(s) (one device each) are available"
        )
    size = world if n_devices is None else n_devices
    device = rank_device(DistributedConfig(), "cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"window mesh on {device}, but CUDA is not available "
            "(pass device='cpu' to run on the CPU)"
        )
    if size == 1:
        return WindowMesh(size=1, rank=0, device=device)
    rank = process_rank()
    if size == world:
        return WindowMesh(size=size, rank=rank, device=device, world=world)
    group = dist.new_group(list(range(size)))
    return WindowMesh(size=size, rank=rank if rank < size else None, device=device,
                      group=group, world=world)


def _local_mesh(batch: WindowSample) -> WindowMesh:
    return WindowMesh(size=1, rank=0, device=batch.xs.device)


# ------------------------------------------- batched windows and results

# the host-side counters of each result type: not tensors in a window's
# result, CPU tensors of shape (B,) in a batched one
_COUNTERS = {
    BFGSResult: {"iter_num", "total_iters", "n_fun_evals", "n_attempts", "success", "status",
                 "n_host_syncs"},
    BFGSHistory: {"n"},
    SolveResult: {"n_host_syncs"},
}


def _tree_map(fn: Callable, *trees, counter: bool = False):
    """fn(counter, *leaves) over SolveResult-like trees (named tuples,
    tuples, None, leaves) of one structure."""
    t0 = trees[0]
    if t0 is None:
        if any(t is not None for t in trees):
            raise ValueError("the results differ in structure (None vs a value)")
        return None
    if isinstance(t0, tuple):
        if any(type(t) is not type(t0) or len(t) != len(t0) for t in trees):
            raise ValueError(f"the results differ in structure at a {type(t0).__name__}")
        if hasattr(t0, "_fields"):
            names = _COUNTERS.get(type(t0), ())
            return type(t0)(*(
                _tree_map(fn, *leaves, counter=name in names)
                for name, leaves in zip(t0._fields, zip(*trees))
            ))
        return tuple(_tree_map(fn, *leaves, counter=counter) for leaves in zip(*trees))
    return fn(counter, *trees)


def stack_results(results: Sequence[SolveResult]) -> SolveResult:
    """Per-window results -> one result with a leading window axis."""

    def stack(counter, *leaves):
        if counter:
            dtype = torch.bool if isinstance(leaves[0], bool) else torch.int64
            return torch.tensor(leaves, dtype=dtype)
        return torch.stack(leaves)

    return _tree_map(stack, *results)


def result_at(batched: SolveResult, i: int) -> SolveResult:
    """Window i of a batched result, as `solve_window` returns it."""
    return _tree_map(lambda counter, t: t[i].item() if counter else t[i], batched)


def concat_results(parts: Sequence[SolveResult]) -> SolveResult:
    """Batched results -> one, their window axes concatenated in order."""
    return _tree_map(lambda counter, *leaves: torch.cat(leaves), *parts)


def stack_windows(samples: Sequence[WindowSample]) -> WindowSample:
    return WindowSample(*(torch.stack(f) for f in zip(*samples)))


def window_at(batch: WindowSample, i: int) -> WindowSample:
    return WindowSample(*(f[i] for f in batch))


def _local_size(batch: WindowSample) -> int:
    n = batch.xs.shape[0]
    if n == 0:
        raise ValueError("every rank needs at least one window")
    return n


def _gather(mesh: WindowMesh, local: Optional[SolveResult]) -> SolveResult:
    """Every member's batched result, concatenated in rank order (the
    global window axis), on this rank's device; a rank outside the mesh
    passes None and receives it."""
    if mesh.size == 1:
        return local
    whole = None
    if mesh.member:
        # this rank's device tensors cross to the host in one transfer
        leaves: List[torch.Tensor] = []
        _tree_map(lambda counter, t: None if counter else leaves.append(t), local)
        arrays = host.tree_to_host({str(k): t for k, t in enumerate(leaves)})
        it = iter(torch.from_numpy(arrays[str(k)]) for k in range(len(leaves)))
        parts = mesh.all_gather(_tree_map(lambda counter, t: t if counter else next(it), local))
        sizes = [p.final_theta_pyr[0].shape[0] for p in parts]
        if len(set(sizes)) != 1:
            raise ValueError(f"every rank must hold the same number of windows, got {sizes}")
        whole = concat_results(parts)
    return _tree_map(
        lambda counter, t: t if counter else t.to(mesh.device), mesh.share(whole)
    )


def _pass_right(mesh: WindowMesh, pyr: Tuple[torch.Tensor, ...]):
    """The boundary exchange (`lax.ppermute` with perm [(i, i + 1)]): this
    rank's pyramid goes to rank + 1, rank - 1's comes back, on this rank's
    device; rank 0 receives None. One flat gloo message of all levels."""
    flat = torch.cat([p.reshape(-1) for p in pyr])
    send = None
    if mesh.rank + 1 < mesh.size:
        out = torch.from_numpy(host.tree_to_host({"f": flat})["f"])  # alive until the wait
        send = dist.isend(out, mesh.rank + 1, group=mesh.group)
    recv = None
    if mesh.rank > 0:
        buf = torch.empty(flat.shape, dtype=flat.dtype)
        dist.recv(buf, mesh.rank - 1, group=mesh.group)
        buf = buf.to(mesh.device)
        recv, k = [], 0
        for p in pyr:
            recv.append(buf[k : k + p.numel()].reshape(p.shape))
            k += p.numel()
        recv = tuple(recv)
    if send is not None:
        send.wait()
    return recv


# ------------------------------------------------------------ the schedules


def _solve_one(solver, sample, prior, is_first, where, stats):
    """One window's solve, noted in `stats` (when given) as its global
    window index and pass, host ms (the solve ends in host reads), host
    syncs and BFGS evaluations."""
    t0 = time.perf_counter()
    res = solver(sample, prior, is_first)
    if stats is not None:
        stats.append({
            "window": where[0], "pass": where[1],
            "ms": (time.perf_counter() - t0) * 1e3,
            "host_syncs": res.n_host_syncs,
            "evals": sum(s.n_fun_evals for s in res.theta_opt_states),
        })
    return res


def _chain(solver, batch, prior, first, offset, pass_no, stats) -> List[SolveResult]:
    """This rank's chunk solved in order with the handover chain: the first
    window from `prior` (first-sample semantics if `first`), every later
    one from its predecessor's final pyramid."""
    out = []
    for i in range(batch.xs.shape[0]):
        res = _solve_one(solver, window_at(batch, i), prior, first and i == 0,
                         (offset + i, pass_no), stats)
        prior = res.final_theta_pyr
        out.append(res)
    return out


def _boundary(boundary_prior, batch: WindowSample, device):
    if boundary_prior is None:
        return None
    return tuple(torch.as_tensor(b, dtype=batch.xs.dtype, device=device) for b in boundary_prior)


def solve_window_batch(
    cfg: SolverConfig,
    batch: WindowSample,
    prior_pyrs: Optional[Tuple[torch.Tensor, ...]] = None,
    is_first: bool = True,
    *,
    window_stats: Optional[list] = None,
) -> SolveResult:
    """Multi-window solve on the batch's device (the JAX package vmaps it;
    here the windows are solved one after another).

    Args:
        batch: WindowSample with a leading batch axis on every field.
        prior_pyrs: optional tuple of (B, h_l, w_l, 2) priors per level.
        window_stats: optional list each solve appends its record to (see
            `_solve_one`).
    """
    return solve_window_batch_sharded(
        cfg, batch, _local_mesh(batch), prior_pyrs, is_first, window_stats=window_stats
    )


def solve_window_batch_sharded(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: WindowMesh,
    prior_pyrs: Optional[Tuple[torch.Tensor, ...]] = None,
    is_first: bool = True,
    *,
    window_stats: Optional[list] = None,
) -> SolveResult:
    """Multi-window solve over `mesh`: each rank solves its chunk (`batch`,
    `prior_pyrs`: this rank's windows) one window after another; windows are
    independent, so the only collective is the final gather. A rank
    outside the mesh passes no windows (`batch` is not read)."""
    if not mesh.member:
        return _gather(mesh, None)
    n = _local_size(batch)
    solver = make_window_solver(cfg, mesh.device)
    zero = cfg.zero_pyramid(batch.xs.dtype, device=mesh.device)
    off = mesh.rank * n
    results = [
        _solve_one(
            solver, window_at(batch, i),
            zero if prior_pyrs is None else tuple(p[i] for p in prior_pyrs),
            is_first, (off + i, 1), window_stats,
        )
        for i in range(n)
    ]
    return _gather(mesh, stack_results(results))


def sequence_shard_solve(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: WindowMesh,
    boundary_prior: Optional[Tuple[torch.Tensor, ...]] = None,
    *,
    window_stats: Optional[list] = None,
) -> Tuple[SolveResult, Tuple[torch.Tensor, ...]]:
    """Sequence-sharded solve with a boundary prior exchange.

    Each rank takes a contiguous chunk of the window sequence and solves it
    with the true in-chunk handover chain (src/eincm/solver.py:254-255);
    only the chunk boundaries are approximate:

      pass 1: every chunk solves; chunk-first windows use first-sample
              semantics;
      exchange: each chunk's final theta pyramid goes to the next rank;
      pass 2: chunks re-solve with the received boundary prior seeding
              their first window's handover. Rank 0 has no predecessor: its
              pass-1 chunk (whose first window is the global first) is kept,
              and its pass 2 is not solved. The last rank has no successor:
              it solves no pass 1, only its pass 2 once its boundary came.

    `boundary_prior` (one window's theta pyramid, the carry from an earlier
    super-step) seeds the GLOBAL first window: rank 0 then solves pass 2
    from it like every other rank. On a one-member mesh ONE chunk chain is
    the exact sequential answer, seeded by the boundary prior if given,
    else with first-sample semantics.

    Returns:
        (SolveResult with leading window axis, final theta pyramids).
    """
    if not mesh.member:
        res = _gather(mesh, None)
        return res, res.final_theta_pyr
    n = _local_size(batch)
    solver = make_window_solver(cfg, mesh.device)
    zero = cfg.zero_pyramid(batch.xs.dtype, device=mesh.device)
    carry = _boundary(boundary_prior, batch, mesh.device)
    off = mesh.rank * n
    if mesh.size == 1:
        kept = _chain(solver, batch, zero if carry is None else carry, carry is None,
                      off, 1, window_stats)
    else:
        # the last rank's pass 1 would feed no one: it only receives
        last = mesh.rank == mesh.size - 1
        pass1 = None if last else _chain(solver, batch, zero, True, off, 1, window_stats)
        received = _pass_right(mesh, zero if last else pass1[-1].final_theta_pyr)
        seed = carry if mesh.rank == 0 else received
        kept = pass1 if seed is None else _chain(solver, batch, seed, False, off, 2, window_stats)
    res = _gather(mesh, stack_results(kept))
    return res, res.final_theta_pyr


def two_pass_sequence_solve(
    cfg: SolverConfig,
    batch: WindowSample,
    mesh: Optional[WindowMesh] = None,
    boundary_prior: Optional[Tuple[torch.Tensor, ...]] = None,
    *,
    window_stats: Optional[list] = None,
) -> Tuple[SolveResult, Tuple[torch.Tensor, ...]]:
    """Whole-sequence solve with the two-pass handover schedule.

    Pass 1 solves every window without priors. Pass 2 re-solves each window
    with handover from its predecessor's pass-1 final pyramid (across a
    chunk edge it comes from the previous rank). Window 0 keeps its ENTIRE
    pass-1 record (thetas, optimizer states, losses, handover weights; the
    JAX package's pass-2 re-solve of it is discarded, so it is not solved
    here) unless `boundary_prior` (the carry from an earlier checkpointed
    super-step) is given: then it is window 0's pass-2 prior, and its pass-2
    result is kept like every other window's. The last window's pass-1
    final feeds only the next rank, so the last rank does not solve it
    (unless it is the global first window, kept whole). Without a mesh the
    batch is solved on its own device.

    Returns:
        (SolveResult with leading window axis, final theta pyramids).
    """
    mesh = _local_mesh(batch) if mesh is None else mesh
    if not mesh.member:
        res = _gather(mesh, None)
        return res, res.final_theta_pyr
    n = _local_size(batch)
    solver = make_window_solver(cfg, mesh.device)
    zero = cfg.zero_pyramid(batch.xs.dtype, device=mesh.device)
    off = mesh.rank * n
    carry = _boundary(boundary_prior, batch, mesh.device) if mesh.rank == 0 else None
    last = mesh.rank == mesh.size - 1
    # the last rank's last pass 1 would feed no one: it is solved only as
    # the global first window without a carry, whose pass 1 is kept
    keeps_first = mesh.rank == 0 and carry is None
    n1 = n - 1 if last and not (n == 1 and keeps_first) else n
    pass1 = [
        _solve_one(solver, window_at(batch, i), zero, True, (off + i, 1), window_stats)
        for i in range(n1)
    ]
    received = None
    if mesh.size > 1:
        received = _pass_right(mesh, zero if last else pass1[-1].final_theta_pyr)
    head = carry if mesh.rank == 0 else received
    kept = []
    for i in range(n):
        prior = head if i == 0 else pass1[i - 1].final_theta_pyr
        if prior is None:  # the global first window, no carry: pass 1 kept
            kept.append(pass1[0])
            continue
        kept.append(_solve_one(solver, window_at(batch, i), prior, False, (off + i, 2),
                               window_stats))
    res = _gather(mesh, stack_results(kept))
    return res, res.final_theta_pyr


# ------------------------------------------------------------------ the EVAL


def _stack_trees(trees: Sequence[Dict]) -> Dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def bundle_at(small: Dict, i: int) -> Dict:
    """Window i of `eval_batch_sharded`'s bundles: each value a numpy array
    (0-dim for a scalar), as one serial evaluation's bundle holds it."""
    if isinstance(small, dict):
        return {k: bundle_at(v, i) for k, v in small.items()}
    return np.asarray(small[i])


def eval_batch_sharded(
    theta_coarse: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ts: torch.Tensor,
    edges: torch.Tensor,
    edge_ts: torch.Tensor,
    gt_flow: Optional[torch.Tensor],
    err_mask: Optional[torch.Tensor],
    pvec,
    mesh: WindowMesh,
    sensor_size: Tuple[int, int],
    upscale_method: str = "bilinear",
) -> Dict:
    """Evaluate a batch of windows over `mesh`.

    The EVAL phase's data-parallel path (reference scope: exp_mgr.py:
    662-714, a serial per-window loop): each rank evaluates its chunk one
    window after another with `evals/theta_metrics.py:eval_window_small`,
    the same per-window computation as the serial path. Its bundles cross
    to the host in one transfer; the ranks' bundles are all-gathered.

    Args (this rank's windows, on its device):
        theta_coarse: (B, h0, w0, 2) solver-final level-0 thetas (upscaled
            to the sensor on the device).
        xs/ys/ts: (B, E) NaN-padded eval events, ONE shared pad length.
        edges/edge_ts: (B, R, H, W) / (B, R).
        gt_flow: (B, H, W, 2) or None (test splits).
        err_mask: (H, W) bool or None, the same on every rank (e.g.
            outdoor_day1's hood).
        pvec: (4,) loss weights (alpha, beta, gamma, delta).

    Returns:
        the small bundles as host numpy, a leading (global B,) window axis.
    """
    from eincm_tpu_torch.evals.theta_metrics import eval_window_small

    if not mesh.member:  # passes no windows: its arguments are not read
        return mesh.share(None)
    b = theta_coarse.shape[0]
    has_gt, has_mask = gt_flow is not None, err_mask is not None
    local = {
        str(i): eval_window_small(
            theta_coarse[i], xs[i], ys[i], ts[i], edges[i], edge_ts[i],
            gt_flow[i] if has_gt else None, err_mask, pvec,
            sensor_size, has_gt, has_mask, upscale_method,
        )
        for i in range(b)
    }
    local = host.tree_to_host(local)
    parts = mesh.all_gather([local[str(i)] for i in range(b)])
    if len({len(p) for p in parts}) != 1:
        raise ValueError(f"every rank must hold the same number of windows, got "
                         f"{[len(p) for p in parts]}")
    return mesh.share(_stack_trees([bundle for part in parts for bundle in part]))
