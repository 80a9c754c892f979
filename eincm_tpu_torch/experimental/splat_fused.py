"""Fused warp + splat forward for one reference time (measurement vehicle).

Replaces the two TPU kernels of eincm_tpu/experimental/splat_fused.py
(`_fused_fwd_kernel` through `fused_warp_splat_frame`,
`_fully_fused_fwd_kernel` through `fully_fused_warp_splat_frame`) with the
CUDA kernels of `csrc/fused.cu`, and keeps their plain PyTorch versions
beside them.

The production path warps every event to every reference time in one step
(`ops/warp.py`) and splats the (n_refs, E) warped coordinates in another
(`ops/splat_kernel.py`), so the warped coordinates make a round trip
through device memory. Here they never leave the kernel:

- `fused_warp_splat_frame` takes the per-event velocities (thx, thy) from
  the production interp and warps inside the splat;
- `fully_fused_warp_splat_frame` also samples the coarse theta inside the
  kernel, with the production interp's taps, at (xi, yi) as given.

Per event cx = xi - thx * (ts - t_ref), cy likewise, then the
(2 hw + 1)^2 Gaussian taps around (round(cx), round(cy)), hw =
window_size // 2 (any window of 1 or more, as the JAX functions take),
with the production splat's drop semantics. xi and yi are used as given,
not rounded: callers pass rounded coordinates.

Both return `(frame (H, W), ok)`. On the TPU `ok` said whether the row
bands of sorted events covered every event (a frame with `ok` False had
lost mass). The port scatters with atomics and has no bands of sorted
events, so every frame is complete, in any event order, and `ok` is a 0-d
True tensor on the frame's device. Where events are few, both kernels add
each tap into the frame in device memory; where they are many, in shared
memory, where a thread block cluster holds the whole frame (`plan_fused`
chooses and cuts, with a crossover of its own for each kernel). The two
cluster kernels are one body (csrc/fused.cu): kernel 7 loads the velocity
where kernel 8 samples theta. The TPU versions' `b` (band height) and
`interpret` arguments only shaped that band tiling and are dropped.

Forward only; nothing in the solver or the loss calls these. Dispatch: CPU
tensors take the plain version; CUDA tensors launch the kernel at windows
3 and 5 (`WINDOW_SIZES`, which the cluster kernels are built for) and, at
any other window, are routed by that argument as the production splat
routes it (`ops/splat.py`): the warp as the plain version computes it,
then the direct splat kernel (`csrc/direct.cu`), with the direct interp
forward in float32 sampling theta first for kernel 8, at (xi, yi) as given,
as kernel 8 and its plain version do. Neither route reads the host.
Anything a kernel does not take raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from eincm_tpu_torch.ops._build import KERNELS, active_clusters, check_cuda
from eincm_tpu_torch.ops.interp import (
    FWD_STAGED_BYTES, _scales, interp_direct_fwd_cuda, interp_theta_at_events_plain,
)
from eincm_tpu_torch.ops.splat_kernel import (
    N_SM, SMEM_BLOCK, SMEM_PER_SM, WINDOW_SIZES, half_window, splat_direct_fwd_cuda,
    splat_plain,
)

# The two kernels of kernels 7 and 8 (csrc/fused.cu). The cluster kernel
# zeroes and writes back a whole frame per cluster and passes two cluster
# barriers per round, which few events do not pay for: below the crossover
# the scatter kernel, whose global atomics are then few. Measured on an H100
# over the first 2^14 to 2^20 permuted events (PERF.md): kernel 8's scatter
# kernel led at 2^18 and was even at 2^19; kernel 7's sweep put its
# crossover in the same place (ahead at 2^18, 0.0313 against 0.0371 ms;
# behind at 2^19, 0.0588 against 0.0540), since its scatter kernel samples
# nothing either. One crossover serves both.
CLUSTER_EVENTS = 1 << 19
MAX_CLUSTER = 8  # blocks in a thread block cluster: the portable limit
SCATTER_THREADS = 256
SCATTER_MAX_BLOCKS = N_SM * 16
MAX_PER_THREAD = 8  # events a thread of kernels 7 and 8 warps in a round, at most
MIN_QUEUE = 32  # events a block can queue for a sibling in a round, at least
QUEUE_MARGIN = 1.5  # a queue's size over a sibling's even share of a round
SMEM_RESERVE = 128  # a block's own words beside its tile, queues and theta


def _f32(t_ref) -> float:
    return float(np.float32(float(t_ref)))


def _ok(frame: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=frame.device)


def _check_window(name: str, window_size) -> int:
    if int(window_size) < 1:
        raise ValueError(f"{name}: window_size {window_size} < 1")
    return int(window_size)


def _warp(xi, yi, ts, thx, thy, t_ref):
    """The warped coordinates (cx, cy), as the kernels compute them."""
    dt = ts - t_ref
    return xi - thx * dt, yi - thy * dt


def fused_warp_splat_frame_plain(
    xi, yi, ts, thx, thy, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """The plain version of kernel 7: the displacement as two torch ops,
    then the (2 hw + 1)-tap plain splat. Returns the (H, W) frame."""
    ws = _check_window("fused_warp_splat", window_size)
    cx, cy = _warp(xi, yi, ts, thx, thy, _f32(t_ref))
    return splat_plain(cx[None], cy[None], sensor_size, ws)[0]


def fully_fused_warp_splat_frame_plain(
    xi, yi, ts, theta, t_ref, sensor_size, window_size: int = 3
) -> torch.Tensor:
    """The plain version of kernel 8: the production interp's plain version
    at (xi, yi) as given, then kernel 7's plain version."""
    _check_window("fully_fused_warp_splat", window_size)
    th = interp_theta_at_events_plain(theta, xi, yi, sensor_size, round_coords=False)
    return fused_warp_splat_frame_plain(
        xi, yi, ts, th[:, 0], th[:, 1], t_ref, sensor_size, window_size
    )


def fused_warp_splat_routed(
    xi, yi, ts, thx, thy, t_ref, sensor_size, window_size: int
) -> torch.Tensor:
    """Kernel 7 at a window the cluster kernels are not built for, on the
    card: the plain version's warp, then the direct splat kernel (exact
    sums: the same bits for any event order)."""
    e = xi.shape[0]
    check_cuda("fused_warp_splat", (xi, yi, ts, thx, thy), [(e,)] * 5)
    cx, cy = _warp(xi, yi, ts, thx, thy, _f32(t_ref))
    return splat_direct_fwd_cuda(
        cx[None], cy[None], sensor_size, _check_window("fused_warp_splat", window_size)
    )[0]


def fully_fused_warp_splat_routed(
    xi, yi, ts, theta, t_ref, sensor_size, window_size: int
) -> torch.Tensor:
    """Kernel 8 at a window the cluster kernels are not built for, on the
    card: the direct interp forward samples theta at (xi, yi) as given
    (float32, unrounded: the plain version's taps bit for bit), then kernel
    7's route."""
    e = xi.shape[0]
    h, w, _ = theta.shape
    check_cuda("fully_fused_warp_splat", (xi, yi, ts, theta), [(e,)] * 3 + [(h, w, 2)])
    _check_window("fully_fused_warp_splat", window_size)
    th = interp_direct_fwd_cuda(theta, xi, yi, sensor_size, round_coords=False)
    return fused_warp_splat_routed(
        xi, yi, ts, th[:, 0].contiguous(), th[:, 1].contiguous(), t_ref, sensor_size,
        window_size,
    )


@dataclass(frozen=True)
class FusedPlan:
    """Which kernel runs for kernel 7 or 8, and how it cuts the (H, W) frame
    and the E events.

    `scatter`: one thread per event in a grid-stride loop of `chunks` blocks
    of `threads` threads, every tap a global atomic; the other fields are 0.

    `cluster`: a thread block cluster of `cluster` blocks holds `cluster` x
    `tile_rows` rows of the frame in shared memory as 32-bit fixed-point
    texels, block r of it the rows [r tile_rows, (r + 1) tile_rows); `bands`
    such bands cover the frame (one, where the whole frame fits a cluster).
    The events are cut into `cluster` sections, one per block, and a
    section into runs of `threads` x `per_thread` events, of which chunk c
    takes runs c, c + chunks, ...; the grid has chunks x bands clusters, and
    a cluster adds its tiles into the zeroed frame once. A run is a round:
    every block warps its run's events, adds the taps that fall on its own
    rows and sends each other event to the block that owns its rows, into
    one of the `cluster` queues of `queue` events it has there; after a
    cluster barrier every block adds the taps of the events it received. An
    event that finds its queue full is added into the sibling's tile with
    remote atomics, which is slow (PERF.md) and right. `staged` (kernel 8
    only): theta is read from a copy in shared memory beside the tile and
    the queues."""

    kernel: str
    chunks: int
    threads: int
    cluster: int = 0
    tile_rows: int = 0
    bands: int = 0
    staged: bool = False
    per_thread: int = 0
    queue: int = 0
    smem_bytes: int = 0

    @property
    def run_events(self) -> int:
        return self.threads * self.per_thread


@functools.lru_cache(maxsize=256)
def plan_fused(
    E: int, H: int, W: int, h: int, w: int, kernel: str = None, cluster: int = None,
    chunks: int = None, threads: int = None, per_thread: int = None,
    queue: int = None, active_clusters: int = None,
) -> FusedPlan:
    """The plan of kernel 8 for E events on an H x W sensor and an (h, w, 2)
    theta, or of kernel 7 with h = w = 0 (the velocities are inputs: no
    theta is staged): by default the cluster kernel from CLUSTER_EVENTS
    events on, else the scatter kernel, a choice by shape alone.
    `active_clusters` is the number of clusters of the launch that the card
    runs at once (the CUDA runtime's answer, `card_plan`; by default an
    H100's SMs over the cluster)."""
    if not (E >= 1 and H >= 1 and W >= 1 and ((h, w) == (0, 0) or (h >= 1 and w >= 1))):
        raise ValueError(f"plan_fused: need E, H, W >= 1 and h, w >= 1 or both 0, "
                         f"got {(E, H, W, h, w)}")
    if kernel is None:
        kernel = "cluster" if E >= CLUSTER_EVENTS else "scatter"
    if kernel not in ("scatter", "cluster"):
        raise ValueError(f"plan_fused: kernel {kernel!r}")
    limit = 1024
    if kernel == "scatter":
        threads = SCATTER_THREADS if threads is None else threads
        if chunks is None:
            chunks = max(1, min(-(-E // threads), SCATTER_MAX_BLOCKS))
        if not (32 <= threads <= limit and threads % 32 == 0 and chunks >= 1):
            raise ValueError(f"plan_fused: {chunks} blocks of {threads} threads")
        return FusedPlan(kernel="scatter", chunks=chunks, threads=threads)
    S = min(MAX_CLUSTER, H) if cluster is None else cluster
    if not 1 <= S <= MAX_CLUSTER:
        raise ValueError(f"plan_fused: cluster {S} not in [1, {MAX_CLUSTER}]")
    staged = h > 0 and 8 * h * w <= FWD_STAGED_BYTES
    theta_bytes = 8 * h * w if staged else 0
    # beside the tile: theta, the block's own few words, and at least
    # MIN_QUEUE events from each sibling
    min_queues = 8 * S * MIN_QUEUE if S > 1 else 0
    room = SMEM_BLOCK - SMEM_RESERVE - theta_bytes - min_queues
    max_rows = room // 16 * 4 // W  # the tile is zeroed as uint4
    if max_rows < 1 or H >= 65536:
        raise ValueError(f"plan_fused: a row of {W} texels does not fit a tile of "
                         f"{room} bytes, or {H} rows are too many")
    bands = -(-H // (S * max_rows))
    tile_rows = -(-H // (S * bands))
    tile_bytes = 16 * -(-tile_rows * W // 4)
    per_sm = SMEM_PER_SM // (tile_bytes + theta_bytes + min_queues + 1024)
    if threads is None:
        threads = 1024 if per_sm == 1 else 512
    if not (32 <= threads <= limit and threads % 32 == 0):
        raise ValueError(f"plan_fused: threads {threads}: a multiple of 32 up to {limit}")
    if active_clusters is None:
        active_clusters = (N_SM // S) * max(1, min(per_sm, 2048 // threads))
    section = -(-E // S)
    if chunks is None:
        # enough clusters to fill the card, none without a run of events;
        # each writes the whole frame back
        chunks = max(1, min(active_clusters // bands, -(-section // threads)))
    # events a sibling's queue can hold beside the tile
    fit = (SMEM_BLOCK - SMEM_RESERVE - theta_bytes - tile_bytes) // (8 * S)
    if per_thread is None:
        # the fewest rounds (each costs two cluster barriers) whose queues
        # hold QUEUE_MARGIN times a sibling's even share of a round, and
        # the same number of events in each
        each = -(-section // (chunks * threads))  # events a thread takes in all
        cap = MAX_PER_THREAD if S == 1 else int(fit * S / (QUEUE_MARGIN * threads))
        rounds = -(-each // max(1, min(MAX_PER_THREAD, cap)))
        per_thread = -(-each // rounds)
    if not (chunks >= 1 and per_thread >= 1):
        raise ValueError(f"plan_fused: chunks {chunks}, per_thread {per_thread}")
    if S == 1:
        queue = 0
    elif queue is None:
        want = -(-2 * threads * per_thread // S // 32) * 32
        queue = max(MIN_QUEUE, min(want, fit // 32 * 32))
    elif not MIN_QUEUE <= queue <= fit:
        raise ValueError(f"plan_fused: queue {queue} not in [{MIN_QUEUE}, {fit}]")
    return FusedPlan(kernel="cluster", chunks=chunks, threads=threads, cluster=S,
                     tile_rows=tile_rows, bands=bands, staged=staged,
                     per_thread=per_thread, queue=queue,
                     smem_bytes=tile_bytes + 8 * S * queue + theta_bytes)


def card_plan(E: int, H: int, W: int, h: int, w: int, window_size: int = 3) -> FusedPlan:
    """`plan_fused`'s plan (kernel 7's with h = w = 0); the cluster kernel's
    with as many chunks as the current CUDA device runs clusters of that
    launch at once (the CUDA runtime's answer)."""
    p = plan_fused(E, H, W, h, w)
    if p.kernel != "cluster":
        return p
    active = active_clusters(
        "fused", "eincm_fused_active_clusters", H, W, half_window(window_size),
        int(h > 0), h, w, p.cluster, p.tile_rows, p.threads, int(p.staged), p.queue,
    )
    return plan_fused(E, H, W, h, w, active_clusters=active)


def _fitted(name, plan, E, H, W, h, w, window_size) -> FusedPlan:
    """`plan`, if it is one that `plan_fused` makes for these shapes, else
    raise; None: the card's plan."""
    if plan is None:
        return card_plan(E, H, W, h, w, window_size)
    if plan != plan_fused(E, H, W, h, w, plan.kernel, plan.cluster or None, plan.chunks,
                          plan.threads, plan.per_thread or None, plan.queue or None):
        raise ValueError(f"{name}: {plan} does not fit {(E, H, W, h, w)}")
    return plan


def fused_warp_splat_cuda(
    xi, yi, ts, thx, thy, t_ref, sensor_size, window_size: int = 3,
    plan: FusedPlan = None,
) -> torch.Tensor:
    """Launch kernel 7: (E,) xi, yi, ts, thx, thy -> (H, W) frame, cut as
    `plan` (default: `plan_fused`'s with h = w = 0, with the clusters the
    card runs at once) says. A plan that does not fit the shapes raises."""
    hw = half_window(window_size)
    e = xi.shape[0]
    check_cuda("fused_warp_splat", (xi, yi, ts, thx, thy), [(e,)] * 5)
    H, W = sensor_size
    frame = torch.zeros((H, W), dtype=torch.float32, device=xi.device)
    if not e:
        return frame
    with torch.cuda.device(xi.device):
        p = _fitted("fused_warp_splat", plan, e, H, W, 0, 0, window_size)
        KERNELS["fused_warp_splat"](
            xi.data_ptr(), yi.data_ptr(), ts.data_ptr(), thx.data_ptr(),
            thy.data_ptr(), frame.data_ptr(), e, _f32(t_ref), H, W, hw,
            p.cluster, p.tile_rows, p.bands, p.chunks, p.threads, p.per_thread,
            p.queue, torch.cuda.current_stream().cuda_stream,
        )
    return frame


def fully_fused_warp_splat_cuda(
    xi, yi, ts, theta, t_ref, sensor_size, window_size: int = 3,
    plan: FusedPlan = None,
) -> torch.Tensor:
    """Launch kernel 8: (E,) xi, yi, ts and (h, w, 2) theta -> (H, W), cut
    as `plan` (default: `plan_fused`'s, with the clusters the card runs at
    once) says. A plan that does not fit the shapes raises."""
    hw = half_window(window_size)
    e = xi.shape[0]
    h, w, _ = theta.shape
    check_cuda(
        "fully_fused_warp_splat", (xi, yi, ts, theta), [(e,)] * 3 + [(h, w, 2)]
    )
    sy, sx = _scales(h, w, sensor_size)
    H, W = sensor_size
    frame = torch.zeros((H, W), dtype=torch.float32, device=xi.device)
    if not e:
        return frame
    with torch.cuda.device(xi.device):
        p = _fitted("fully_fused_warp_splat", plan, e, H, W, h, w, window_size)
        KERNELS["fully_fused_warp_splat"](
            xi.data_ptr(), yi.data_ptr(), ts.data_ptr(), theta.data_ptr(),
            frame.data_ptr(), e, _f32(t_ref), H, W, hw, h, w, sy, sx,
            p.cluster, p.tile_rows, p.bands, p.chunks, p.threads, int(p.staged),
            p.per_thread, p.queue, torch.cuda.current_stream().cuda_stream,
        )
    return frame


def fused_warp_splat_frame(
    xi: torch.Tensor,
    yi: torch.Tensor,
    ts: torch.Tensor,
    thx: torch.Tensor,
    thy: torch.Tensor,
    t_ref,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward IWE for ONE reference time, warped inside the splat.

    Args:
        xi, yi: rounded event coordinates (float).
        ts: event timestamps.
        thx, thy: per-event velocities (from `interp_theta_at_events`).
        t_ref: scalar reference time (rounded to float32).

    Returns:
        (frame (H, W), ok): `ok` is always True (see the module docstring).
    """
    if all(t.device.type == "cpu" for t in (xi, yi, ts, thx, thy)):
        frame = fused_warp_splat_frame_plain(
            xi, yi, ts, thx, thy, t_ref, sensor_size, window_size
        )
    elif int(window_size) not in WINDOW_SIZES:
        frame = fused_warp_splat_routed(
            xi, yi, ts, thx, thy, t_ref, sensor_size, window_size
        )
    else:
        frame = fused_warp_splat_cuda(
            xi, yi, ts, thx, thy, t_ref, sensor_size, window_size
        )
    return frame, _ok(frame)


def fully_fused_warp_splat_frame(
    xi: torch.Tensor,
    yi: torch.Tensor,
    ts: torch.Tensor,
    theta: torch.Tensor,
    t_ref,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward IWE for ONE reference time with the coarse-theta interp, the
    warp and the splat in one kernel: neither per-event velocities nor
    warped coordinates exist in device memory.

    Returns (frame (H, W), ok): `ok` is always True (module docstring).
    """
    if all(t.device.type == "cpu" for t in (xi, yi, ts, theta)):
        frame = fully_fused_warp_splat_frame_plain(
            xi, yi, ts, theta, t_ref, sensor_size, window_size
        )
    elif int(window_size) not in WINDOW_SIZES:
        frame = fully_fused_warp_splat_routed(
            xi, yi, ts, theta, t_ref, sensor_size, window_size
        )
    else:
        frame = fully_fused_warp_splat_cuda(
            xi, yi, ts, theta, t_ref, sensor_size, window_size
        )
    return frame, _ok(frame)
