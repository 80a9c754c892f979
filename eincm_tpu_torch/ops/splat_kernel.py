"""The IWE splat of all reference times at once: (R, E) warped coordinates
-> (R, H, W) frames, and its coordinate gradient.

Replaces the TPU kernels of eincm_tpu/ops/splat_pallas.py (`_splat_kernel`,
`_bwd_kernel`) and eincm_tpu/ops/splat_banded.py (`_fwd_kernel`,
`_bwd_kernel`) with the CUDA kernels of `csrc/splat.cu`, and keeps their
plain PyTorch version beside them. The forward adds every tap in shared
memory, one tile per (ref, event chunk, slab of the frame); `plan_splat`
cuts the frame and the events. The backward gathers each event's window of
the cotangent through the caches, one event per thread where events are
few, four in a row as float4s where they are many; `plan_splat_bwd` chooses.

Each event deposits the `window_size` x `window_size` window (3 by default)
of separable standard-normal pdf values `g(i - y) g(j - x)`,
`g(q) = exp(-q^2 / 2) / sqrt(2 pi)`, around its rounded (half to even)
coordinate. Texels outside the sensor are dropped on every side; an event
whose coordinate is NaN or infinite, or whose window misses the sensor (the
-1e4 padding sentinel, a far line-search probe), deposits nothing and gets
a zero gradient. The kernels are built for windows 3 and 5 (WINDOW_SIZES)
and refuse any other size; the plain version takes any.

The direct kernels (`splat_direct_fwd_cuda`, `splat_direct_bwd_cuda`;
`csrc/direct.cu`) take what the slab and stream kernels do not: float64
coordinates and the wrap-compat splat, in float32 or float64, at any window
size. The direct forward runs the slab design too (`plan_splat` with 8-byte
texels in float64) and its frames are exact sums as well; the direct
backward is one thread per event.

Dispatch (`ops/splat.py`): a CPU tensor takes the plain version; a CUDA
tensor launches the kernels, and anything they do not take raises.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda, direct_launch

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gauss1d(q: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * q * q) * _INV_SQRT_2PI


WINDOW_SIZES = (3, 5)  # the kernels are built for these


def half_window(window_size: int) -> int:
    """The kernels' radius for `window_size`; raises for a size not built."""
    if int(window_size) not in WINDOW_SIZES:
        raise ValueError(f"window_size {window_size}: must be one of {WINDOW_SIZES}")
    return int(window_size) // 2


def splat_plain(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
    wrap: bool = False,
) -> torch.Tensor:
    """The plain version: an `index_put(accumulate=True)` of the
    (2 (w // 2) + 1)^2 taps of `window_size` w into the flattened frames, on
    the coordinates' device, differentiated by autograd. Also the scatter
    oracle.

    `wrap` reproduces the reference's negative-index wrap (eincm_tpu/ops/
    splat.py:set_splat_wrap_compat): a tap at row (column) s in [-H, -1]
    lands at H + s with the unwrapped pdf value; taps past the far edge are
    still dropped."""
    R, E = warped_xs.shape
    H, W = sensor_size
    dtype = torch.promote_types(warped_xs.dtype, torch.float32)
    wx, wy = warped_xs.to(dtype), warped_ys.to(dtype)
    dev = wx.device
    hw = window_size // 2
    d = torch.arange(-hw, hw + 1, dtype=dtype, device=dev)
    rows = torch.round(wy)[..., None] + d  # (R, E, 2 hw + 1)
    cols = torch.round(wx)[..., None] + d
    # NaN and +-inf fail these comparisons: such taps are dropped
    vr = (rows >= (-H if wrap else 0)) & (rows <= H - 1)
    vc = (cols >= (-W if wrap else 0)) & (cols <= W - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # substitute before the pdf so dropped taps have finite zero gradients
    qy = torch.where(vr, rows - wy[..., None], zero)
    qx = torch.where(vc, cols - wx[..., None], zero)
    gy = torch.where(vr, _gauss1d(qy), zero)
    gx = torch.where(vc, _gauss1d(qx), zero)
    vals = gy[..., :, None] * gx[..., None, :]  # (R, E, taps, taps)
    ri = torch.where(vr, rows, zero).long()
    ci = torch.where(vc, cols, zero).long()
    if wrap:
        ri = torch.where(ri < 0, ri + H, ri)
        ci = torch.where(ci < 0, ci + W, ci)
    ref = torch.arange(R, device=dev)[:, None, None, None]
    flat = (ref * H + ri[..., :, None]) * W + ci[..., None, :]
    frames = torch.zeros(R * H * W, dtype=dtype, device=dev)
    frames = frames.index_put((flat.reshape(-1),), vals.reshape(-1), accumulate=True)
    return frames.reshape(R, H, W)


# an H100's shared memory: the opt-in limit of one block, and one SM's;
# a block keeps its warps' event queues (csrc/splat.cu) beside its tile
SMEM_BLOCK = 232_448
SMEM_PER_SM = 233_472
QUEUE_BYTES = 32 * 64 * 8
SMEM_MAX = SMEM_BLOCK - QUEUE_BYTES  # the largest tile
N_SM = 132  # streaming multiprocessors of an H100 SXM
# the tile's shared memory by default. Every block walks all events of its
# chunk, so fewer, larger slabs walk less where events are many; where
# they are few, the tile's zeroing and scan dominate and a half-size tile
# is faster (PERF.md: the H100's times at 1.5M and at 30k events per
# ref and tile budgets from 28 to 211 KB)
LARGE_EVENTS = 1 << 18
SMALL_BUDGET = 113 * 1024
# the texels the blocks write back (chunks x the frames) stay at most this
# many times the taps (9 per event and ref, counted for a 3x3 window: a 5x5
# window's 25 only make the cap looser): each block scans its tile in
# shared memory and adds only its nonzero texels into the frame, so a
# chunk costs far less than its taps (PERF.md: at 30k events per
# ref, 16 chunks beat 9 and 9 beat 1)
MAX_WRITEBACK_SHARE = 6.0
# events each thread of csrc/splat.cu loads at once (its kUnroll)
EVENTS_PER_THREAD = 2


@dataclass(frozen=True)
class SplatPlan:
    """How the slab kernel cuts the (R, H, W) frames and the (R, E) events.

    A tile is `tile_rows` x `tile_cols` texels of one ref's frame; the
    frame is `row_slabs` x `col_slabs` tiles (the last ones may be short).
    The events of a ref are cut into runs of `threads` x EVENTS_PER_THREAD,
    and chunk c takes runs c, c + chunks, ...: time- or row-sorted events
    reach every slab. The grid has R x chunks x row_slabs x col_slabs
    blocks of `threads` threads, each adding its tile into the frames'
    exact sums, which a second kernel rounds to f32: the frames are bitwise
    the same for every plan."""

    tile_rows: int
    tile_cols: int
    row_slabs: int
    col_slabs: int
    chunks: int
    threads: int
    smem_bytes: int

    @property
    def run_events(self) -> int:
        return self.threads * EVENTS_PER_THREAD

    def write_back_texels(self, n_refs: int) -> int:
        """Texels the blocks write back: chunks x the frames."""
        return n_refs * self.chunks * self.row_slabs * self.col_slabs * (
            self.tile_rows * self.tile_cols
        )


def plan_splat(R: int, E: int, H: int, W: int, smem_budget: int = None,
               texel_bytes: int = 4) -> SplatPlan:
    """The slab plan of the forward kernel for R refs of E events on an
    H x W sensor, with tiles of at most `smem_budget` bytes (default: the
    largest for LARGE_EVENTS or more events per ref, else SMALL_BUDGET) of
    `texel_bytes` a texel (4; the float64 direct forward's 8). The same
    plan serves every window size: a block takes each event whose window
    reaches its slab, up to two rows (a 5x5 window) past its edge
    (csrc/splat.cu: `in_tile`), and adds only the taps on its own rows."""
    if smem_budget is None:
        smem_budget = SMEM_MAX if E >= LARGE_EVENTS else SMALL_BUDGET
    if not (R >= 1 and E >= 1 and H >= 1 and W >= 1):
        raise ValueError(f"plan_splat: need R, E, H, W >= 1, got {(R, E, H, W)}")
    if not 16 <= smem_budget <= SMEM_MAX:
        raise ValueError(f"plan_splat: smem_budget {smem_budget} not in [16, {SMEM_MAX}]")
    if texel_bytes not in (4, 8):
        raise ValueError(f"plan_splat: texel_bytes {texel_bytes} not 4 or 8")
    texels = smem_budget // 16 * (16 // texel_bytes)  # the tile is zeroed as uint4
    # whole rows where one fits, else column slabs of one row each
    col_slabs = -(-W // texels)
    tile_cols = -(-W // col_slabs)
    row_slabs = -(-H // max(1, texels // tile_cols))
    tile_rows = -(-H // row_slabs)
    smem_bytes = 16 * -(-tile_rows * tile_cols * texel_bytes // 16)  # zeroed as uint4
    # blocks resident on one SM, as its 228 KB of shared memory allows
    # (1 KB of each is reserved), and threads to keep ~32 warps there
    per_sm = min(4, SMEM_PER_SM // (smem_bytes + QUEUE_BYTES + 1024))
    threads = {1: 1024, 2: 512}.get(per_sm, 256)
    # the chunks of one wave of blocks (a second, partial wave of a few
    # blocks takes as long as a whole one: the float64 direct forward at
    # DSEC, 120 blocks against 144, PERF.md), no more than the
    # write-back share allows, and none without a run of events
    want = N_SM * per_sm // (R * row_slabs * col_slabs)
    cap = int(MAX_WRITEBACK_SHARE * 9 * E) // (H * W)
    runs = -(-E // (threads * EVENTS_PER_THREAD))
    chunks = max(1, min(want, cap, runs))
    return SplatPlan(
        tile_rows=tile_rows, tile_cols=tile_cols, row_slabs=row_slabs,
        col_slabs=col_slabs, chunks=chunks, threads=threads, smem_bytes=smem_bytes,
    )


def splat_fwd_cuda(
    warped_xs, warped_ys, sensor_size, window_size: int = 3, plan: SplatPlan = None
) -> torch.Tensor:
    """Launch the forward kernel: (R, E) coordinates -> (R, H, W) frames,
    cut as `plan` (default: `plan_splat`'s) says."""
    R, E = warped_xs.shape
    H, W = sensor_size
    hw = half_window(window_size)
    check_cuda("splat_fwd", (warped_xs, warped_ys), ((R, E), (R, E)))
    if not R * E:
        return torch.zeros((R, H, W), dtype=torch.float32, device=warped_xs.device)
    frames = torch.empty((R, H, W), dtype=torch.float32, device=warped_xs.device)
    # the kernel's scratch: each texel's exact 64-bit fixed-point sum
    sums = torch.empty((R, H, W), dtype=torch.int64, device=warped_xs.device)
    p = plan_splat(R, E, H, W) if plan is None else plan
    with torch.cuda.device(warped_xs.device):
        KERNELS["splat_fwd"](
            warped_xs.data_ptr(), warped_ys.data_ptr(), sums.data_ptr(), frames.data_ptr(),
            R, E, H, W, hw, p.tile_rows, p.tile_cols, p.row_slabs, p.col_slabs,
            p.chunks, p.threads, torch.cuda.current_stream().cuda_stream,
        )
    return frames


# The backward's two kernels (csrc/splat.cu). Both gather each event's
# window of the cotangent through L1 and L2 and give the same bits. The
# gather kernel is one thread per (ref, event); the stream kernel gives a
# thread four events in a row, as float4 loads and stores, with a grid of
# its own per ref. From BWD_STREAM_EVENTS events per ref on the stream
# kernel, below it the gather kernel, whose time is then the launch's
# (PERF.md: both on an H100 at 30k and at 1.5M events per ref, over threads
# and blocks per SM).
BWD_STREAM_EVENTS = 1 << 19
BWD_EVENTS_PER_THREAD = 4  # one float4 of xs and of ys
GATHER_THREADS = 256
GATHER_MAX_BLOCKS = N_SM * 16
STREAM_THREADS = 256
STREAM_BLOCKS_PER_SM = 8  # over all refs


@dataclass(frozen=True)
class SplatBwdPlan:
    """Which of the backward's two kernels runs, and its launch.

    `gather`: one thread per (ref, event) in a grid-stride loop of `blocks`
    x `threads` over all refs' events.

    `stream`: a grid of `blocks` x R blocks of `threads` threads; a thread
    takes BWD_EVENTS_PER_THREAD events in a row, grid-stride within its ref;
    `vec`: as one float4 load per coordinate array and one float4 store per
    gradient array (every ref's arrays start on 16 bytes)."""

    kernel: str
    blocks: int
    threads: int
    vec: bool = False


@functools.lru_cache(maxsize=256)
def plan_splat_bwd(
    R: int, E: int, H: int, W: int, kernel: str = None, threads: int = None,
    blocks: int = None, aligned: bool = True,
) -> SplatBwdPlan:
    """The backward's plan for R refs of E events on an H x W sensor: by
    default the stream kernel from BWD_STREAM_EVENTS events per ref on, else
    the gather kernel, a choice by shape alone. `aligned` says whether the
    four (R, E) arrays start on 16 bytes."""
    if not (R >= 1 and E >= 1 and H >= 1 and W >= 1):
        raise ValueError(f"plan_splat_bwd: need R, E, H, W >= 1, got {(R, E, H, W)}")
    if kernel is None:
        kernel = "stream" if E >= BWD_STREAM_EVENTS else "gather"
    if kernel == "gather":
        threads = GATHER_THREADS if threads is None else threads
        limit = 1024
        if blocks is None:
            blocks = max(1, min(-(-R * E // threads), GATHER_MAX_BLOCKS))
        vec = False
    elif kernel == "stream":
        threads = STREAM_THREADS if threads is None else threads
        limit = 512
        if blocks is None:
            full = -(-E // (threads * BWD_EVENTS_PER_THREAD))
            blocks = max(1, min(full, -(-N_SM * STREAM_BLOCKS_PER_SM // R)))
        vec = aligned and (E % 4 == 0 or R == 1)
    else:
        raise ValueError(f"plan_splat_bwd: kernel {kernel!r}")
    if not (32 <= threads <= limit and threads % 32 == 0 and blocks >= 1):
        raise ValueError(f"plan_splat_bwd: {blocks} blocks of {threads} threads: threads "
                         f"a multiple of 32 up to {limit}")
    return SplatBwdPlan(kernel=kernel, blocks=blocks, threads=threads, vec=vec)


def splat_bwd_cuda(
    warped_xs, warped_ys, grad_frames, sensor_size, window_size: int = 3,
    plan: SplatBwdPlan = None,
):
    """Launch a backward kernel: (R, H, W) cotangent -> (dwx, dwy), each
    (R, E), by `plan` (default: `plan_splat_bwd`'s). A plan with float4s
    on arrays that do not start on 16 bytes raises."""
    R, E = warped_xs.shape
    H, W = sensor_size
    hw = half_window(window_size)
    check_cuda(
        "splat_bwd",
        (warped_xs, warped_ys, grad_frames),
        ((R, E), (R, E), (R, H, W)),
    )
    dwx = torch.empty_like(warped_xs)
    dwy = torch.empty_like(warped_ys)
    if R * E:
        aligned = all(t.data_ptr() % 16 == 0 for t in (warped_xs, warped_ys, dwx, dwy))
        p = plan_splat_bwd(R, E, H, W, aligned=aligned) if plan is None else plan
        if p.vec and not (aligned and (E % 4 == 0 or R == 1)):
            raise ValueError(f"splat_bwd: {p} takes float4s, but the arrays of "
                             f"{(R, E)} do not start on 16 bytes in every ref")
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_bwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(),
                grad_frames.data_ptr(), dwx.data_ptr(), dwy.data_ptr(),
                R, E, H, W, hw, int(p.kernel == "stream"), p.blocks, p.threads,
                int(p.vec), torch.cuda.current_stream().cuda_stream,
            )
    return dwx, dwy


class _SplatCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped_xs, warped_ys, sensor_size, window_size=3):
        ctx.save_for_backward(warped_xs, warped_ys)
        ctx.sensor_size = sensor_size
        ctx.window_size = window_size
        return splat_fwd_cuda(warped_xs, warped_ys, sensor_size, window_size)

    @staticmethod
    def backward(ctx, grad_frames):
        wx, wy = ctx.saved_tensors
        dwx, dwy = splat_bwd_cuda(
            wx, wy, grad_frames.contiguous(), ctx.sensor_size, ctx.window_size
        )
        return dwx, dwy, None, None


# ---- the direct kernels: float64, and the wrap-compat splat -----------------

def _direct_dtype(name, warped_xs, window_size) -> torch.dtype:
    if warped_xs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {warped_xs.dtype}")
    if int(window_size) < 1:
        raise ValueError(f"{name}: window_size {window_size} < 1")
    return warped_xs.dtype


def splat_direct_fwd_cuda(warped_xs, warped_ys, sensor_size, window_size: int = 3,
                          wrap: bool = False, plan: SplatPlan = None) -> torch.Tensor:
    """Launch the direct forward: (R, E) float32 or float64 coordinates ->
    (R, H, W) frames of their dtype, `splat_plain(..., wrap=wrap)`'s
    function, cut as `plan` (default: `plan_splat`'s, 8-byte texels in
    float64) says; the frames are exact sums, bitwise the same for every
    plan."""
    R, E = warped_xs.shape
    H, W = sensor_size
    dtype = _direct_dtype("splat_direct_fwd", warped_xs, window_size)
    check_cuda("splat_direct_fwd", (warped_xs, warped_ys), ((R, E), (R, E)), dtype)
    if not R * E:
        return torch.zeros((R, H, W), dtype=dtype, device=warped_xs.device)
    f64 = dtype == torch.float64
    p = plan_splat(R, E, H, W, texel_bytes=8 if f64 else 4) if plan is None else plan
    frames = torch.empty((R, H, W), dtype=dtype, device=warped_xs.device)
    # the kernel's scratch: each texel's exact sum, 64 bits (128 in float64)
    sums = torch.empty((2 if f64 else 1, R, H, W), dtype=torch.int64, device=warped_xs.device)
    with torch.cuda.device(warped_xs.device):
        KERNELS["splat_direct_fwd"](
            warped_xs.data_ptr(), warped_ys.data_ptr(), sums.data_ptr(), frames.data_ptr(),
            R, E, H, W, int(window_size) // 2, int(f64), int(wrap), p.tile_rows,
            p.tile_cols, p.row_slabs, p.col_slabs, p.chunks, p.threads,
            torch.cuda.current_stream().cuda_stream,
        )
    return frames


def splat_direct_bwd_cuda(warped_xs, warped_ys, grad_frames, sensor_size,
                          window_size: int = 3, wrap: bool = False):
    """Launch the direct backward: (R, H, W) cotangent -> (dwx, dwy), each
    (R, E), in the coordinates' dtype."""
    R, E = warped_xs.shape
    H, W = sensor_size
    dtype = _direct_dtype("splat_direct_bwd", warped_xs, window_size)
    check_cuda("splat_direct_bwd", (warped_xs, warped_ys, grad_frames),
               ((R, E), (R, E), (R, H, W)), dtype)
    dwx = torch.empty_like(warped_xs)
    dwy = torch.empty_like(warped_ys)
    if R * E:
        blocks, threads = direct_launch(R * E)
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_direct_bwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(), grad_frames.data_ptr(),
                dwx.data_ptr(), dwy.data_ptr(), R, E, H, W, int(window_size) // 2,
                int(dtype == torch.float64), int(wrap), blocks, threads,
                torch.cuda.current_stream().cuda_stream,
            )
    return dwx, dwy


class _SplatDirect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped_xs, warped_ys, sensor_size, window_size=3, wrap=False):
        ctx.save_for_backward(warped_xs, warped_ys)
        ctx.args = (sensor_size, window_size, wrap)
        return splat_direct_fwd_cuda(warped_xs, warped_ys, sensor_size, window_size, wrap)

    @staticmethod
    def backward(ctx, grad_frames):
        wx, wy = ctx.saved_tensors
        dwx, dwy = splat_direct_bwd_cuda(wx, wy, grad_frames.contiguous(), *ctx.args)
        return dwx, dwy, None, None, None
