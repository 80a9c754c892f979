"""The IWE splat of all reference times at once: (R, E) warped coordinates
-> (R, H, W) frames, and its coordinate gradient.

Replaces the TPU kernels of eincm_tpu/ops/splat_pallas.py (`_splat_kernel`,
`_bwd_kernel`) and eincm_tpu/ops/splat_banded.py (`_fwd_kernel`,
`_bwd_kernel`) with the two CUDA kernels of `csrc/splat.cu`, and keeps
their plain PyTorch version beside them. The forward adds every tap in
shared memory, one tile per (ref, event chunk, slab of the frame);
`plan_splat` cuts the frame and the events.

Each event deposits the 3x3 window of separable standard-normal pdf values
`g(i - y) g(j - x)`, `g(q) = exp(-q^2 / 2) / sqrt(2 pi)`, around its
rounded (half to even) coordinate. Texels outside the sensor are dropped on
every side; an event whose coordinate is NaN or infinite, or whose window
misses the sensor (the -1e4 padding sentinel, a far line-search probe),
deposits nothing and gets a zero gradient.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernels, and anything they do not take raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda_f32

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gauss1d(q: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * q * q) * _INV_SQRT_2PI


def splat_plain(
    warped_xs: torch.Tensor,
    warped_ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    window_size: int = 3,
) -> torch.Tensor:
    """The plain version: a 9-tap `index_put(accumulate=True)` into the
    flattened frames, differentiated by autograd. Also the scatter oracle.
    `window_size` w deposits the (2 (w // 2) + 1)^2 taps instead."""
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
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    # substitute before the pdf so dropped taps have finite zero gradients
    qy = torch.where(vr, rows - wy[..., None], zero)
    qx = torch.where(vc, cols - wx[..., None], zero)
    gy = torch.where(vr, _gauss1d(qy), zero)
    gx = torch.where(vc, _gauss1d(qx), zero)
    vals = gy[..., :, None] * gx[..., None, :]  # (R, E, taps, taps)
    ri = torch.where(vr, rows, zero).long()
    ci = torch.where(vc, cols, zero).long()
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
# many times the taps (9 per event and ref): each block scans its tile in
# shared memory and adds only its nonzero float4s into the frame, so a
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
    blocks of `threads` threads, each adding its tile into the zeroed
    frames."""

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


def plan_splat(R: int, E: int, H: int, W: int, smem_budget: int = None) -> SplatPlan:
    """The slab plan of the forward kernel for R refs of E events on an
    H x W sensor, with tiles of at most `smem_budget` bytes (default: the
    largest for LARGE_EVENTS or more events per ref, else SMALL_BUDGET)."""
    if smem_budget is None:
        smem_budget = SMEM_MAX if E >= LARGE_EVENTS else SMALL_BUDGET
    if not (R >= 1 and E >= 1 and H >= 1 and W >= 1):
        raise ValueError(f"plan_splat: need R, E, H, W >= 1, got {(R, E, H, W)}")
    if not 16 <= smem_budget <= SMEM_MAX:
        raise ValueError(f"plan_splat: smem_budget {smem_budget} not in [16, {SMEM_MAX}]")
    texels = smem_budget // 16 * 4  # the tile is zeroed as uint4
    # whole rows where one fits, else column slabs of one row each
    col_slabs = -(-W // texels)
    tile_cols = -(-W // col_slabs)
    row_slabs = -(-H // max(1, texels // tile_cols))
    tile_rows = -(-H // row_slabs)
    smem_bytes = 16 * -(-tile_rows * tile_cols // 4)  # zeroed as uint4
    # blocks resident on one SM, as its 228 KB of shared memory allows
    # (1 KB of each is reserved), and threads to keep ~32 warps there
    per_sm = min(4, SMEM_PER_SM // (smem_bytes + QUEUE_BYTES + 1024))
    threads = {1: 1024, 2: 512}.get(per_sm, 256)
    # enough chunks to fill the card, no more than the write-back share
    # allows, and none without a run of events
    want = -(-N_SM * per_sm // (R * row_slabs * col_slabs))
    cap = int(MAX_WRITEBACK_SHARE * 9 * E) // (H * W)
    runs = -(-E // (threads * EVENTS_PER_THREAD))
    chunks = max(1, min(want, cap, runs))
    return SplatPlan(
        tile_rows=tile_rows, tile_cols=tile_cols, row_slabs=row_slabs,
        col_slabs=col_slabs, chunks=chunks, threads=threads, smem_bytes=smem_bytes,
    )


def splat_fwd_cuda(warped_xs, warped_ys, sensor_size, plan: SplatPlan = None) -> torch.Tensor:
    """Launch the forward kernel: (R, E) coordinates -> (R, H, W) frames,
    cut as `plan` (default: `plan_splat`'s) says."""
    R, E = warped_xs.shape
    H, W = sensor_size
    check_cuda_f32("splat_fwd", (warped_xs, warped_ys), ((R, E), (R, E)))
    frames = torch.zeros((R, H, W), dtype=torch.float32, device=warped_xs.device)
    if R * E:
        p = plan_splat(R, E, H, W) if plan is None else plan
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_fwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(), frames.data_ptr(),
                R, E, H, W, p.tile_rows, p.tile_cols, p.row_slabs, p.col_slabs,
                p.chunks, p.threads, torch.cuda.current_stream().cuda_stream,
            )
    return frames


def splat_bwd_cuda(warped_xs, warped_ys, grad_frames, sensor_size):
    """Launch the backward kernel: (R, H, W) cotangent -> (dwx, dwy), each
    (R, E)."""
    R, E = warped_xs.shape
    H, W = sensor_size
    check_cuda_f32(
        "splat_bwd",
        (warped_xs, warped_ys, grad_frames),
        ((R, E), (R, E), (R, H, W)),
    )
    dwx = torch.empty_like(warped_xs)
    dwy = torch.empty_like(warped_ys)
    if R * E:
        with torch.cuda.device(warped_xs.device):
            KERNELS["splat_bwd"](
                warped_xs.data_ptr(), warped_ys.data_ptr(),
                grad_frames.data_ptr(), dwx.data_ptr(), dwy.data_ptr(),
                R, E, H, W, torch.cuda.current_stream().cuda_stream,
            )
    return dwx, dwy


class _SplatCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped_xs, warped_ys, sensor_size):
        ctx.save_for_backward(warped_xs, warped_ys)
        ctx.sensor_size = sensor_size
        return splat_fwd_cuda(warped_xs, warped_ys, sensor_size)

    @staticmethod
    def backward(ctx, grad_frames):
        wx, wy = ctx.saved_tensors
        dwx, dwy = splat_bwd_cuda(wx, wy, grad_frames.contiguous(), ctx.sensor_size)
        return dwx, dwy, None

