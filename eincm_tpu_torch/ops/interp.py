"""Per-event bilinear sample of the coarse theta grid -> (E, 2).

Replaces the TPU kernels of eincm_tpu/ops/interp_pallas.py (`_fwd_kernel`
through `_interp_fwd`, `_bwd_kernel` through `_interp_bwd`) with the CUDA
kernels of `csrc/interp.cu`, and keeps their plain PyTorch version beside
them.

The sample reads the *unwarped, rounded* event coordinates (round half to
even) and follows `scale_and_translate(method='bilinear')`: pixel centre
`c` maps to `u = (c + 0.5) * n / N - 0.5` on an axis of n coarse cells,
with triangle weights `max(0, 1 - |k - u|)` at the two cells around `u`,
masked to [0, n) and divided by `max(sum, 1e-20)`. An event far off the
sensor (the -1e4 padding sentinel) therefore samples exactly 0. Gradients
flow to theta only; the coordinates enter through round() and get no
cotangent.

Dispatch (`interp_theta_at_events`): CPU tensors take the plain version.
On the card a float64 theta launches the direct kernels of `csrc/direct.cu`
(the JAX package keeps float64 off its Pallas kernels the same way,
eincm_tpu/ops/warp.py:199-209), and a float32 one the kernels of
`csrc/interp.cu`; both take any grid. Every backward on the card is
bitwise the same from run to run: registers or a fixed point unit per
block up to 16x16 in float32, exact sums in one unit per launch
(`csrc/exact.cuh`) above that and in float64. Anything a kernel does not
take raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from eincm_tpu_torch.ops._build import KERNELS, check_cuda, direct_launch

# the kernel gate of eincm_tpu/ops/warp.py:interp_theta_at_events, which the
# dense-layout interp and the fully fused warp+splat keep; kernels 1 and 2
# take any grid whose 2 h w words an int counts
MAX_GRID = 128
MAX_WORDS = 2**31 - 1


def _axis_taps(coord: torch.Tensor, n: int, full_n: int, round_coords: bool):
    """Two taps per event along one axis: (index0, index1, w0, w1).

    Indices are clamped for safe gathers; a clamped tap carries weight 0.
    A NaN coordinate gives NaN weights, as the reference's do.
    """
    if round_coords:
        coord = torch.round(coord)
    u = (coord + 0.5) * (n / full_n) - 0.5
    k0 = torch.floor(u)
    k1 = k0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(k0 - u), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(k1 - u), 0.0)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    w0 = torch.where((k0 >= 0) & (k0 < n), w0, zero)
    w1 = torch.where((k1 >= 0) & (k1 < n), w1, zero)
    s = torch.clamp_min(w0 + w1, 1e-20)
    nan = torch.isnan(u)
    w0 = torch.where(nan, u, w0 / s)
    w1 = torch.where(nan, u, w1 / s)
    k0 = torch.where(torch.isfinite(k0), k0, zero).clamp(-1, n).long()
    return k0.clamp(0, n - 1), (k0 + 1).clamp(0, n - 1), w0, w1


def _axis_weights(coord, n, npad, scale, norm):
    """The same weights as dense (E, npad) rows at the rounded coordinates,
    zero beyond n; NaN rows for NaN coordinates. The dense-layout interp
    (experimental/interp_proto.py) is built from these."""
    u = (torch.round(coord) + 0.5) * scale - 0.5
    k = torch.arange(npad, dtype=u.dtype, device=u.device)
    w = torch.clamp_min(1.0 - torch.abs(k - u[:, None]), 0.0)
    if npad > n:
        w = torch.where(k < n, w, torch.zeros((), dtype=w.dtype, device=w.device))
    if norm:
        w = w / torch.clamp_min(w.sum(1, keepdim=True), 1e-20)
    return w


def interp_theta_at_events_plain(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
    round_coords: bool = True,
) -> torch.Tensor:
    """The plain version: four gathered taps, rows summed first, then
    columns, as the reference contracts them. Differentiable by autograd.

    `round_coords=False` samples at the coordinates as given, as the fully
    fused warp+splat does with its (already rounded) inputs."""
    h, w, _ = theta.shape
    H, W = sensor_size
    y0, y1, uy0, uy1 = _axis_taps(ys.to(theta.dtype), h, H, round_coords)
    x0, x1, vx0, vx1 = _axis_taps(xs.to(theta.dtype), w, W, round_coords)
    uy0, uy1 = uy0[:, None], uy1[:, None]
    m0 = uy0 * theta[y0, x0] + uy1 * theta[y1, x0]
    m1 = uy0 * theta[y0, x1] + uy1 * theta[y1, x1]
    return m0 * vx0[:, None] + m1 * vx1[:, None]


def interp_bwd_plain(g, xs, ys, theta_shape, sensor_size, sum_dtype=None):
    """The plain version of the backward: the float32 taps and products
    (vx * g) * uy of `interp_theta_at_events_plain`, added into dtheta with
    `index_add_` in `sum_dtype` (default: g's). In float64 it is the exact
    sum of the terms the kernel adds, so it measures the kernel's summation
    alone; a tap outside the grid adds its zero weight times g."""
    h, w, _ = theta_shape
    H, W = sensor_size
    y0, y1, uy0, uy1 = _axis_taps(ys.to(g.dtype), h, H, True)
    x0, x1, vx0, vx1 = _axis_taps(xs.to(g.dtype), w, W, True)
    dtheta = torch.zeros((h * w, 2), dtype=sum_dtype or g.dtype, device=g.device)
    for xc, vx in ((x0, vx0), (x1, vx1)):
        c = vx[:, None] * g
        for yc, uy in ((y0, uy0), (y1, uy1)):
            dtheta.index_add_(0, yc * w + xc, (c * uy[:, None]).to(dtheta.dtype))
    return dtheta.reshape(h, w, 2)


def _check_grid(h, w, max_grid=None):
    if not (h >= 1 and w >= 1 and 2 * h * w <= MAX_WORDS):
        raise ValueError(f"interp kernel takes h, w >= 1 and 2 h w <= {MAX_WORDS}, "
                         f"got {h}x{w}")
    if max_grid is not None and not (h <= max_grid and w <= max_grid):
        raise ValueError(f"interp kernel takes h, w <= {max_grid}, got {h}x{w}")


def _scales(h, w, sensor_size, max_grid=MAX_GRID):
    """The float32 kernels' (scale_y, scale_x), for grids up to `max_grid`
    cells a side (None: any grid)."""
    H, W = sensor_size
    _check_grid(h, w, max_grid)
    return float(h) / H, float(w) / W


# ---- the launch plan of csrc/interp.cu --------------------------------------

N_SM = 132  # streaming multiprocessors of an H100 SXM
SMEM_BLOCK = 232_448  # one block's shared memory on an H100 (opt-in limit)
STATIC_SMEM = 21 * 1024  # the backward kernels' own, beside the grid
EVENTS_PER_GROUP = 4  # events a thread loads at once: one float4 of xs, of ys
# events are read in groups from this many on; below, one event per thread
# was faster on the card (PERF.md)
GROUP_EVENTS = 1 << 17
# the forward reads theta from a shared-memory copy up to this many bytes
# (64x64 cells); above it, it gathers from device memory
FWD_STAGED_BYTES = 32 * 1024
# the backward keeps a block's partial grid in registers for these sizes
BWD_REGISTER_SIZES = (1, 2, 4)
# ... and above them, up to this many words (16x16 cells), in fixed point
# with a unit per block in shared memory (9 bytes per word: two 32-bit
# halves and a flag byte), the blocks' partial grids summed by the last
# block; above it, and always in float64, in exact sums with one unit per
# launch (csrc/exact.cuh): "banded" (each block's terms into a band of rows
# in shared memory first, each band re-reading the events) while the grid
# needs at most BANDED_MAX_BANDS bands (and, in float64, the blocks' write-
# back of their bands, blocks x words, is at most the 8 terms an event that
# "global" adds), else "global" (every term into device memory). On an H100
# at 30k and 1.5M events (PERF.md): float32 banded won at 1 and 2
# bands (32x32 to 128x128) and lost at 5 (256x256); float64 banded, whose
# shared atomics are 64-bit, won at one band (16x16, 32x32) and lost at 3
# (128x128)
BWD_FIXED_WORDS = 2 * 16 * 16
BANDED_MAX_BANDS = {False: 2, True: 1}  # by f64
BANDED_WRITEBACK_F64 = 8
MODES = {"registers": 0, "fixed": 1}
EXACT_MODES = ("banded", "global")
# the exact kernels' shared memory beside a band: block_max's words, with room
EXACT_STATIC_SMEM = 1024
EXACT_PREP_BLOCKS = 264  # csrc/exact.cuh: kPrepBlocks
SMEM_PER_SM = 233_472


def exact_scratch_bytes(words: int, f64: bool) -> int:
    """csrc/exact.cuh:ExactLayout's bytes for `words` words of the grid:
    the sums (one 64-bit word each in float32, two in float64), a flag byte
    each, the prep kernel's partial maxima and the launch's shift."""
    a16 = lambda n: -(-n // 16) * 16
    maxima = a16(8 * (2 if f64 else 1) * words) + a16(4 * -(-words // 4))
    return maxima + a16((8 if f64 else 4) * EXACT_PREP_BLOCKS) + 16


@dataclass(frozen=True)
class InterpPlan:
    """How csrc/interp.cu cuts the E events of a call and sizes its launch.

    Events [0, head) and the last `tail` are read one by one; between them
    `groups` runs of EVENTS_PER_GROUP events start where xs and ys are
    16-byte aligned and are read as one float4 each. `vec` says how the
    (E, 2) array (the forward's output, the backward's cotangent) is
    accessed there: 4 (two float4), 2 (four float2) or 1 (scalars). Thread
    t of block b takes groups b T + t, b T + t + B T, ... and the scalar
    events of the same numbers (head first, then tail).

    `mode`: the forward's "staged" (theta copied to shared memory) or
    "ldg"; the backward's "registers", "fixed", "banded" or "global".
    `slices`: in "registers" and "fixed" the last block sums the blocks'
    partial grids as `slices` interleaved slices, each in block order, then
    the slices in order. `band_rows`: in "banded" each block adds into a
    band of that many rows of the grid in shared memory, the grid's bands
    along blockIdx.y (`blocks` is then the chunks of events per band);
    "global" adds every term into device memory."""

    mode: str
    head: int
    groups: int
    tail: int
    vec: int
    blocks: int
    threads: int
    smem_bytes: int
    slices: int = 1
    band_rows: int = 0
    bands: int = 1

    @property
    def work(self) -> int:
        """Trips of the busiest loop: groups, or the scalar events."""
        return max(self.groups, self.head + self.tail)


def float_offset(t: torch.Tensor) -> int:
    """Where the tensor starts within a 16-byte line, in floats (0-3)."""
    return (t.data_ptr() // 4) % 4


def _cut(E, offsets):
    """(head, groups, tail, vec) of E events whose xs, ys and (E, 2) array
    start at these float offsets: groups need xs and ys aligned at the same
    events."""
    xo, yo, go = offsets
    head = E if xo != yo else min(E, -xo % 4)
    groups = (E - head) // EVENTS_PER_GROUP
    tail = E - head - EVENTS_PER_GROUP * groups
    return head, groups, tail, {0: 4, 2: 2}.get((go + 2 * head) % 4, 1)


def _plan_for(E, h, w, backward, tensors, plan):
    """`plan`, checked against the tensors' alignment, or the default."""
    offsets = tuple(map(float_offset, tensors))
    if plan is None:
        return plan_interp(E, h, w, backward, offsets)
    cut = (plan.head, plan.groups, plan.tail, plan.vec)
    if cut != _cut(E, offsets) and cut[:3] != (E, 0, 0):  # or one by one
        raise ValueError(f"interp: {plan} does not cut {E} events at offsets {offsets}")
    return plan


def plan_interp(E, h, w, backward=False, offsets=(0, 0, 0), mode=None,
                blocks=None, threads=None, grouped=None, band_rows=None,
                f64=False) -> InterpPlan:
    """The plan of the forward (or backward) kernel for E events on an
    (h, w, 2) theta. `offsets`: `float_offset` of xs, ys and the (E, 2)
    array. `mode`, `blocks`, `threads`, `grouped` (False: every event read
    one by one) and `band_rows` override the defaults (for timing sweeps and
    tests). `f64`: the float64 backward of `csrc/direct.cu` (exact modes
    only, events one by one)."""
    if not E >= 0:
        raise ValueError(f"plan_interp: E >= 0, got {E}")
    _check_grid(h, w)
    if f64:
        if not backward:
            raise ValueError("plan_interp: the float64 forward has no plan")
        if grouped:
            raise ValueError("plan_interp: the float64 backward reads events one by one")
        grouped = False
    if grouped is None:
        grouped = E >= GROUP_EVENTS
    head, groups, tail, vec = _cut(E, offsets) if grouped else (E, 0, 0, 1)
    words = 2 * h * w
    work = max(groups, head + tail)
    # the launches that were fastest on an H100 at 30k and at 1.5M events
    # (PERF.md): the forward one trip per thread; the backward, which pays
    # for a partial grid per block, one block of 1024 threads per SM in
    # fixed point and exact float32 sums, two of 512 in float64 and below
    # those event counts, two of 512 (one at 4x4) in registers
    large = work > N_SM * 512
    word_bytes = 16 if f64 else 8  # a band's word: two halves of T's integers
    if backward:
        row_fits = (SMEM_BLOCK - EXACT_STATIC_SMEM) // (2 * w * word_bytes)
        if mode is None:
            if not f64 and h in BWD_REGISTER_SIZES and w in BWD_REGISTER_SIZES:
                mode = "registers"
            elif not f64 and words <= BWD_FIXED_WORDS:
                mode = "fixed"
            else:
                banded = row_fits and plan_interp(
                    E, h, w, True, offsets, "banded", blocks, threads, grouped, band_rows, f64)
                mode = "banded" if banded and banded.bands <= BANDED_MAX_BANDS[f64] and (
                    not f64 or banded.blocks * 2 * h * w <= BANDED_WRITEBACK_F64 * E) else "global"
        if f64 and mode not in EXACT_MODES:
            raise ValueError(f"plan_interp: the float64 backward has no mode {mode!r}")
        if mode == "registers":
            if not (h in BWD_REGISTER_SIZES and w in BWD_REGISTER_SIZES):
                raise ValueError(f"plan_interp: no register kernel for {h}x{w}")
            smem, max_threads = 0, 512
        elif mode == "fixed":
            smem, max_threads = 8 * words + 4 * (-(-words // 4)), 1024
            # static shared memory beside the grid: the warps' sums, the
            # last block's slices
            if smem > SMEM_BLOCK - STATIC_SMEM:
                raise ValueError(f"plan_interp: {h}x{w} does not fit mode {mode!r}")
        elif mode == "banded":
            if band_rows is None:
                if not row_fits:
                    raise ValueError(f"plan_interp: a row of {w} cells does not fit a band")
                bands = -(-h // row_fits)
                band_rows = -(-h // bands)
            smem = band_rows * 2 * w * word_bytes
            if not (1 <= band_rows and smem <= SMEM_BLOCK - EXACT_STATIC_SMEM):
                raise ValueError(f"plan_interp: a band of {band_rows} rows of {w} cells "
                                 f"does not fit a block")
            max_threads = 512 if f64 else 1024
        elif mode == "global":
            smem, max_threads = 0, (512 if f64 else 1024)
        else:
            raise ValueError(f"plan_interp: unknown backward mode {mode!r}")
    else:
        if mode is None:
            mode = "staged" if 4 * words <= FWD_STAGED_BYTES else "ldg"
        if mode not in ("staged", "ldg"):
            raise ValueError(f"plan_interp: unknown forward mode {mode!r}")
        if mode == "staged" and 4 * words > 48 * 1024:
            raise ValueError(f"plan_interp: {h}x{w} is too large to stage")
        smem, max_threads = (4 * words if mode == "staged" else 0), 512
    if mode != "banded":
        band_rows = 0
    bands = -(-h // band_rows) if band_rows else 1
    if threads is None:
        if mode == "fixed" or mode in EXACT_MODES:
            threads = 512 if f64 or not large else 1024
        else:
            threads = {"registers": 512 if large else 256}.get(mode, 256)
    if threads % 32 or not 32 <= threads <= max_threads:
        raise ValueError(f"plan_interp: threads {threads} not a multiple of 32 "
                         f"in [32, {max_threads}]")
    if mode in EXACT_MODES:
        # a block's share of the sums' write-back is its band: as few blocks
        # as fill the card, over the bands
        per_sm = min(2048 // threads, SMEM_PER_SM // (smem + EXACT_STATIC_SMEM + 1024),
                     1 if large and not f64 else 2)
    else:
        per_sm = {"fixed": 1 if large else 2, "registers": 2 if words < 32 else 1}.get(mode)
    if blocks is None:
        blocks = max(1, -(-work // threads))
        if per_sm:
            blocks = min(blocks, max(1, -(-N_SM * per_sm // bands)))
    if blocks < 1:
        raise ValueError(f"plan_interp: blocks {blocks} < 1")
    slices = 1
    if backward and mode in MODES:
        # a thread of a slice sums four words at a time where it can
        lanes = words // 4 if words % 4 == 0 else words
        if lanes > threads:
            raise ValueError(f"plan_interp: {threads} threads cannot sum {words} words")
        while 2 * slices * lanes <= threads and 2 * slices <= blocks:
            slices *= 2
    return InterpPlan(mode=mode, head=head, groups=groups, tail=tail, vec=vec,
                      blocks=blocks, threads=threads, smem_bytes=smem, slices=slices,
                      band_rows=band_rows, bands=bands)


_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The backward's arrival counter for launches on `stream` of `device`:
    zero between launches (the last block resets it), so the launches of a
    stream, which run in order, share it."""
    t = _TICKETS.get((device, stream))
    if t is None:
        t = _TICKETS[device, stream] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def interp_fwd_cuda(theta, xs, ys, sensor_size, plan: InterpPlan = None) -> torch.Tensor:
    """Launch the forward kernel: (h, w, 2) theta, (E,) coords -> (E, 2),
    cut as `plan` (default: `plan_interp`'s) says."""
    h, w, c = theta.shape
    e = xs.shape[0]
    check_cuda("interp_fwd", (theta, xs, ys), ((h, w, 2), (e,), (e,)))
    sy, sx = _scales(h, w, sensor_size, None)
    out = torch.empty((e, 2), dtype=torch.float32, device=theta.device)
    if e:
        p = _plan_for(e, h, w, False, (xs, ys, out), plan)
        with torch.cuda.device(theta.device):
            KERNELS["interp_fwd"](
                theta.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                e, p.head, p.groups, p.vec, h, w, sy, sx, int(p.mode == "staged"),
                p.blocks, p.threads, torch.cuda.current_stream().cuda_stream,
            )
    return out


def interp_bwd_cuda(g, xs, ys, theta_shape, sensor_size, plan: InterpPlan = None) -> torch.Tensor:
    """Launch the backward kernel: (E, 2) cotangent -> (h, w, 2) dtheta,
    cut as `plan` (default: `plan_interp`'s) says. Every mode writes dtheta
    whole and is bitwise the same from run to run: "registers" and "fixed"
    (KERNELS["interp_bwd"]) in one launch; "banded" and "global"
    (KERNELS["interp_bwd_exact"], csrc/exact.cuh) in three, for every plan
    and event order."""
    h, w, _ = theta_shape
    e = xs.shape[0]
    check_cuda("interp_bwd", (g, xs, ys), ((e, 2), (e,), (e,)))
    sy, sx = _scales(h, w, sensor_size, None)
    if not e:
        return torch.zeros((h, w, 2), dtype=torch.float32, device=g.device)
    p = _plan_for(e, h, w, True, (xs, ys, g), plan)
    dtheta = torch.empty((h, w, 2), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.mode in EXACT_MODES:
            scratch = torch.empty(exact_scratch_bytes(2 * h * w, False), dtype=torch.uint8,
                                  device=g.device)
            KERNELS["interp_bwd_exact"](
                g.data_ptr(), xs.data_ptr(), ys.data_ptr(), dtheta.data_ptr(),
                scratch.data_ptr(), e, p.head, p.groups, p.vec, h, w, sy, sx,
                p.band_rows, p.blocks, p.threads, stream,
            )
        else:
            scratch = torch.empty((p.blocks, 2 * h * w), dtype=torch.float32, device=g.device)
            KERNELS["interp_bwd"](
                g.data_ptr(), xs.data_ptr(), ys.data_ptr(), dtheta.data_ptr(),
                scratch.data_ptr(), _ticket(g.device, stream).data_ptr(), e, p.head,
                p.groups, p.vec, h, w, sy, sx, MODES[p.mode], p.blocks, p.threads,
                p.slices, stream,
            )
    return dtheta


def interp_direct_fwd_cuda(theta, xs, ys, sensor_size) -> torch.Tensor:
    """Launch the float64 direct forward: (h, w, 2) theta, (E,) coords ->
    (E, 2), `interp_theta_at_events_plain`'s function, on any grid."""
    h, w, _ = theta.shape
    e = xs.shape[0]
    check_cuda("interp_direct_fwd", (theta, xs, ys), ((h, w, 2), (e,), (e,)), torch.float64)
    H, W = sensor_size
    out = torch.empty((e, 2), dtype=torch.float64, device=theta.device)
    if e:
        blocks, threads = direct_launch(e)
        with torch.cuda.device(theta.device):
            KERNELS["interp_direct_fwd"](
                theta.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(), e, h, w,
                h / H, w / W, blocks, threads, torch.cuda.current_stream().cuda_stream,
            )
    return out


def interp_direct_bwd_cuda(g, xs, ys, theta_shape, sensor_size,
                           plan: InterpPlan = None) -> torch.Tensor:
    """Launch the float64 direct backward: (E, 2) cotangent -> (h, w, 2)
    dtheta, `interp_bwd_plain`'s function as exact sums rounded once
    (csrc/exact.cuh), by `plan` (default: `plan_interp(..., f64=True)`'s);
    bitwise the same from run to run, for every plan and event order."""
    h, w, _ = theta_shape
    e = xs.shape[0]
    check_cuda("interp_direct_bwd", (g, xs, ys), ((e, 2), (e,), (e,)), torch.float64)
    _check_grid(h, w)
    H, W = sensor_size
    if not e:
        return torch.zeros((h, w, 2), dtype=torch.float64, device=g.device)
    p = plan_interp(e, h, w, True, f64=True) if plan is None else plan
    if p.mode not in EXACT_MODES or p.head != e:
        raise ValueError(f"interp_direct_bwd: {p} is not a float64 plan of {e} events")
    dtheta = torch.empty((h, w, 2), dtype=torch.float64, device=g.device)
    scratch = torch.empty(exact_scratch_bytes(2 * h * w, True), dtype=torch.uint8,
                          device=g.device)
    with torch.cuda.device(g.device):
        KERNELS["interp_direct_bwd"](
            g.data_ptr(), xs.data_ptr(), ys.data_ptr(), dtheta.data_ptr(),
            scratch.data_ptr(), e, h, w, h / H, w / W, p.band_rows, p.blocks, p.threads,
            torch.cuda.current_stream().cuda_stream,
        )
    return dtheta


class _InterpCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, xs, ys, sensor_size):
        ctx.save_for_backward(xs, ys)
        ctx.theta_shape = tuple(theta.shape)
        ctx.sensor_size = sensor_size
        return interp_fwd_cuda(theta, xs, ys, sensor_size)

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.saved_tensors
        dtheta = interp_bwd_cuda(
            g.contiguous(), xs, ys, ctx.theta_shape, ctx.sensor_size
        )
        return dtheta, None, None, None


class _InterpDirect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, xs, ys, sensor_size):
        ctx.save_for_backward(xs, ys)
        ctx.theta_shape = tuple(theta.shape)
        ctx.sensor_size = sensor_size
        return interp_direct_fwd_cuda(theta, xs, ys, sensor_size)

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.saved_tensors
        dtheta = interp_direct_bwd_cuda(g.contiguous(), xs, ys, ctx.theta_shape,
                                        ctx.sensor_size)
        return dtheta, None, None, None


def interp_theta_at_events(
    theta: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    sensor_size: Tuple[int, int],
) -> torch.Tensor:
    """Per-event velocity sampled from the coarse (h, w, 2) theta -> (E, 2).

    Equal to gathering `scale_theta_to_sensor_size(theta, S, 'bilinear')`
    at the rounded event coordinates, without the full-sensor field.

    The plain version runs where all three tensors lie on the CPU. On the
    card a float64 theta (the condition is its dtype, not the grid)
    launches the direct kernels, which take float64 coordinates; every
    other call the float32 kernels. Both take any grid. Anything a kernel
    does not take raises.
    """
    if all(t.device.type == "cpu" for t in (theta, xs, ys)):
        return interp_theta_at_events_plain(theta, xs, ys, sensor_size)
    if theta.dtype == torch.float64:
        return _InterpDirect.apply(theta, xs, ys, tuple(sensor_size))
    return _InterpCuda.apply(theta, xs, ys, tuple(sensor_size))
