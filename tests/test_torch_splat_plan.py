"""The slab plan of the splat forward kernel (`ops/splat_kernel.py:
plan_splat`) and a plain emulation of the kernel's partition, on the CPU.

The kernel (`csrc/splat.cu`) runs one block per (ref, event chunk, row
slab, column slab); each adds the taps of its chunk that fall in its slab
into a shared-memory tile of fixed-point sums (units of 2^-24) and adds
the tile into the frame once. The emulation here does the same with torch
ops, slab by slab and chunk by chunk, with exact integer sums, and is held
to `splat_plain` within 1e-5 of max |frame| (the tolerance the card's
kernel is held to as well): the partition and the fixed point only change
how a texel's sum is rounded.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eincm_tpu_torch.ops import splat_kernel as tk

TOL_ATOMIC = 1e-5
UNIT = 2.0**24  # csrc/splat.cu's fixed-point unit is 2^-24

SENSORS = {
    "mvsec": (256, 336),
    "dsec": (480, 640),
    "ecd": (180, 240),
    "tall_wide": (1080, 1440),
    "one_row_wider_than_a_tile": (3, 70_000),
}


def _spans(n_slabs, size, total):
    return [(i * size, min((i + 1) * size, total)) for i in range(n_slabs)]


@pytest.mark.parametrize("budget", [None, 113 * 1024, tk.SMEM_MAX])
@pytest.mark.parametrize("R,E", [(1, 30_000), (2, 30_000), (2, 1_500_000), (3, 17)])
@pytest.mark.parametrize("sensor", list(SENSORS.values()), ids=list(SENSORS))
def test_plan_invariants(sensor, R, E, budget):
    H, W = sensor
    p = tk.plan_splat(R, E, H, W, smem_budget=budget)
    budget = budget or tk.SMEM_MAX
    # the slabs cover every row and every column exactly once, none empty
    for n, size, total in ((p.row_slabs, p.tile_rows, H), (p.col_slabs, p.tile_cols, W)):
        spans = _spans(n, size, total)
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a < b for a, b in spans)
        assert all(spans[i][1] == spans[i + 1][0] for i in range(n - 1))
    # a tile fits the budget and the card
    assert 4 * p.tile_rows * p.tile_cols <= p.smem_bytes <= budget <= tk.SMEM_MAX
    assert p.col_slabs == 1 or p.tile_rows == 1  # whole rows where one fits
    # the interleaved chunks cover every run of events, none is empty
    runs = -(-E // p.run_events)
    assert 1 <= p.chunks <= runs
    assert sorted(r for c in range(p.chunks) for r in range(c, runs, p.chunks)) == list(range(runs))
    # with more than one chunk, the write-back stays below the taps
    if p.chunks > 1:
        assert p.write_back_texels(R) <= tk.MAX_WRITEBACK_SHARE * 9 * R * E
    assert p.threads % 32 == 0 and 256 <= p.threads <= 1024


@pytest.mark.parametrize(
    "sensor,lo,hi",
    [((480, 640), 6, 12), ((256, 336), 2, 4), ((180, 240), 1, 2)],
    ids=["dsec", "mvsec", "ecd"],
)
def test_plan_slab_counts_of_the_sensors(sensor, lo, hi):
    """DSEC takes 6-12 slabs, MVSEC 2-4, ECD 1-2, at a one- or two-block
    budget, and 1.5M events x 2 refs are split into chunks that fill the
    card; MVSEC's 30k events into as many chunks as they have runs."""
    for budget in (113 * 1024, tk.SMEM_MAX):
        p = tk.plan_splat(2, 1_500_000, *sensor, smem_budget=budget)
        assert lo <= p.row_slabs <= hi and p.col_slabs == 1
        assert 2 * p.chunks * p.row_slabs >= tk.N_SM
    # the defaults: DSEC's window in the largest tiles, MVSEC's 30k events
    # in half-size tiles and as many chunks as the write-back allows
    p = tk.plan_splat(2, 1_500_000, 480, 640)
    assert (p.row_slabs, p.chunks, p.threads) == (6, 11, 1024)
    p = tk.plan_splat(2, 30_000, 256, 336)
    assert (p.row_slabs, p.chunks, p.run_events) == (3, 15, 2048)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tk.plan_splat(2, 0, 10, 10)
    with pytest.raises(ValueError):
        tk.plan_splat(1, 10, 10, 10, smem_budget=tk.SMEM_MAX + 4)


def _slab_taps(xs, ys, H, W, r0, r1, c0, c1):
    """The taps of events (xs, ys) that fall in [r0, r1) x [c0, c1): flat
    tile indices and values in units of 2^-24, as csrc/splat.cu's
    `deposit` computes them."""
    rx, ry = torch.round(xs), torch.round(ys)
    # window_hits: the rounded 3x3 window touches the sensor (NaN, +-inf
    # fail), tested before any int conversion
    hit = (ry >= -1) & (ry <= H) & (rx >= -1) & (rx <= W)
    rx, ry, xs, ys = rx[hit], ry[hit], xs[hit], ys[hit]
    idx, val = [], []
    for a in (-1, 0, 1):
        row = ry + a
        gy = torch.exp(-0.5 * (row - ys) * (row - ys)) * tk._INV_SQRT_2PI
        for b in (-1, 0, 1):
            col = rx + b
            gx = torch.exp(-0.5 * (col - xs) * (col - xs)) * tk._INV_SQRT_2PI
            keep = (row >= r0) & (row < r1) & (col >= c0) & (col < c1)
            idx.append(((row[keep] - r0) * (c1 - c0) + (col[keep] - c0)).long())
            val.append(torch.round((gy[keep] * gx[keep]) * UNIT).long())
    return torch.cat(idx), torch.cat(val)


def slab_emulation(wx, wy, sensor, plan):
    """The kernel's partition in torch ops: block (ref, chunk, row slab,
    column slab) deposits the taps of its chunk's runs of events in its
    tile, exactly, and the tile is added into the frame."""
    R, E = wx.shape
    H, W = sensor
    run = plan.run_events
    frames = torch.zeros(R, H, W, dtype=torch.float64)
    for r in range(R):
        for c in range(plan.chunks):
            e = [torch.arange(i, min(i + run, E))
                 for i in range(c * run, E, run * plan.chunks)]
            if not e:  # a chunk past the last run: an idle block
                continue
            e = torch.cat(e)
            for r0, r1 in _spans(plan.row_slabs, plan.tile_rows, H):
                for c0, c1 in _spans(plan.col_slabs, plan.tile_cols, W):
                    tile = torch.zeros((r1 - r0) * (c1 - c0), dtype=torch.long)
                    idx, val = _slab_taps(wx[r, e], wy[r, e], H, W, r0, r1, c0, c1)
                    tile.index_put_((idx,), val, accumulate=True)
                    frames[r, r0:r1, c0:c1] += tile.reshape(r1 - r0, c1 - c0) / UNIT
    return frames.float()


EDGE_XY = [
    (-1e4, -1e4),  # the padding sentinel
    (np.nan, 5.0), (5.0, np.nan), (np.nan, np.nan),
    (np.inf, 4.0), (4.0, -np.inf), (-np.inf, np.inf),
    (1e10, 3.0), (-1e10, 3.0), (3.0, 1e10),
    (2.5, 3.5), (-0.5, -0.5), (-1.5, 4.5), (0.0, 0.0),  # .5 ties, the corner
    (63.0, 47.0), (63.5, 47.5), (64.0, 48.0), (64.5, 20.0), (65.6, 20.0),
]


def _window(rng, R, n, H, W, slab_rows):
    """n uniform events per ref, the edge cases, and events on and around
    every slab edge, so that their windows straddle two slabs."""
    xs = [rng.uniform(-3, W + 2, n)]
    ys = [rng.uniform(-3, H + 2, n)]
    ex, ey = np.array(EDGE_XY, np.float64).T
    xs.append(ex)
    ys.append(ey)
    edges = np.arange(slab_rows, H, slab_rows, dtype=np.float64)
    for d in (-1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0):
        ys.append(edges + d)
        xs.append(rng.uniform(0, W - 1, edges.size))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.float32)
    out = [rng.permutation(x.size) for _ in range(R)]
    return (torch.as_tensor(np.stack([x[o] for o in out])),
            torch.as_tensor(np.stack([y[o] for o in out])))


def _close(ref, got, tol):
    err = float((ref.double() - got.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize(
    "R,budget",
    [(1, tk.SMEM_MAX), (2, 48 * 64 * 4 // 5), (3, 64 * 4 * 3), (2, 4 * 24)],
    ids=["one_slab", "five_row_slabs", "many_row_slabs", "column_slabs"],
)
def test_slab_emulation_matches_splat_plain(R, budget):
    H, W = 48, 64
    p = tk.plan_splat(R, 600, H, W, smem_budget=budget)
    rng = np.random.default_rng(21 + R)
    wx, wy = _window(rng, R, 600, H, W, p.tile_rows)
    p = tk.plan_splat(R, wx.shape[1], H, W, smem_budget=budget)
    ref = tk.splat_plain(wx, wy, (H, W))
    _close(ref, slab_emulation(wx, wy, (H, W), p), TOL_ATOMIC)
    # the same partition with the events cut into many chunks of short runs
    many = dataclasses.replace(p, chunks=7, threads=32)
    _close(ref, slab_emulation(wx, wy, (H, W), many), TOL_ATOMIC)


def test_slab_emulation_every_event_on_one_texel():
    """The worst contention: every event's window on the same 3x3 texels.
    The coordinates vary within the texel: 5000 equal terms would make the
    f32 sums' rounding one-sided, in both versions alike."""
    H, W = 48, 64
    rng = np.random.default_rng(3)
    wx = torch.as_tensor(rng.uniform(20.2, 20.4, (2, 5000)).astype(np.float32))
    # on a slab edge of 8-row slabs
    wy = torch.as_tensor(rng.uniform(23.9, 24.1, (2, 5000)).astype(np.float32))
    p = tk.plan_splat(2, 5000, H, W, smem_budget=8 * W * 4)
    assert p.row_slabs == 6
    _close(tk.splat_plain(wx, wy, (H, W)), slab_emulation(wx, wy, (H, W), p), TOL_ATOMIC)
