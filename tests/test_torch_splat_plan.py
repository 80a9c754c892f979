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


def _slab_taps(xs, ys, H, W, r0, r1, c0, c1, hw=1):
    """The taps of events (xs, ys) that fall in [r0, r1) x [c0, c1): flat
    tile indices and values in units of 2^-24, as csrc/splat.cu's
    `deposit` computes them for windows of radius hw."""
    rx, ry = torch.round(xs), torch.round(ys)
    # window_hits: the rounded window touches the sensor (NaN, +-inf fail),
    # tested before any int conversion
    hit = (ry >= -hw) & (ry <= H - 1 + hw) & (rx >= -hw) & (rx <= W - 1 + hw)
    rx, ry, xs, ys = rx[hit], ry[hit], xs[hit], ys[hit]
    idx, val = [], []
    for a in range(-hw, hw + 1):
        row = ry + a
        gy = torch.exp(-0.5 * (row - ys) * (row - ys)) * tk._INV_SQRT_2PI
        for b in range(-hw, hw + 1):
            col = rx + b
            gx = torch.exp(-0.5 * (col - xs) * (col - xs)) * tk._INV_SQRT_2PI
            keep = (row >= r0) & (row < r1) & (col >= c0) & (col < c1)
            idx.append(((row[keep] - r0) * (c1 - c0) + (col[keep] - c0)).long())
            val.append(torch.round((gy[keep] * gx[keep]) * UNIT).long())
    return torch.cat(idx), torch.cat(val)


def slab_emulation(wx, wy, sensor, plan, window_size=3):
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
                    idx, val = _slab_taps(wx[r, e], wy[r, e], H, W, r0, r1, c0, c1,
                                          window_size // 2)
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


SLAB_EDGE_OFFSETS = (-1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0)
# a 5x5 window reaches two rows past its center: events up to 2.5 rows off
# an edge still straddle it
SLAB_EDGE_OFFSETS_5 = SLAB_EDGE_OFFSETS + (-2.5, -2.0, 1.5, 2.0, 2.4)


def _window(rng, R, n, H, W, slab_rows, offsets=SLAB_EDGE_OFFSETS):
    """n uniform events per ref, the edge cases, and events on and around
    every slab edge, so that their windows straddle two slabs."""
    xs = [rng.uniform(-3, W + 2, n)]
    ys = [rng.uniform(-3, H + 2, n)]
    ex, ey = np.array(EDGE_XY, np.float64).T
    xs.append(ex)
    ys.append(ey)
    edges = np.arange(slab_rows, H, slab_rows, dtype=np.float64)
    for d in offsets:
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


@pytest.mark.parametrize(
    "R,budget",
    [(1, tk.SMEM_MAX), (2, 48 * 64 * 4 // 5), (3, 64 * 4 * 3), (2, 4 * 24)],
    ids=["one_slab", "five_row_slabs", "many_row_slabs", "column_slabs"],
)
def test_slab_emulation_window5_matches_splat_plain(R, budget):
    """The same partitions with a 5x5 window, whose taps reach two rows
    and columns past a slab edge; the plan is the same for every window."""
    H, W = 48, 64
    p = tk.plan_splat(R, 600, H, W, smem_budget=budget)
    rng = np.random.default_rng(31 + R)
    wx, wy = _window(rng, R, 600, H, W, p.tile_rows, SLAB_EDGE_OFFSETS_5)
    p = tk.plan_splat(R, wx.shape[1], H, W, smem_budget=budget)
    ref = tk.splat_plain(wx, wy, (H, W), 5)
    _close(ref, slab_emulation(wx, wy, (H, W), p, 5), TOL_ATOMIC)
    many = dataclasses.replace(p, chunks=7, threads=32)
    _close(ref, slab_emulation(wx, wy, (H, W), many, 5), TOL_ATOMIC)
    # the 3x3 window's taps are a part of the 5x5 window's (up to the f32
    # sums' rounding)
    assert float((ref - tk.splat_plain(wx, wy, (H, W))).min()) >= -1e-6 * float(ref.max())


def test_slab_emulation_window5_every_event_on_one_texel():
    H, W = 48, 64
    rng = np.random.default_rng(4)
    wx = torch.as_tensor(rng.uniform(20.2, 20.4, (2, 5000)).astype(np.float32))
    wy = torch.as_tensor(rng.uniform(23.9, 24.1, (2, 5000)).astype(np.float32))
    p = tk.plan_splat(2, 5000, H, W, smem_budget=8 * W * 4)
    _close(tk.splat_plain(wx, wy, (H, W), 5), slab_emulation(wx, wy, (H, W), p, 5),
           TOL_ATOMIC)


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


# ---- the splat backward's two kernels -------------------------------------------


@pytest.mark.parametrize("R,E", [(1, 30_000), (2, 30_000), (2, 1_500_000), (3, 17),
                                 (2, 1 << 19), (2, (1 << 19) + 1), (1, (1 << 19) + 1)])
@pytest.mark.parametrize("sensor", [(256, 336), (480, 640), (47, 63)],
                         ids=["mvsec", "dsec", "odd"])
def test_bwd_plan_invariants(sensor, R, E):
    H, W = sensor
    p = tk.plan_splat_bwd(R, E, H, W)
    # by shape alone: the stream kernel from BWD_STREAM_EVENTS events per ref
    assert p.kernel == ("stream" if E >= tk.BWD_STREAM_EVENTS else "gather")
    g = tk.plan_splat_bwd(R, E, H, W, "gather")
    assert g.threads % 32 == 0 and 1 <= g.blocks <= tk.GATHER_MAX_BLOCKS and not g.vec
    assert g.blocks * g.threads >= min(R * E, tk.GATHER_MAX_BLOCKS * g.threads)
    st = tk.plan_splat_bwd(R, E, H, W, "stream")
    assert st.threads % 32 == 0 and st.threads <= 512 and st.blocks >= 1
    # float4s only where every ref's arrays start on 16 bytes
    assert st.vec == (E % 4 == 0 or R == 1)
    assert not tk.plan_splat_bwd(R, E, H, W, "stream", aligned=False).vec
    # enough blocks for the card, none without events
    per_block = st.threads * tk.BWD_EVENTS_PER_THREAD
    assert st.blocks <= -(-E // per_block)
    assert st.blocks == -(-E // per_block) or st.blocks * R >= tk.N_SM
    if E <= 30_000:  # the threads of a ref's blocks take every event once
        first = torch.arange(0, E, 4)  # a thread's four events start here
        owner = (first // 4) % (st.blocks * st.threads)
        assert owner.max() < st.blocks * st.threads
        assert int(first[-1]) + 4 >= E


def test_bwd_plan_at_the_two_shapes():
    p = tk.plan_splat_bwd(2, 1_500_000, 480, 640)
    assert (p.kernel, p.vec) == ("stream", True)
    assert tk.plan_splat_bwd(2, 30_000, 256, 336).kernel == "gather"
    assert not tk.plan_splat_bwd(2, 1_500_001, 480, 640).vec
    assert tk.plan_splat_bwd(1, 1_500_001, 480, 640).vec
    with pytest.raises(ValueError):
        tk.plan_splat_bwd(2, 100, 48, 64, "cluster")
    with pytest.raises(ValueError):
        tk.plan_splat_bwd(2, 100, 48, 64, "gather", threads=48)
    with pytest.raises(ValueError):
        tk.plan_splat_bwd(2, 100, 48, 64, "stream", threads=1024)
    with pytest.raises(ValueError):
        tk.plan_splat_bwd(2, 0, 48, 64)


# ---- the fully fused warp+splat (kernel 8) on a cluster's tiles ----------------
#
# A thread block cluster of S blocks holds a frame in shared memory, block r
# the rows [r tile_rows, (r + 1) tile_rows); the events are cut into S
# sections, one per block, and a section into runs of which chunk (cluster) c
# takes runs c, c + chunks, ... A run is a round: a block adds the taps on
# its own rows and sends the warped event to the owners of its window's
# other rows, which add theirs after a barrier. The plan is pure Python; the
# emulation below routes every event and every tap with torch ops, as
# csrc/fused.cu and csrc/tile.cuh's `Slabs` do.

from eincm_tpu_torch.experimental import splat_fused as tf  # noqa: E402
from eincm_tpu_torch.ops.interp import interp_theta_at_events_plain  # noqa: E402


def _round_events(E, S, run, rank, base):
    """The events block `rank` warps in the round that starts `base` events
    into every section."""
    section = -(-E // S)
    s0 = min(rank * section, E)
    s1 = min(s0 + section, E)
    return torch.arange(min(s0 + base, s1), min(s0 + base + run, s1))


def _owner(local_row, tile_rows):
    """csrc/tile.cuh: the owner block of a row by a multiplication,
    `__umulhi(row, ceil(2^32 / tile_rows))`."""
    if tile_rows == 1:
        return local_row
    magic = -(-(1 << 32) // tile_rows)
    assert magic < 1 << 32
    return (local_row * magic) >> 32


def test_owner_by_multiplication_is_the_quotient():
    rows = torch.arange(1 << 16)
    for d in [1, 2, 3, 5, 6, 7, 12, 32, 34, 60, 61, 80, 127, 128, 255, 641, 1000,
              4095, 4097, 32767, 32768, 65535]:
        assert torch.equal(_owner(rows, d), rows // d), d


@pytest.mark.parametrize("E", [30_000, 1_500_000, 17])
@pytest.mark.parametrize("theta", [(1, 1), (16, 16), (128, 128)], ids=["1x1", "16x16", "128x128"])
@pytest.mark.parametrize("sensor", [(256, 336), (480, 640), (47, 63), (5, 64), (1080, 1440)],
                         ids=["mvsec", "dsec", "odd", "five_rows", "tall_wide"])
@pytest.mark.parametrize("cluster", [None, 1, 2, 8])
def test_fused_plan_invariants(sensor, theta, E, cluster):
    H, W = sensor
    h, w = theta
    p = tf.plan_fused(E, H, W, h, w)
    # by shape alone: the cluster kernel from CLUSTER_EVENTS events on
    assert p.kernel == ("cluster" if E >= tf.CLUSTER_EVENTS else "scatter")
    sc = tf.plan_fused(E, H, W, h, w, "scatter")
    assert sc.threads % 32 == 0 and 1 <= sc.chunks <= tf.SCATTER_MAX_BLOCKS
    assert sc.chunks * sc.threads >= min(E, tf.SCATTER_MAX_BLOCKS * sc.threads)
    p = tf.plan_fused(E, H, W, h, w, "cluster", cluster=cluster)
    S = p.cluster
    assert 1 <= S <= tf.MAX_CLUSTER
    # the tiles of the bands' clusters cover every row once
    spans = [(i * p.tile_rows, min((i + 1) * p.tile_rows, H)) for i in range(p.bands * S)]
    assert spans[0][0] == 0 and max(b for _, b in spans) == H
    assert all(spans[i][1] == spans[i + 1][0] or spans[i + 1][0] >= H
               for i in range(len(spans) - 1))
    assert (p.bands - 1) * S * p.tile_rows < H  # no band without a row
    # a tile, the queues and the staged theta fit a block's shared memory
    assert p.staged == (8 * h * w <= 32 * 1024)
    assert p.smem_bytes == (16 * -(-p.tile_rows * W // 4) + 8 * S * p.queue
                            + (8 * h * w if p.staged else 0))
    assert p.smem_bytes <= tk.SMEM_BLOCK - tf.SMEM_RESERVE
    assert (p.queue == 0) == (S == 1) and p.queue % 32 == 0
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.chunks >= 1 and 1 <= p.per_thread <= tf.MAX_PER_THREAD
    # the rounds' queues hold a sibling's even share with a margin, or
    # there is one event a thread
    if S > 1:
        assert p.per_thread == 1 or tf.QUEUE_MARGIN * p.run_events / S <= p.queue + 32
    if E <= 30_000:  # the blocks of the chunks' clusters take every event once
        section = -(-E // S)
        seen = torch.cat([_round_events(E, S, p.run_events, r, base)
                          for c in range(p.chunks) for r in range(S)
                          for base in range(c * p.run_events, section, p.run_events * p.chunks)])
        assert torch.equal(torch.sort(seen).values, torch.arange(E))


def test_fused_plan_at_the_two_shapes():
    """DSEC: the whole frame in one cluster of 8 tiles of 60 rows beside the
    queues and the 2 KB theta, 16 clusters on 132 SMs, rounds of 4 events a
    thread; MVSEC: 8 tiles of 32 rows; a sensor too large for one cluster in
    bands."""
    p = tf.plan_fused(1_500_000, 480, 640, 16, 16)
    assert (p.kernel, p.cluster, p.tile_rows, p.bands) == ("cluster", 8, 60, 1)
    assert (p.chunks, p.threads, p.per_thread, p.queue) == (16, 1024, 6, 1184)
    assert p.smem_bytes == 153_600 + 8 * 8 * 1184 + 2048
    # 187,500 events a section: two rounds of 6 events a thread in 16
    # clusters, three of 5 in 15
    p = tf.plan_fused(1_500_000, 480, 640, 16, 16, active_clusters=15)
    assert (p.chunks, p.per_thread) == (15, 5)
    assert tf.plan_fused(30_000, 256, 336, 16, 16).kernel == "scatter"
    p = tf.plan_fused(30_000, 256, 336, 16, 16, "cluster")
    assert (p.cluster, p.tile_rows, p.bands, p.per_thread) == (8, 32, 1, 1)
    assert tf.plan_fused(30_000, 1080, 1440, 16, 16, "cluster").bands == 4
    with pytest.raises(ValueError):
        tf.plan_fused(100, 3, 70_000, 16, 16, "cluster")  # a row wider than a tile
    with pytest.raises(ValueError):
        tf.plan_fused(100, 48, 64, 16, 16, "cluster", cluster=16)
    with pytest.raises(ValueError):
        tf.plan_fused(100, 48, 64, 16, 16, "cluster", queue=8)
    with pytest.raises(ValueError):
        tf.plan_fused(1_500_000, 480, 640, 16, 16, queue=2048)  # no room beside the tile
    with pytest.raises(ValueError):
        tf.plan_fused(0, 48, 64, 16, 16)
    with pytest.raises(ValueError):
        tf.plan_fused(100, 48, 64, 16, 16, "slabs")


def _add_taps(tiles, cx, cy, H, W, hw, row0, c0, c1, tile_rows):
    """`cluster_taps`: the taps of warped events (cx, cy) on rows [c0, c1),
    in units of 2^-24, into the tiles (S, tile_rows * W) of the cluster that
    holds the frame's rows from row0 on."""
    rx, ry = torch.round(cx), torch.round(cy)
    hit = (ry >= -hw) & (ry <= H - 1 + hw) & (rx >= -hw) & (rx <= W - 1 + hw)
    x, y, rx, ry = cx[hit], cy[hit], rx[hit], ry[hit]
    for a in range(-hw, hw + 1):
        row = ry + a
        gy = torch.exp(-0.5 * (row - y) * (row - y)) * tk._INV_SQRT_2PI
        for b in range(-hw, hw + 1):
            col = rx + b
            gx = torch.exp(-0.5 * (col - x) * (col - x)) * tk._INV_SQRT_2PI
            ok = (row >= c0) & (row < c1) & (col >= 0) & (col < W)
            local = (row[ok] - row0).long()
            owner = _owner(local, tile_rows)
            offset = (local - owner * tile_rows) * W + col[ok].long()
            q = torch.round((gy[ok] * gx[ok]) * UNIT).long()
            tiles.index_put_((owner, offset), q, accumulate=True)


def cluster_fused_emulation(xi, yi, ts, velocity, t_ref, sensor, window_size, plan):
    """Kernels 7 and 8 in torch ops: `velocity` is the (h, w, 2) theta that
    kernel 8 samples, or kernel 7's per-event (thx, thy). Per (chunk, band)
    cluster and round, each block warps its events, adds the taps on its
    own rows, and queues each event for every other block that owns rows of
    its window (straight into that block's tile once the queue is full);
    then each block adds the taps of its inbox on its own rows. A 32-bit
    counter that wraps carries 256.0; at the end every tile is added into
    the frame. Returns (frame, events queued, events that found a queue
    full)."""
    H, W = sensor
    S, tr, hw = plan.cluster, plan.tile_rows, window_size // 2
    E = xi.shape[0]
    if isinstance(velocity, tuple):
        thx, thy = velocity
    else:
        th = interp_theta_at_events_plain(velocity, xi, yi, sensor, round_coords=False)
        thx, thy = th[:, 0], th[:, 1]
    dt = ts - np.float32(t_ref)
    wx, wy = xi - thx * dt, yi - thy * dt
    frame = torch.zeros(H, W, dtype=torch.float64)
    queued = full = 0
    section = -(-E // S)
    for c in range(plan.chunks):
        for band in range(plan.bands):
            row0 = min(band * S * tr, H)
            row1 = min(row0 + S * tr, H)
            own = [(min(row0 + r * tr, row1), min(row0 + (r + 1) * tr, row1)) for r in range(S)]
            tiles = torch.zeros(S, tr * W, dtype=torch.long)
            for base in range(c * plan.run_events, section, plan.run_events * plan.chunks):
                inbox = [[] for _ in range(S)]
                for rank in range(S):
                    e = _round_events(E, S, plan.run_events, rank, base)
                    cx, cy = wx[e], wy[e]
                    rx, ry = torch.round(cx), torch.round(cy)
                    hit = (ry >= -hw) & (ry <= H - 1 + hw) & (rx >= -hw) & (rx <= W - 1 + hw)
                    lo = torch.clamp(torch.where(hit, ry, 0.0).long() - hw, min=row0)
                    hi = torch.clamp(torch.where(hit, ry, 0.0).long() + hw, max=row1 - 1)
                    valid = hit & (lo <= hi)
                    o_lo = _owner(torch.where(valid, lo - row0, 0), tr)
                    o_hi = _owner(torch.where(valid, hi - row0, 0), tr)
                    for o in range(S):
                        to = valid & (o_lo <= o) & (o <= o_hi)
                        if o == rank:
                            _add_taps(tiles, cx[to], cy[to], H, W, hw, row0, *own[rank], tr)
                            continue
                        sx, sy = cx[to], cy[to]
                        queued += min(sx.numel(), plan.queue)
                        full += max(sx.numel() - plan.queue, 0)
                        inbox[o].append((sx[:plan.queue], sy[:plan.queue]))
                        _add_taps(tiles, sx[plan.queue:], sy[plan.queue:], H, W, hw, row0,
                                  *own[o], tr)
                for rank in range(S):
                    for sx, sy in inbox[rank]:
                        _add_taps(tiles, sx, sy, H, W, hw, row0, *own[rank], tr)
            carries, counters = tiles >> 32, tiles & 0xFFFFFFFF
            total = (carries * 256.0 + counters / UNIT).reshape(S * tr, W)
            frame[row0:row1] += total[: row1 - row0]
    return frame.float(), queued, full


def _fused_window(rng, n, H, W, tile_rows):
    x, y = _window(rng, 1, n, H, W, tile_rows)
    ts = torch.as_tensor(rng.uniform(0, 1, x.shape[1]).astype(np.float32))
    return torch.round(x[0]), torch.round(y[0]), ts


@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize(
    "sensor,S,chunks,rows,queue",
    [((48, 64), 8, 2, None, None), ((47, 63), 4, 3, None, None), ((48, 64), 1, 1, None, None),
     ((48, 64), 2, 2, 7, None), ((48, 64), 8, 1, None, 32), ((48, 64), 8, 1, 2, None)],
    ids=["eight_tiles", "odd_sensor", "one_tile", "four_bands", "full_queues", "two_row_tiles"],
)
def test_cluster_fused_emulation_matches_plain(sensor, S, chunks, rows, queue, window_size):
    H, W = sensor
    rng = np.random.default_rng(41)
    theta = torch.as_tensor(rng.normal(0, 1, (4, 4, 2)).astype(np.float32))
    p = tf.plan_fused(600, H, W, 4, 4, "cluster", cluster=S, chunks=chunks, threads=32,
                      queue=queue)
    if rows is not None:  # as if a block's shared memory held only so many rows
        p = dataclasses.replace(p, tile_rows=rows, bands=-(-H // (S * rows)))
    # two rounds; with short queues one, of enough events to fill them
    xi, yi, ts = _fused_window(rng, 600 if queue is None else 4000, H, W, p.tile_rows)
    rounds = 2 if queue is None else 1
    p = dataclasses.replace(p, per_thread=-(-xi.shape[0] // (p.cluster * p.chunks * 32 * rounds)))
    for t_ref in (0.0, 1.0):
        ref = tf.fully_fused_warp_splat_frame_plain(xi, yi, ts, theta, t_ref, sensor, window_size)
        got, queued, full = cluster_fused_emulation(xi, yi, ts, theta, t_ref, sensor,
                                                    window_size, p)
        _close(ref, got, TOL_ATOMIC)
        assert (queued > 0) == (S > 1)  # windows straddle every edge between tiles
        assert (full > 0) == (queue is not None)


@pytest.mark.parametrize("window_size", [3, 5])
def test_cluster_fused_emulation_every_event_on_one_texel(window_size):
    """Every event's window on the same texels, on a tile edge, often enough
    that a texel's 32-bit counter wraps: the carries keep the sum."""
    H, W = 48, 64
    rng = np.random.default_rng(5)
    n = 3000
    xi = torch.as_tensor(rng.uniform(20.2, 20.4, n).astype(np.float32))
    yi = torch.as_tensor(rng.uniform(23.9, 24.1, n).astype(np.float32))  # 6-row tiles
    ts = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32))
    theta = torch.zeros(4, 4, 2)
    p = tf.plan_fused(n, H, W, 4, 4, "cluster", chunks=1, threads=32)
    assert p.tile_rows == 6
    ref = tf.fully_fused_warp_splat_frame_plain(
        xi.double(), yi.double(), ts.double(), theta.double(), 0.0, (H, W), window_size)
    assert float(ref.max()) > 256.0  # the counter wrapped
    got, _, full = cluster_fused_emulation(xi, yi, ts, theta, 0.0, (H, W), window_size, p)
    _close(ref, got, TOL_ATOMIC)
    assert full > 0  # every event goes to the same two blocks


# ---- kernel 7 on the same cluster stage: the velocities are inputs ----------


def test_fused_plan_of_kernel7():
    """h = w = 0: no theta, nothing staged, the whole block's shared memory
    for the tile and the queues; kernel 8's crossover."""
    p = tf.plan_fused(1_500_000, 480, 640, 0, 0)
    assert (p.kernel, p.cluster, p.tile_rows, p.bands, p.staged) == ("cluster", 8, 60, 1, False)
    assert p.smem_bytes == 153_600 + 8 * 8 * p.queue <= tk.SMEM_BLOCK - tf.SMEM_RESERVE
    assert p.queue >= tf.plan_fused(1_500_000, 480, 640, 16, 16).queue
    for E in (tf.CLUSTER_EVENTS - 1, tf.CLUSTER_EVENTS):
        assert tf.plan_fused(E, 480, 640, 0, 0).kernel == (
            "cluster" if E >= tf.CLUSTER_EVENTS else "scatter")
    assert tf.plan_fused(30_000, 256, 336, 0, 0).kernel == "scatter"
    for h, w in ((0, 4), (4, 0), (-1, -1)):
        with pytest.raises(ValueError):
            tf.plan_fused(100, 48, 64, h, w)


def _kernel7_inputs(rng, n, H, W, tile_rows, spread=1.0):
    xi, yi, ts = _fused_window(rng, n, H, W, tile_rows)
    thx = torch.as_tensor(rng.normal(0, spread, xi.shape[0]).astype(np.float32))
    thy = torch.as_tensor(rng.normal(0, spread, xi.shape[0]).astype(np.float32))
    return xi, yi, ts, thx, thy


@pytest.mark.parametrize("window_size", [3, 5])
@pytest.mark.parametrize(
    "sensor,S,chunks,rows,queue",
    [((48, 64), 8, 2, None, None), ((47, 63), 4, 3, None, None), ((48, 64), 1, 1, None, None),
     ((48, 64), 2, 2, 7, None), ((48, 64), 8, 1, None, 32), ((48, 64), 8, 1, 2, None)],
    ids=["eight_tiles", "odd_sensor", "one_tile", "four_bands", "full_queues", "two_row_tiles"],
)
def test_cluster_fused_emulation_kernel7_matches_plain(sensor, S, chunks, rows, queue,
                                                       window_size):
    """Kernel 7's routing, queues and full-queue overflow against its plain
    version: the same stage as kernel 8's, with per-event velocities."""
    H, W = sensor
    rng = np.random.default_rng(43)
    p = tf.plan_fused(600, H, W, 0, 0, "cluster", cluster=S, chunks=chunks, threads=32,
                      queue=queue)
    if rows is not None:
        p = dataclasses.replace(p, tile_rows=rows, bands=-(-H // (S * rows)))
    xi, yi, ts, thx, thy = _kernel7_inputs(rng, 600 if queue is None else 4000, H, W,
                                           p.tile_rows)
    rounds = 2 if queue is None else 1
    p = dataclasses.replace(p, per_thread=-(-xi.shape[0] // (p.cluster * p.chunks * 32 * rounds)))
    for t_ref in (0.0, 1.0):
        ref = tf.fused_warp_splat_frame_plain(xi, yi, ts, thx, thy, t_ref, sensor, window_size)
        got, queued, full = cluster_fused_emulation(xi, yi, ts, (thx, thy), t_ref, sensor,
                                                    window_size, p)
        _close(ref, got, TOL_ATOMIC)
        assert (queued > 0) == (S > 1)
        assert (full > 0) == (queue is not None)


@pytest.mark.parametrize("window_size", [3, 5])
def test_cluster_fused_emulation_kernel7_every_event_on_one_texel(window_size):
    """Kernel 7 with every event on the same texels of a tile edge, zero
    velocities: the counters wrap and the carries keep the sum."""
    H, W = 48, 64
    rng = np.random.default_rng(6)
    n = 3000
    xi = torch.as_tensor(rng.uniform(20.2, 20.4, n).astype(np.float32))
    yi = torch.as_tensor(rng.uniform(23.9, 24.1, n).astype(np.float32))
    ts = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32))
    zero = torch.zeros(n)
    p = tf.plan_fused(n, H, W, 0, 0, "cluster", chunks=1, threads=32)
    assert p.tile_rows == 6
    ref = tf.fused_warp_splat_frame_plain(xi.double(), yi.double(), ts.double(),
                                          zero.double(), zero.double(), 0.0, (H, W),
                                          window_size)
    assert float(ref.max()) > 256.0
    got, _, full = cluster_fused_emulation(xi, yi, ts, (zero, zero), 0.0, (H, W),
                                           window_size, p)
    _close(ref, got, TOL_ATOMIC)
    assert full > 0
