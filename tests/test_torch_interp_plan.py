"""The launch plan of the interp kernels (`ops/interp.py:plan_interp`) and a
plain emulation of the backward kernel's accumulation, on the CPU.

`csrc/interp.cu` cuts the events of a call into a scalar head, groups of
four and a scalar tail, gives thread t of block b the groups (and scalar
events) b T + t, b T + t + B T, ..., and sums the backward in one of two
fixed orders that the emulation here repeats with torch ops:

- registers (h, w in {1, 2, 4}): each thread adds its events' terms in
  order into f32 accumulators, the lanes of a warp are summed by an xor
  butterfly (16, 8, 4, 2, 1), the warps of a block in warp order;
- fixed point: each block rounds every term to a power-of-two unit taken
  from the largest finite |g| of its events (|term| <= 2^30 units), sums
  the integers exactly, converts the sum to f32 once, and flags decide the
  words that got a NaN or an infinite term.

Both then sum the blocks' f32 partial grids as `slices` interleaved slices
in block order, and the slices in order.

Above 16x16 (and in float64, tests/test_torch_direct_plan.py) the backward
takes exact sums in one unit per launch (`csrc/exact.cuh`): the unit from
the largest finite |g| of all events, every term rounded once, the
integers summed into a band of rows in shared memory per block (32-bit
halves with a carry) and the blocks' bands into 64-bit sums in device
memory, each rounded to f32 once. The emulation below keeps the blocks and
bands of the plan; the result is bitwise the same under any permutation of
the events and any plan.

Tolerance: 2e-6 x max |dtheta| against `torch.autograd.grad` of the plain
version and against `jax.grad` of the JAX interp, both of which sum up to
3600 f32 terms per cell in another order; the emulation's own sums are
exact (fixed point) or f32 sums of the same terms (registers). The NaN and
infinity pattern must equal the plain version's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import warp as jw
from eincm_tpu_torch.ops import interp as ti

SENSOR = (48, 64)
H, W = SENSOR
TOL = 2e-6
GRIDS = [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (3, 5), (1, 4), (4, 2)]
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the kernel's arithmetic in torch ops -----------------------------------

def axis_taps(coord, n, full_n):
    """csrc/common.cuh:axis_taps and interp.cu:event_taps on one axis: the
    clamped cells (a, b) of the two taps, their weights, and whether each
    counts (inside [0, n), or both where the weight is NaN)."""
    scale = torch.tensor(float(n) / full_n, dtype=F32)
    u = (torch.round(coord) + 0.5) * scale - 0.5
    nan = torch.isnan(u)
    window = (u > -2.0) & (u < n + 1.0)
    kf = torch.where(window, torch.floor(u), torch.zeros_like(u))
    k0 = kf.long()
    in0 = window & (k0 >= 0) & (k0 < n)
    in1 = window & (k0 + 1 >= 0) & (k0 + 1 < n)
    zero = torch.zeros((), dtype=F32)
    a = torch.where(in0, torch.clamp_min(1.0 - torch.abs(kf - u), 0.0), zero)
    b = torch.where(in1, torch.clamp_min(1.0 - torch.abs((kf + 1.0) - u), 0.0), zero)
    s = torch.clamp_min(a + b, 1e-20)
    w0 = torch.where(nan, u, a / s)
    w1 = torch.where(nan, u, b / s)
    return k0.clamp(0, n - 1), (k0 + 1).clamp(0, n - 1), w0, w1, in0 | nan, in1 | nan


def event_terms(g, xs, ys, h, w):
    """Per event, the cell (E, 4), the two f32 terms (E, 4, 2) and whether
    it counts (E, 4) of the taps (y0, x0), (y1, x0), (y0, x1), (y1, x1)."""
    y0, y1, uy0, uy1, iy0, iy1 = axis_taps(ys, h, H)
    x0, x1, vx0, vx1, ix0, ix1 = axis_taps(xs, w, W)
    cells, terms, on = [], [], []
    for xc, vx, ix in ((x0, vx0, ix0), (x1, vx1, ix1)):
        c = vx[:, None] * g  # (vx * g), then * uy: the kernel's order
        for yc, uy, iy in ((y0, uy0, iy0), (y1, uy1, iy1)):
            cells.append(yc * w + xc)
            terms.append(c * uy[:, None])
            on.append(iy & ix)
    return torch.stack(cells, 1), torch.stack(terms, 1), torch.stack(on, 1)


def owners(E, plan):
    """(thread of the whole grid, round) of every event: a thread's events
    in the order it adds them (groups first, four events each, then the
    scalar events)."""
    n_threads = plan.blocks * plan.threads
    e = torch.arange(E)
    in_group = (e >= plan.head) & (e < plan.head + 4 * plan.groups)
    q = (e - plan.head) // 4
    group_rounds = 4 * (-(-plan.groups // n_threads))
    s = torch.where(e < plan.head, e, e - 4 * plan.groups)
    owner = torch.where(in_group, q % n_threads, s % n_threads)
    rnd = torch.where(in_group, 4 * (q // n_threads) + (e - plan.head) % 4,
                      group_rounds + s // n_threads)
    return owner, rnd


def sum_partials(partials, slices):
    """The last block's sum: slice s adds blocks s, s + slices, ... in
    order, then the slices are added in order."""
    B = partials.shape[0]
    total = None
    for s in range(slices):
        v = partials[s]
        for b in range(s + slices, B, slices):
            v = v + partials[b]
        total = v if total is None else total + v
    return total


def emulate_registers(g, xs, ys, h, w, plan):
    M = 2 * h * w
    cells, terms, on = event_terms(g, xs, ys, h, w)
    E = xs.shape[0]
    # each event's (M,) contribution: a cell gets its tap's term or an exact 0
    contrib = torch.zeros(E, h * w, 2)
    rows = torch.arange(E)
    for tap in (3, 2, 1, 0):  # the first tap wins where two share a cell
        sel = on[:, tap]
        contrib[rows[sel], cells[sel, tap]] = terms[sel, tap]
    contrib = contrib.reshape(E, M)
    owner, rnd = owners(E, plan)
    acc = torch.zeros(plan.blocks * plan.threads, M)
    for r in range(int(rnd.max()) + 1 if E else 0):
        sel = rnd == r
        assert owner[sel].unique().numel() == int(sel.sum())
        acc[owner[sel]] = acc[owner[sel]] + contrib[sel]
    v = acc.reshape(plan.blocks, plan.threads // 32, 32, M)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, :, lane ^ off]
    warp_sums = v[:, :, 0]
    partial = warp_sums[:, 0]
    for k in range(1, plan.threads // 32):
        partial = partial + warp_sums[:, k]
    return sum_partials(partial, plan.slices).reshape(h, w, 2)


def emulate_fixed(g, xs, ys, h, w, plan):
    M = 2 * h * w
    cells, terms, on = event_terms(g, xs, ys, h, w)
    E = xs.shape[0]
    owner, _ = owners(E, plan)
    block = owner // plan.threads
    partials = torch.zeros(plan.blocks, M)
    for b in range(plan.blocks):
        sel = block == b
        gb = g[sel]
        fin = torch.isfinite(gb)
        gmax = float(gb[fin].abs().max()) if bool(fin.any()) else 0.0
        expo = int(np.float32(gmax).view(np.uint32) >> 23) - 127
        s = min(29 - expo, 126)
        word = (2 * cells[sel][:, :, None] + torch.arange(2)).reshape(-1)
        term = terms[sel].reshape(-1)
        keep = on[sel][:, :, None].expand(-1, -1, 2).reshape(-1)
        word, term = word[keep], term[keep]
        finite = torch.isfinite(term)
        q = torch.round(term[finite].double() * 2.0**s).long()
        assert q.numel() == 0 or int(q.abs().max()) <= 2**30
        sums = torch.zeros(M, dtype=torch.long).index_add_(0, word[finite], q)
        v = sums.to(F32) * torch.tensor(2.0**-s, dtype=F32)
        partials[b] = flags_decide(v, word, term, M)
    return sum_partials(partials, plan.slices).reshape(h, w, 2)


def launch_shift(g, bits=30, max_shift=126):
    """csrc/exact.cuh:Fixed::shift of the largest finite |g|: the unit 2^-s
    with max |g| 2^s in [2^(bits-1), 2^bits)."""
    a = g.abs()
    a = a[torch.isfinite(a)]
    gmax = float(a.max()) if a.numel() else 0.0
    expo = (int(np.float32(gmax).view(np.uint32) >> 23) - 127 if bits == 30
            else int(np.float64(gmax).view(np.uint64) >> np.uint64(52)) - 1023)
    return min(bits - 1 - expo, max_shift)


def halves_add(lo, hi, q, width):
    """exact.cuh:band_terms on one word: lo += q with `width`-bit wrap, hi
    moves on a carry or for a negative q; returns (lo, hi)."""
    mask = (1 << width) - 1
    u = q & mask
    new_lo = (lo + u) & mask
    up = (-1 if q < 0 else 0) + (1 if new_lo < lo else 0)
    return new_lo, (hi + up) & mask


def flags_decide(v, word, term, M):
    """A word that got a non-finite term is +inf, -inf or NaN, as the float
    sum would be."""
    bad_w, bad_t = word[~torch.isfinite(term)], term[~torch.isfinite(term)]
    pos = torch.zeros(M, dtype=torch.bool).index_put_((bad_w[bad_t == np.inf],), torch.tensor(True))
    neg = torch.zeros(M, dtype=torch.bool).index_put_((bad_w[bad_t == -np.inf],), torch.tensor(True))
    nan = torch.zeros(M, dtype=torch.bool).index_put_((bad_w[torch.isnan(bad_t)],), torch.tensor(True))
    v = torch.where(pos, torch.tensor(np.inf, dtype=v.dtype), v)
    v = torch.where(neg, torch.tensor(-np.inf, dtype=v.dtype), v)
    return torch.where(nan | (pos & neg), torch.tensor(np.nan, dtype=v.dtype), v)


def emulate_exact(g, xs, ys, h, w, plan, block_order=None):
    """The exact mode: one unit for the launch; each block's terms summed
    (exactly, as its band's 32-bit halves do) over the plan's chunks and
    bands; the blocks' sums added into 64-bit words in `block_order` (the
    order the blocks arrive; default: block order), each rounded to f32
    once."""
    M = 2 * h * w
    cells, terms, on = event_terms(g, xs, ys, h, w)
    E = xs.shape[0]
    s = launch_shift(g)
    owner, _ = owners(E, plan)
    chunk = owner // plan.threads
    word = (2 * cells[:, :, None] + torch.arange(2)).reshape(E, -1)
    term = terms.reshape(E, -1)
    keep = on[:, :, None].expand(-1, -1, 2).reshape(E, -1)
    chunk = chunk[:, None].expand(-1, 8)[keep]
    word, term = word[keep], term[keep]
    finite = torch.isfinite(term)
    q = torch.round(term[finite].double() * 2.0**s).long()
    assert q.numel() == 0 or int(q.abs().max()) <= 2**30
    rows_per_band = plan.band_rows or h
    band = (word[finite] // (2 * w)) // rows_per_band
    block = chunk[finite] * plan.bands + band
    n_blocks = plan.blocks * plan.bands
    per_block = torch.zeros(n_blocks, M, dtype=torch.long)
    per_block.index_put_((block, word[finite]), q, accumulate=True)
    total = torch.zeros(M, dtype=torch.long)
    for b in (range(n_blocks) if block_order is None else block_order):
        total += per_block[b]  # the flush: a 64-bit integer atomic per word
    v = total.to(F32) * torch.tensor(2.0**-s, dtype=F32)
    return flags_decide(v, word, term, M).reshape(h, w, 2)


def emulate(g, xs, ys, h, w, plan):
    fn = {"registers": emulate_registers, "fixed": emulate_fixed, "banded": emulate_exact,
          "global": emulate_exact}[plan.mode]
    return fn(g, xs, ys, h, w, plan)


# ---- inputs -------------------------------------------------------------------

EDGE_XY = [
    (-1e4, -1e4),  # the padding sentinel
    (2.5, 3.5), (0.5, 1.5), (-0.5, -0.5),  # exact .5 ties: half to even
    (0.0, 0.0), (63.0, 47.0), (63.5, 47.5), (64.0, 48.0),  # at the edge
    (-1.0, 5.0), (-2.0, 5.0), (70.0, 60.0),  # beyond it
    (1e10, 3.0), (-1e10, 3.0), (3.0, 1e10),
]


def _events(rng, n=3000, clustered=600):
    """Uniform events, `clustered` events on one pixel neighbourhood (one
    coarse cell at every grid) and the edge cases; finite coordinates."""
    xs = np.concatenate([rng.uniform(-3, W + 2, n), rng.uniform(20.2, 20.4, clustered)])
    ys = np.concatenate([rng.uniform(-3, H + 2, n), rng.uniform(30.1, 30.3, clustered)])
    ex, ey = np.array(EDGE_XY, np.float64).T
    xs, ys = np.concatenate([xs, ex]), np.concatenate([ys, ey])
    order = rng.permutation(xs.size)
    return xs[order].astype(np.float32), ys[order].astype(np.float32)


def _plan(E, h, w, offsets=(0, 0, 0)):
    """A small launch: 3 blocks of 128 threads, so threads take several
    trips and the last block sums several partial grids."""
    return ti.plan_interp(E, h, w, True, offsets, blocks=3, threads=128, grouped=True)


def _plain_grad(g, xs, ys, h, w):
    th = torch.zeros(h, w, 2, requires_grad=True)
    out = ti.interp_theta_at_events_plain(th, xs, ys, SENSOR)
    return torch.autograd.grad(out, th, g)[0]


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    np.testing.assert_array_equal(np.isposinf(ref), np.isposinf(got))
    np.testing.assert_array_equal(np.isneginf(ref), np.isneginf(got))
    fin = np.isfinite(ref)
    scale = max(np.abs(ref[fin]).max(), 1e-30) if fin.any() else 1.0
    err = np.abs(ref[fin] - got[fin]).max() if fin.any() else 0.0
    assert err <= tol * scale, err / scale


# ---- (a) the backward's accumulation ---------------------------------------------

@pytest.mark.parametrize("gh,gw", GRIDS)
def test_taps_match_the_plain_version(gh, gw):
    rng = np.random.default_rng(5)
    xs, ys = _events(rng)
    for coord, n, full in ((torch.as_tensor(ys), gh, H), (torch.as_tensor(xs), gw, W)):
        a, b, w0, w1, _, _ = axis_taps(coord, n, full)
        pa, pb, pw0, pw1 = ti._axis_taps(coord, n, full, True)
        assert torch.equal(w0, pw0) and torch.equal(w1, pw1)
        assert torch.equal(a[w0 != 0], pa[w0 != 0]) and torch.equal(b[w1 != 0], pb[w1 != 0])


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("gh,gw", GRIDS)
def test_emulation_matches_autograd_and_jax(gh, gw, offset):
    rng = np.random.default_rng(100 * gh + gw)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    plan = _plan(xs.size, gh, gw, (offset, offset, 2 * offset % 4))
    assert plan.mode == ("registers" if max(gh, gw) <= 4 else "fixed")
    assert plan.head == -offset % 4 and plan.groups > 3 * 128 and plan.slices >= 1
    got = emulate(*map(torch.as_tensor, (g, xs, ys)), gh, gw, plan)
    _close(_plain_grad(*map(torch.as_tensor, (g, xs, ys)), gh, gw), got, TOL)
    jx, jy, jg = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g)
    ref = jax.grad(lambda t: jnp.vdot(jw.interp_theta_at_events(t, jx, jy, SENSOR), jg))(
        jnp.zeros((gh, gw, 2), jnp.float32))
    _close(ref, got, TOL)


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_emulation_one_by_one_matches_groups(gh, gw):
    """Reading every event one by one gives each thread other events: the
    fixed-point sums of a call change only through the blocks' units."""
    rng = np.random.default_rng(7)
    xs, ys = _events(rng, 1500, 300)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    single = ti.plan_interp(xs.size, gh, gw, True, blocks=2, threads=160, grouped=False)
    assert (single.head, single.groups, single.tail) == (xs.size, 0, 0)
    _close(_plain_grad(*args, gh, gw), emulate(*args, gh, gw, single), TOL)


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_emulation_every_event_on_one_cell(gh, gw):
    """The worst contention, 4000 events inside one pixel, with cotangents
    of very different sizes: held to the plain version in f64."""
    rng = np.random.default_rng(8)
    xs = rng.uniform(20.2, 20.4, 4000).astype(np.float32)
    ys = rng.uniform(30.1, 30.3, 4000).astype(np.float32)
    g = (rng.normal(0, 1, (4000, 2)) * 10.0 ** rng.uniform(-3, 3, (4000, 1))).astype(np.float32)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    th = torch.zeros(gh, gw, 2, dtype=torch.float64, requires_grad=True)
    out = ti.interp_theta_at_events_plain(th, args[1].double(), args[2].double(), SENSOR)
    (ref,) = torch.autograd.grad(out, th, args[0].double())
    _close(ref, emulate(*args, gh, gw, _plan(4000, gh, gw)), TOL)


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_emulation_nan_and_inf_pattern(gh, gw):
    """NaN and infinite coordinates and cotangents poison the same entries
    as in the plain version. The plain version also adds 0 x inf = NaN at
    the clamped cell of a tap outside the grid, which the kernel skips: the
    infinite cotangents sit on events with both taps of both axes inside,
    and an axis of one cell (which has no such event) gets none."""
    rng = np.random.default_rng(9)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    # interior events: rounded coordinate between the centres of the first
    # and the last cell of each axis
    xi = (np.round(xs) + 0.5) * gw / W - 0.5
    yi = (np.round(ys) + 0.5) * gh / H - 0.5
    inside = np.flatnonzero((xi > 0.05) & (xi < gw - 1.05) & (yi > 0.05) & (yi < gh - 1.05))
    if min(gh, gw) > 1:
        assert inside.size > 10
        g[inside[0], 0] = np.inf
        g[inside[1], 1] = -np.inf
        g[inside[2]] = np.nan
        ys[inside[3]] = np.nan  # NaN weights on an event whose x taps are inside
        xs[inside[4]] = np.nan
    else:
        g[5] = np.nan
    # infinite coordinates have no tap
    xs[7], ys[8] = np.inf, -np.inf
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    ref = _plain_grad(*args, gh, gw)
    assert bool(torch.isnan(ref).any())
    _close(ref, emulate(*args, gh, gw, _plan(xs.size, gh, gw)), TOL)


def test_fixed_point_unit_ignores_non_finite_cotangents():
    """An infinite cotangent sets a flag and leaves the block's unit to the
    finite ones: the other entries keep their precision."""
    rng = np.random.default_rng(10)
    xs, ys = _events(rng, 500, 0)
    g = rng.normal(0, 1e-3, (xs.size, 2)).astype(np.float32)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    ref = _plain_grad(*args, 8, 8)
    g[:, 0][np.flatnonzero((xs > 30) & (xs < 34) & (ys > 20) & (ys < 24))[0]] = np.inf
    got = emulate(torch.as_tensor(g), *args[1:], 8, 8, _plan(xs.size, 8, 8))
    hit = torch.isinf(got)
    assert 1 <= int(hit.sum()) <= 4 and not bool(torch.isnan(got).any())
    _close(ref[~hit], got[~hit], TOL)


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_backward_plain_version_matches_autograd(gh, gw):
    """`interp_bwd_plain` adds the terms autograd adds: equal within f32
    summation in float32, and the float64 sum lies within both."""
    rng = np.random.default_rng(11)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    ref = _plain_grad(*args, gh, gw)
    _close(ref, ti.interp_bwd_plain(*args, (gh, gw, 2), SENSOR), TOL)
    exact = ti.interp_bwd_plain(*args, (gh, gw, 2), SENSOR, torch.float64)
    assert exact.dtype == torch.float64
    _close(exact, ref, TOL)
    _close(exact, emulate(*args, gh, gw, _plan(xs.size, gh, gw)), 2e-7)


# ---- (b) the launch plan ------------------------------------------------------

@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("grid", [(1, 1), (4, 4), (16, 16), (32, 32), (5, 12), (64, 64), (128, 128),
                                  (256, 256), (480, 640)])
@pytest.mark.parametrize("E", [0, 1, 3, 30_000, 1_500_000])
def test_plan_invariants(E, grid, backward):
    h, w = grid
    for xo, yo, go, grouped in itertools.product(range(4), range(4), range(4), (None, True)):
        p = ti.plan_interp(E, h, w, backward, (xo, yo, go), grouped=grouped)
        # every event once: head, groups of four, tail
        assert p.head + 4 * p.groups + p.tail == E
        assert 0 <= p.tail < 4 and (p.head < 4 or p.head == E)
        if grouped is None and E < ti.GROUP_EVENTS:
            assert p.groups == 0 and p.head == E  # few events: one per thread
        elif xo == yo:
            assert p.head == min(E, -xo % 4)
        if p.groups:
            # a group starts where xs and ys are 16-byte aligned
            assert (xo + p.head) % 4 == 0 and (yo + p.head) % 4 == 0
            at = (go + 2 * p.head) % 4
            assert p.vec == {0: 4, 2: 2}.get(at, 1)
        assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
        assert 1 <= p.blocks <= max(1, -(-p.work // p.threads))
        static = (ti.STATIC_SMEM if p.mode in ti.MODES else ti.EXACT_STATIC_SMEM) if backward else 0
        assert p.smem_bytes + static <= ti.SMEM_BLOCK
        if not backward:
            assert p.mode == ("staged" if 8 * h * w <= ti.FWD_STAGED_BYTES else "ldg")
            assert p.smem_bytes == (8 * h * w if p.mode == "staged" else 0)
            continue
        words = 2 * h * w
        if max(h, w) <= 4:
            assert p.mode == "registers" and p.threads >= words
        elif words <= ti.BWD_FIXED_WORDS:
            assert p.mode == "fixed"
        else:  # exact sums in one unit per launch, in bands or not
            assert p.mode in ti.EXACT_MODES
        if p.mode == "fixed":
            assert p.smem_bytes >= 9 * words
        # the last block sums slices x words partial sums at once
        assert p.slices >= 1 and p.slices & (p.slices - 1) == 0
        lanes = words // 4 if words % 4 == 0 else words
        if p.mode in ti.EXACT_MODES:
            assert p.slices == 1  # no partial grids: exact sums in device memory
            if p.mode == "banded":
                # the bands cover the grid's rows, each within one block's memory
                assert p.bands == -(-h // p.band_rows) and (p.bands - 1) * p.band_rows < h
                assert p.smem_bytes == 8 * p.band_rows * 2 * w
                assert p.bands <= ti.BANDED_MAX_BANDS[False]
            else:
                assert p.band_rows == 0 and p.bands == 1 and p.smem_bytes == 0
        else:
            assert p.slices * lanes <= p.threads and p.slices <= p.blocks


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("E", [0, 1, 3, 4, 7, 1000, 4099])
def test_plan_gives_every_event_to_one_thread_once(E, grouped):
    for offset in range(4):
        p = ti.plan_interp(E, 8, 8, True, (offset, offset, 0), blocks=3, threads=64,
                           grouped=grouped)
        owner, rnd = owners(E, p)
        slot = owner * (int(rnd.max()) + 1 if E else 1) + rnd
        assert slot.unique().numel() == E
        assert E == 0 or (0 <= int(owner.min()) and int(owner.max()) < 3 * 64)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        ti.plan_interp(10, 0, 4)
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, True, mode="float")  # the float-atomic mode is gone
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, f64=True)  # the float64 forward has no plan
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, True, mode="fixed", f64=True)
    with pytest.raises(ValueError):
        ti.plan_interp(10, 256, 256, True, mode="banded", band_rows=200)  # 819 KB a band
    with pytest.raises(ValueError):
        ti.plan_interp(-1, 4, 4)
    with pytest.raises(ValueError):
        ti.plan_interp(10, 8, 8, True, mode="registers")
    with pytest.raises(ValueError):
        ti.plan_interp(10, 128, 128, True, mode="fixed")  # 288 KB of sums
    with pytest.raises(ValueError):
        ti.plan_interp(10, 128, 128, mode="staged")
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, True, threads=1024)  # the register kernel's limit
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, threads=48)
    with pytest.raises(ValueError):
        ti.plan_interp(10, 4, 4, blocks=0)
    with pytest.raises(ValueError):
        ti.plan_interp(10, 16, 16, True, threads=64)  # 128 threads sum 512 words


# ---- (c) above 16x16: exact sums in one unit per launch ---------------------

SENSOR_L = (300, 320)
# 81x81 is pyramid_bases=(3, 3, 3, 3)'s finest grid; 256x256 needs more
# shared memory than a block has (five bands); 40x72 is not square
EXACT_GRIDS = [(32, 32), (64, 64), (81, 81), (128, 128), (256, 256), (40, 72)]


def _events_l(rng, n=4000, clustered=800):
    """`_events` on SENSOR_L: uniform, clustered on one pixel, the edges."""
    HL, WL = SENSOR_L
    xs = np.concatenate([rng.uniform(-3, WL + 2, n), rng.uniform(120.2, 120.4, clustered)])
    ys = np.concatenate([rng.uniform(-3, HL + 2, n), rng.uniform(130.1, 130.3, clustered)])
    ex = np.array([-1e4, 2.5, -0.5, 0.0, WL - 1.0, WL - 0.5, WL, -1.0, 1e10], np.float64)
    ey = np.array([-1e4, 3.5, -0.5, 0.0, HL - 1.0, HL - 0.5, HL, 5.0, 3.0], np.float64)
    xs, ys = np.concatenate([xs, ex]), np.concatenate([ys, ey])
    order = rng.permutation(xs.size)
    return xs[order].astype(np.float32), ys[order].astype(np.float32)


def _exact_plan(E, h, w, mode, offsets=(0, 0, 0), **kw):
    """A small launch of the exact kernel: 3 chunks of 128 threads (per band)."""
    kw = {"blocks": 3, "threads": 128, "grouped": True, **kw}
    return ti.plan_interp(E, h, w, True, offsets, mode, **kw)


def _emulate_on(sensor, *args):
    global H, W
    saved = H, W
    H, W = sensor
    try:
        return emulate(*args)
    finally:
        H, W = saved


@pytest.mark.parametrize("mode", ti.EXACT_MODES)
@pytest.mark.parametrize("gh,gw", EXACT_GRIDS)
def test_exact_emulation_matches_autograd_and_jax(gh, gw, mode):
    rng = np.random.default_rng(300 + gh + gw)
    xs, ys = _events_l(rng)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    plan = _exact_plan(xs.size, gh, gw, mode, (1, 1, 2))
    assert plan.mode == mode and plan.groups > 3 * 128
    if mode == "banded":
        assert plan.bands == -(-gh // plan.band_rows) and plan.bands == {128: 2, 256: 5}.get(gh, 1)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    got = _emulate_on(SENSOR_L, *args, gh, gw, plan)
    th = torch.zeros(gh, gw, 2, requires_grad=True)
    out = ti.interp_theta_at_events_plain(th, args[1], args[2], SENSOR_L)
    _close(torch.autograd.grad(out, th, args[0])[0], got, TOL)
    exact = ti.interp_bwd_plain(*args, (gh, gw, 2), SENSOR_L, torch.float64)
    _close(exact, got, 2e-7)
    jx, jy, jg = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g)
    ref = jax.grad(lambda t: jnp.vdot(jw.interp_theta_at_events(t, jx, jy, SENSOR_L), jg))(
        jnp.zeros((gh, gw, 2), jnp.float32))
    _close(ref, got, TOL)


@pytest.mark.parametrize("gh,gw", EXACT_GRIDS)
def test_exact_emulation_is_bitwise_order_free(gh, gw):
    """The card's premise: the same bits under a random permutation of the
    events (within blocks and across them), for another plan (chunks,
    threads, bands, grouping) and whatever order the blocks arrive in."""
    rng = np.random.default_rng(400 + gh + gw)
    xs, ys = _events_l(rng)
    g = (rng.normal(0, 1, (xs.size, 2)) * 10.0 ** rng.uniform(-2, 2, (xs.size, 1))).astype(np.float32)
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    base = _emulate_on(SENSOR_L, *args, gh, gw, _exact_plan(xs.size, gh, gw, "banded"))
    perm = torch.as_tensor(rng.permutation(xs.size))
    pargs = tuple(a[perm].contiguous() for a in args)
    for plan in (_exact_plan(xs.size, gh, gw, "global"),
                 _exact_plan(xs.size, gh, gw, "banded", blocks=5, threads=64,
                             band_rows=max(1, gh // 7)),
                 _exact_plan(xs.size, gh, gw, "banded", grouped=False)):
        got = _emulate_on(SENSOR_L, *pargs, gh, gw, plan)
        assert torch.equal(got, base), plan
    plan = _exact_plan(xs.size, gh, gw, "banded", blocks=4)
    order = rng.permutation(plan.blocks * plan.bands)
    assert torch.equal(_emulate_on(SENSOR_L, *args, gh, gw, plan), base)
    assert torch.equal(emulate_exact_on_l(args, gh, gw, plan, order), base)


def emulate_exact_on_l(args, gh, gw, plan, order):
    global H, W
    saved = H, W
    H, W = SENSOR_L
    try:
        return emulate_exact(*args, gh, gw, plan, block_order=order)
    finally:
        H, W = saved


@pytest.mark.parametrize("gh,gw", [(32, 32), (40, 72)])
def test_exact_emulation_nan_and_inf_pattern(gh, gw):
    """Non-finite cotangents and coordinates poison the plain version's
    entries (the flags), and leave the launch's unit to the finite |g|."""
    rng = np.random.default_rng(12)
    xs, ys = _events_l(rng)
    g = rng.normal(0, 1, (xs.size, 2)).astype(np.float32)
    HL, WL = SENSOR_L
    xi = (np.round(xs) + 0.5) * gw / WL - 0.5
    yi = (np.round(ys) + 0.5) * gh / HL - 0.5
    inside = np.flatnonzero((xi > 0.05) & (xi < gw - 1.05) & (yi > 0.05) & (yi < gh - 1.05))
    g[inside[0], 0] = np.inf
    g[inside[1], 1] = -np.inf
    g[inside[2]] = np.nan
    ys[inside[3]] = np.nan
    xs[inside[4]] = np.nan
    xs[7], ys[8] = np.inf, -np.inf
    args = tuple(map(torch.as_tensor, (g, xs, ys)))
    th = torch.zeros(gh, gw, 2, requires_grad=True)
    out = ti.interp_theta_at_events_plain(th, args[1], args[2], SENSOR_L)
    ref = torch.autograd.grad(out, th, args[0])[0]
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    for mode in ti.EXACT_MODES:
        _close(ref, _emulate_on(SENSOR_L, *args, gh, gw, _exact_plan(xs.size, gh, gw, mode)), TOL)


@pytest.mark.parametrize("width", [32, 64])
def test_halves_carry_is_the_exact_sum_in_any_order(width):
    """exact.cuh:band_terms keeps a word as (lo, hi) halves of `width` bits
    (32 in float32, 64 in float64): lo wraps, hi takes the carry and the
    sign of each term. Whatever the order, (hi, lo) is the exact sum modulo
    2^(2 width), and the flush that adds (hi, lo) into device memory, the
    carry out of lo into hi, keeps it so."""
    rng = np.random.default_rng(width)
    bound = 2 ** (30 if width == 32 else 62)
    q = [int(v) for v in rng.integers(-bound, bound + 1, 3000, dtype=np.int64)]
    q += [bound, -bound, 1, -1, 0]
    exact = sum(q)
    mask2 = (1 << (2 * width)) - 1
    for _ in range(4):
        order = rng.permutation(len(q))
        lo = hi = 0
        for i in order:
            lo, hi = halves_add(lo, hi, q[i], width)
        assert (hi << width) | lo == exact & mask2
        # two blocks' words flushed into one in device memory, either order
        half = len(order) // 2
        blocks = []
        for part in (order[:half], order[half:]):
            b_lo = b_hi = 0
            for i in part:
                b_lo, b_hi = halves_add(b_lo, b_hi, q[i], width)
            blocks.append((b_lo, b_hi))
        for first, second in (blocks, blocks[::-1]):
            g_lo, g_hi = first
            mask = (1 << width) - 1
            new = (g_lo + second[0]) & mask
            g_hi = (g_hi + second[1] + (1 if new < g_lo else 0)) & mask
            assert (g_hi << width) | new == exact & mask2
