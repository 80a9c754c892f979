"""The float64 and wrap-compat kernels of `csrc/direct.cu`, emulated on the
CPU: the float64 interp backward's exact sums (`csrc/exact.cuh`) and the
direct splat forward's slab routing with the reference's wrap.

- interp backward, float64: one unit 2^-s for the launch, max |g| 2^s in
  [2^61, 2^62); every term (vx g) uy of `interp_bwd_plain` (all four taps,
  a clamped one with its zero weight) rounded once to an integer; the
  integers summed exactly (128 bits on the card: two 64-bit halves with a
  carry) and each sum rounded to float64 once. Held within 1e-12 x max
  |dtheta| to the correctly rounded sum of the same terms (`math.fsum`),
  to `torch.autograd.grad` and to `jax.grad` under `jax.enable_x64`, and
  bitwise the same under a permutation of the events.
- splat forward: block (ref, slab) of `plan_splat` takes an event when a
  tap of its window lands in the block's tile (the window's rows are up to
  two runs of the frame with the wrap: [0, n) directly and [-n, -1] at
  n + s), and adds the taps inside its tile, each rounded to 2^-24
  (float32) or 2^-62 (float64) and summed exactly. Every tap must land in
  exactly one block, and the frames must equal `splat_plain(..., wrap)`'s
  and the JAX package's (`_axis_weights(wrap=True)`) within 1e-5 (float32,
  the card's TOL_ATOMIC) or 1e-12 (float64), for every plan.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import splat as js
from eincm_tpu.ops import warp as jw
from eincm_tpu_torch.ops import interp as ti
from eincm_tpu_torch.ops import splat_kernel as sk

F64 = torch.float64
SENSOR = (300, 320)
H, W = SENSOR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the float64 interp backward ---------------------------------------------

def launch_shift(g):
    """csrc/exact.cuh:Fixed<double>::shift of the largest finite |g|."""
    a = g.abs()
    a = a[torch.isfinite(a)]
    gmax = float(a.max()) if a.numel() else 0.0
    expo = int(np.float64(gmax).view(np.uint64) >> np.uint64(52)) - 1023
    return min(62 - 1 - expo, 1022)


def terms_f64(g, xs, ys, h, w, sensor):
    """(word, term) of every term `interp_bwd_plain` adds: four taps of two
    channels per event, the direct kernel's order ((vx g) uy)."""
    y0, y1, uy0, uy1 = ti._axis_taps(ys, h, sensor[0], True)
    x0, x1, vx0, vx1 = ti._axis_taps(xs, w, sensor[1], True)
    words, terms = [], []
    for xc, vx in ((x0, vx0), (x1, vx1)):
        c = vx[:, None] * g
        for yc, uy in ((y0, uy0), (y1, uy1)):
            words.append(2 * (yc * w + xc)[:, None] + torch.arange(2))
            terms.append(c * uy[:, None])
    return torch.cat(words, 1).reshape(-1), torch.cat(terms, 1).reshape(-1)


def exact_words(word, q, m):
    """The exact integer sum of q per word, as Python ints (the 128-bit sums):
    q split into 32-bit halves whose sums int64 holds."""
    lo = torch.zeros(m, dtype=torch.long).index_add_(0, word, q & 0xFFFFFFFF)
    hi = torch.zeros(m, dtype=torch.long).index_add_(0, word, q >> 32)
    return [(int(a) << 32) + int(b) for a, b in zip(hi.tolist(), lo.tolist())]


def flags_decide(v, word, term):
    """Words with a term that is not finite: +inf, -inf or NaN, as the sum."""
    for i, t in zip(word[~torch.isfinite(term)].tolist(), term[~torch.isfinite(term)].tolist()):
        old = v[i]
        if math.isnan(t) or math.isnan(old) or (math.isinf(old) and old != t):
            v[i] = math.nan
        else:
            v[i] = t
    return v


def emulate_direct_bwd(g, xs, ys, h, w, sensor=SENSOR):
    word, term = terms_f64(g, xs, ys, h, w, sensor)
    m = 2 * h * w
    s = launch_shift(g)
    fin = torch.isfinite(term)
    q = torch.round(term[fin] * 2.0**s).long()
    assert q.numel() == 0 or int(q.abs().max()) <= 2**62
    v = [math.ldexp(float(t), -s) for t in exact_words(word[fin], q, m)]
    # the kernel's flags decide a word once any term is not finite; here
    # the finite sum is replaced term by term (+inf and -inf: NaN)
    bad = torch.zeros(m, dtype=torch.bool)
    bad[word[~fin]] = True
    v = flags_decide(v, word, term)
    out = torch.tensor(v, dtype=F64)
    return out.reshape(h, w, 2), bad.reshape(h, w, 2)


def fsum_reference(g, xs, ys, h, w, sensor=SENSOR):
    """The correctly rounded sum of each word's float64 terms."""
    word, term = terms_f64(g, xs, ys, h, w, sensor)
    order = torch.argsort(word, stable=True)
    word, term = word[order].tolist(), term[order].tolist()
    out = [0.0] * (2 * h * w)
    i = 0
    while i < len(word):
        j = i
        while j < len(word) and word[j] == word[i]:
            j += 1
        out[word[i]] = math.fsum(term[i:j])
        i = j
    return torch.tensor(out, dtype=F64).reshape(h, w, 2)


def _events(rng, n=3000, clustered=600):
    xs = np.concatenate([rng.uniform(-3, W + 2, n), rng.uniform(120.2, 120.4, clustered)])
    ys = np.concatenate([rng.uniform(-3, H + 2, n), rng.uniform(130.1, 130.3, clustered)])
    ex = np.array([-1e4, 2.5, -0.5, 0.0, W - 1.0, W - 0.5, W, -1.0, 1e10])
    ey = np.array([-1e4, 3.5, -0.5, 0.0, H - 1.0, H - 0.5, H, 5.0, 3.0])
    xs, ys = np.concatenate([xs, ex]), np.concatenate([ys, ey])
    order = rng.permutation(xs.size)
    return xs[order], ys[order]


def _close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
    np.testing.assert_array_equal(np.isposinf(ref), np.isposinf(got))
    np.testing.assert_array_equal(np.isneginf(ref), np.isneginf(got))
    fin = np.isfinite(ref)
    scale = max(np.abs(ref[fin]).max(), 1e-300) if fin.any() else 1.0
    err = np.abs(ref[fin] - got[fin]).max() if fin.any() else 0.0
    assert err <= tol * scale, err / scale


# 16x16: the chain's finest grid (MVSEC, DSEC); 32x32: n_pyr_lvls=6; 81x81:
# pyramid_bases=(3, 3, 3, 3); 256x256: more than one band of shared memory
# holds (10 bands); 40x72: not square
GRIDS = [(16, 16), (32, 32), (64, 64), (81, 81), (128, 128), (256, 256), (40, 72)]


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_direct_bwd_emulation_matches_fsum_autograd_and_jax(gh, gw):
    rng = np.random.default_rng(500 + gh + gw)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2)) * 10.0 ** rng.uniform(-3, 3, (xs.size, 1))
    tg, tx, ty = (torch.as_tensor(a, dtype=F64) for a in (g, xs, ys))
    got, _ = emulate_direct_bwd(tg, tx, ty, gh, gw)
    _close(fsum_reference(tg, tx, ty, gh, gw), got, 1e-12)
    th = torch.zeros(gh, gw, 2, dtype=F64, requires_grad=True)
    out = ti.interp_theta_at_events_plain(th, tx, ty, SENSOR)
    _close(torch.autograd.grad(out, th, tg)[0], got, 1e-12)
    _close(ti.interp_bwd_plain(tg, tx, ty, (gh, gw, 2), SENSOR), got, 1e-12)
    with jax.enable_x64(True):
        jx, jy, jg = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g)
        ref = jax.grad(lambda t: jnp.vdot(jw.interp_theta_at_events(t, jx, jy, SENSOR), jg))(
            jnp.zeros((gh, gw, 2), jnp.float64))
        ref = np.asarray(ref)
    _close(ref, got, 1e-12)


@pytest.mark.parametrize("gh,gw", GRIDS)
def test_direct_bwd_emulation_is_bitwise_order_free(gh, gw):
    rng = np.random.default_rng(600 + gh + gw)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2))
    tg, tx, ty = (torch.as_tensor(a, dtype=F64) for a in (g, xs, ys))
    base, _ = emulate_direct_bwd(tg, tx, ty, gh, gw)
    for seed in (1, 2):
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(xs.size))
        got, _ = emulate_direct_bwd(tg[perm], tx[perm], ty[perm], gh, gw)
        assert torch.equal(got, base)
    # the blocks' 128-bit sums in any order: the halves' carry arithmetic
    word, term = terms_f64(tg, tx, ty, gh, gw, SENSOR)
    q = torch.round(term * 2.0 ** launch_shift(tg)).long()
    k = int(torch.argmax(torch.bincount(word)))
    vals = q[word == k].tolist()
    mask = (1 << 64) - 1
    for seed in (3, 4):
        lo = hi = 0
        for i in np.random.default_rng(seed).permutation(len(vals)):
            u = vals[i] & mask
            new = (lo + u) & mask
            hi = (hi + (mask if vals[i] < 0 else 0) + (1 if new < lo else 0)) & mask
            lo = new
        total = (hi << 64) | lo
        assert total - (1 << 128) * (total >> 127) == sum(vals)


def test_direct_bwd_emulation_nan_and_inf():
    """A non-finite cotangent poisons the four cells its event's taps
    gather, clamped cells included (0 x inf is NaN), as the plain version;
    the launch's unit follows the finite |g|."""
    rng = np.random.default_rng(7)
    xs, ys = _events(rng)
    g = rng.normal(0, 1, (xs.size, 2))
    g[3, 0], g[4, 1], g[5] = np.inf, -np.inf, np.nan
    ys[6] = np.nan
    tg, tx, ty = (torch.as_tensor(a, dtype=F64) for a in (g, xs, ys))
    got, bad = emulate_direct_bwd(tg, tx, ty, 32, 32)
    ref = ti.interp_bwd_plain(tg, tx, ty, (32, 32, 2), SENSOR)
    assert bool(bad.any()) and bool(torch.isnan(ref).any())
    _close(ref, got, 1e-12)


@pytest.mark.parametrize("E", [1, 30_000, 1_500_000])
@pytest.mark.parametrize("grid", [(1, 1), (16, 16), (32, 32), (64, 64), (81, 81), (128, 128),
                                  (256, 256), (480, 640)])
def test_f64_plan_invariants(grid, E):
    h, w = grid
    p = ti.plan_interp(E, h, w, True, f64=True)
    assert (p.head, p.groups, p.tail, p.vec) == (E, 0, 0, 1)  # one by one
    assert p.mode in ti.EXACT_MODES and p.threads == 512 and p.slices == 1
    assert 1 <= p.blocks <= max(1, -(-E // p.threads))
    if p.mode == "banded":
        assert p.bands == 1 and p.band_rows == h
        assert p.smem_bytes == 16 * 2 * h * w <= ti.SMEM_BLOCK - ti.EXACT_STATIC_SMEM
        assert p.blocks * 2 * h * w <= ti.BANDED_WRITEBACK_F64 * E
    else:
        assert p.smem_bytes == 0 and p.band_rows == 0
    # the float64 kernel takes no other mode
    with pytest.raises(ValueError):
        ti.plan_interp(E, h, w, True, mode="registers", f64=True)


def test_exact_scratch_bytes_match_the_layout():
    """csrc/exact.cuh:ExactLayout: sums, a flag byte a word, the partial
    maxima, the shift, each part on 16 bytes."""
    assert ti.exact_scratch_bytes(512, False) == 4096 + 512 + 1056 + 16
    assert ti.exact_scratch_bytes(512, True) == 8192 + 512 + 2112 + 16
    assert ti.exact_scratch_bytes(6, True) == 96 + 16 + 2112 + 16


# ---- the direct splat forward: slabs and the wrap ------------------------------

def _texel(s, n, wrap):
    valid = (s < n) & (s >= (-n if wrap else 0))
    return torch.where(valid, torch.where(s < 0, s + n, s), torch.full_like(s, -1))


def _span_hits(lo, hi, n, a0, a1, wrap):
    l, h = lo.clamp_min(0), hi.clamp_max(n - 1)
    hit = (l <= h) & (l < a1) & (h >= a0)
    if wrap:
        wl, wh = lo.clamp_min(-n) + n, hi.clamp_max(-1) + n
        hit = hit | ((wl <= wh) & (wl < a1) & (wh >= a0))
    return hit


def emulate_direct_fwd(wx, wy, sensor, ws, wrap, plan):
    """The frames of csrc/direct.cu:splat_direct_fwd_kernel: each block
    (ref, slab) queues the events whose window reaches its tile and adds
    their taps inside it, rounded to the unit and summed exactly. Also
    asserts that every tap of the plain version lands in exactly one block."""
    Hs, Ws = sensor
    R, E = wx.shape
    dtype = wx.dtype
    hw = ws // 2
    rx, ry = torch.round(wx), torch.round(wy)
    lo_r, lo_c = (-Hs, -Ws) if wrap else (0, 0)
    ok = (ry >= lo_r - hw) & (ry <= Hs - 1 + hw) & (rx >= lo_c - hw) & (rx <= Ws - 1 + hw)
    zero = torch.zeros((), dtype=dtype)
    iy = torch.where(ok, ry, zero).long()
    ix = torch.where(ok, rx, zero).long()
    d = torch.arange(-hw, hw + 1)
    trow = _texel(iy[..., None] + d, Hs, wrap)  # (R, E, taps)
    tcol = _texel(ix[..., None] + d, Ws, wrap)
    gy = sk._gauss1d((ry[..., None] + d.to(dtype)) - wy[..., None])
    gx = sk._gauss1d((rx[..., None] + d.to(dtype)) - wx[..., None])
    val = gy[..., :, None] * gx[..., None, :]  # (R, E, taps, taps)
    valid = ok[..., None, None] & (trow >= 0)[..., :, None] & (tcol >= 0)[..., None, :]
    unit_bits = 62 if dtype == F64 else 24
    q = torch.round(val * 2.0**unit_bits).long()
    texel = (torch.arange(R)[:, None, None, None] * Hs + trow[..., :, None]) * Ws + tcol[..., None, :]
    count = torch.zeros_like(valid, dtype=torch.long)
    n = R * Hs * Ws
    lo = torch.zeros(n, dtype=torch.long)
    hi = torch.zeros(n, dtype=torch.long)
    for rs in range(plan.row_slabs):
        r0, r1 = rs * plan.tile_rows, min(Hs, (rs + 1) * plan.tile_rows)
        for cs in range(plan.col_slabs):
            c0, c1 = cs * plan.tile_cols, min(Ws, (cs + 1) * plan.tile_cols)
            hit = ok & _span_hits(iy - hw, iy + hw, Hs, r0, r1, wrap) & _span_hits(
                ix - hw, ix + hw, Ws, c0, c1, wrap)
            inside = (valid & hit[..., None, None] & ((trow >= r0) & (trow < r1))[..., :, None]
                      & ((tcol >= c0) & (tcol < c1))[..., None, :])
            count += inside.long()
            lo.index_add_(0, texel[inside], q[inside] & 0xFFFFFFFF)
            hi.index_add_(0, texel[inside], q[inside] >> 32)
    assert torch.equal(count, valid.long()), "a tap missed its block or landed twice"
    if dtype == F64:
        vals = [math.ldexp(float((int(a) << 32) + int(b)), -62)
                for a, b in zip(hi.tolist(), lo.tolist())]
        return torch.tensor(vals, dtype=F64).reshape(R, Hs, Ws)
    total = (hi << 32) + lo  # < 2^63: every float32 texel's sum
    return (total.to(torch.float32) * torch.tensor(2.0**-24, dtype=torch.float32)).reshape(
        R, Hs, Ws)


SPLAT_SENSOR = (12, 17)


def _edge_events(rng, sensor, n=400):
    """Uniform events around the sensor, and events on every edge and corner
    and on both sides of -0.5 (which rounds to -0, half to even), of -n and
    of the far edges."""
    Hs, Ws = sensor
    xs = list(rng.uniform(-Ws - 3, Ws + 3, n))
    ys = list(rng.uniform(-Hs - 3, Hs + 3, n))
    edge_x = [-0.51, -0.5, -0.49, 0.0, -1.0, -1.5, -2.5, Ws - 1.0, Ws - 0.51, Ws - 0.5,
              Ws + 0.5, Ws + 1.5, -Ws - 0.5, -Ws - 0.51, -Ws - 1.5, -Ws - 2.5, 0.49]
    edge_y = [-0.51, -0.5, -0.49, 0.0, -1.0, -1.5, -2.5, Hs - 1.0, Hs - 0.51, Hs - 0.5,
              Hs + 0.5, Hs + 1.5, -Hs - 0.5, -Hs - 0.51, -Hs - 1.5, -Hs - 2.5, 0.49]
    for x in edge_x:  # every pair: the edges and the corners
        for y in edge_y:
            xs.append(x)
            ys.append(y)
    xs += [np.nan, np.inf, 3.0, -1e4]
    ys += [2.0, 3.0, -np.inf, -1e4]
    order = rng.permutation(len(xs))
    return np.asarray(xs)[order], np.asarray(ys)[order]


def _plans(R, E, sensor, texel_bytes):
    """Whole-row slabs of 5 rows, one-row slabs of 6 columns, the default."""
    Hs, Ws = sensor
    return [sk.plan_splat(R, E, Hs, Ws, 16 * -(-5 * Ws * texel_bytes // 16), texel_bytes),
            sk.plan_splat(R, E, Hs, Ws, 16 * -(-6 * texel_bytes // 16), texel_bytes),
            sk.plan_splat(R, E, Hs, Ws, texel_bytes=texel_bytes)]


def _jax_frames(xs, ys, sensor, ws, f64):
    js.set_splat_wrap_compat(True)
    try:
        with jax.enable_x64(f64):
            dt = jnp.float64 if f64 else jnp.float32
            return np.stack([np.asarray(js.events_to_pdf_frame(
                jnp.asarray(x, dt), jnp.asarray(y, dt), sensor, ws)) for x, y in zip(xs, ys)])
    finally:
        js.set_splat_wrap_compat(False)


@pytest.mark.parametrize("ws", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_direct_fwd_wrap_emulation_matches_plain_and_jax(dtype, ws):
    rng = np.random.default_rng(ws)
    ev = [_edge_events(rng, SPLAT_SENSOR) for _ in range(2)]
    xs = np.stack([e[0] for e in ev])
    ys = np.stack([e[1] for e in ev])
    wx, wy = torch.as_tensor(xs, dtype=dtype), torch.as_tensor(ys, dtype=dtype)
    f64 = dtype == F64
    tol = 1e-12 if f64 else 1e-5
    plain = sk.splat_plain(wx, wy, SPLAT_SENSOR, ws, wrap=True)
    fin = np.isfinite(xs) & np.isfinite(ys)  # the JAX path wants finite coordinates
    jax_ref = _jax_frames(np.where(fin, xs, -1e4), np.where(fin, ys, -1e4), SPLAT_SENSOR, ws, f64)
    plans = _plans(2, xs.shape[1], SPLAT_SENSOR, 8 if f64 else 4)
    assert [(p.row_slabs, p.col_slabs) for p in plans[:2]] == [(3, 1), (12, 3)]
    frames = [emulate_direct_fwd(wx, wy, SPLAT_SENSOR, ws, True, p) for p in plans]
    for f in frames[1:]:
        assert torch.equal(f, frames[0])  # the same bits for every plan
    _close(plain, frames[0], tol)
    _close(jax_ref, frames[0], tol)
    # the wrap moved mass: without it the frames differ
    assert not torch.allclose(plain, sk.splat_plain(wx, wy, SPLAT_SENSOR, ws, wrap=False))
    # and a permutation of each ref's events gives the same bits
    perm = torch.as_tensor(rng.permutation(xs.shape[1]))
    assert torch.equal(emulate_direct_fwd(wx[:, perm], wy[:, perm], SPLAT_SENSOR, ws, True,
                                          plans[1]), frames[0])


@pytest.mark.parametrize("ws", [3, 5])
def test_direct_fwd_f64_emulation_without_wrap(ws):
    rng = np.random.default_rng(20 + ws)
    xs, ys = _edge_events(rng, SPLAT_SENSOR)
    wx, wy = (torch.as_tensor(a, dtype=F64)[None] for a in (xs, ys))
    plain = sk.splat_plain(wx, wy, SPLAT_SENSOR, ws)
    for p in _plans(1, xs.size, SPLAT_SENSOR, 8):
        _close(plain, emulate_direct_fwd(wx, wy, SPLAT_SENSOR, ws, False, p), 1e-12)


def test_plan_splat_texel_bytes():
    """8-byte texels halve a tile's texels; the default plan is unchanged."""
    p4 = sk.plan_splat(2, 1_500_000, 480, 640)
    p8 = sk.plan_splat(2, 1_500_000, 480, 640, texel_bytes=8)
    assert p8.tile_rows * 640 * 8 <= sk.SMEM_MAX and p8.row_slabs == 2 * p4.row_slabs
    assert p8.smem_bytes == 16 * -(-p8.tile_rows * p8.tile_cols * 8 // 16)
    with pytest.raises(ValueError):
        sk.plan_splat(2, 10, 4, 4, texel_bytes=2)
