"""The EVAL path of eincm_tpu_torch vs eincm_tpu, on CPU.

The same seeded numpy inputs go through the JAX function and the port's:
the sparse flow errors, the objective zoo and its ops helpers, the
evaluation side of the loss (`compute_loss_objectives`, `loss_func`,
`handover_loss_func`), `evaluate_theta_array` with its prepared inputs,
`eval_window_small`, and the host half of staging (`StagedSample`).

Tolerances: float64 1e-12 relative (machine epsilon in practice); counts
exact; eval strings equal apart from the time stamp. float32: 1e-5
relative for the loss terms (the splat
and the mean reductions sum thousands of terms in another order, as in
test_torch_loss.py's 2e-6, here over several such reductions and their
ratios), absolute 1e-5 px for the flow errors, which are exact sums of a
few hundred float32 norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.evals import flow_metrics as jfm
from eincm_tpu.evals import theta_metrics as jtm
from eincm_tpu.models import loss as jl
from eincm_tpu.models import objectives as jo
from eincm_tpu.ops import filters as jf
from eincm_tpu.ops import normalize as jn
from eincm_tpu.ops import warp as jw
from eincm_tpu_torch.evals import flow_metrics as tfm
from eincm_tpu_torch.evals import theta_metrics as ttm
from eincm_tpu_torch.models import loss as tl
from eincm_tpu_torch.models import objectives as to
from eincm_tpu_torch.ops import _build
from eincm_tpu_torch.ops import filters as tf
from eincm_tpu_torch.ops import normalize as tn
from eincm_tpu_torch.ops import warp as tw
from eincm_tpu_torch.utils import host

SENSOR = (24, 32)
H, W = SENSOR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ref, got, rtol=1e-12, atol=0.0):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


# ---- sparse flow errors -----------------------------------------------------

def _flows(dt, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 3, (H, W, 2)).astype(dt)
    gt = rng.normal(0, 3, (H, W, 2)).astype(dt)
    gt[2, 3] = np.inf  # invalid GT
    gt[4, 1, 1] = -np.inf
    gt[5, 5] = 0.0  # zero GT
    pred[7, 7] = 0.0  # zero prediction
    pred[1, 1] = np.inf
    pred[9, 2, 0] = np.nan  # a NaN norm is not > 0
    return rng, pred, gt


def _flow_error_both(pred, gt, mask, dt):
    with jax.enable_x64(dt == np.float64):
        j = jfm.sparse_flow_error(
            jnp.asarray(pred), jnp.asarray(gt), None if mask is None else jnp.asarray(mask)
        )
        j = jax.tree_util.tree_map(np.asarray, j)
    t = tfm.sparse_flow_error(
        torch.as_tensor(pred), torch.as_tensor(gt),
        None if mask is None else torch.as_tensor(mask),
    )
    return j, t


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_flow_error_matches_jax(dt, masked):
    rng, pred, gt = _flows(dt)
    mask = rng.uniform(0, 1, (H, W)) > 0.4 if masked else None
    j, t = _flow_error_both(pred, gt, mask, dt)
    for k, v in j["errors"].items():
        assert t["errors"][k].dtype == torch.from_numpy(np.zeros(0, dt)).dtype, k
        _close(v, t["errors"][k], *((1e-12, 0.0) if dt == np.float64 else (1e-6, 1e-5)))
    for k, v in j["counts"].items():
        assert not t["counts"][k].is_floating_point()
        assert int(t["counts"][k]) == int(v), k
    assert 0 < int(t["counts"]["n_ee"]) < H * W


def test_sparse_flow_error_perfect_prediction_and_no_valid_pixel():
    _, _, gt = _flows(np.float64)
    j, t = _flow_error_both(gt, gt, None, np.float64)
    assert float(t["errors"]["AEE"]) == float(j["errors"]["AEE"]) == 0.0
    assert all(float(t["errors"][f"A{n}PE"]) == 0.0 for n in (1, 2, 3, 5, 10, 20))
    zero = np.zeros((H, W, 2))
    j, t = _flow_error_both(zero, gt, None, np.float64)
    assert int(t["counts"]["n_ee"]) == int(j["counts"]["n_ee"]) == 0
    assert float(t["errors"]["AEE"]) == 0.0 and float(t["errors"]["A1PE"]) == 0.0


# ---- objectives and ops helpers ---------------------------------------------

def _events(rng, n, sensor=SENSOR, nan=20, margin=2):
    """Integer events, `margin` px of them off the sensor, `nan` padding."""
    xs = rng.integers(-margin, sensor[1] + margin, n).astype(np.float64)
    ys = rng.integers(-margin, sensor[0] + margin, n).astype(np.float64)
    ts = rng.uniform(0, 1, n)
    xs[:nan], ys[:nan], ts[:nan] = np.nan, np.nan, np.nan  # padding
    return xs, ys, ts


def _jt(fn_j, fn_t, *arrays):
    """fn_j on jnp float64 arrays and fn_t on torch tensors of the same
    numpy inputs -> (numpy, tensor)."""
    with jax.enable_x64(True):
        j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    return j, fn_t(*[torch.as_tensor(a) for a in arrays])


def test_per_pix_theta_to_flow_matches_jax():
    rng = np.random.default_rng(1)
    theta = rng.normal(0, 2, (H, W, 2))
    xs, ys, ts = _events(rng, 300)
    j, t = _jt(jo.per_pix_theta_to_flow, to.per_pix_theta_to_flow, theta, xs, ys, ts)
    _close(j, t, rtol=0)
    assert 0 < int((t[..., 0] != 0).sum()) < H * W
    # tests/test_evals.py's case: two events, 2.5 everywhere
    flow = to.per_pix_theta_to_flow(torch.full((8, 10, 2), 2.5), torch.tensor([1.0, 5.0]),
                                    torch.tensor([2.0, 6.0]), torch.tensor([0.1, 0.9]))
    assert flow[2, 1].tolist() == flow[6, 5].tolist() == [2.5, 2.5]
    assert float(flow.sum()) == 10.0


IMAGE_OBJECTIVES = {
    "variance": (jo.compute_variance, to.compute_variance, 1),
    "adaptive_mean_gradient_magnitude": (
        jo.compute_adaptive_mean_gradient_magnitude,
        to.compute_adaptive_mean_gradient_magnitude, 1),
    "adaptive_variance": (jo.compute_adaptive_variance, to.compute_adaptive_variance, 1),
    "sum_squared_error": (jo.compute_sum_squared_error, to.compute_sum_squared_error, 2),
    "mean_hadamard_product": (
        jo.compute_mean_hadamard_product, to.compute_mean_hadamard_product, 2),
    "sum_hadamard_product": (
        jo.compute_sum_hadamard_product, to.compute_sum_hadamard_product, 2),
    "joint_contrast": (jo.compute_joint_contrast, to.compute_joint_contrast, 2),
    "adaptive_mean_squared_error": (
        jo.compute_adaptive_mean_squared_error, to.compute_adaptive_mean_squared_error, 2),
    "fwl": (jo.compute_fwl, to.compute_fwl, 2),
    "iwe_divergence": (jo.iwe_divergence, to.iwe_divergence, 1),
    "theta_divergence": (jo.per_pix_theta_divergence, to.per_pix_theta_divergence, "theta"),
    "gaussian_blur_3x3": (jf.gaussian_blur_3x3, tf.gaussian_blur_3x3, 1),
    "gradient_magnitude": (jf.gradient_magnitude, tf.gradient_magnitude, 1),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OBJECTIVES))
@pytest.mark.parametrize("shape", [(70, 90), (64, 84)], ids=["remainder", "whole_tiles"])
def test_image_objectives_match_jax(name, shape):
    """The objective zoo on images whose size leaves partial tiles (32x42
    default tiles) or none."""
    fj, ft, n_args = IMAGE_OBJECTIVES[name]
    rng = np.random.default_rng(sorted(IMAGE_OBJECTIVES).index(name))
    if n_args == "theta":
        args = [rng.normal(0, 2, (*shape, 2))]
    else:
        args = [rng.gamma(1.0, 1.0, shape) for _ in range(n_args)]
    j, t = _jt(fj, ft, *args)
    _close(j, t)


@pytest.mark.parametrize("tile", [(8, 10), (7, 9)])
def test_extract_tiles_and_adaptive_tile_sizes_match_jax(tile):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(30, 41)), rng.normal(size=(30, 41))
    j, t = _jt(lambda x: jn.extract_tiles(x, *tile), lambda x: tn.extract_tiles(x, *tile), a)
    _close(j, t, rtol=0)
    assert t.shape == (30 // tile[0] * (41 // tile[1]), *tile)
    for fj, ft in ((jo.compute_adaptive_variance, to.compute_adaptive_variance),
                   (jo.compute_adaptive_mean_gradient_magnitude,
                    to.compute_adaptive_mean_gradient_magnitude)):
        _close(*_jt(lambda x: fj(x, tile), lambda x: ft(x, tile), a))
    _close(*_jt(lambda x, y: jo.compute_adaptive_mean_squared_error(x, y, tile),
                lambda x, y: to.compute_adaptive_mean_squared_error(x, y, tile), a, b))


def test_per_pix_total_variation_matches_jax():
    rng = np.random.default_rng(3)
    theta = rng.normal(0, 2, (H, W, 2))
    xs, ys, ts = _events(rng, 250)
    _close(*_jt(jo.per_pix_total_variation, to.per_pix_total_variation, theta, xs, ys, ts))


@pytest.mark.parametrize("t_ref", [0.0, 0.5, 1.0])
def test_per_pix_warp_matches_jax(t_ref):
    rng = np.random.default_rng(4)
    theta = rng.normal(0, 3, (H, W, 2))
    xs = rng.uniform(0, W - 1, 400)
    ys = rng.uniform(0, H - 1, 400)
    ts = rng.uniform(0, 1, 400)
    j, t = _jt(lambda *a: jw.per_pix_warp(*a, t_ref), lambda *a: tw.per_pix_warp(*a, t_ref),
               theta, xs, ys, ts)
    for a, b in zip(j, t):
        _close(a, b)


def test_gather_gradient_matches_jax_custom_vjp():
    """The full-sensor gather's gradient is JAX's custom VJP: an event off
    the grid or not finite reads a clamped or wrapped pixel forward but
    sends its cotangent nowhere (eincm_tpu/ops/warp.py:_gather_bwd)."""
    rng = np.random.default_rng(5)
    theta = rng.normal(0, 1, (H, W, 2))
    xs = rng.uniform(-3, W + 2, 500)
    ys = rng.uniform(-3, H + 2, 500)
    xs[:10], ys[10:20] = np.nan, np.inf
    cot = rng.normal(0, 1, (500, 2))
    with jax.enable_x64(True):
        jg = jax.grad(lambda t: (jw.gather_theta_at_events(t, jnp.asarray(xs), jnp.asarray(ys))
                                 * jnp.asarray(cot)).sum())(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    (tw.gather_theta_at_events(th, torch.as_tensor(xs), torch.as_tensor(ys))
     * torch.as_tensor(cot)).sum().backward()
    _close(np.asarray(jg), th.grad, rtol=0, atol=1e-12)
    off = (np.round(xs) < 0) | (np.round(xs) > W - 1) | (np.round(ys) < 0) | (np.round(ys) > H - 1)
    assert off.sum() > 50  # events whose cotangent plain indexing would have routed


# ---- the evaluation side of the loss ----------------------------------------

def _window(seed, n=600, n_refs=2, sensor=SENSOR, margin=2):
    rng = np.random.default_rng(seed)
    xs, ys, ts = _events(rng, n, sensor, margin=margin)
    edges = rng.uniform(0, 1, (n_refs, *sensor))
    return rng, [xs, ys, ts, edges, np.linspace(0.0, 1.0, n_refs)]


@pytest.mark.parametrize("n_refs", [1, 2, 3])
def test_compute_loss_objectives_matches_jax(n_refs):
    rng, arrays = _window(10 + n_refs, n_refs=n_refs)
    theta = rng.normal(0, 2, (H, W, 2))
    with jax.enable_x64(True):
        j = jl.compute_loss_objectives(jnp.asarray(theta), *[jnp.asarray(a) for a in arrays],
                                       SENSOR)
        j = {k: np.asarray(v) for k, v in j.items()}
    t = tl.compute_loss_objectives(torch.as_tensor(theta),
                                   *[torch.as_tensor(a) for a in arrays], SENSOR)
    assert set(t) == set(j)
    for k in j:
        _close(j[k], t[k], atol=1e-300), k
    assert t["warped_xs"].shape == (n_refs, arrays[0].shape[0])


@pytest.mark.parametrize(
    "params,lvl",
    [(dict(alpha=60.0, beta=60.0), 1), (dict(alpha=20.0, beta=35.0, gamma=0.01), 0),
     (dict(alpha=20.0, beta=35.0, delta=0.5), 2), (dict(alpha=2000.0, beta=4000.0, gamma=0.1,
                                                        delta=0.3), 0)],
)
def test_loss_func_matches_jax_and_solver_loss(params, lvl):
    """loss_func against JAX's (value, terms and gradient, float64) and
    against the port's own solver_loss, as tests/test_loss.py holds JAX's
    (on the sensor: off it, the full-sensor gather wraps a negative index
    where the coarse interp samples the edge, in both packages)."""
    rng, arrays = _window(20 + lvl, margin=0)
    theta = rng.normal(0, 1, (4, 4, 2))
    statics = (SENSOR, 3)
    with jax.enable_x64(True):
        ja = [jnp.asarray(a) for a in arrays]
        (jv, jaux), jg = jax.value_and_grad(jl.loss_func, has_aux=True)(
            jnp.asarray(theta), *ja, jl.LossParams(**params), lvl, jl.LossStatics(*statics))
        jaux = {k: np.asarray(v) for k, v in jaux.items()}
    ta = [torch.as_tensor(a) for a in arrays]
    th = torch.as_tensor(theta).requires_grad_(True)
    tv, taux = tl.loss_func(th, *ta, tl.LossParams(**params), lvl, tl.LossStatics(*statics))
    (tg,) = torch.autograd.grad(tv, th)
    _close(float(jv), float(tv.detach()))
    _close(np.asarray(jg), tg, rtol=0, atol=1e-12 * np.abs(np.asarray(jg)).max())
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(jaux[k], taux[k], atol=1e-300)
    ws = tl.compute_window_statics(ta[0], ta[1], ta[3], SENSOR)
    lean = tl.solver_loss(torch.as_tensor(theta), *ta, tl.LossParams(**params), lvl,
                          tl.LossStatics(*statics), ws)
    _close(float(tv.detach()), float(lean))


def test_handover_loss_func_matches_jax():
    rng, arrays = _window(30)
    prev, cur = rng.normal(0, 1, (4, 4, 2)), rng.normal(0, 1, (4, 4, 2))
    params = dict(alpha=60.0, beta=60.0, gamma=0.01)
    for w in (0.0, 0.3, 1.0):
        with jax.enable_x64(True):
            j = float(jl.handover_loss_func(
                jnp.asarray(w), jnp.asarray(prev), jnp.asarray(cur),
                *[jnp.asarray(a) for a in arrays], jl.LossParams(**params), 0,
                jl.LossStatics(SENSOR, 3)))
        t = tl.handover_loss_func(
            torch.tensor(w, dtype=torch.float64), torch.as_tensor(prev), torch.as_tensor(cur),
            *[torch.as_tensor(a) for a in arrays], tl.LossParams(**params), 0,
            tl.LossStatics(SENSOR, 3))
        _close(j, float(t))
    ta = [torch.as_tensor(a) for a in arrays]
    end, _ = tl.loss_func(torch.as_tensor(prev), *ta, tl.LossParams(**params), 0,
                          tl.LossStatics(SENSOR, 3))
    assert float(t) == float(end)  # w = 1 is the previous theta's loss


# ---- evaluate_theta_array ---------------------------------------------------

def _gt_window(seed=40, n=700, n_refs=2):
    """A window with GT flow, theta = GT + noise (full sensor)."""
    rng, arrays = _window(seed, n, n_refs)
    vel = np.array([2.5, -1.5])
    gt = np.broadcast_to(vel, (H, W, 2)).copy()
    gt[3, 4] = np.inf
    gt[0, :5] = 0.0
    theta = vel + rng.normal(0, 0.7, (H, W, 2))
    mask = rng.uniform(0, 1, SENSOR) > 0.3
    return arrays, theta, gt, mask


def _eval_both(dt, with_gt=True, with_mask=False, prepared=False):
    arrays, theta, gt, mask = _gt_window()
    arrays = [a.astype(dt) for a in arrays]
    theta, gt = theta.astype(dt), gt.astype(dt)
    params = dict(alpha=60.0, beta=60.0, gamma=0.01, delta=0.1)
    with jax.enable_x64(dt == np.float64):
        ja = [jnp.asarray(a) for a in arrays]
        j = jtm.evaluate_theta_array(
            jnp.asarray(theta), *ja, jnp.asarray(gt) if with_gt else None,
            jl.LossParams(**params), SENSOR,
            err_eval_event_mask=jnp.asarray(mask) if with_mask else None)
    ta = [torch.as_tensor(a) for a in arrays]
    kw = {}
    if prepared:
        xs, ys, ts, ws = ttm.prepare_eval_inputs(ta[0], ta[1], ta[2], ta[3], SENSOR,
                                                 dtype=ta[0].dtype)
        ta[:3] = xs, ys, ts
        kw["window_statics"] = ws
    t = ttm.evaluate_theta_array(
        torch.as_tensor(theta), *ta, torch.as_tensor(gt) if with_gt else None,
        tl.LossParams(**params), SENSOR,
        err_eval_event_mask=torch.as_tensor(mask) if with_mask else None, **kw)
    return j, t


COUNTS = ("n_ee", "n_pred", "n_gt", "n_pixels")


@pytest.mark.parametrize("with_gt,with_mask", [(True, False), (True, True), (False, False)])
def test_evaluate_theta_array_f64_matches_jax(with_gt, with_mask):
    (_, jstr, jev, jobj), (_, tstr, tev, tobj) = _eval_both(np.float64, with_gt, with_mask)
    assert set(tev) == set(jev)
    for k, v in jev.items():
        if k in COUNTS:
            assert int(tev[k]) == int(v), k
        else:
            assert tev[k].dtype == np.float64, k
            _close(v, tev[k]), k
    assert tstr == jstr
    assert ("AEE" in tstr) == with_gt
    for k in ("warped_xs", "rel_contrasts"):
        assert isinstance(tobj[k], torch.Tensor)
        _close(np.asarray(jobj[k]), tobj[k])


def test_evaluate_theta_array_f32_matches_jax():
    (_, _, jev, _), (_, _, tev, _) = _eval_both(np.float32, with_mask=True)
    assert set(tev) == set(jev)
    for k, v in jev.items():
        if k in COUNTS:
            assert int(tev[k]) == int(v), k
        elif k in ("AEE", "AREE"):
            _close(v, tev[k], rtol=0, atol=1e-5)
        else:
            assert tev[k].dtype == np.float32, k
            _close(v, tev[k], rtol=1e-5, atol=1e-6)


def test_prepared_inputs_give_identical_results(monkeypatch):
    """prepare_eval_inputs (padded once, statics hoisted) gives bit-identical
    metrics to the self-contained path, reused across calls
    (tests/test_evals.py:109); each evaluation reads the host once, and no
    other op reads a value there."""
    _, (_, ref_str, ref, _) = _eval_both(np.float32, with_mask=True)
    calls = []
    real = host.to_host
    monkeypatch.setattr(host, "to_host", lambda t: calls.append(1) or real(t))
    for _ in range(2):
        with torch.autograd.profiler.profile() as prof:
            _, (_, s, got, _) = _eval_both(np.float32, with_mask=True, prepared=True)
        reads = {"aten::_local_scalar_dense", "aten::nonzero"}
        assert [e.name for e in prof.function_events if e.name in reads] == []
        assert s == ref_str
        for k, v in ref.items():
            assert np.array_equal(np.asarray(v), np.asarray(got[k])), k
    assert len(calls) == 2


def test_bucket_padding_and_zero_theta():
    """Events pad to a multiple of 8192 (idempotent); a zero theta has no
    valid prediction, so AEE 0 over n_ee 0 (tests/test_evals.py)."""
    x = torch.arange(8193, dtype=torch.float64)
    xs, _, _ = ttm._bucket_pad_events(x, x, x, torch.float32)
    assert xs.shape == (16384,) and xs.dtype == torch.float32 and torch.isnan(xs[-1])
    again = ttm._bucket_pad_events(xs, xs, xs, torch.float32)[0]
    assert again is xs
    arrays, _, gt, _ = _gt_window()
    ta = [torch.as_tensor(a) for a in arrays]
    _, s, ev, _ = ttm.evaluate_theta_array(
        torch.zeros(H, W, 2, dtype=torch.float64), *ta, torch.as_tensor(gt),
        tl.LossParams(60.0, 60.0), SENSOR)
    assert int(ev["n_ee"]) == 0 and float(ev["AEE"]) == 0.0
    assert "total_loss" in s and "FWL" in s and "AEE" in s


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_eval_window_small_matches_jax(method):
    rng, arrays = _window(50)
    theta = rng.normal(0, 1.5, (4, 4, 2))
    gt = rng.normal(0, 2, (H, W, 2))
    mask = rng.uniform(0, 1, SENSOR) > 0.5
    pvec = (20.0, 35.0, 0.01, 0.2)
    with jax.enable_x64(True):
        j = jtm.eval_window_small(
            jnp.asarray(theta), *[jnp.asarray(a) for a in arrays], jnp.asarray(gt),
            jnp.asarray(mask), jnp.asarray(pvec), SENSOR, True, True, method)
        j = jax.tree_util.tree_map(np.asarray, j)
    t = ttm.eval_window_small(
        torch.as_tensor(theta), *[torch.as_tensor(a) for a in arrays], torch.as_tensor(gt),
        torch.as_tensor(mask), pvec, SENSOR, True, True, method)
    jl_, tl_ = jax.tree_util.tree_leaves(j), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda v: v.numpy(), t))
    assert jax.tree_util.tree_structure(j) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda v: v.numpy(), t))
    for a, b in zip(jl_, tl_):
        _close(a, b)


def test_eval_on_cpu_launches_no_kernel():
    _build.reset_launch_counts()
    _eval_both(np.float32, prepared=True)
    assert all(v == 0 for v in _build.launch_counts().values())


# ---- StagedSample -----------------------------------------------------------

@pytest.mark.parametrize("units", ["s", "us"])
def test_staged_sample_matches_jax(units):
    """The port's StagedSample against JAX's stage_datasample(preprocess=
    False) on a synthetic window padded beyond its eval span
    (n_event_deficiency > 0): the window (on the requested device), the
    eval-consistent event subset, GT flow, polarities, times and indices."""
    from eincm_tpu.data.staging import stage_datasample as jax_stage
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.data.synthetic import SyntheticDataLoader

    dl = SyntheticDataLoader(sensor_size=(32, 40), n_windows=3, des_n_events=3000,
                             velocity=(2.0, -1.0), n_features=20, seed=5)
    dl.get_ready()
    dl.des_n_events = 3500  # more than the window holds: it grows into its neighbours
    sample = dl[1]
    assert sample["n_event_deficiency"] > 0
    sample["file_idx"] = 7
    if units == "us":
        sample["eval_ts_us"] = sample.pop("eval_ts") * 1e6
        sample["events"] = dict(sample["events"], t=sample["events"]["t"] * 1e6)
        sample["image_ts"] = sample["image_ts"] * 1e6
    ref = jax_stage(sample, preprocess=False, pad_to=4096)
    got = stage_datasample(sample, "cpu", pad_to=4096)
    for a, b in zip(ref.window, got.window):
        assert b.device.type == "cpu" and b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(ref.images, got.images)
    assert set(ref.eval_events) == set(got.eval_events) == {"x", "y", "t", "p"}
    for k in ref.eval_events:
        np.testing.assert_array_equal(ref.eval_events[k], got.eval_events[k])
    assert 0 < len(got.eval_events["x"]) < len(sample["events"]["x"])
    np.testing.assert_array_equal(ref.gt_flow, got.gt_flow)
    np.testing.assert_array_equal(ref.polarities, got.polarities)
    assert got.polarities.shape == (4096,)
    for field in ("t_ref", "eval_ts", "eval_ts_units", "file_idx", "n_event_deficiency"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.eval_ts_units == units and got.file_idx == 7
    with pytest.raises(NotImplementedError):
        stage_datasample(sample, "cpu", preprocess=True)
