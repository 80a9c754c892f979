"""eincm_tpu_torch ops vs eincm_tpu ops on identical numpy inputs (CPU).

Tolerances: relative to max |JAX|, 1e-12 in float64 (the two frameworks
sum a few terms in other orders) and 1e-6 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eincm_tpu.ops import filters as jf
from eincm_tpu.ops import normalize as jn
from eincm_tpu.ops import resize as jr
from eincm_tpu_torch.ops import filters as tf
from eincm_tpu_torch.ops import normalize as tn
from eincm_tpu_torch.ops import resize as tr

TOL = {"f64": 1e-12, "f32": 1e-6}
NP_DTYPE = {"f64": np.float64, "f32": np.float32}
LEVEL_SHAPES = [(1, 1), (2, 2), (4, 4), (8, 8), (16, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers per machine; torch's CPU thread pool
    # would otherwise oversubscribe the cores, at a many-fold slowdown
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(jax_out, torch_out, dt):
    j = np.asarray(jax_out, np.float64)
    t = torch_out.detach().numpy().astype(np.float64)
    assert j.shape == t.shape
    scale = max(np.abs(j).max(), 1e-300)
    assert np.abs(j - t).max() <= TOL[dt] * scale, np.abs(j - t).max() / scale


def _run(dt, jax_fn, torch_fn, *arrays):
    arrays = [a.astype(NP_DTYPE[dt]) for a in arrays]
    with jax.enable_x64(dt == "f64"):
        j = np.asarray(jax_fn(*[jnp.asarray(a) for a in arrays]))
    t = torch_fn(*[torch.as_tensor(a) for a in arrays])
    _close(j, t, dt)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(24, 32), (1, 5), (7, 1)])
def test_normalize(dt, shape):
    a = np.random.default_rng(0).normal(0, 3, shape)
    _run(dt, jn.normalize_to_unit_range, tn.normalize_to_unit_range, a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_normalize_batched_matches_per_image(dt):
    a = np.random.default_rng(1).normal(0, 3, (3, 10, 12))
    _run(
        dt,
        jax.vmap(jn.normalize_to_unit_range),
        tn.normalize_to_unit_range,
        a,
    )


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(24, 32), (3, 3), (1, 1), (2, 9)])
def test_scharr_grads(dt, shape):
    a = np.random.default_rng(2).uniform(0, 1, shape)
    _run(dt, jf.scharr_grads, tf.scharr_grads, a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_divergence_filter(dt):
    a = np.random.default_rng(3).normal(0, 1, (20, 17))
    _run(dt, jf.divergence_filter, tf.divergence_filter, a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_filters_batched(dt):
    a = np.random.default_rng(4).uniform(0, 1, (2, 11, 13))
    _run(dt, jax.vmap(jf.scharr_grads), tf.scharr_grads, a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", LEVEL_SHAPES)
def test_upscale_repeat(dt, shape):
    a = np.random.default_rng(5).normal(0, 2, (*shape, 2))
    _run(
        dt,
        lambda t: jr.upscale_theta(t, 2, "repeat"),
        lambda t: tr.upscale_theta(t, 2, "repeat"),
        a,
    )


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", LEVEL_SHAPES[1:])
def test_downscale_bilinear_antialiased(dt, shape):
    a = np.random.default_rng(6).normal(0, 2, (*shape, 2))
    _run(
        dt,
        lambda t: jr.downscale_theta(t, 2, "bilinear"),
        lambda t: tr.downscale_theta(t, 2, "bilinear"),
        a,
    )


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", LEVEL_SHAPES + [(3, 5)])
@pytest.mark.parametrize("sensor", [(40, 48), (256, 336)])
def test_scale_theta_to_sensor_size(dt, shape, sensor):
    a = np.random.default_rng(7).normal(0, 2, (*shape, 2))
    _run(
        dt,
        lambda t: jr.scale_theta_to_sensor_size(t, sensor, "bilinear"),
        lambda t: tr.scale_theta_to_sensor_size(t, sensor, "bilinear"),
        a,
    )


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_upscale_linear(dt):
    a = np.random.default_rng(8).normal(0, 2, (4, 6, 2))
    _run(
        dt,
        lambda t: jr.upscale_theta(t, 2, "linear"),
        lambda t: tr.upscale_theta(t, 2, "linear"),
        a,
    )


def test_unported_resize_method_raises():
    """A name outside eincm_tpu/ops/resize.py:_INTERP_METHODS raises, as
    it does in the JAX package."""
    for fn in (tr.downscale_theta, tr.upscale_theta):
        with pytest.raises(NotImplementedError):
            fn(torch.zeros(4, 4, 2), 2, "nearest")
        with pytest.raises(NotImplementedError):
            fn(torch.zeros(4, 4, 2), 2, "triangle")
    with pytest.raises(ValueError):
        tr.scale_theta_to_sensor_size(torch.zeros(4, 4, 2), (8, 8), "nearest")


RESIZE_METHODS = ["linear", "bilinear", "trilinear", "cubic", "bicubic", "tricubic",
                  "lanczos3", "lanczos5"]


def test_resize_methods_are_the_jax_packages():
    assert tuple(RESIZE_METHODS) == jr._INTERP_METHODS == tr._INTERP_METHODS


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("method", RESIZE_METHODS)
@pytest.mark.parametrize("shape", [(2, 2), (4, 6), (16, 16)])
def test_resize_every_method_up_and_down(dt, method, shape):
    a = np.random.default_rng(10).normal(0, 2, (*shape, 2))
    _run(dt, lambda t: jr.upscale_theta(t, 2, method),
         lambda t: tr.upscale_theta(t, 2, method), a)
    _run(dt, lambda t: jr.downscale_theta(t, 2, method),
         lambda t: tr.downscale_theta(t, 2, method), a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("method", RESIZE_METHODS)
@pytest.mark.parametrize("shape,sensor", [((4, 4), (40, 48)), ((3, 5), (17, 23)),
                                          ((16, 16), (256, 336))])
def test_resize_every_method_to_sensor_size(dt, method, shape, sensor):
    a = np.random.default_rng(11).normal(0, 2, (*shape, 2))
    _run(dt, lambda t: jr.scale_theta_to_sensor_size(t, sensor, method),
         lambda t: tr.scale_theta_to_sensor_size(t, sensor, method), a)


def test_resize_gradient_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(0, 2, (4, 4, 2))
    ct = rng.normal(0, 1, (24, 20, 2))
    with jax.enable_x64(True):
        gj = jax.grad(
            lambda t: jnp.vdot(
                jr.scale_theta_to_sensor_size(t, (24, 20), "bilinear"), ct
            )
        )(jnp.asarray(a))
    t = torch.as_tensor(a).requires_grad_(True)
    out = tr.scale_theta_to_sensor_size(t, (24, 20), "bilinear")
    (gt,) = torch.autograd.grad((out * torch.as_tensor(ct)).sum(), t)
    _close(gj, gt, "f64")


@pytest.mark.parametrize("method", ["bicubic", "lanczos3"])
def test_resize_gradient_of_cubic_and_lanczos_matches_jax(method):
    """Down and up, so that both the widened (antialiased) kernel and the
    plain one are differentiated."""
    rng = np.random.default_rng(12)
    a = rng.normal(0, 2, (8, 6, 2))
    ct = rng.normal(0, 1, (8, 6, 2))

    def both(resize):
        return lambda t: resize.upscale_theta(resize.downscale_theta(t, 2, method), 2, method)

    with jax.enable_x64(True):
        gj = jax.grad(lambda t: jnp.vdot(both(jr)(t), ct))(jnp.asarray(a))
    t = torch.as_tensor(a).requires_grad_(True)
    (gt,) = torch.autograd.grad((both(tr)(t) * torch.as_tensor(ct)).sum(), t)
    _close(gj, gt, "f64")
