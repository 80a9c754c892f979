"""The port's edge preprocessing (eincm_tpu_torch/edge/) against the JAX
package's numpy filters, bitwise, on seeded uint8 frames. Both packages
prefer their C++ filters (eincm_tpu/native, eincm_tpu_torch/native) where
they are built; these comparisons turn the C++ filters off in both for the
test (monkeypatch), as if they were not built, so the numpy filters are
held to each other (tests/test_torch_native.py holds the C++ ones)."""

import numpy as np
import pytest
import torch

import eincm_tpu.native.vision as jax_native
import eincm_tpu_torch.native.vision as port_native
from eincm_tpu.data.staging import stage_datasample as jax_stage
from eincm_tpu.edge import filters_np as jf
from eincm_tpu.edge import iedt as jiedt
from eincm_tpu.edge import pipeline as jp
from eincm_tpu.experiments.config import EdgeConfig as JaxEdgeConfig
from eincm_tpu_torch.data.prefetch import StagingPrefetcher
from eincm_tpu_torch.data.staging import stage_datasample
from eincm_tpu_torch.data.synthetic import SyntheticDataLoader
from eincm_tpu_torch.edge import filters_np as tf
from eincm_tpu_torch.edge import iedt as tiedt
from eincm_tpu_torch.edge import pipeline as tp
from eincm_tpu_torch.experiments.config import EdgeConfig

SHAPES = [(24, 32), (37, 29)]


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def _frame(seed, shape):
    """A smooth scene with noise, as uint8 (edges for Canny to find)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    img = 90 + 60 * (xx > w // 2) + 40 * ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2)
    return np.clip(img + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h,template,search", [(4.0, 3, 11), (10.0, 5, 7)])
def test_nl_means_bitwise(shape, h, template, search):
    img = _frame(1, shape)
    np.testing.assert_array_equal(
        tf.nl_means_denoise(img, h, template, search),
        jf.nl_means_denoise(img, h, template, search),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("clip,grid", [(5.0, (10, 10)), (2.0, (4, 6))])
def test_clahe_bitwise(shape, clip, grid):
    img = _frame(2, shape)
    np.testing.assert_array_equal(tf.clahe(img, clip, grid), jf.clahe(img, clip, grid))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.8, 2.0])
def test_gaussian_blur_and_add_weighted_bitwise(shape, sigma):
    img = _frame(3, shape)
    blurred = tf.gaussian_blur(img, sigma)
    np.testing.assert_array_equal(blurred, jf.gaussian_blur(img, sigma))
    np.testing.assert_array_equal(
        tf.add_weighted(img, 1.5, blurred, -0.5), jf.add_weighted(img, 1.5, blurred, -0.5)
    )
    f = img.astype(np.float64)
    np.testing.assert_array_equal(
        tf.add_weighted(f, 1.5, blurred, -0.5, 3.0), jf.add_weighted(f, 1.5, blurred, -0.5, 3.0)
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d,sc,ss", [(5, 15.0, 15.0), (7, 30.0, 5.0)])
def test_bilateral_bitwise(shape, d, sc, ss):
    img = _frame(4, shape)
    np.testing.assert_array_equal(
        tf.bilateral_filter(img, d, sc, ss), jf.bilateral_filter(img, d, sc, ss)
    )


@pytest.mark.parametrize("seed", [5, 6])
def test_preprocess_image_bitwise(no_native, seed):
    img = _frame(seed, (40, 48)).astype(np.float64) / 255.0
    np.testing.assert_array_equal(tp.preprocess_image(img), jp.preprocess_image(img))


@pytest.mark.parametrize("formulation", ["linear", "linear-bound", "logarithmic", "exponential"])
def test_rtef_iedt_matches(no_native, formulation):
    edges = jp.image_to_edge(_frame(7, (30, 40)))
    np.testing.assert_array_equal(
        tiedt.rtef_inv_exp_dist_transform(edges, 4.0, None, formulation),
        jiedt.rtef_inv_exp_dist_transform(edges, 4.0, None, formulation),
    )


@pytest.mark.parametrize("smoothen", ["gaussian", "eincm_iedt", "rtef_iedt"])
@pytest.mark.parametrize("preprocess", [True, False])
def test_edge_fn_matches_jax(no_native, smoothen, preprocess):
    """`EdgeConfig.make_edge_fn` (extract_edges with each smoothen method)
    against the JAX package's, bitwise."""
    images = np.stack([_frame(8, (36, 44)), _frame(9, (36, 44))]).astype(np.float64)
    kw = dict(smoothen_method=smoothen, enable_image_preprocessing=preprocess)
    np.testing.assert_array_equal(
        EdgeConfig(**kw).make_edge_fn()(images), JaxEdgeConfig(**kw).make_edge_fn()(images)
    )


def test_extract_edges_preprocess_kwargs(no_native):
    images = _frame(10, (32, 32))[None].astype(np.float64)
    kw = {"denoise_h": 8, "clahe_tile_grid_size": [4, 4], "sharpen_alpha": 2.0}
    np.testing.assert_array_equal(
        tp.extract_edges(images, preprocess_kwargs=kw),
        jp.extract_edges(images, preprocess_kwargs=kw),
    )


def test_stage_datasample_preprocesses_by_default(no_native):
    """The port's default is the JAX package's: preprocess=True."""
    dl = SyntheticDataLoader(sensor_size=(32, 40), n_windows=2, des_n_events=2000,
                             velocity=(2.0, -1.0), n_features=20, seed=3)
    dl.get_ready()
    sample = dl[1]
    ref = jax_stage(sample, pad_to=2048)
    got = stage_datasample(sample, "cpu", pad_to=2048)
    for a, b in zip(ref.window, got.window):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    plain = stage_datasample(sample, "cpu", preprocess=False, pad_to=2048)
    assert not torch.equal(plain.window.edges, got.window.edges)


# ---- the prefetcher (a copy of eincm_tpu/data/prefetch.py) --------------------

class _Loader:
    def __getitem__(self, i):
        return i


def test_prefetcher_order_and_duplicates():
    for idxs in ([0, 2, 5], [3, 3], [1, 2, 1], [0, 0, 0, 0], []):
        pf = StagingPrefetcher(_Loader(), idxs, lambda i: i * 10, depth=2)
        assert list(pf) == [(i, i * 10) for i in idxs]


def test_prefetcher_exception_propagates():
    def stage(i):
        if i == 1:
            raise ValueError("boom")
        return i

    with pytest.raises(ValueError):
        list(StagingPrefetcher(_Loader(), [0, 1], stage, depth=2))
