"""The port's native host library (eincm_tpu_torch/native: vision.cpp and
events.cpp built by g++) against the JAX package's (eincm_tpu/native),
bitwise for every entry point, and against the numpy filters within the
tolerances of tests/test_native_vision.py and test_native_events.py; and
the staging of both packages with their defaults (native filters on),
bitwise, on a window where native and numpy NL-means differ."""

import numpy as np
import pytest

import eincm_tpu.native.events as jax_events
import eincm_tpu.native.vision as jax_vision
import eincm_tpu_torch.native.events as port_events
import eincm_tpu_torch.native.vision as port_vision
from eincm_tpu.data.staging import stage_datasample as jax_stage
from eincm_tpu_torch.data.staging import stage_datasample
from eincm_tpu_torch.edge import filters_np as tf
from eincm_tpu_torch.edge import iedt as tiedt
from eincm_tpu_torch.edge import pipeline as tp
from eincm_tpu_torch.edge.canny import canny as canny_np
from eincm_tpu_torch.native import build as port_build


def _frame(shape, seed):
    """A structured scene with noise (tests/test_native_vision.py's)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    img = rng.uniform(0, 255, shape) * 0.3
    img += 120 * np.sin(yy / 6) * np.cos(xx / 9) + 100
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(params=[((48, 64), 42), ((37, 53), 7)], ids=["48x64", "37x53"])
def img(request):
    return _frame(*request.param)


def test_both_libraries_build():
    assert port_vision.available() and port_events.available()
    assert jax_vision.available() and jax_events.available()
    lib = port_build.build()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "eincm_tpu_torch"


def test_build_failure_is_reported_once(monkeypatch, tmp_path, capsys):
    """Without g++ the build fails once, says why on stderr, and later
    probes answer None without running g++ again."""
    calls = []

    def no_gxx(*args, **kwargs):
        calls.append(args)
        raise FileNotFoundError("g++")

    monkeypatch.setattr(port_build, "LIB", tmp_path / "lib.so")
    monkeypatch.setattr(port_build, "_failed", False)
    monkeypatch.setattr(port_build.subprocess, "run", no_gxx)
    assert port_build.build() is None
    assert port_build.build() is None
    assert len(calls) == 1
    assert "build failed" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())  # no half-written library left


# ---- every entry point: the port's library is bitwise the JAX package's ------

@pytest.mark.parametrize("sigma", [0.8, 2.0])
def test_gaussian_blur_bitwise(img, sigma):
    x = img.astype(np.float64)
    np.testing.assert_array_equal(port_vision.gaussian_blur(x, sigma),
                                  jax_vision.gaussian_blur(x, sigma))


@pytest.mark.parametrize("name,args", [
    ("nl_means_denoise", ()), ("nl_means_denoise", (8.0, 3, 7)),
    ("clahe", ()), ("clahe", (2.0, (4, 6))),
    ("bilateral_filter", ()), ("canny", (30, 80)), ("canny", (100, 200, 3, False)),
])
def test_u8_filters_bitwise(img, name, args):
    np.testing.assert_array_equal(getattr(port_vision, name)(img, *args),
                                  getattr(jax_vision, name)(img, *args))


def test_exact_edt_bitwise(img):
    mask = canny_np(img, 30, 80) > 0
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(port_vision.exact_edt(mask), jax_vision.exact_edt(mask))


def _events(n, h, w, seed):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack([gx + rng.normal(0, 6, (h, w)).astype(np.float32) + 0.123,
                  gy + rng.normal(0, 6, (h, w)).astype(np.float32) + 0.123], axis=-1)
    return (rng.integers(0, w, n).astype(np.uint16), rng.integers(0, h, n).astype(np.uint16),
            np.sort(rng.integers(0, 10**9, n)).astype(np.int64),
            rng.integers(0, 2, n).astype(np.uint8), m)


def test_rectify_filter_events_bitwise():
    x, y, t, p, m = _events(100_000, 60, 80, 0)
    got = port_events.rectify_filter_events(x, y, t, p, m, (60, 80))
    ref = jax_events.rectify_filter_events(x, y, t, p, m, (60, 80))
    assert len(got[0]) < len(x)  # some events leave the sensor
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sort_events_by_row_bitwise():
    ys = np.random.default_rng(3).uniform(-2, 50, 20_000).astype(np.float32)
    got = port_events.sort_events_by_row_perm(ys, 48)
    np.testing.assert_array_equal(got, jax_events.sort_events_by_row_perm(ys, 48))
    assert np.all(np.diff(np.floor(np.clip(ys[got], 0, 47))) >= 0)


# ---- native against numpy (the tolerances of tests/test_native_*.py) ---------

def _off_by_one(a, b, max_frac):
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= max_frac


def test_native_against_numpy(img):
    np.testing.assert_allclose(port_vision.gaussian_blur(img.astype(np.float64), 2.0),
                               tf.gaussian_blur(img.astype(np.float64), 2.0), rtol=0, atol=1e-9)
    _off_by_one(port_vision.nl_means_denoise(img), tf.nl_means_denoise(img), 0.005)
    _off_by_one(port_vision.clahe(img), tf.clahe(img), 0.005)
    np.testing.assert_array_equal(port_vision.bilateral_filter(img), tf.bilateral_filter(img))
    np.testing.assert_array_equal(port_vision.canny(img, 30, 80), canny_np(img, 30, 80))
    from scipy import ndimage

    mask = canny_np(img, 30, 80) > 0
    np.testing.assert_array_equal(port_vision.exact_edt(mask),
                                  ndimage.distance_transform_edt(~mask))


def test_rectify_against_numpy():
    """The DSEC loader's numpy path (dsec.py:rectify_events), half ties too."""
    x, y, t, p, m = _events(50_000, 40, 50, 1)
    m[0, :, 0] = np.arange(50) - 0.5  # exact .5 ties round half to even
    rect = m[y, x]
    rx, ry = np.round(rect[:, 0]).astype(np.int16), np.round(rect[:, 1]).astype(np.int16)
    keep = (rx >= 0) & (rx < 50) & (ry >= 0) & (ry < 40)
    for a, b in zip(port_events.rectify_filter_events(x, y, t, p, m, (40, 50)),
                    (rx[keep], ry[keep], t[keep], p[keep])):
        np.testing.assert_array_equal(a, b)


# ---- the dispatch: where the JAX package picks its library, the port its own --

def test_pipeline_dispatches_native():
    assert tp._native_or(tf.nl_means_denoise) is port_vision.nl_means_denoise
    assert tp._native_or(tf.clahe) is port_vision.clahe
    assert tp._native_or(tf.bilateral_filter) is port_vision.bilateral_filter
    assert tp._native_or(canny_np) is port_vision.canny
    assert tp._native_or(tf.gaussian_blur) is port_vision.gaussian_blur  # by name, as JAX


def test_numpy_when_not_built(monkeypatch, img):
    monkeypatch.setattr(port_vision, "available", lambda: False)
    assert tp._native_or(tf.nl_means_denoise) is tf.nl_means_denoise
    edges = canny_np(img, 30, 80)
    from scipy import ndimage

    np.testing.assert_array_equal(tiedt._exact_edt(edges == 0),
                                  ndimage.distance_transform_edt(edges == 0))


def test_native_errors_are_raised(monkeypatch, img):
    """An error inside a native filter reaches the caller; numpy does not
    answer in its place."""
    def broken(*args, **kwargs):
        raise RuntimeError("native fault")

    monkeypatch.setattr(port_vision, "nl_means_denoise", broken)
    with pytest.raises(RuntimeError, match="native fault"):
        tp.preprocess_image(img)


def _window(seed, shape=(40, 48)):
    rng = np.random.default_rng(seed)
    n = 1500
    events = {"x": rng.integers(0, shape[1], n).astype(np.int16),
              "y": rng.integers(0, shape[0], n).astype(np.int16),
              "t": np.sort(rng.uniform(0, 1, n)), "p": rng.integers(0, 2, n).astype(bool)}
    images = np.stack([_frame(shape, seed), _frame(shape, seed + 100)])
    return {"events": events, "images": images, "image_ts": np.array([0.0, 1.0]),
            "eval_ts": np.array([0.0, 1.0])}


def test_default_staging_matches_jax_with_native_filters(monkeypatch):
    """Both packages' default staging (preprocess=True, C++ filters built)
    gives bitwise the same edge maps, on a window where native NL-means
    differs from numpy NL-means, so that numpy staging would not."""
    sample = _window(0)
    frame = sample["images"][0]
    assert not np.array_equal(port_vision.nl_means_denoise(frame), tf.nl_means_denoise(frame))
    ref = jax_stage(sample, pad_to=2048)
    got = stage_datasample(sample, "cpu", pad_to=2048)
    np.testing.assert_array_equal(np.asarray(ref.window.edges), got.window.edges.numpy())
    for a, b in zip(ref.window, got.window):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    monkeypatch.setattr(port_vision, "available", lambda: False)
    plain = stage_datasample(sample, "cpu", pad_to=2048)
    assert not np.array_equal(np.asarray(ref.window.edges), plain.window.edges.numpy())


def test_threads_build_once(monkeypatch, tmp_path):
    """The staging prefetcher's threads may build at once: each gets the
    library, and g++ runs once (one process, one temporary name)."""
    import threading

    runs = []
    real_run = port_build.subprocess.run

    def counted(cmd, **kwargs):
        runs.append(cmd)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(port_build, "LIB", tmp_path / "libeincm_native.so")
    monkeypatch.setattr(port_build, "_failed", False)
    monkeypatch.setattr(port_build.subprocess, "run", counted)
    out = []
    threads = [threading.Thread(target=lambda: out.append(port_build.build())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert out == [tmp_path / "libeincm_native.so"] * 4 and len(runs) == 1
