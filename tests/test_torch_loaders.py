"""The port's real-data loaders (eincm_tpu_torch/data/{ecd,mvsec,dsec}.py)
against the JAX package's, bitwise, on trees written by
tests/dataset_fixtures.py: every key of each `get_sample` dict (events,
images, flow_gt, valid2D, timestamps, file_idx, deficiency), read once
through h5py and once with h5py blocked, so that `utils/h5_lite.py` reads
the HDF5 files. Also `read_png16` against PIL and the loop decoder the port
replaced, `imread_gray` against the JAX package's for every PNG colour type
and depth, and one tiny CLI experiment per loader kind through both
managers."""

import importlib.util
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from eincm_tpu.data.dsec import DSECDataLoader as JaxDSEC
from eincm_tpu.data.ecd import ECDDataLoader as JaxECD
from eincm_tpu.data.mvsec import MVSECDataLoader as JaxMVSEC
from eincm_tpu.experiments import config as jcfg
from eincm_tpu.experiments.manager import EINCMExperiment as JaxExperiment
from eincm_tpu_torch.data import DSECDataLoader, ECDDataLoader, MVSECDataLoader
from eincm_tpu_torch.data.readers import HDF5FileReader, imread_gray
from eincm_tpu_torch.experiments import config as tcfg
from eincm_tpu_torch.experiments.manager import EINCMExperiment
from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
from eincm_tpu_torch.utils import dataset_trees
from eincm_tpu_torch.utils.png16 import read_png16, write_png16

from dataset_fixtures import (
    make_dsec_test_tree, make_dsec_tree, make_ecd_tree, make_mvsec_tree,
)

REPO = Path(__file__).resolve().parent.parent
BACKENDS = ["h5py", "h5_lite"]


def _ready(jax_loader, backend, monkeypatch):
    """Load the JAX package's reference (through h5py), then, for 'h5_lite',
    make h5py unimportable (as on the card's machine) for the port."""
    jax_loader.get_ready()
    if backend == "h5_lite":
        monkeypatch.setitem(sys.modules, "h5py", None)
    return jax_loader


def _same(a, b, where="sample"):
    """Bitwise equality of two loader outputs, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, where
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


def _compare(jax_loader, port_loader, indices=None):
    port_loader.get_ready()
    assert len(port_loader) == len(jax_loader) > 0
    for i in indices if indices is not None else range(len(jax_loader)):
        _same(jax_loader[i], port_loader[i], f"window {i}")
        assert port_loader.n_event_deficiency == jax_loader.n_event_deficiency
    return port_loader


# ---- MVSEC -------------------------------------------------------------------

MVSEC_CASES = {
    # (sequence, GT mode, loader kwargs)
    "day2-const": ("outdoor_day2", "const", dict(delta_idx=1, des_n_events=1500)),
    "day2-new-limits": ("outdoor_day2", "const",
                        dict(delta_idx=4, des_n_events=2000, load_more_images=True,
                             use_new_pruning_limits=True)),
    "day1-varying": ("outdoor_day1", "varying",
                     dict(delta_idx=8, des_n_events=1000, load_more_images=True,
                          prefer_latest_events=False)),
}


@pytest.fixture(scope="module")
def mvsec_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvsec")
    trees = {}
    for name, (seq, gt_mode, _) in MVSEC_CASES.items():
        trees[name] = make_mvsec_tree(root / name, seed=3, sequence=seq, polarity="pm1",
                                      gt_mode=gt_mode, gt_margin=0.05)
    return trees


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(MVSEC_CASES))
def test_mvsec_bitwise(mvsec_trees, case, backend, monkeypatch):
    seq, _, kw = MVSEC_CASES[case]
    jax_loader = _ready(JaxMVSEC(mvsec_trees[case], seq, **kw), backend, monkeypatch)
    port = _compare(jax_loader, MVSECDataLoader(mvsec_trees[case], seq, **kw))
    if seq == "outdoor_day1":  # the hood filter
        assert port.l_events["y"].max() < 190
    with HDF5FileReader(port.data_path) as rdr:
        assert rdr.backend == backend


# ---- DSEC --------------------------------------------------------------------

@pytest.fixture(scope="module")
def dsec_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec")
    return {
        "identity": make_dsec_tree(root / "identity", seed=1, sensor=(120, 160),
                                   n_ev=20000, n_eval_windows=2),
        "warped": make_dsec_tree(root / "warped", seed=2, geometry="warped",
                                 sensor=(240, 320), n_ev=30000, n_eval_windows=3),
        "test": make_dsec_test_tree(root / "test"),
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("geometry,sensor", [("identity", (120, 160)), ("warped", (240, 320))])
def test_dsec_train_bitwise(dsec_trees, geometry, sensor, backend, monkeypatch):
    root, seq = dsec_trees[geometry]
    kw = dict(des_n_events=8000, data_split="train", sensor_size=sensor)
    jax_loader = _ready(JaxDSEC(root, seq, **kw), backend, monkeypatch)
    port = _compare(jax_loader, DSECDataLoader(root, seq, **kw))
    assert port.mapping.dtype == np.float32
    _same(jax_loader.event_rect_map, port.event_rect_map)
    if geometry == "warped":
        assert len(port.l_events["x"]) < 30000  # rectification dropped events


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("extended", [False, True])
def test_dsec_test_split_bitwise(dsec_trees, extended, backend, monkeypatch):
    root, seq = dsec_trees["test"]
    kw = dict(des_n_events=3000, data_split="test", extended=extended)
    jax_loader = _ready(JaxDSEC(root, seq, **kw), backend, monkeypatch)
    port = DSECDataLoader(root, seq, **kw)
    _compare(jax_loader, port, indices=[0, len(jax_loader) - 1])
    assert len(port) == (11 if extended else 3)
    assert not (root / f"Evaluation/test_forward_optical_flow_timestamps/{seq}_.csv").exists()


# ---- ECD ---------------------------------------------------------------------

def test_ecd_bitwise(tmp_path):
    root, seq = make_ecd_tree(tmp_path / "ecd")
    for kw in (dict(des_n_events=400), dict(des_n_events=5000, delta_idx=2,
                                            prefer_latest_events=False)):
        jax_loader = JaxECD(root, seq, **kw)
        jax_loader.get_ready()
        port = _compare(jax_loader, ECDDataLoader(root, seq, **kw))
        assert port[0]["images"].shape[1:] == (176, 240)


# ---- geometry -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_geometry_bitwise(dtype):
    from eincm_tpu.data import geometry as jg
    from eincm_tpu_torch.data import geometry as tg

    rng = np.random.default_rng(8)
    img = (rng.uniform(0, 255, (30, 40))).astype(dtype)
    gy, gx = np.mgrid[0:30, 0:40].astype(np.float32)
    mapping = np.stack([gx * 1.01 + rng.normal(0, 2, gx.shape) - 1.5,
                        gy * 0.98 + rng.normal(0, 2, gy.shape) + 0.7], -1).astype(np.float32)
    _same(jg.remap_bicubic(img, mapping), tg.remap_bicubic(img, mapping))
    coords = np.stack(np.meshgrid(np.arange(40.0), np.arange(30.0))).reshape(2, -1)
    K = np.array([[380.0, 0, 21.0], [0, 382.0, 14.0], [0, 0, 1]])
    R = jg.Rot.from_euler("xyz", [0.3, -0.2, 0.1], degrees=True).as_matrix()
    for dist in ([-0.1, 0.02, 0.001, -0.001], [-0.3, 0.1, 0.002, 0.001, -0.02]):
        _same(jg.undistort_points_iter(coords, K, np.array(dist), R, K),
              tg.undistort_points_iter(coords, K, np.array(dist), R, K))
    a = jg.Transform(np.array([0.1, 0.2, 0.3]), jg.Rot.from_rotvec([0.01, 0.02, 0.03]))
    b = tg.Transform(np.array([0.1, 0.2, 0.3]), tg.Rot.from_rotvec([0.01, 0.02, 0.03]))
    _same((a @ a.inverse()).R_matrix(), (b @ b.inverse()).R_matrix())


# ---- imread_gray and read_png16 ----------------------------------------------

def _old_png16():
    """The JAX package's png16 module: its per-byte loop decoder is the
    reference of the port's vectorized one."""
    spec = importlib.util.spec_from_file_location("jax_png16", REPO / "eincm_tpu/utils/png16.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scenes(rng, shape):
    h, w = shape[:2]
    yy, xx = np.mgrid[:h, :w]
    smooth = 110 + 80 * np.sin(xx / 13.0) * np.cos(yy / 9.0)
    if len(shape) == 3:
        smooth = np.stack([smooth, smooth[::-1], (xx + yy) % 256], -1)
    return {"noise": rng.integers(0, 256, shape).astype(np.uint8),
            "smooth": np.clip(smooth + rng.normal(0, 4, shape), 0, 255).astype(np.uint8)}


def _filters_of(path):
    """Filter types of a PNG's rows."""
    data = Path(path).read_bytes()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            ihdr = data[pos + 8:pos + 8 + n]
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    h = int.from_bytes(ihdr[4:8], "big")
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("shape", [(37, 53), (40, 64, 3)], ids=["grey", "rgb"])
def test_png_decoders_against_pil_and_loops(tmp_path, shape):
    from PIL import Image

    old = _old_png16()
    seen = set()
    for name, img in _scenes(np.random.default_rng(len(shape)), shape).items():
        path = tmp_path / f"{name}.png"
        Image.fromarray(img).save(path)
        seen |= _filters_of(path)
        got = read_png16(path)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, old.read_png16(path))
        ref = np.asarray(Image.open(path).convert("L"))
        if len(shape) == 3:  # PIL's own luminance rounds; the loaders' BT.601 floors
            bt601 = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
            np.testing.assert_array_equal(imread_gray(path), bt601.astype(np.uint8))
            assert np.abs(imread_gray(path).astype(int) - ref).max() <= 1
        else:
            np.testing.assert_array_equal(imread_gray(path), ref)
    assert {0, 1, 2, 4} <= seen or {1, 2, 4} <= seen  # PIL chose several filters


def test_png_every_filter_bitwise(tmp_path):
    """A PNG whose rows use filters 0-4 in turn (written here) decodes as
    the loop decoder does, in 8 and 16 bits."""
    old = _old_png16()
    rng = np.random.default_rng(5)
    for dtype, c in ((np.uint8, 3), (np.uint16, 3), (np.uint8, 1)):
        img = rng.integers(0, np.iinfo(dtype).max, (23, 31, c)).astype(dtype)
        img[5:12] = img[5:12] // 7  # runs of similar values
        raw = (img.astype(">u2") if dtype == np.uint16 else img).tobytes()
        bypp = c * np.dtype(dtype).itemsize
        rows = np.frombuffer(raw, np.uint8).reshape(23, -1).astype(int)
        prev, out = np.zeros(rows.shape[1], int), []
        for y, line in enumerate(rows):
            f = y % 5
            left = np.concatenate([np.zeros(bypp, int), line[:-bypp]])
            upleft = np.concatenate([np.zeros(bypp, int), prev[:-bypp]])
            if f == 4:
                p = left + prev - upleft
                pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            else:
                pred = [0 * line, left, prev, (left + prev) // 2][f]
            out.append(bytes([f]) + ((line - pred) % 256).astype(np.uint8).tobytes())
            prev = line
        path = tmp_path / f"filters_{np.dtype(dtype).name}_{c}.png"
        write_png16(path, img)  # a valid PNG; then its IDAT replaced
        data = path.read_bytes()
        import struct

        idat = zlib.compress(b"".join(out))
        chunk = struct.pack(">I", len(idat)) + b"IDAT" + idat + struct.pack(
            ">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF)
        start = data.index(b"IDAT") - 4
        end = start + 12 + int.from_bytes(data[start:start + 4], "big")
        path.write_bytes(data[:start] + chunk + data[end:])
        got = read_png16(path)
        np.testing.assert_array_equal(got, img[..., 0] if c == 1 else img)
        np.testing.assert_array_equal(got, old.read_png16(path))


def _png(path, rows, w, depth, color_type, interlace=0):
    """A PNG of filter-0 rows written here, for what PIL does not write (2-
    and 4-bit grey, 16-bit colour, interlacing)."""
    import struct

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\0" + r for r in rows)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, len(rows), depth, color_type,
                                                  0, 0, interlace))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _png_kind(path, kind, rng):
    """Write a 9x13 PNG of `kind`: PIL's modes and palettes, or by hand."""
    from PIL import Image

    g = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    if kind == "grey1":
        Image.fromarray(g > 128).save(path)
    elif kind == "grey8":
        Image.fromarray(g, "L").save(path)
    elif kind == "grey8_trns":
        Image.fromarray(g, "L").save(path, transparency=5)
    elif kind == "grey16":
        Image.fromarray(g.astype(np.uint16) * 257).save(path)
    elif kind in ("grey2", "grey4"):
        depth = int(kind[-1])
        v = rng.integers(0, 1 << depth, (9, 13)).astype(np.uint8)
        bits = np.unpackbits(v[..., None], axis=2)[..., 8 - depth:].reshape(9, -1)
        _png(path, [np.packbits(r).tobytes() for r in bits], 13, depth, 0)
    elif kind == "rgb":
        Image.fromarray(rgb, "RGB").save(path)
    elif kind == "rgb_trns":
        Image.fromarray(rgb, "RGB").save(path, transparency=(1, 2, 3))
    elif kind == "rgba":
        Image.fromarray(rng.integers(0, 256, (9, 13, 4), dtype=np.uint8), "RGBA").save(path)
    elif kind.startswith("palette"):
        bits = int(kind.split("_")[0][7:])
        q = Image.fromarray(rgb, "RGB").quantize(1 << bits)
        q.save(path, bits=bits, **({"transparency": 0} if kind.endswith("trns") else {}))
    elif kind in ("rgb16", "rgba16", "grey_alpha16"):
        c = {"rgb16": 3, "rgba16": 4, "grey_alpha16": 2}[kind]
        v = rng.integers(0, 65536, (9, 13, c)).astype(">u2")
        _png(path, [r.tobytes() for r in v], 13, 16, {3: 2, 4: 6, 2: 4}[c])


PNG_KINDS = ["grey1", "grey2", "grey4", "grey8", "grey8_trns", "grey16", "rgb", "rgb_trns",
             "rgba", "rgb16", "rgba16", "grey_alpha16"] + [
    f"palette{b}{t}" for b in (1, 2, 4, 8) for t in ("", "_trns")]


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_imread_gray_matches_the_jax_package(tmp_path, kind):
    """Every colour type and bit depth that PIL writes (1-bit, 8-bit and
    16-bit grey, RGB, RGBA, palettes of 1, 2, 4 and 8 bits with and without
    tRNS), and those written here that PIL reads (2- and 4-bit grey, 16-bit
    colour): the port's imread_gray gives the dtype, shape and bytes of
    eincm_tpu/data/readers.py:imread_gray (imageio, PIL)."""
    from eincm_tpu.data.readers import imread_gray as jax_imread_gray

    path = tmp_path / f"{kind}.png"
    _png_kind(path, kind, np.random.default_rng(len(kind)))
    ref, got = jax_imread_gray(path), imread_gray(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype)
    assert got.tobytes() == ref.tobytes()


def test_imread_gray_refuses_other_pngs(tmp_path):
    """What the port refused until it read them (RGBA, a palette, 16-bit
    grey) reads as the JAX package's imread_gray reads it; an 8-bit grey +
    alpha PNG still raises, as the JAX function does (IndexError there).
    An interlaced PNG, refused here until the port read it, reads as the
    JAX function reads it; an unknown interlace method raises naming it."""
    from PIL import Image

    from eincm_tpu.data.readers import imread_gray as jax_imread_gray

    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 256, (4, 5, 4), dtype=np.uint8), "RGBA").save(
        tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (4, 5), dtype=np.uint8), "L").convert("P").save(
        tmp_path / "p.png")
    write_png16(tmp_path / "w.png", rng.integers(0, 65535, (4, 5)).astype(np.uint16))
    for name in ("a.png", "p.png", "w.png"):
        ref, got = jax_imread_gray(tmp_path / name), imread_gray(tmp_path / name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert got.tobytes() == ref.tobytes(), name
    Image.fromarray(np.zeros((4, 5, 2), np.uint8), "LA").save(tmp_path / "la.png")
    with pytest.raises(IndexError):
        jax_imread_gray(tmp_path / "la.png")
    with pytest.raises(ValueError, match="grey \\+ alpha"):
        imread_gray(tmp_path / "la.png")
    _adam7_png(tmp_path / "i.png", rng.integers(0, 256, (4, 5, 1), dtype=np.uint8), 8, 0)
    ref, got = jax_imread_gray(tmp_path / "i.png"), imread_gray(tmp_path / "i.png")
    assert got.dtype == ref.dtype and got.shape == ref.shape and got.tobytes() == ref.tobytes()
    _png(tmp_path / "m.png", [bytes(5)] * 4, 5, 8, 0, interlace=2)
    with pytest.raises(ValueError, match="interlace method 2"):
        imread_gray(tmp_path / "m.png")


def _filtered(rows: np.ndarray, bypp: int, first: int) -> bytes:
    """Rows of bytes (n, stride) filtered as a PNG encoder filters them,
    row i by filter (first + i) % 5, each with its filter byte."""
    prev, out = np.zeros(rows.shape[1], int), []
    for y, line in enumerate(rows.astype(int)):
        f = (first + y) % 5
        left = np.concatenate([np.zeros(bypp, int), line[:-bypp]])
        upleft = np.concatenate([np.zeros(bypp, int), prev[:-bypp]])
        if f == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * line, left, prev, (left + prev) // 2][f]
        out.append(bytes([f]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prev = line
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _adam7_png(path, samples, depth, color_type, plte=None, trns=None):
    """An Adam7-interlaced PNG of (h, w, c) samples at `depth` bits, each
    pass's rows filtered by filters 0-4 in turn (PIL writes no interlaced
    PNG)."""
    import struct

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w, c = samples.shape
    bypp = max(1, c * depth // 8)
    raw = b""
    for k, (x0, y0, dx, dy) in enumerate(ADAM7):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = np.frombuffer(sub.astype(">u2").tobytes(), np.uint8).reshape(len(sub), -1)
        elif depth == 8:
            rows = sub.reshape(len(sub), -1).astype(np.uint8)
        else:
            bits = np.unpackbits(sub.reshape(len(sub), -1, 1).astype(np.uint8), axis=2)
            rows = np.packbits(bits[..., 8 - depth:].reshape(len(sub), -1), axis=1)
        raw += _filtered(rows, bypp, k)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 1))
                     + (chunk(b"PLTE", plte.tobytes()) if plte is not None else b"")
                     + (chunk(b"tRNS", trns) if trns is not None else b"")
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# every colour type and depth that png16.read_png reads: (colour type, depth)
ADAM7_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
               (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("shape", [(9, 13), (1, 1), (5, 2), (17, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("color_type,depth", ADAM7_KINDS, ids=lambda v: str(v))
def test_interlaced_png_matches_imageio(tmp_path, color_type, depth, shape):
    """An Adam7-interlaced PNG of every colour type and depth that png16
    reads (written here: seven passes, each with its own filter rows, empty
    passes left out), at sizes with every pass, with empty ones, and a
    single pixel: read_png gives imageio.v2.imread's dtype, shape and
    bytes, and imread_gray the JAX package's."""
    import imageio.v2 as imageio

    from eincm_tpu.data.readers import imread_gray as jax_imread_gray
    from eincm_tpu_torch.utils.png16 import read_png

    rng = np.random.default_rng(depth * 16 + color_type)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << depth) - 1
    plte = None
    if color_type == 3:
        top = min(top, 5)  # indices of a 6-entry palette
        plte = rng.integers(0, 256, (top + 1, 3), dtype=np.uint8)
    samples = rng.integers(0, top + 1, (*shape, c)).astype(np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "i.png"
    _adam7_png(path, samples, depth, color_type, plte)
    ref, got = imageio.imread(path), read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape)
    assert got.tobytes() == np.asarray(ref).tobytes()
    if c != 2 or depth == 16:  # an 8-bit grey + alpha PNG has no luminance (above)
        ref, got = jax_imread_gray(path), imread_gray(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


# ---- trees written by utils/dataset_trees.py (h5_lite's writer) --------------

def _small_tree(kind, root):
    """A small tree of `kind` and the overrides that point a config at it."""
    if kind == "dsec":
        d = dataset_trees.write_dsec_tree(root, sensor=(120, 160), n_windows=3,
                                          events_per_window=6000, n_features=60)
        return d, "dsec_test.yaml", [
            f"dataset.root_dir={d['root']}", f"dataset.sequence_name={d['sequence']}",
            "dataset.data_split=train", "dataset.sensor_size=[120, 160]",
            "dataset.des_n_events=6000", "solver.splat_impl=xla",
            # DSEC's tuning (alpha 2000, beta 4000) reaches the float32 noise
            # floor within a few iterations, where its retries after a failed
            # line search go by rounding: compare iterations without them
            "solver.n_extra_attempts={0: 0, 1: 0}"]
    if kind == "mvsec":
        d = dataset_trees.write_mvsec_tree(root, n_windows=2, events_per_window=4000,
                                           n_features=40)
        return d, "mvsec_indoor.yaml", [
            f"dataset.root_dir={d['root']}", f"dataset.sequence_name={d['sequence']}",
            "dataset.des_n_events=4000"]
    d = dataset_trees.write_ecd_tree(root, n_windows=2, events_per_window=4000, n_features=40)
    return d, "ecd_slider.yaml", [f"dataset.root_dir={d['root']}",
                                  f"dataset.sequence_name={d['sequence']}",
                                  "dataset.des_n_events=4000"]


@pytest.mark.parametrize("kind", ["dsec", "mvsec", "ecd"])
def test_written_trees_load_bitwise(tmp_path, kind, monkeypatch):
    """The JAX package's loader reads a written tree through h5py and
    PyYAML, the port's through h5_lite and yaml_lite: the same samples."""
    d, config, ovs = _small_tree(kind, tmp_path / kind)
    kw = {o.split("=", 1)[0].split(".", 1)[1]: o.split("=", 1)[1] for o in ovs
          if o.startswith("dataset.") and "root_dir" not in o}
    cfg = jcfg.load_config(str(REPO / "configs" / config),
                           [f"dataset.{k}={v}" for k, v in kw.items()]
                           + [f"dataset.root_dir={d['root']}"])
    jax_loader = _ready(cfg.dataset.make_loader(), "h5_lite", monkeypatch)
    monkeypatch.setitem(sys.modules, "yaml", None)
    port_cfg = tcfg.load_config(str(REPO / "configs" / config),
                                [f"dataset.{k}={v}" for k, v in kw.items()]
                                + [f"dataset.root_dir={d['root']}"])
    _compare(jax_loader, port_cfg.dataset.make_loader())


# ---- one tiny CLI experiment per loader kind, through both managers ---------

CLI_OVERRIDES = ["solver.n_pyr_lvls=2", "solver.theta_maxiter=4", "solver.handover_maxiter=3",
                 "solver.theta_miniter=2", "solver.handover_miniter=1",
                 "phases.plot=false", "phases.run_idx_range=[0, 2]",
                 "phases.checkpoint_every_percent=0", "solver.armijo_rescue=false",
                 "edge.enable_image_preprocessing=false", "edge.smoothen_method=eincm_iedt"]


def _aee(results):
    return [float(results[k]["evals"]["AEE"]) for k in sorted(results)]


@pytest.fixture
def one_thread():
    """The port's plain splat sums in a thread-dependent order on the CPU;
    one thread makes its run repeatable."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["ecd", "mvsec", "dsec"])
def test_cli_experiment_per_loader(tmp_path, kind, one_thread):
    """The same tiny experiment (2 windows, 2 levels) on a written tree
    through both managers: the first window's iterations and statuses
    equal, AEE within 0.05 px (ECD, which has no GT: the level-0 flow's
    error against the scene's velocity)."""
    d, config, ovs = _small_tree(kind, tmp_path / "data")
    path = str(REPO / "configs" / config)
    ovs = [*ovs, *CLI_OVERRIDES]
    jax_exp = JaxExperiment(jcfg.load_config(path, [*ovs, f"output_dir={tmp_path}/j"]))
    jax_exp.run()
    port = EINCMExperiment(tcfg.load_config(path, [*ovs, f"output_dir={tmp_path}/t"]),
                           device=torch.device("cpu"))
    port.run()
    assert sorted(port.opt_results) == sorted(jax_exp.opt_results)
    ref = jax_exp.opt_results["datasample_idx_0"]["solver_final_results"]["theta_opt_state_pyr"]
    got = port.opt_results["datasample_idx_0"]["solver_final_results"]["theta_opt_state_pyr"]
    for lvl in ref:
        for key in ("iter_num", "total_iters", "n_attempts", "status"):
            assert int(got[lvl][key]) == int(ref[lvl][key]), (lvl, key)
    if kind == "ecd":
        ref = [flow_error(jax_exp, k, d) for k in sorted(jax_exp.opt_results)]
        got = [flow_error(port, k, d) for k in sorted(port.opt_results)]
    else:
        ref, got = _aee(jax_exp.eval_results), _aee(port.eval_results)
    print(f"\n[{kind}] AEE per window: JAX {np.round(ref, 4).tolist()}, port "
          f"{np.round(got, 4).tolist()}; velocity {d['velocity']}")
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=0.05)


def flow_error(exp, key, tree):
    """Mean |level-0 flow - the scene's velocity| over the sensor (px)."""
    theta = exp.opt_results[key]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"]
    flow = scale_theta_to_sensor_size(torch.tensor(np.asarray(theta)), tree["sensor"])
    return float(torch.linalg.norm(flow - torch.tensor(tree["velocity"]), dim=-1).mean())
