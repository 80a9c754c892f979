"""`eincm_tpu_torch/utils/h5_lite.py` against h5py: it reads bitwise what
h5py writes by default (contiguous, compact and chunked layouts, gzip and
shuffle, scalars and 1-3-D arrays of every dtype the loaders use, nested
groups, object headers continued in a second block); h5py reads what
`write_h5` writes; and what it does not read raises `UnsupportedHDF5`
naming the feature."""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from eincm_tpu_torch.utils import h5_lite  # noqa: E402
from eincm_tpu_torch.utils.h5_lite import UnsupportedHDF5, write_h5  # noqa: E402



def read_h5(path, key):
    with h5_lite.File(path) as f:
        return f.read(key)


# the dtypes of the loaders' files: DSEC events (u2, i8, u1), ms_to_idx
# (u8), rectify maps (f4), MVSEC events and timestamps (f8), images (u1)
DTYPES = ["u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8", "f2", "f4", "f8", ">i4", ">f8", ">u2"]
SHAPES = [(), (7,), (5, 3), (2, 3, 4), (0,)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.normal(0, 1000, shape)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=np.int64 if info.min < 0 else np.uint64,
                        endpoint=True).astype(dt)


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_h5py_contiguous(tmp_path, dtype):
    path = tmp_path / "a.h5"
    arrays = {f"s{i}": _array(dtype, shape, i) for i, shape in enumerate(SHAPES)}
    with h5py.File(path, "w") as f:
        for key, a in arrays.items():
            f[key] = a
    with h5_lite.File(path) as f:
        for key, a in arrays.items():
            _same(f.read(key), np.asarray(h5py.File(path)[key]))
            _same(f.read(key), a)


@pytest.mark.parametrize("dtype", ["u1", "u2", "i8", "f4", "f8", ">i4"])
@pytest.mark.parametrize("filters", [{}, {"compression": "gzip"},
                                     {"compression": "gzip", "shuffle": True},
                                     {"shuffle": True}, {"compression": "gzip",
                                                         "compression_opts": 9}])
def test_reads_h5py_chunked(tmp_path, dtype, filters):
    path = tmp_path / "c.h5"
    arrays = {"one": (_array(dtype, (1000,)), (64,)),
              "two": (_array(dtype, (37, 53), 1), (8, 16)),  # edge chunks are partial
              "three": (_array(dtype, (5, 6, 7), 2), (2, 6, 3)),
              "grown": (_array(dtype, (25,), 3), (4,))}
    with h5py.File(path, "w") as f:
        for key, (a, chunks) in arrays.items():
            kw = {"maxshape": (None,)} if key == "grown" else {}
            f.create_dataset(key, data=a, chunks=chunks, **filters, **kw)
    with h5_lite.File(path) as f:
        for key, (a, _) in arrays.items():
            _same(f.read(key), a)


def test_reads_many_chunks_and_unwritten(tmp_path):
    """A chunk B-tree of more than one level, and datasets never written
    (h5py reads them as zeros)."""
    path = tmp_path / "m.h5"
    a = np.arange(300_000, dtype=np.float32).reshape(600, 500)
    with h5py.File(path, "w") as f:
        f.create_dataset("big", data=a, chunks=(7, 9), compression="gzip")
        f.create_dataset("empty_chunked", shape=(10, 4), dtype="i2", chunks=(3, 3))
        f.create_dataset("empty", shape=(6,), dtype="f8")
    with h5_lite.File(path) as f:
        _same(f.read("big"), a)
        _same(f.read("empty_chunked"), np.zeros((10, 4), "i2"))
        _same(f.read("empty"), np.zeros(6))


def test_reads_compact(tmp_path):
    path = tmp_path / "k.h5"
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(a.shape)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, space, dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a)
    assert h5py.File(path)["compact"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
    _same(read_h5(path, "compact"), a)


def test_nested_groups_and_continued_headers(tmp_path):
    """Paths through nested groups, a group with more members than one
    symbol node holds, and object headers long enough (many attributes) to
    continue in a second block."""
    path = tmp_path / "g.h5"
    rng = np.random.default_rng(1)
    data = {"davis/left/events": rng.normal(0, 1, (100, 4)),
            "davis/left/image_raw": rng.integers(0, 255, (3, 26, 34)).astype(np.uint8),
            "davis/right/imu_ts": np.linspace(0, 1, 10)}
    with h5py.File(path, "w") as f:
        for key, a in data.items():
            f[key] = a
        for i in range(40):
            f[f"many/m{i:03d}"] = np.full(3, i, np.int16)
            f["davis/left/events"].attrs[f"attr{i}"] = np.arange(i + 1)
            f["davis"].attrs[f"a{i}"] = "x" * 30
    f = h5_lite.File(path)
    msgs = f._messages(*f._find(["davis", "left", "events"]))
    assert any(t == 0x10 for t, _ in msgs)  # a continuation message was followed
    for key, a in data.items():
        _same(f.read(key), a)
    for i in range(40):
        _same(f.read(f"many/m{i:03d}"), np.full(3, i, np.int16))
    with pytest.raises(KeyError, match="no object 'nope'"):
        f.read("davis/nope")
    with pytest.raises(KeyError, match="not a dataset"):
        f.read("davis/left")
    f.close()


def test_h5py_reads_write_h5(tmp_path):
    path = tmp_path / "w.h5"
    rng = np.random.default_rng(2)
    data = {"events/x": rng.integers(0, 640, 1000).astype(np.uint16),
            "events/t": np.sort(rng.integers(0, 10**9, 1000)),
            "events/p": rng.integers(0, 2, 1000).astype(np.uint8),
            "t_offset": np.int64(123456789), "scale": 2.5,
            "rectify_map": rng.normal(0, 100, (12, 16, 2)).astype(np.float32),
            "a/b/c/deep": np.arange(6, dtype=">i4").reshape(2, 3),
            "empty": np.zeros((0, 4)),
            **{f"g/m{i:02d}": np.full(2, i, np.int8) for i in range(30)}}
    write_h5(path, data)
    with h5py.File(path, "r") as f:
        for key, a in data.items():
            got = f[key][()]
            a = np.asarray(a)
            assert np.asarray(got).shape == a.shape and np.asarray(got).dtype == a.dtype, key
            np.testing.assert_array_equal(got, a)
        assert f["t_offset"].shape == ()
    with h5_lite.File(path) as f:
        for key, a in data.items():
            _same(f.read(key), np.asarray(a))
    with pytest.raises(UnsupportedHDF5, match="bool"):
        write_h5(tmp_path / "b.h5", {"p": np.zeros(3, bool)})


@pytest.mark.parametrize("what,feature", [
    ("lzf", "filter 32000 \\(LZF\\)"),
    ("fletcher32", "filter 3 \\(fletcher32\\)"),
    ("string", "datatype class 3 \\(string\\)"),
    ("bool", "datatype class 8 \\(enumerated\\)"),
    ("compound", "datatype class 6 \\(compound\\)"),
])
def test_unsupported_features_raise(tmp_path, what, feature):
    path = tmp_path / f"{what}.h5"
    with h5py.File(path, "w") as f:
        if what == "lzf":
            f.create_dataset("d", data=np.arange(100.0), chunks=(10,), compression="lzf")
        elif what == "fletcher32":
            f.create_dataset("d", data=np.arange(100.0), chunks=(10,), fletcher32=True)
        elif what == "string":
            f["d"] = np.bytes_(b"abc")
        elif what == "bool":
            f["d"] = np.array([True, False])
        else:
            f["d"] = np.zeros(3, [("a", "i4"), ("b", "f8")])
    with pytest.raises(UnsupportedHDF5, match=f"{path}: /d: {feature}"):
        read_h5(path, "d")


def test_latest_format_raises(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(3)
    with pytest.raises(UnsupportedHDF5, match="superblock v3"):
        h5_lite.File(path)


def test_not_hdf5_raises(tmp_path):
    (tmp_path / "x.h5").write_bytes(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5_lite.File(tmp_path / "x.h5")
