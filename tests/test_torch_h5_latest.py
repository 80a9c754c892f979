"""`eincm_tpu_torch/utils/h5_lite.py` on what h5py writes under every
`libver`, held to the JAX package's reader
(`eincm_tpu/data/readers.py:HDF5FileReader.read_dataset`, which is h5py's
`np.asarray`): the same dtype, shape and bytes (object arrays element by
element) for every dataset of `tests/make_hdf5_fixtures.py:write_features`
under superblocks 0, 2 and 3; fill values (old and new messages, int,
float and NaN, every layout); the checksums (lookup3, Fletcher-32) against
their definitions; the committed fixtures (tests/data/hdf5/) against their
manifest; the DSEC and MVSEC loaders on latest-format trees bitwise the
JAX loaders'; structures past a first level (paged extensible arrays,
B-tree levels, fractal heap indirect blocks); features that still raise;
and malformed files, which raise only ValueError, in a subprocess that
must survive them."""

import importlib.util
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from eincm_tpu.data.readers import HDF5FileReader as JaxReader  # noqa: E402
from eincm_tpu_torch.utils import dataset_trees, h5_latest, h5_lite  # noqa: E402
from eincm_tpu_torch.utils.h5_lite import UnsupportedHDF5  # noqa: E402

from make_hdf5_fixtures import (  # noqa: E402
    LIBVERS, _appended, dataset_keys, payload_sha, write_features,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "hdf5"
SUPERBLOCK = {"earliest": 0, "v108": 2, "v110": 3, "v112": 3, "latest": 3}


def _jax(path, key):
    with JaxReader(path) as r:
        return r.read_dataset(key)


def _same(ref: np.ndarray, got: np.ndarray, key: str) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape, (key, got.dtype, ref.dtype,
                                                               got.shape, ref.shape)
    if ref.dtype == object:
        for a, b in zip(ref.reshape(-1), got.reshape(-1)):
            assert type(a) is type(b) and a == b, (key, a, b)
    else:
        assert got.tobytes() == ref.tobytes(), key


def _all_same(path, keys=None) -> int:
    keys = dataset_keys(path) if keys is None else keys
    with h5_lite.File(path) as f:
        for key in keys:
            _same(_jax(path, key), f.read(key), key)
    return len(keys)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- checksums ---------------------------------------------------------------

def test_lookup3_known_values():
    """Bob Jenkins' published values of `hashlittle` (lookup3.c's self-test)."""
    assert h5_latest.lookup3(b"") == 0xDEADBEEF
    text = b"Four score and seven years ago"
    assert h5_latest.lookup3(text) == 0x17770551
    assert h5_latest.lookup3(text, 1) == 0xCD628161


def _fletcher32_loop(data: bytes) -> int:
    """H5_checksum_fletcher32 (H5checksum.c) line by line."""
    n, s1, s2, i = len(data) // 2, 0, 0, 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            s1 += (data[i] << 8) | data[i + 1]
            i += 2
            s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[i] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def test_fletcher32_is_hdf5s():
    """The vectorized Fletcher-32 against HDF5's loop: odd and even lengths,
    more than one 360-word block, all zeros and all 0xFF (where the folded
    sums reach 65535); HDF5's byte-swapped form is accepted too."""
    rng = np.random.default_rng(0)
    cases = [b"", b"\x01", b"\x00" * 999, b"\xff" * 2000, b"\xff" * 1441,
             bytes(rng.integers(0, 256, 5001, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 720, dtype=np.uint8))]
    for data in cases:
        f = _fletcher32_loop(data)
        assert h5_latest.fletcher32(data) == f, len(data)
        swapped = ((f & 0x00FF00FF) << 8) | ((f >> 8) & 0x00FF00FF)
        assert h5_latest.fletcher32_matches(data, f)
        assert h5_latest.fletcher32_matches(data, swapped)
        assert not h5_latest.fletcher32_matches(data, f ^ 0x10000)


# ---- every feature, every libver ---------------------------------------------

@pytest.mark.parametrize("libver", list(LIBVERS))
def test_features_read_as_h5py_reads_them(tmp_path, libver):
    """Every dataset of `write_features` (groups dense and compact, soft
    links, every chunk index, filters, Fletcher-32, enums, strings, fill
    values) under h5py's `libver`: bitwise the JAX package's reading."""
    path = tmp_path / f"{libver}.h5"
    write_features(path, libver)
    assert path.read_bytes()[8] == SUPERBLOCK[libver]
    assert _all_same(path) >= 60


@pytest.mark.parametrize("libver", ["earliest", "v108", "latest"])
def test_compact_layout_and_wide_header_sizes(tmp_path, libver):
    """A compact dataset of 60000 bytes (its data in the layout message, so
    a version 2 header's chunk 0 needs a 2-byte size field) and a small
    one, under each superblock: bitwise the JAX package's reading."""
    path = tmp_path / "compact.h5"
    with h5py.File(path, "w", libver={"earliest": "earliest", "v108": ("v108", "v108"),
                                      "latest": "latest"}[libver]) as f:
        for key, a in (("big", np.arange(7500, dtype="<f8")), ("small", np.arange(6, dtype="i2"))):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            ds = h5py.h5d.create(f.id, key.encode(), h5py.h5t.py_create(a.dtype),
                                 h5py.h5s.create_simple(a.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a)
    assert _all_same(path) == 2
    with h5_lite.File(path) as f:
        addr, obj = f._find(["big"])
        assert [b for t, b in f._messages(addr, obj) if t == 0x8][0][1] == 0  # compact
        if libver != "earliest":
            assert f._read(addr, 6)[5] & 0x03 == 1  # chunk 0's size in 2 bytes


def _layout_index(f: h5_lite.File, key: str):
    """The chunk index type of a dataset's layout message v4 (None for any
    other layout)."""
    addr, obj = f._find(key.split("/"))
    layout = [b for t, b in f._messages(addr, obj) if t == 0x8][0]
    if layout[0] != 4 or layout[1] != 2:
        return None
    ndims, enc = layout[3], layout[4]
    return layout[5 + ndims * enc]


def test_latest_fixture_holds_every_structure():
    """The committed latest-format file holds each structure this port
    reads: the five chunk indexes, a paged fixed array, extensible array
    super blocks, B-tree internal nodes, dense groups (fractal heap), a
    continued object header, global heap strings, creation order."""
    path = FIXTURES / "features_latest.h5"
    data = path.read_bytes()
    assert data[8] == 3
    with h5_lite.File(path) as f:
        kinds = {k: _layout_index(f, k) for k in (
            "single", "single_gz", "fill_single", "implicit", "fixed", "fixed_gz",
            "fixed_paged", "extensible", "extensible_gz", "extensible_many", "mvsec_events",
            "extensible_axis1", "btree2", "btree2_gz", "btree2_levels")}
        assert kinds == {"single": 1, "single_gz": 1, "fill_single": 1, "implicit": 2,
                         "fixed": 3, "fixed_gz": 3, "fixed_paged": 3, "extensible": 4,
                         "extensible_gz": 4, "extensible_many": 4, "mvsec_events": 4,
                         "extensible_axis1": 4, "btree2": 5, "btree2_gz": 5,
                         "btree2_levels": 5}
        addr, obj = f._find(["continued"])
        assert any(t == 0x10 for t, _ in f._messages(addr, obj))
    for sig in (b"OHDR", b"OCHK", b"FRHP", b"FHDB", b"BTHD", b"BTIN", b"BTLF", b"FAHD",
                b"FADB", b"EAHD", b"EAIB", b"EASB", b"EADB", b"GCOL"):
        assert sig in data, sig
    with h5py.File(path) as f:
        assert f["mvsec_events"].shape == (1200, 4) and f["mvsec_events"].dtype == "f8"
        assert f["fixed_paged"].id.get_num_chunks() > 1024


# ---- fill values -------------------------------------------------------------

FILLS = {"int": ("i4", 7), "float": ("f8", 2.5), "nan": ("f4", np.nan)}


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("libver", ["earliest", "v108", "latest"])
def test_fill_values_as_h5py(tmp_path, libver, fill):
    """h5py's fill value where nothing was written: a contiguous dataset
    never written, chunks no index lists (fixed, unlimited, two unlimited
    axes, a single chunk), a chunk half written, under the old layouts and
    the new ones."""
    dtype, value = FILLS[fill]
    path = tmp_path / "fill.h5"
    with h5py.File(path, "w", libver={"earliest": "earliest", "v108": ("v108", "v108"),
                                      "latest": "latest"}[libver]) as f:
        f.create_dataset("contiguous", shape=(6,), dtype=dtype, fillvalue=value)
        f.create_dataset("contiguous_written", shape=(6,), dtype=dtype, fillvalue=value)[2] = 1
        f.create_dataset("chunked", shape=(30,), dtype=dtype, chunks=(10,), fillvalue=value)[:5] = 1
        f.create_dataset("unlimited", shape=(30,), dtype=dtype, chunks=(4,), fillvalue=value,
                         maxshape=(None,))[9:11] = 1
        f.create_dataset("two_unlimited", shape=(7, 9), dtype=dtype, chunks=(3, 4),
                         fillvalue=value, maxshape=(None, None))[4, 5] = 1
        f.create_dataset("single", shape=(3, 4), dtype=dtype, chunks=(3, 4), fillvalue=value)
        f.create_dataset("default", shape=(5,), dtype=dtype, chunks=(2,))
    assert _all_same(path) == 7
    with h5_lite.File(path) as f:
        tail = f.read("chunked")[10:]
        assert np.isnan(tail).all() if fill == "nan" else (tail == value).all()


def _old_fill_file(path, message: int, body: bytes, dtype="<i4", shape=(5,)):
    """A version 0 file (`write_h5`'s) of one dataset never written whose
    fill value is given by message `message` (0x4 old, 0x5 new) `body`."""
    original = h5_lite._write_dataset

    def write_dataset(w, value):
        space = struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
            struct.pack("<Q", d) for d in shape)
        return w.append(h5_lite._object_header([
            h5_lite._message(0x1, space),
            h5_lite._message(0x3, h5_lite._datatype_message(np.dtype(dtype)), flags=1),
            h5_lite._message(message, body, flags=1),
            h5_lite._message(0x8, struct.pack("<BBQQ", 3, 1, h5_lite.UNDEF,
                                              int(np.prod(shape)) * np.dtype(dtype).itemsize))]))

    h5_lite._write_dataset = write_dataset
    try:
        h5_lite.write_h5(path, {"d": np.zeros(1)})
    finally:
        h5_lite._write_dataset = original


@pytest.mark.parametrize("case", ["old", "new_v1", "new_v1_undefined", "new_v2",
                                  "new_v3", "new_v3_undefined", "new_v3_never"])
def test_fill_value_messages(tmp_path, case):
    """The old fill value message (0x4) and versions 1-3 of the new one
    (0x5), defined and never filled, read as h5py reads them; undefined,
    over storage never allocated, refused as HDF5 refuses it."""
    seven = struct.pack("<i", 7)
    body = {"old": struct.pack("<I", 4) + seven,
            "new_v1": struct.pack("<BBBBI", 1, 2, 2, 1, 4) + seven,
            "new_v1_undefined": struct.pack("<BBBB", 1, 2, 2, 0),
            "new_v2": struct.pack("<BBBBI", 2, 2, 2, 1, 4) + seven,
            "new_v3": struct.pack("<BBI", 3, 0x20 | 2 << 2 | 2, 4) + seven,
            "new_v3_undefined": struct.pack("<BB", 3, 0x10 | 2 << 2 | 2),
            "new_v3_never": struct.pack("<BBI", 3, 0x20 | 1 << 2 | 2, 4) + seven}[case]
    path = tmp_path / "f.h5"
    _old_fill_file(path, 0x4 if case == "old" else 0x5, body)
    if "undefined" in case:  # never written, nothing to fill with: HDF5 reads nothing
        with pytest.raises(OSError, match="no data can be read"):
            _jax(path, "d")
        with pytest.raises(ValueError, match="its fill value is undefined"):
            h5_lite.File(path).read("d")
        return
    ref = _jax(path, "d")
    _same(ref, h5_lite.File(path).read("d"), case)
    assert (ref == (0 if "never" in case else 7)).all()


# ---- superblocks, links, object headers --------------------------------------

def test_superblock_extension_and_object_header_options(tmp_path):
    """A superblock extension (paged file space), and version 2 object
    headers with times, attribute phase values and creation order kept
    per message."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest", fs_strategy="page", fs_persist=True) as f:
        f.create_dataset("timed", data=np.arange(7.0), track_times=True)
        f.create_dataset("ordered", data=np.arange(5), track_order=True).attrs["a"] = 1
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_attr_phase_change(4, 2)
        h5py.h5d.create(f.id, b"phases", h5py.h5t.STD_I16LE, h5py.h5s.create_simple((3,)),
                        dcpl=dcpl)
    data = path.read_bytes()
    assert struct.unpack("<Q", data[20:28])[0] != h5_lite.UNDEF  # the extension's address
    with h5_lite.File(path) as f:
        flags = {k: f._read(f._find([k])[0], 6)[5] for k in ("timed", "ordered", "phases")}
    assert flags["timed"] & 0x20 and flags["ordered"] & 0x04 and flags["phases"] & 0x10
    assert _all_same(path) == 3


def test_soft_external_and_dangling_links(tmp_path):
    """Soft links as h5py follows them (absolute, relative, chained); a
    dangling one and a missing name raise KeyError; a cycle raises
    ValueError; an external link, which raised here until h5_lite followed
    them (tests/test_torch_h5_features.py), to a file that is nowhere
    raises KeyError naming it, as h5py does."""
    path = tmp_path / "l.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["g/data"] = np.arange(4)
        f["g/rel"] = h5py.SoftLink("data")
        f["abs"] = h5py.SoftLink("/g/rel")
        f["dangling"] = h5py.SoftLink("/nowhere")
        f["loop_a"] = h5py.SoftLink("/loop_b")
        f["loop_b"] = h5py.SoftLink("/loop_a")
        f["ext"] = h5py.ExternalLink("other.h5", "/x")
    with h5_lite.File(path) as f:
        for key in ("g/rel", "abs"):
            _same(_jax(path, key), f.read(key), key)
        with pytest.raises(KeyError, match="no object 'nowhere'"):
            f.read("dangling")
        with pytest.raises(ValueError, match="more than 16 soft links"):
            f.read("loop_a")
        with pytest.raises(KeyError, match=f"{path}: /ext: an external link to other.h5:/x, "
                                           "and no file 'other.h5' in"):
            f.read("ext")
    with h5py.File(path, "r") as f:
        with pytest.raises(KeyError):
            f["ext"]


def test_open_for_writing_raises(tmp_path):
    """A version 3 file copied while a writer holds it open (SWMR, and a
    plain writer) is marked so in its superblock: h5py refuses it, and so
    does h5_lite; closed, both read it."""
    path = tmp_path / "w.h5"
    for swmr in (True, False):
        copy = tmp_path / f"open_{swmr}.h5"
        f = h5py.File(path, "w", libver="latest")
        f.create_dataset("x", data=np.arange(5), maxshape=(None,), chunks=(2,))
        if swmr:
            f.swmr_mode = True
        f.flush()
        shutil.copyfile(path, copy)
        f.close()
        assert copy.read_bytes()[11] & 0x05
        with pytest.raises(OSError):
            h5py.File(copy, "r")
        with pytest.raises(ValueError, match="marked open for writing"):
            h5_lite.File(copy)
        assert _all_same(path) == 1


# ---- structures past a first level --------------------------------------------

def test_large_indexes_and_dense_groups(tmp_path):
    """A paged extensible array (over 131056 chunks: super blocks whose data
    blocks are paged), a version 2 B-tree of three levels, and a dense
    group whose fractal heap needs indirect blocks below its root."""
    path = tmp_path / "big.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("ea_paged", data=np.arange(140_000, dtype="u1"), maxshape=(None,),
                         chunks=(1,))
        f.create_dataset("btree_levels", data=np.arange(10_000, dtype="i4").reshape(100, 100),
                         maxshape=(None, None), chunks=(1, 1))
        f["target"] = np.arange(3)
        g = f.create_group("links")
        for i in range(2800):
            g[f"{i:05d}_" + "n" * 200] = f["target"]
    with h5_lite.File(path) as f:
        heap = f._links(f._find(["links"])[0], "/links")
        assert len(heap) == 2800
        addr, obj = f._find(["links"])
        info = [b for t, b in f._messages(addr, obj) if t == 0x2][0]
        fheap = h5_latest.FractalHeap(f._read, struct.unpack("<Q", info[2:10])[0], "links")
        assert fheap.blocks[-1][0] > 4 * 131072  # past the root's direct rows
    data = path.read_bytes()
    assert data.count(b"FHIB") > 1 and data.count(b"EASB") == 10  # super blocks 4-13
    assert _all_same(path, ["ea_paged", "btree_levels", "links/01234_" + "n" * 200]) == 3


# ---- still unsupported ----------------------------------------------------------

def _unsupported_file(path, what):
    with h5py.File(path, "w", libver="latest") as f:
        if what == "virtual":  # a source whose strings cannot become numbers
            f["src"] = np.array([b"ab", b"cd"])
            layout = h5py.VirtualLayout(shape=(2,), dtype="i8")
            layout[:] = h5py.VirtualSource(f["src"])
            f.create_virtual_dataset("d", layout)
        elif what in ("bitshuffle", "blosc2"):
            d = f.create_dataset("d", shape=(8,), dtype="u2", chunks=(8,),
                                 compression={"bitshuffle": 32008, "blosc2": 32026}[what],
                                 allow_unknown_filter=True)
            d.id.write_direct_chunk((0,), bytes(16), 0)
        elif what == "sequence":  # of variable-length strings
            f.create_dataset("d", shape=(2,), dtype=h5py.vlen_dtype(h5py.string_dtype()))
        elif what == "reference":  # in a compound
            f.create_dataset("d", shape=(2,), dtype=[("r", h5py.ref_dtype), ("i", "<i4")])
        elif what == "external":  # an opaque type, stored in an external file
            f.create_dataset("d", shape=(4,), dtype="V4", external=[("raw.bin", 0, 16)])


@pytest.mark.parametrize("what,feature", [
    ("virtual", "a source of \\|S2 in a virtual dataset of int64"),
    ("bitshuffle", "filter 32008 \\(bitshuffle\\)"),
    ("blosc2", "filter 32026 \\(Blosc2\\)"),
    ("sequence", "a variable-length sequence of vlen string"),
    ("reference", "a reference member of a compound type"),
    ("external", "datatype class 5 \\(opaque\\)"),
])
def test_still_unsupported_raise(tmp_path, what, feature):
    """What h5_lite still does not read raises UnsupportedHDF5 naming the
    file, the object and the feature. Virtual datasets, sequences,
    references and external data files, which raised here until h5_lite
    read them (tests/test_torch_h5_features.py), raise where they hold
    what it does not read."""
    path = tmp_path / f"{what}.h5"
    _unsupported_file(path, what)
    with pytest.raises(UnsupportedHDF5, match=f"{path}: /d: {feature} is not supported"):
        h5_lite.File(path).read("d")


# ---- the committed fixtures and the loaders -------------------------------------

def test_committed_fixtures_match_their_manifest(tmp_path):
    """tests/data/hdf5/ as tests/make_hdf5_fixtures.py writes it: each file by
    its sha256 (the features files written again here, bitwise), each
    dataset through h5_lite (chip_smoke.py [h5]'s check, run here) and
    through the JAX package's reader by its sha256, dtype and shape; the
    directory under 1.5 MB."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    counts = _chip_smoke().check_codec_fixtures(FIXTURES)
    assert sum(c[0] for c in counts.values()) == len(manifest["payloads"])
    assert set(counts) == set(manifest["files"]) == {
        "features_earliest.h5", "features_v108.h5", "features_latest.h5",
        "dsec_events_latest.h5"}
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1_500_000
    for key, p in manifest["payloads"].items():
        rel, _, dataset = key.partition(":")
        a = _jax(FIXTURES / rel, dataset)
        assert [payload_sha(a), a.dtype.str, list(a.shape)] == [p["sha256"], p["dtype"],
                                                                p["shape"]], key
    for libver in ("earliest", "v108", "latest"):
        path = tmp_path / f"features_{libver}.h5"
        write_features(path, libver, many_chunks=libver == "latest")
        assert payload_sha(np.frombuffer(path.read_bytes(), np.uint8)) == (
            manifest["files"][path.name]["sha256"]), libver


def _rewrite_latest(path: Path) -> None:
    """The file's datasets written again under libver="latest": every array
    appended along axis 0 in three pieces under maxshape None, gzip and
    shuffle (extensible arrays), scalars as they were."""
    with h5py.File(path, "r") as f:
        data = {k: np.asarray(f[k]) for k in dataset_keys(path)}
    path.unlink()
    with h5py.File(path, "w", libver="latest") as f:
        for key, a in data.items():
            if a.ndim == 0 or a.size == 0:
                f[key] = a
            else:
                chunks = (max(1, min(4096, len(a) // 5)),) + a.shape[1:]
                _appended(f, key, a, chunks, len(a) // 3 + 1, compression="gzip",
                          shuffle=True)


def _same_sample(a, b, where="sample"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same_sample(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_sample(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, where
        assert np.asarray(b).tobytes() == np.asarray(a).tobytes(), where
    else:
        assert a == b, where


@pytest.mark.parametrize("kind", ["dsec", "mvsec"])
def test_loaders_on_latest_format_trees(tmp_path, kind, monkeypatch):
    """Each HDF5 file of a small DSEC or MVSEC tree written again under
    libver="latest" (events appended into extensible arrays; MVSEC's
    davis/left/events (N, 4) float64): the port's loader, h5py blocked so
    that h5_lite reads, gives bitwise the JAX loader's samples."""
    from eincm_tpu.data.dsec import DSECDataLoader as JaxDSEC
    from eincm_tpu.data.mvsec import MVSECDataLoader as JaxMVSEC
    from eincm_tpu_torch.data import DSECDataLoader, MVSECDataLoader

    if kind == "dsec":
        tree = dataset_trees.write_dsec_tree(tmp_path, sensor=(120, 160), n_windows=3,
                                             events_per_window=6000, n_features=60)
        kw = dict(des_n_events=6000, data_split="train", sensor_size=(120, 160))
        make = lambda cls: cls(tree["root"], tree["sequence"], **kw)  # noqa: E731
        jax_cls, port_cls = JaxDSEC, DSECDataLoader
    else:
        tree = dataset_trees.write_mvsec_tree(tmp_path, n_windows=2, events_per_window=4000,
                                              n_features=40)
        make = lambda cls: cls(tree["root"], tree["sequence"], des_n_events=4000)  # noqa: E731
        jax_cls, port_cls = JaxMVSEC, MVSECDataLoader
    files = sorted(p for p in Path(tree["root"]).rglob("*") if p.suffix in (".h5", ".hdf5"))
    assert files
    for p in files:
        _rewrite_latest(p)
        assert p.read_bytes()[8] == 3
    jax_loader = make(jax_cls)
    jax_loader.get_ready()
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = make(port_cls)
    port.get_ready()
    assert len(port) == len(jax_loader) >= 2
    for i in range(len(port)):
        _same_sample(jax_loader[i], port[i], f"{kind} window {i}")


def test_dsec_loader_reads_the_latest_fixture(tmp_path, monkeypatch):
    """The slice: a DSEC tree whose events.h5 is the committed latest-format
    fixture, read by the port's loader through h5_lite, gives bitwise the
    JAX loader's samples on it, and window 0 bitwise the port's window 0 of
    the Blosc-Zstd fixture of the same scene (chip_smoke.py [h5] asserts
    the same on the card)."""
    from eincm_tpu.data.dsec import DSECDataLoader as JaxDSEC
    from eincm_tpu_torch.data import DSECDataLoader

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    tree = dataset_trees.write_dsec_tree(tmp_path, **manifest["events_tree"])
    events = tree["root"] / f"Train/train_events/{tree['sequence']}/events/left/events.h5"
    kw = dict(des_n_events=100_000, data_split="train")
    shutil.copyfile(FIXTURES / "dsec_events_latest.h5", events)
    jax_loader = JaxDSEC(tree["root"], tree["sequence"], **kw)
    jax_loader.get_ready()
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = DSECDataLoader(tree["root"], tree["sequence"], **kw)
    port.get_ready()
    assert len(port) == len(jax_loader) == 2
    latest = [port[i] for i in range(len(port))]
    for i, s in enumerate(latest):
        _same_sample(jax_loader[i], s, f"window {i}")
    shutil.copyfile(REPO / "tests" / "data" / "codecs" / "events.h5", events)
    port = DSECDataLoader(tree["root"], tree["sequence"], **kw)
    port.get_ready()
    _chip_smoke()._same_sample(port[0], latest[0], "window 0")


# ---- malformed files, in a subprocess that must survive them ------------------

_FUZZ = r"""
import json, resource, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from make_hdf5_fixtures import dataset_keys
from eincm_tpu_torch.utils import h5_latest, h5_lite

src = open(sys.argv[2], "rb").read()
keys = dataset_keys(sys.argv[2])
# every region each dataset's read touches
regions, touched = {}, {}
real_read = h5_lite.File._read
def spy(self, addr, n):
    regions.setdefault((addr, n), set()).add(getattr(self, "_key", None))
    return real_read(self, addr, n)
h5_lite.File._read = spy
for key in keys:
    with h5_lite.File(sys.argv[2]) as f:
        f._key = key
        f.read(key)
h5_lite.File._read = real_read
# the checksummed blocks among them
blocks = sorted((a, n, keys if None in ks else sorted(ks)) for (a, n), ks in regions.items()
                if n > 4 and h5_latest.lookup3(src[a:a + n - 4])
                == int.from_bytes(src[a + n - 4:a + n], "little"))
resource.setrlimit(resource.RLIMIT_DATA, (3 << 30, 3 << 30))
path = sys.argv[3]
rng = np.random.default_rng(13)

def attempt(data, ks):
    open(path, "wb").write(data)
    try:
        with h5_lite.File(path) as f:
            for key in ks:
                f.read(key)
    except KeyError as e:  # h5_lite's own miss: a link's name was flipped
        if not any(m in str(e) for m in ("no object", "is not a group", "is not a dataset")):
            raise
        return "key"
    except ValueError:
        return "value"
    return "read"

counts = {"blocks": len(blocks), "flipped": 0, "resummed": 0, "truncated": 0,
          "value": 0, "key": 0, "read": 0}
for a, n, ks in blocks:
    for resum in (False, True):
        bad = bytearray(src)
        for _ in range(rng.integers(1, 4)):
            i = a + rng.integers(0, n - 4)
            bad[i] ^= 1 << rng.integers(0, 8)
        if resum:  # well-formed again as far as the checksum can tell
            bad[a + n - 4:a + n] = h5_latest.lookup3(bytes(bad[a:a + n - 4])).to_bytes(4, "little")
        out = attempt(bytes(bad), ks)
        counts["resummed" if resum else "flipped"] += 1
        counts[out] += 1
        if not resum:
            assert out == "value", ("a flipped bit passed its block's checksum", a, n)
for k in range(60):
    cut = int(rng.integers(48, len(src)))
    bad = bytearray(src[:cut])
    if k % 2:  # the superblock made to say so: the cut is met inside a structure
        bad[28:36] = cut.to_bytes(8, "little")
        bad[44:48] = h5_latest.lookup3(bytes(bad[:44])).to_bytes(4, "little")
    out = attempt(bytes(bad), keys)
    counts["truncated"] += 1
    counts[out] += 1
    assert out == "value" or k % 2 and out == "read", ("truncated at", cut, out)
print(json.dumps(counts))
"""


def test_malformed_files_raise_value_error(tmp_path):
    """Every checksummed block that reading the latest-format fixture
    touches (superblock, object headers and their continuations, B-tree
    nodes, heaps, array blocks and pages), with 1-3 bits flipped: the
    checksum catches it (ValueError); the same with the checksum made
    good again: the parsers behind it raise ValueError (or KeyError, where
    the flipped byte was a link's name) or read; the file cut short at 60
    places: ValueError (HDF5's end-of-file check), or, where the superblock
    is made to give the cut as the end, ValueError or a read of what lies
    before it. One subprocess, memory-capped, that must exit cleanly."""
    proc = subprocess.run(
        [sys.executable, "-c", _FUZZ, str(REPO / "tests"), str(FIXTURES / "features_latest.h5"),
         str(tmp_path / "bad.h5")], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts["blocks"] >= 150, counts
    assert counts["flipped"] == counts["resummed"] == counts["blocks"], counts
    assert counts["value"] >= counts["flipped"] + counts["truncated"] // 2, counts


def test_io_bench_reads_the_fixtures(tmp_path):
    """`utils/io_bench.py` times this tree's h5_lite on the Blosc-Zstd and
    the latest-format DSEC fixtures beside its other reads."""
    from eincm_tpu_torch.utils import io_bench

    res = io_bench.main(["--reps", "1", "--out", str(tmp_path / "io.json")])
    assert json.loads((tmp_path / "io.json").read_text()) == res
    for key in ("png_decode_ms_filter0", "png_decode_ms_paeth", "h5_lite_events_mb_s",
                "h5_lite_blosc_zstd_mb_s", "h5_lite_latest_mb_s"):
        assert res[key] > 0, key
    assert Path(res["package"]) == REPO / "eincm_tpu_torch"
