"""`eincm_tpu_torch/utils/h5_lite.py` on the HDF5 structures that point
elsewhere (`utils/h5_features.py`), as h5py writes them here, held to the
JAX package's reader (`eincm_tpu/data/readers.py:HDF5FileReader`, whose
`read_dataset` is h5py's `np.asarray` and `read_attr` its `[()]`): the
same dtype, shape and bytes, object arrays element by element, references
by the path and the elements they point to.

Committed datatypes (shared message encodings 1-3), compound types,
variable-length sequences, object and region references, external links
and external data files, virtual datasets and empty datasets, under
`libver` "earliest" and "latest" where the encodings differ; where HDF5
looks for the files that links, mappings and external data files name,
from another working directory with a same-named file in each place
(h5py in a subprocess, which sees the environment from its start); link
cycles, a missing source, what still raises; the committed fixtures of
tests/data/hdf5_features/ against their manifest; the DSEC loader on the
virtual-dataset tree bitwise the JAX loader's samples."""

import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from eincm_tpu.data.readers import HDF5FileReader as JaxReader  # noqa: E402
from eincm_tpu_torch.data.readers import HDF5FileReader  # noqa: E402
from eincm_tpu_torch.utils import dataset_trees, h5_lite  # noqa: E402
from eincm_tpu_torch.utils.h5_lite import UnsupportedHDF5  # noqa: E402

from make_hdf5_feature_fixtures import (  # noqa: E402
    DSEC_SOURCE, dataset_keys, fixture_env, h5py_deref, payload_sha, write_dsec_virtual,
    write_features,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "hdf5_features"
HDF5_FIXTURES = REPO / "tests" / "data" / "hdf5"
LIBVERS = ("earliest", "latest")
ENV_KEYS = ("HDF5_EXT_PREFIX", "HDF5_VDS_PREFIX", "HDF5_EXTFILE_PREFIX")


@pytest.fixture(autouse=True)
def _no_prefixes(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_h5f", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(ref, got, key, ref_file=None, got_file=None):
    """h5py's array and h5_lite's: dtype (a compound's in full), shape and
    bytes; object arrays element by element (references by path and
    data)."""
    assert got.dtype == ref.dtype and str(got.dtype) == str(ref.dtype), (key, got.dtype,
                                                                        ref.dtype)
    assert got.shape == ref.shape, (key, got.shape, ref.shape)
    if ref.dtype.names:  # field by field: h5py leaves the gaps between them unset
        for name in ref.dtype.names:
            _same(ref[name], got[name], f"{key}/{name}", ref_file, got_file)
        return
    if ref.dtype != object:
        assert got.tobytes() == ref.tobytes(), key
        return
    for a, b in zip(ref.reshape(-1), got.reshape(-1)):
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype and b.shape == a.shape
            assert b.tobytes() == a.tobytes(), key
        elif isinstance(a, bytes):
            assert type(b) is bytes and a == b, key
        else:
            assert h5py_deref(ref_file)(a) == _chip_smoke().h5_lite_deref(got_file)(b), key


def _compare_all(path, keys=None) -> int:
    keys = dataset_keys(path) if keys is None else keys
    with h5py.File(path, "r") as g, h5_lite.File(path) as f:
        for key in keys:
            _same(np.asarray(g[key]), f.read(key), key, g, f)
            if g[key].shape == ():
                ref, got = g[key][()], f.read_value(key)
                assert type(got) is type(ref) and np.asarray(got).tobytes() == (
                    np.asarray(ref).tobytes()), key
    return len(keys)


# ---- the slice, as h5py writes it ---------------------------------------------

@pytest.mark.parametrize("libver", LIBVERS)
def test_every_feature_reads_as_h5py(tmp_path, monkeypatch, libver):
    """Every dataset of tests/make_hdf5_feature_fixtures.py:write_features
    (committed types, compounds, complex, sequences, references, external
    links into a second and a third file, an external data file, virtual
    datasets of every mapping kind, the empty one) under each libver; the
    external data file's name is relative, so both read from its
    directory."""
    write_features(tmp_path, libver)
    monkeypatch.chdir(tmp_path)
    assert _compare_all(tmp_path / "features.h5") >= 25


def test_committed_types(tmp_path):
    """A dataset of a committed type holds a shared datatype message, and a
    compound member of one a copy of its type: both read as h5py reads
    them; each shared message encoding (version 1, and 3 as a committed
    message, made here from h5py's version 2 in a file whose headers have
    no checksum) reads the same; one shared through the SOHM table raises
    naming it."""
    path = tmp_path / "c.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        f["T"] = np.dtype(">i4")
        f.create_dataset("d", data=np.arange(4), dtype=f["T"])
        ct = h5py.h5t.create(h5py.h5t.COMPOUND, 12)  # a member of the committed type
        ct.insert(b"t", 0, f["T"].id)
        ct.insert(b"x", 4, h5py.h5t.IEEE_F64LE)
        ds = h5py.h5d.create(f.id, b"member", ct, h5py.h5s.create_simple((2,)))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([(1, 2.5), (3, 4.5)], ct.dtype),
                 mtype=ct)
    assert _compare_all(path, ["d", "member"]) == 2
    with h5_lite.File(path) as f:
        addr = f._find(["T"])[0]
    v2 = b"\x02\x02" + addr.to_bytes(8, "little") + bytes(6)
    data = path.read_bytes()
    assert data.count(v2) == 1
    ref = np.asarray(h5py.File(path, "r")["d"])
    assert ref.dtype == np.dtype(">i4")
    for name, body in (("v1", b"\x01\x00" + bytes(6) + addr.to_bytes(8, "little")),
                       ("v3", b"\x03\x02" + addr.to_bytes(8, "little") + bytes(6))):
        (tmp_path / f"{name}.h5").write_bytes(data.replace(v2, body))
        with h5_lite.File(tmp_path / f"{name}.h5") as f:
            _same(ref, f.read("d"), name)
    (tmp_path / "sohm.h5").write_bytes(data.replace(v2, b"\x03\x01" + bytes(14)))
    with pytest.raises(UnsupportedHDF5, match="/d: message 0x3: a message shared through "
                                              "the SOHM table"):
        h5_lite.File(tmp_path / "sohm.h5").read("d")


@pytest.mark.parametrize("libver", LIBVERS)
def test_compound_types(tmp_path, libver):
    """Compounds (datatype message versions 1-3 by libver) of every member
    h5py writes: nested, arrays, bool and integer enums, fixed strings of
    each padding (cut as h5py cuts them), big-endian numbers, gaps between members (explicit
    offsets); {r, i} as complex, other pairs as they are; chunked and
    filled; a dataset of an array type, its dimensions after the
    dataset's, as h5py's `[()]` gives it."""
    path = tmp_path / "c.h5"
    rng = np.random.default_rng(3)
    inner = np.dtype({"names": ["p", "q"], "formats": ["<f2", (">u4", (2,))],
                      "offsets": [0, 4], "itemsize": 16})
    rec = np.dtype({"names": ["a", "b", "s", "e", "n", "z"],
                    "formats": ["<i8", "?", "S3", h5py.enum_dtype({"X": 5, "Y": -7}, "i2"),
                                inner, ("<f4", (2, 3))],
                    "offsets": [0, 9, 10, 14, 20, 40], "itemsize": 72})
    a = np.zeros(11, rec)
    a["a"], a["s"] = rng.integers(-1 << 40, 1 << 40, 11), [b"x" * (i % 4) for i in range(11)]
    a["n"]["q"] = rng.integers(0, 1 << 31, (11, 2))
    a["b"] = rng.uniform(size=11) < 0.5
    a["e"] = rng.choice([5, -7], 11)
    a["n"]["p"] = rng.normal(size=11)
    a["z"] = rng.normal(size=(11, 2, 3))
    with h5py.File(path, "w", libver=libver) as f:
        f["rec"] = a
        f["rec_scalar"] = a[3]
        f.create_dataset("rec_chunked", data=a, chunks=(4,), compression="gzip", shuffle=True)
        f.create_dataset("rec_fill", shape=(6,), dtype=rec, chunks=(4,), fillvalue=a[5])
        f["complex64"] = rng.normal(size=(3, 2)).astype("<f4").view("<c8")
        f["complex128_be"] = (rng.normal(size=4) + 1j).astype(">c16")
        f["not_complex"] = np.zeros(3, [("r", "<f4"), ("i", "<f8")])
        t = h5py.h5t.array_create(h5py.h5t.IEEE_F64LE, (2, 2))
        ds = h5py.h5d.create(f.id, b"array_dataset", t, h5py.h5s.create_simple((4,)))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, rng.normal(size=(4, 2, 2)), mtype=t)
        for pad in ("NULLTERM", "SPACEPAD"):
            t = h5py.h5t.C_S1.copy()
            t.set_size(4)
            t.set_strpad(getattr(h5py.h5t, f"STR_{pad}"))
            ct = h5py.h5t.create(h5py.h5t.COMPOUND, 12)
            ct.insert(b"s", 0, t)
            ct.insert(b"i", 4, h5py.h5t.STD_I64LE)
            raw = np.zeros(3, {"names": ["s", "i"], "formats": ["S4", "<i8"],
                               "offsets": [0, 4], "itemsize": 12})
            raw["s"], raw["i"] = [b"ab\0c", b"x  \0", b"ab  "], [1, 2, 3]
            ds = h5py.h5d.create(f.id, f"str_{pad}".encode(), ct, h5py.h5s.create_simple((3,)))
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, raw, mtype=ct)
    keys = dataset_keys(path)
    keys.remove("array_dataset")  # np.asarray refuses it (h5py: "Can't broadcast")
    assert _compare_all(path, keys) == 9
    with h5py.File(path, "r") as g, h5_lite.File(path) as f:  # as h5py's [()] reads it
        _same(g["array_dataset"][()], f.read_value("array_dataset"), "array_dataset")


@pytest.mark.parametrize("libver", LIBVERS)
def test_variable_length_sequences(tmp_path, libver):
    """Sequences of each base type h5py writes (integers, floats, bool;
    big-endian ones, whose stored bytes h5py labels with the machine's
    order), empty elements, 2-D and scalar datasets, chunked with gzip,
    never written: object arrays of 1-D arrays as h5py gives them."""
    path = tmp_path / "v.h5"
    rng = np.random.default_rng(4)

    def seqs(dtype, n=7):
        out = np.empty(n, object)
        for i in range(n):
            out[i] = rng.integers(0, 9, (i * 3) % 5).astype(dtype)
        return out

    with h5py.File(path, "w", libver=libver) as f:
        for dtype in ("<i4", ">i8", ">f8", "<f4", "u1", "?"):
            name = f"seq_{np.dtype(dtype).str.strip('<>|')}"
            f.create_dataset(name, data=seqs(dtype), dtype=h5py.vlen_dtype(dtype))
        f.create_dataset("seq_2d", data=seqs("<i2", 6).reshape(2, 3),
                         dtype=h5py.vlen_dtype("<i2"))
        f.create_dataset("seq_chunked", data=seqs("<f8", 40), dtype=h5py.vlen_dtype("<f8"),
                         chunks=(8,), compression="gzip")
        f.create_dataset("seq_scalar", shape=(), dtype=h5py.vlen_dtype("<i4"))
        f["seq_scalar"][()] = np.arange(5, dtype="<i4")
        f.create_dataset("seq_unwritten", shape=(3,), dtype=h5py.vlen_dtype("<i4"))
    assert _compare_all(path) == 10


@pytest.mark.parametrize("libver", LIBVERS)
def test_references(tmp_path, libver):
    """Object references (to datasets, groups, the root, a committed type,
    an object with two names, a null one) dereference to h5py's
    `f[ref].name`; region references (regular and irregular hyperslabs,
    points in their order, all, none of a row) give h5py's `f[ref][ref]`,
    shaped as h5py guesses; a reference array is read as h5py reads it."""
    path = tmp_path / "r.h5"
    grid = np.arange(70, dtype="<i4").reshape(7, 10)
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("g/h/grid", data=grid)
        f["g/alias"] = d  # a second name: h5py names the first in a group's stored order
        f["T"] = np.dtype("<f4")
        s = d.id.get_space()
        s.select_hyperslab((1, 2), (2, 1), (3, 1), (1, 4))
        s.select_hyperslab((5, 0), (1, 1), (1, 1), (2, 2), op=h5py.h5s.SELECT_OR)
        irregular = h5py.h5r.create(f.id, b"g/h/grid", h5py.h5r.DATASET_REGION, s)
        f["objects"] = np.array([d.ref, f["g"].ref, f.ref, f["T"].ref, h5py.Reference()],
                                dtype=h5py.ref_dtype)
        f["regions"] = np.array([
            d.regionref[2:5, 3], d.regionref[::3, ::4], d.regionref[...], irregular,
            d.regionref[np.isin(grid, [61, 3, 17, 44])], d.regionref[6:6, :],
            d.regionref[1, 1:2]], dtype=h5py.regionref_dtype)
        f.create_dataset("regions_chunked", data=f["regions"][()], chunks=(2,),
                         dtype=h5py.regionref_dtype)
    assert _compare_all(path) == 4  # g/alias is g/h/grid
    with h5py.File(path, "r") as g, h5_lite.File(path) as f:
        refs = f.read("objects")
        assert [f.dereference(r) for r in refs[:4]] == [g[r].name for r in g["objects"][:4]]
        assert not refs[4] and refs[0] == f.read("objects")[0]
        with pytest.raises(ValueError, match="null reference"):
            f.dereference(refs[4])
        for ref, got in zip(g["regions"][()], f.read("regions")):
            want = g[ref][ref]
            sel = f.read_region(got)
            assert sel.dtype == want.dtype and sel.shape == want.shape, (sel.shape, want.shape)
            assert sel.tobytes() == want.tobytes()
            assert f.dereference(got) == g[ref].name


def test_external_links_follow_soft_and_external_links(tmp_path):
    """An external link into a group, to a soft link, and on through the
    target file's own external link into a third file, read as h5py reads
    them; a path through them (`ext/g/x`); a missing file raises KeyError
    naming the places looked in; a cycle across two files raises, as h5py
    refuses it."""
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f["x"] = np.arange(3.0)
    with h5py.File(tmp_path / "b.h5", "w", libver="latest") as f:
        f["g/x"] = np.arange(5, dtype="u2")
        f["soft"] = h5py.SoftLink("/g/x")
        f["onward"] = h5py.ExternalLink("c.h5", "/x")
        f["loop"] = h5py.ExternalLink("a.h5", "/loop")
    with h5py.File(tmp_path / "a.h5", "w") as f:
        f["ext"] = h5py.ExternalLink("b.h5", "/")
        f["ext_g"] = h5py.ExternalLink("b.h5", "/g")
        f["ext_soft"] = h5py.ExternalLink("b.h5", "/soft")
        f["ext_on"] = h5py.ExternalLink("b.h5", "/onward")
        f["loop"] = h5py.ExternalLink("b.h5", "/loop")
        f["gone"] = h5py.ExternalLink("nowhere.h5", "/x")
    assert _compare_all(tmp_path / "a.h5", ["ext/g/x", "ext_g/x", "ext_soft", "ext_on",
                                           "ext/onward"]) == 5
    with h5py.File(tmp_path / "a.h5", "r") as g:
        for key in ("loop", "gone"):
            with pytest.raises(KeyError):
                g[key]
    with h5_lite.File(tmp_path / "a.h5") as f:
        with pytest.raises(ValueError, match="more than 16 soft links and external links"):
            f.read("loop")
        with pytest.raises(KeyError, match="an external link to nowhere.h5:/x, and no file "
                                           "'nowhere.h5' in"):
            f.read("gone")
        assert len(f._opened.files) == 2  # each file opened once, closed with a.h5
        files = list(f._opened.files.values())
    assert all(x._f.closed for x in files)


# ---- where HDF5 looks for a file ------------------------------------------------

_H5PY_READ = r"""
import json, sys
import h5py
import numpy as np
out = {}
with h5py.File(sys.argv[1], "r") as f:
    for key in sys.argv[2:]:
        try:
            out[key] = np.asarray(f[key]).tolist()
        except Exception as e:
            out[key] = type(e).__name__
print(json.dumps(out))
"""


def _places(tmp_path):
    """The main file in `a/`, and a same-named target in each place HDF5
    may look (a prefix directory, `a/`, the working directory `cwd/`),
    each holding its own number."""
    for d in ("a", "pre", "cwd", "pre2"):
        (tmp_path / d).mkdir()
    for d, v in (("a", 1), ("pre", 2), ("cwd", 3), ("pre2", 4)):
        with h5py.File(tmp_path / d / "t.h5", "w") as f:
            f["x"] = np.array([v, v], "<i8")
        (tmp_path / d / "raw.bin").write_bytes(np.full(2, v, "<i8").tobytes())
    with h5py.File(tmp_path / "a" / "main.h5", "w") as f:
        f["link"] = h5py.ExternalLink("t.h5", "/x")
        f["link_abs"] = h5py.ExternalLink(str(tmp_path / "elsewhere" / "t.h5"), "/x")
        layout = h5py.VirtualLayout(shape=(2,), dtype="<i8")
        layout[:] = h5py.VirtualSource("t.h5", "x", shape=(2,))
        f.create_virtual_dataset("vds", layout, fillvalue=-1)
        f.create_dataset("efile", shape=(2,), dtype="<i8", external=[("raw.bin", 0, 16)])


def _read_both(tmp_path, monkeypatch, env, keys=("link", "link_abs", "vds", "efile")):
    """{key: first element or the error's name} by h5py (a subprocess in
    cwd/ with `env`) and by h5_lite (here, likewise)."""
    full = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    proc = subprocess.run([sys.executable, "-c", _H5PY_READ, str(tmp_path / "a" / "main.h5"),
                           *keys], cwd=tmp_path / "cwd", env={**full, **env},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = {k: v[0] if isinstance(v, list) else "error"
           for k, v in json.loads(proc.stdout).items()}
    monkeypatch.chdir(tmp_path / "cwd")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {}
    with h5_lite.File(tmp_path / "a" / "main.h5") as f:
        for key in keys:
            try:
                got[key] = int(f.read(key)[0])
            except (KeyError, OSError):
                got[key] = "error"
    return ref, got


@pytest.mark.parametrize("case", ["every place", "prefix", "prefix list", "origin prefix",
                                  "no file beside", "prefix missing", "nowhere"])
def test_where_files_are_found(tmp_path, monkeypatch, case):
    """The order HDF5 here looks in, from another working directory with a
    same-named file in each place, pinned against h5py: an external link's
    file in each directory of HDF5_EXT_PREFIX (split at ':', no ${ORIGIN}),
    then beside the linking file, then in the working directory (an
    absolute name that is not there: its last component likewise); a
    virtual dataset's source likewise with HDF5_VDS_PREFIX, whose
    ${ORIGIN} is the virtual file's directory, and a missing one leaves the
    fill value; an external data file in HDF5_EXTFILE_PREFIX (${ORIGIN}
    too) or else the working directory only."""
    _places(tmp_path)
    pre, pre2 = str(tmp_path / "pre"), str(tmp_path / "pre2")
    env = {"every place": {},
           "prefix": {k: pre for k in ENV_KEYS},
           "prefix list": {"HDF5_EXT_PREFIX": f"/nonexistent:{pre2}:{pre}",
                           "HDF5_VDS_PREFIX": f"/nonexistent:{pre2}"},
           "origin prefix": {k: "${ORIGIN}/../pre" for k in ENV_KEYS},
           "no file beside": {}, "prefix missing": {k: "/nonexistent" for k in ENV_KEYS},
           "nowhere": {}}[case]
    if case in ("no file beside", "prefix missing", "nowhere"):
        (tmp_path / "a" / "t.h5").unlink()
    if case == "nowhere":
        for d in ("cwd", "pre", "pre2"):
            (tmp_path / d / "t.h5").unlink()
        (tmp_path / "cwd" / "raw.bin").unlink()
    ref, got = _read_both(tmp_path, monkeypatch, env)
    assert got == ref
    want = {"every place": {"link": 1, "vds": 1, "efile": 3},
            "prefix": {"link": 2, "vds": 2, "efile": 2},
            "prefix list": {"link": 4, "vds": 4, "efile": 3},
            "origin prefix": {"link": 1, "vds": 2, "efile": 2},
            "no file beside": {"link": 3, "vds": 3, "efile": 3},
            "prefix missing": {"link": 3, "vds": 3, "efile": "error"},
            "nowhere": {"link": "error", "vds": -1, "efile": "error"}}[case]
    assert {k: ref[k] for k in want} == want and ref["link_abs"] == ref["link"]


def test_external_data_files(tmp_path, monkeypatch):
    """External data files: several slots in one file and across files, at
    offsets, the last to the file's end (h5py's UNLIMITED), a file shorter
    than its slot (zeros past its end, as HDF5 reads it), chunk-free 2-D
    data; a missing file raises naming it."""
    monkeypatch.chdir(tmp_path)
    Path("p.bin").write_bytes(np.arange(50, dtype="<i2").tobytes())
    Path("q.bin").write_bytes(np.arange(10, dtype="<i2").tobytes())
    with h5py.File("e.h5", "w") as f:
        f.create_dataset("two_files", shape=(4, 5), dtype="<i2",
                         external=[("p.bin", 10, 16), ("q.bin", 0, 8), ("p.bin", 60, 16)])
        f.create_dataset("to_end", shape=(3,), dtype="<i2",
                         external=[("p.bin", 94, h5py.h5f.UNLIMITED)])
        f.create_dataset("short", shape=(8,), dtype="<i2", external=[("q.bin", 12, 16)])
        f.create_dataset("missing", shape=(2,), dtype="<i2", external=[("none.bin", 0, 4)])
    assert _compare_all(tmp_path / "e.h5", ["two_files", "to_end", "short"]) == 3
    with h5py.File("e.h5", "r") as g, h5_lite.File("e.h5") as f:
        assert f.read("to_end").tolist() == [47, 48, 49]
        assert f.read("short").tolist() == [6, 7, 8, 9, 0, 0, 0, 0]
        with pytest.raises(OSError):
            g["missing"][()]
        with pytest.raises(FileNotFoundError, match="the external data file 'none.bin'"):
            f.read("missing")


@pytest.mark.parametrize("libver", LIBVERS)
def test_virtual_datasets(tmp_path, monkeypatch, libver):
    """Virtual datasets as h5py reads them (its default view, the last
    available): all, regular and irregular hyperslab mappings, 2-D, a
    source in the same file ("."), numbers converted (int16 into uint32
    and float32, saturating), a missing source file and a missing source
    dataset left at the fill value, overlapping mappings (the later wins),
    unlimited mappings whose sources grew after (the extent follows them,
    the largest), printf-style names (%b: the sources up to the first
    missing one, a gap stops them; %% is a %)."""
    monkeypatch.chdir(tmp_path)
    u = h5py.h5s.UNLIMITED
    with h5py.File("src.h5", "w", libver=libver) as s:
        s["x"] = np.arange(-20, 20, dtype="<i2")
        s.create_dataset("grow", data=np.arange(5, dtype="<i4"), maxshape=(None,), chunks=(4,))
        s.create_dataset("grow2", data=np.arange(3, dtype="<i4") + 100, maxshape=(None,),
                         chunks=(4,))
        s["img"] = np.arange(60, dtype="<f8").reshape(6, 10)
    for j in (0, 1, 2, 4):
        with h5py.File(f"p{j}%.h5", "w") as p:
            p["d"] = np.arange(3, dtype="<i4") + 10 * j
    with h5py.File("v.h5", "w", libver=libver) as f:
        f["own"] = np.arange(8, dtype="<i2") * 3
        lay = h5py.VirtualLayout(shape=(50,), dtype="<i2")
        vs = h5py.VirtualSource("src.h5", "x", shape=(40,))
        lay[0:10] = vs[30:40]
        lay[10:30:2] = vs[0:10]
        lay[5:8] = vs[0:3]  # over the first mapping
        lay[40:44] = h5py.VirtualSource(".", "own", shape=(8,))[::2]
        lay[45:47] = h5py.VirtualSource("gone.h5", "x", shape=(2,))
        lay[47:49] = h5py.VirtualSource("src.h5", "absent", shape=(2,))
        f.create_virtual_dataset("v", lay, fillvalue=9)
        for name, dtype in (("v_u4", "<u4"), ("v_f4", "<f4")):
            lay = h5py.VirtualLayout(shape=(40,), dtype=dtype)
            lay[:] = h5py.VirtualSource("src.h5", "x", shape=(40,))
            f.create_virtual_dataset(name, lay)
        lay = h5py.VirtualLayout(shape=(6, 10), dtype="<f8")
        lay[0:3, :] = h5py.VirtualSource("src.h5", "img", shape=(6, 10))[3:6, :]
        lay[3:6, 2:8:2] = h5py.VirtualSource("src.h5", "img", shape=(6, 10))[0:3, 0:3]
        f.create_virtual_dataset("v2d", lay, fillvalue=np.nan)
        sp = h5py.h5s.create_simple((6, 10))
        sp.select_hyperslab((0, 0), (1, 1), (1, 1), (2, 2))
        sp.select_hyperslab((4, 7), (1, 1), (1, 1), (2, 3), op=h5py.h5s.SELECT_OR)
        vsp = h5py.h5s.create_simple((12,))
        vsp.select_hyperslab((2,), (1,), (1,), (10,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_virtual(vsp, b"src.h5", b"img", sp)
        dcpl.set_fill_value(np.array([-1.0]))
        h5py.h5d.create(f.id, b"v_irregular", h5py.h5t.IEEE_F64LE,
                        h5py.h5s.create_simple((12,)), dcpl=dcpl)
        lay = h5py.VirtualLayout(shape=(4,), dtype="<i4", maxshape=(None,))
        lay[0:u:2] = h5py.VirtualSource("src.h5", "grow", shape=(5,), maxshape=(None,))[0:u]
        lay[1:u:2] = h5py.VirtualSource("src.h5", "grow2", shape=(3,), maxshape=(None,))[0:u]
        f.create_virtual_dataset("v_unlimited", lay, fillvalue=-1)
        vsp = h5py.h5s.create_simple((3,), (u,))
        vsp.select_hyperslab((0,), (u,), (3,), (3,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_virtual(vsp, b"p%b%%.h5", b"d", h5py.h5s.create_simple((3,)))
        dcpl.set_fill_value(np.array([-1], "<i4"))
        h5py.h5d.create(f.id, b"v_printf", h5py.h5t.STD_I32LE, vsp, dcpl=dcpl)
    with h5py.File("src.h5", "a") as s:  # the sources grow after the mapping
        s["grow"].resize((9,))
        s["grow"][5:] = [5, 6, 7, 8]
    keys = ["v", "v_u4", "v_f4", "v2d", "v_irregular", "v_unlimited", "v_printf"]
    assert _compare_all(tmp_path / "v.h5", keys) == 7
    with h5_lite.File("v.h5") as f:
        assert f.read("v_unlimited").shape == (17,) and f.read("v_printf").shape == (9,)
        assert f.read("v_u4")[:20].max() == 0  # int16 below 0 saturates at 0


def test_empty_datasets(tmp_path):
    """A null dataspace: `read` raises TypeError as numpy does on h5py's
    dataset; `read_value` (and the port's HDF5FileReader.read_attr) gives
    Empty of h5py's dtype, as the JAX reader's read_attr gives h5py's
    Empty; a scalar's read_attr is the JAX reader's."""
    path = tmp_path / "e.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["empty_f4"] = h5py.Empty("<f4")
        f["empty_str"] = h5py.Empty("S7")
        f.create_dataset("empty_chunked", data=h5py.Empty(">i8"))
        f["t_offset"] = np.int64(123)
    with JaxReader(path) as j:
        rdr = HDF5FileReader(path)
        rdr.h5_file, rdr.backend = h5_lite.File(path), "h5_lite"
        for key in ("empty_f4", "empty_str", "empty_chunked"):
            with pytest.raises(TypeError, match="Empty datasets have no numpy representation"):
                j.read_dataset(key)
            with pytest.raises(TypeError, match="Empty datasets have no numpy representation"):
                rdr.read_dataset(key)
            ref, got = j.read_attr(key), rdr.read_attr(key)
            assert isinstance(ref, h5py.Empty) and isinstance(got, h5_lite.Empty)
            assert got.dtype == ref.dtype and got == h5_lite.Empty(ref.dtype)
        ref, got = j.read_attr("t_offset"), rdr.read_attr("t_offset")
        assert type(got) is type(ref) and got == ref
        rdr.close_file()


@pytest.mark.parametrize("what,feature", [
    ("sohm", "a message shared through the SOHM table"),
    ("vlen_member", "a vlen string member of a compound type"),
    ("opaque", "datatype class 5 \\(opaque\\)"),
    ("bitfield", "datatype class 4 \\(bitfield\\)"),
    ("vlen_of_vlen", "a variable-length sequence of vlen"),
    ("source_dtype", "a source of \\|S4 in a virtual dataset of int32"),
])
def test_what_stays_unsupported_raises(tmp_path, what, feature):
    """What h5_lite still does not read raises UnsupportedHDF5 naming the
    file, the object and the feature."""
    path = tmp_path / "u.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        if what == "sohm":
            f["T"] = np.dtype("<i4")
            f.create_dataset("d", data=np.arange(3), dtype=f["T"])
        elif what == "vlen_member":
            f.create_dataset("d", shape=(2,), dtype=[("s", h5py.string_dtype()), ("i", "<i4")])
        elif what == "opaque":
            f["d"] = np.zeros(3, "V5")
        elif what == "bitfield":
            h5py.h5d.create(f.id, b"d", h5py.h5t.STD_B16LE, h5py.h5s.create_simple((2,)))
        elif what == "vlen_of_vlen":
            t = h5py.h5t.vlen_create(h5py.h5t.vlen_create(h5py.h5t.STD_I32LE))
            h5py.h5d.create(f.id, b"d", t, h5py.h5s.create_simple((2,)))
        else:
            f["src"] = np.array([b"abcd"] * 3)
            lay = h5py.VirtualLayout(shape=(3,), dtype="<i4")
            lay[:] = h5py.VirtualSource(".", "src", shape=(3,))
            f.create_virtual_dataset("d", lay)
    if what == "sohm":  # a SOHM heap ID where h5py wrote the committed type's address
        with h5_lite.File(path) as f:
            addr = f._find(["T"])[0]
        data = path.read_bytes()
        path.write_bytes(data.replace(b"\x02\x02" + addr.to_bytes(8, "little"),
                                      b"\x03\x01" + bytes(8)))
    with pytest.raises(UnsupportedHDF5, match=f"{path}: /d: .*{feature}"):
        h5_lite.File(path).read("d")


# ---- the committed fixtures and the DSEC loader ---------------------------------

def test_committed_feature_fixtures_match_their_manifest(tmp_path):
    """tests/data/hdf5_features/ as tests/make_hdf5_feature_fixtures.py
    writes it: each file by its sha256 (written again here, bitwise), each
    dataset through h5_lite (chip_smoke.py [h5]'s check, run here) and the
    empty one; the directory under 200 KB."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    counts = _chip_smoke().check_codec_fixtures(FIXTURES)
    assert sum(c[0] for c in counts.values()) == len(manifest["payloads"]) >= 30
    assert manifest["env"] == fixture_env(FIXTURES) and manifest["empty"]
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000
    names = write_features(tmp_path) + [
        write_dsec_virtual(tmp_path, HDF5_FIXTURES / DSEC_SOURCE)]
    assert sorted(names) == sorted(manifest["files"])
    for name in names:
        assert payload_sha(np.frombuffer((tmp_path / name).read_bytes(), np.uint8)) == (
            manifest["files"][name]["sha256"]), name


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


def test_dsec_loader_reads_the_virtual_fixture(tmp_path, monkeypatch):
    """The slice's path: a DSEC tree whose events.h5 is the committed
    virtual file (events in virtual datasets over the latest-format file,
    copied beside it; ms_to_idx an external link; t_offset of a committed
    type): the port's loader, h5py blocked so that h5_lite reads, gives
    bitwise the JAX loader's samples through h5py, and the samples of the
    latest-format file itself (chip_smoke.py [h5] also solves window 0)."""
    from eincm_tpu.data.dsec import DSECDataLoader as JaxDSEC
    from eincm_tpu_torch.data import DSECDataLoader

    manifest = json.loads((HDF5_FIXTURES / "manifest.json").read_text())
    tree = dataset_trees.write_dsec_tree(tmp_path, **manifest["events_tree"])
    events = tree["root"] / f"Train/train_events/{tree['sequence']}/events/left/events.h5"
    kw = dict(des_n_events=100_000, data_split="train")
    shutil.copyfile(HDF5_FIXTURES / DSEC_SOURCE, events)
    latest = DSECDataLoader(tree["root"], tree["sequence"], **kw)
    latest.get_ready()
    latest = [latest[i] for i in range(len(latest))]
    shutil.copyfile(HDF5_FIXTURES / DSEC_SOURCE, events.parent / DSEC_SOURCE)
    shutil.copyfile(FIXTURES / "dsec_events_virtual.h5", events)
    jax_loader = JaxDSEC(tree["root"], tree["sequence"], **kw)
    jax_loader.get_ready()
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = DSECDataLoader(tree["root"], tree["sequence"], **kw)
    port.get_ready()
    assert len(port) == len(jax_loader) == len(latest) == 2
    for i in range(len(port)):
        got = port[i]
        _same_sample(jax_loader[i], got, f"window {i}")
        _same_sample(latest[i], got, f"window {i} of the latest-format file")
    with HDF5FileReader(events) as rdr:
        assert rdr.backend == "h5_lite"
