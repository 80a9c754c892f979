"""Write the committed HDF5 fixtures in tests/data/hdf5/ from fixed seeds.

    python tests/make_hdf5_fixtures.py [--out DIR]

h5py is the reference encoder; the card's machine has no h5py, so
`chip_smoke.py` [h5] reads these files with `utils/h5_lite.py` and holds
each dataset to `manifest.json`:

- `features_earliest.h5`, `features_v108.h5`, `features_latest.h5`: one
  file of `write_features` under each of h5py's `libver` bounds (the
  datasets of hundreds of chunks in the last only), so under
  superblock versions 0, 2 and 3 (symbol-table groups and version 1
  object headers in the first; link-message groups, version 2 object
  headers and, in the last, layout message version 4 with its five chunk
  indexes in the others);
- `dsec_events_latest.h5`: a DSEC events file under `libver="latest"` of
  the scene of tests/data/codecs/events.h5 (`utils/dataset_trees.py:
  write_dsec_tree` at 480x640, 2 windows, about 2^18 events): `events/x,
  y, t, p` appended in 20000-event pieces under `maxshape=(None,)` with
  gzip and shuffle, as a recorder writes them (an extensible array
  index), `ms_to_idx` and the scalar `t_offset`.

`manifest.json` has tests/data/codecs/manifest.json's form: each file's
sha256 and byte count, and each dataset's sha256, dtype and shape as h5py
reads it (an object array of bytes hashes as each element's 8-byte
little-endian length and bytes, in C order), plus `write_dsec_tree`'s
arguments for the DSEC scene (`events_tree`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "data" / "hdf5"

# h5py's `libver` values as (low, high) bounds of h5py.h5f.LIBVER_*: superblock
# version 0 ("earliest"), 2 ("v108"), 3 (v110 on)
LIBVERS = {"earliest": ("EARLIEST", "LATEST"), "v108": ("V18", "V18"),
           "v110": ("V110", "V110"), "v112": ("V112", "V112"), "latest": ("LATEST", "LATEST")}
FIXTURE_LIBVERS = ("earliest", "v108", "latest")
EVENTS_PIECE = 20_000  # events a recorder appends at a time
EVENTS_CHUNK = 1 << 15


def _appended(f, key, a, chunks, piece, **kw):
    """A dataset grown along axis 0 by `piece` rows at a time, as a recorder
    appends; every other axis fixed."""
    d = f.create_dataset(key, shape=(0,) + a.shape[1:], maxshape=(None,) + a.shape[1:],
                         dtype=a.dtype, chunks=chunks, **kw)
    for s in range(0, len(a), piece):
        part = a[s:s + piece]
        d.resize((d.shape[0] + len(part),) + a.shape[1:])
        d[-len(part):] = part
    return d


def _dcpl():
    """Dataset creation properties without modification times."""
    import h5py

    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_obj_track_times(False)
    return dcpl


def _string_dataset(f, key, raw, pad):
    """Fixed-length strings of `raw`'s width under HDF5 padding `pad`
    ("NULLTERM", "NULLPAD", "SPACEPAD"), written as these bytes."""
    import h5py

    t = h5py.h5t.C_S1.copy()
    t.set_size(raw.dtype.itemsize)
    t.set_strpad(getattr(h5py.h5t, f"STR_{pad}"))
    ds = h5py.h5d.create(f.id, key.encode(), t, h5py.h5s.create_simple(raw.shape), dcpl=_dcpl())
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, raw, mtype=t)


def _bool_enum(f, key, values, base):
    """An enum {FALSE: 0, TRUE: 1} over integer type `base` (h5py's own
    bool is over int8), written as the integers `values`."""
    import h5py

    t = h5py.h5t.enum_create(h5py.h5t.py_create(np.dtype(base)))
    t.enum_insert(b"FALSE", 0)
    t.enum_insert(b"TRUE", 1)
    ds = h5py.h5d.create(f.id, key.encode(), t, h5py.h5s.create_simple(values.shape),
                         dcpl=_dcpl())
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, values.astype(base),
             mtype=h5py.h5t.py_create(np.dtype(base)))


def _group(parent, name: str, track_order: bool = False):
    """A group without modification times (so the file is the same bytes
    each time it is written)."""
    import h5py

    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    gcpl.set_obj_track_times(False)
    if track_order:
        gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED | h5py.h5p.CRT_ORDER_INDEXED)
    return h5py.Group(h5py.h5g.create(parent.id, name.encode(), gcpl=gcpl))


def _file(path, libver: str):
    """A new file under h5py's `libver` bounds whose root group keeps no
    modification times."""
    import h5py

    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*(getattr(h5py.h5f, f"LIBVER_{v}") for v in LIBVERS[libver]))
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                                     fapl=fapl))


def write_features(path, libver: str = "latest", seed: int = 0,
                   many_chunks: bool = True) -> None:
    """One file of every feature `utils/h5_lite.py` reads, under h5py's
    `libver` bounds `LIBVERS[libver]`: groups (20 members: dense under the
    newer formats; one tracking creation order), soft links, each chunk
    index (single chunk, implicit, fixed array paged or not, extensible
    array 1-D, along axis 1 and MVSEC-shaped (N, 4) float64, with super
    blocks; version 2 B-tree), deflate, shuffle and Fletcher-32, bool and
    int16 enums, fixed and variable-length strings, non-zero fill values,
    an object header continued after its creation. `many_chunks=False`
    leaves out the datasets of hundreds of chunks (paged fixed arrays,
    super blocks, B-tree levels), which only the newer formats index with
    structures of their own."""
    import h5py

    rng = np.random.default_rng(seed)
    with _file(path, libver) as f:
        c = _group(f, "contiguous")
        c["f8"] = rng.normal(0, 100, 500)
        c["u2_be"] = rng.integers(0, 65535, (6, 7)).astype(">u2")
        f["scalar_i8"] = np.int64(1_234_567_890_123)
        g = _group(f, "group")
        for i in range(20):
            g[f"m{i:02d}"] = np.full(3, i, np.int16)
        g["rel"] = h5py.SoftLink("m08")
        f["soft"] = h5py.SoftLink("/group/m07")
        f["soft_to_soft"] = h5py.SoftLink("/soft")
        o = _group(f, "ordered", track_order=True)
        for i in range(12):
            o[f"z{11 - i:02d}"] = np.arange(i + 1, dtype=np.uint8)

        # the chunk indexes
        small = np.arange(12, dtype="i2").reshape(3, 4)
        f.create_dataset("single", data=small, chunks=(3, 4))
        f.create_dataset("single_gz", data=small, chunks=(3, 4), compression="gzip")
        dcpl = _dcpl()
        dcpl.set_chunk((4, 5))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        ds = h5py.h5d.create(f.id, b"implicit", h5py.h5t.STD_I32LE,
                             h5py.h5s.create_simple((10, 12)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(120, dtype="i4").reshape(10, 12))
        grid = rng.integers(0, 1000, (37, 53)).astype("u2")
        f.create_dataset("fixed", data=grid, chunks=(8, 16))
        f.create_dataset("fixed_gz", data=grid, chunks=(8, 16), compression="gzip", shuffle=True)
        if many_chunks:
            f.create_dataset("fixed_paged", data=np.cumsum(rng.normal(size=3000)).astype("f4"),
                             chunks=(2,))  # 1500 chunks: pages of 1024
            _appended(f, "extensible_many", rng.integers(0, 255, 6000).astype("u1"), (8,), 1000)
            f.create_dataset("btree2_levels", data=rng.integers(0, 99, (40, 60)).astype("i2"),
                             maxshape=(None, None), chunks=(2, 2))  # 600 chunks: internal nodes
            d = f.create_dataset("fill_fixed_paged", shape=(5000,), dtype="i2", chunks=(2,),
                                 fillvalue=-3)
            d[10:14], d[4000:4003] = 5, 6  # pages never written stay unallocated
        _appended(f, "extensible", rng.integers(0, 1 << 40, 1500), (50,), 137)
        _appended(f, "extensible_gz", rng.integers(0, 1 << 40, 1500), (50,), 137,
                  compression="gzip", shuffle=True)
        mvsec = np.cumsum(rng.normal(size=(1200, 4)), axis=0)  # davis/left/events' shape
        _appended(f, "mvsec_events", mvsec, (64, 4), 300, compression="gzip")
        f.create_dataset("extensible_axis1", data=rng.normal(size=(5, 120)), maxshape=(5, None),
                         chunks=(2, 7))
        f.create_dataset("btree2", data=rng.normal(size=(20, 30)), maxshape=(None, None),
                         chunks=(7, 9))
        f.create_dataset("btree2_gz", data=rng.normal(size=(20, 30)), maxshape=(None, None),
                         chunks=(7, 9), compression="gzip")

        # Fletcher-32 behind gzip and shuffle
        f.create_dataset("fletcher32", data=rng.normal(size=1000), chunks=(100,),
                         fletcher32=True, compression="gzip", shuffle=True)
        _appended(f, "fletcher32_appended", rng.integers(0, 9, 900).astype("i4"), (64,), 300,
                  fletcher32=True)

        # enumerations and strings
        f["bool"] = rng.uniform(size=(4, 5)) < 0.5
        f["bool_scalar"] = np.bool_(True)
        _bool_enum(f, "bool_u1", np.array([0, 1, 2, 1, 0]), "u1")
        _bool_enum(f, "bool_i1_raw", np.array([0, 1, 2, 1, 0]), "i1")
        f.create_dataset("enum_i16", data=np.array([0, 1, 2, -1, 2], "i2"),
                         dtype=h5py.enum_dtype({"A": 0, "B": 1, "C": 2, "M": -1}, basetype="i2"))
        raw = np.array([b"ab\0cd", b"abcde", b"a  \0 ", b"   x ", b""], "S5")
        for pad in ("NULLTERM", "NULLPAD", "SPACEPAD"):
            _string_dataset(f, f"str_{pad.lower()}", raw, pad)
        f["str_array"] = np.array([[b"x", b"yz"], [b"", b"uvw"]])
        f["str_scalar"] = np.bytes_(b"DSEC")
        f["vlen_ascii"] = np.array([b"x", b"hello" * 20, b""], dtype=h5py.string_dtype("ascii"))
        f["vlen_utf8"] = np.array(["été", "events", ""], dtype=h5py.string_dtype())
        f["vlen_scalar"] = "a scalar string"
        f.create_dataset("vlen_chunked", data=np.array([f"s{i}" * (i % 7) for i in range(40)],
                                                       dtype=h5py.string_dtype()),
                         chunks=(8,), compression="gzip")

        # fill values
        f.create_dataset("fill_int", shape=(30,), dtype="i4", chunks=(10,), fillvalue=7)[:5] = 1
        f.create_dataset("fill_contiguous", shape=(4,), dtype="f8", fillvalue=2.5)
        d = f.create_dataset("fill_nan", shape=(40,), dtype="f4", chunks=(8,), fillvalue=np.nan,
                             maxshape=(None,))
        d[3:9] = 1
        d = f.create_dataset("fill_btree2", shape=(9, 9), dtype="i2", chunks=(4, 4),
                             fillvalue=-2, maxshape=(None, None))
        d[1:3, 5:7] = 4
        f.create_dataset("fill_single", shape=(3, 4), dtype="u8", chunks=(3, 4), fillvalue=9)
        d = f.create_dataset("continued", data=np.arange(10.0))
        for i in range(6):  # attributes added later: the header continues
            d.attrs[f"note{i}"] = "x" * 200


def dataset_keys(path):
    """Every dataset h5py finds in the file, and the soft links to them."""
    import h5py

    keys = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: keys.append(name) if isinstance(obj, h5py.Dataset)
                     else None)
        for name in ("soft", "soft_to_soft", "group/rel"):
            if name in f:
                keys.append(name)
    return keys


def payload_sha(a: np.ndarray) -> str:
    """sha256 of an array's bytes; an object array of bytes hashes as each
    element's 8-byte little-endian length and bytes, in C order."""
    if a.dtype == object:
        return hashlib.sha256(b"".join(len(x).to_bytes(8, "little") + x
                                       for x in a.reshape(-1))).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def write_dsec_events(path, events: dict) -> None:
    with _file(path, "latest") as f:
        g = _group(f, "events")
        for key in ("x", "y", "t", "p"):
            _appended(g, key, events[f"events/{key}"], (EVENTS_CHUNK,), EVENTS_PIECE,
                      compression="gzip", shuffle=True)
        f["ms_to_idx"] = events["ms_to_idx"]
        f["t_offset"] = events["t_offset"]


def main(argv=None) -> int:
    import h5py

    from make_codec_fixtures import EVENTS_TREE, dsec_events

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    for libver in FIXTURE_LIBVERS:
        write_features(out / f"features_{libver}.h5", libver, many_chunks=libver == "latest")
    with tempfile.TemporaryDirectory() as tmp:
        write_dsec_events(out / "dsec_events_latest.h5", dsec_events(tmp))
    manifest = {"files": {}, "payloads": {}, "events_tree": EVENTS_TREE}
    for path in sorted(out.glob("*.h5")):
        data = path.read_bytes()
        manifest["files"][path.name] = {"sha256": hashlib.sha256(data).hexdigest(),
                                        "bytes": len(data)}
        with h5py.File(path, "r") as f:
            for key in dataset_keys(path):
                a = np.asarray(f[key])
                manifest["payloads"][f"{path.name}:{key}"] = {
                    "sha256": payload_sha(a), "dtype": a.dtype.str, "shape": list(a.shape)}
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(v["bytes"] for v in manifest["files"].values())
    print(f"wrote {len(manifest['files'])} files, {total} bytes, "
          f"{len(manifest['payloads'])} datasets, to {out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))  # make_codec_fixtures
    sys.path.insert(0, str(HERE.parent))  # the port, run from anywhere
    raise SystemExit(main())
