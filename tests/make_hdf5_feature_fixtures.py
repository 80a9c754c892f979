"""Write the committed HDF5 feature fixtures in tests/data/hdf5_features/.

    python tests/make_hdf5_feature_fixtures.py [--out DIR]

h5py is the reference encoder, as in tests/make_hdf5_fixtures.py; the
card's machine has no h5py, so `chip_smoke.py` [h5] reads these files with
`utils/h5_lite.py` and holds each dataset to `manifest.json`:

- `features.h5` (h5py's default `libver`, "earliest") and its sources:
  committed datatypes (a plain and a compound one), compound types
  (nested, with array, enum, bool and string members; complex), variable
  length sequences, object and region references, external links (into
  `features_source.h5`: a dataset, a soft link, a group, and an external
  link on into a third file),
  an external data file (`features_raw.bin`), virtual datasets (all,
  regular and irregular hyperslab selections, a source in the same file,
  a missing source, an unlimited mapping, a printf-style one over
  `features_part0.h5`..`features_part2.h5`) and an empty dataset; point
  selections in the region references (HDF5 refuses them in virtual
  dataset mappings);
- `dsec_events_virtual.h5` (`libver="latest"`): the DSEC events file of
  tests/data/hdf5/dsec_events_latest.h5's scene, its `events/x, y, t, p`
  virtual datasets of four hyperslab mappings each over that file (named
  as it lies beside this one in a DSEC tree, so no event is stored
  twice), `ms_to_idx` an external link into it and `t_offset` of a
  committed datatype.

`manifest.json` has tests/data/hdf5/manifest.json's form (`payload_sha`,
extended to arrays of arrays and references: a reference by its object's
path and, for a region, its elements), plus `empty` (the dtype of each
empty dataset) and `env`: the variables to set while the manifest's files
are read, each a directory relative to this one (the external data file's
name is relative, which HDF5 takes from the working directory or
HDF5_EXTFILE_PREFIX; the DSEC file's sources lie in tests/data/hdf5/).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "data" / "hdf5_features"
SEED = 16
DSEC_SOURCE = "dsec_events_latest.h5"  # tests/data/hdf5's, copied beside the virtual file
DSEC_PIECES = 4  # hyperslab mappings a virtual events dataset is cut into
HDF5_FIXTURES = HERE / "data" / "hdf5"  # where DSEC_SOURCE lies


def fixture_env(out) -> dict:
    """The manifest's `env`: the external data file's directory (this
    one) and where the DSEC file's sources lie, relative to `out`."""
    rel = os.path.relpath(HDF5_FIXTURES, Path(out).resolve())
    return {"HDF5_EXTFILE_PREFIX": ".", "HDF5_EXT_PREFIX": rel, "HDF5_VDS_PREFIX": rel}


def _h5py():
    import h5py

    return h5py


def _dcpl():
    h5py = _h5py()
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_obj_track_times(False)
    return dcpl


def _select(space, sel):
    """Select `sel` in a dataspace: None (all), ("hyperslab", start, count,
    stride, block), each a tuple a dimension, or ("blocks", [(start,
    count, stride, block)]), the union of hyperslabs (not a regular one).
    HDF5 refuses point selections in virtual dataset mappings."""
    h5py = _h5py()
    if sel is None:
        space.select_all()
    elif sel[0] == "blocks":
        space.select_none()
        for args in sel[1]:
            space.select_hyperslab(*args, op=h5py.h5s.SELECT_OR)
    else:
        space.select_hyperslab(*sel[1:])
    return space


def _virtual(parent, name, shape, dtype, maps, fill, maxshape=None):
    """A virtual dataset without modification times: `maps` is [(virtual
    selection, source file, source dataset, source shape, source maximum
    shape, source selection)]."""
    h5py = _h5py()
    dcpl = _dcpl()
    for vsel, file, dset, sshape, smax, ssel in maps:
        vspace = _select(h5py.h5s.create_simple(shape, maxshape), vsel)
        sspace = _select(h5py.h5s.create_simple(sshape, smax), ssel)
        dcpl.set_virtual(vspace, file.encode(), dset.encode(), sspace)
    dcpl.set_fill_value(np.array([fill], dtype))
    h5py.h5d.create(parent.id, name.encode(), h5py.h5t.py_create(np.dtype(dtype), logical=1),
                    h5py.h5s.create_simple(shape, maxshape), dcpl=dcpl)


def _commit(f, name, dtype):
    """A committed datatype (under the newer formats its object header
    keeps its creation times: `_untimed` clears them)."""
    h5py = _h5py()
    h5py.h5t.py_create(np.dtype(dtype), logical=1).commit(f.id, name.encode())
    return f[name]


def _untimed(path, name: str) -> None:
    """The version 2 object header of `name` with its four times zeroed and
    its checksum made good again (h5py commits a datatype with no way to
    leave the times out), so the file is the same bytes each time."""
    from eincm_tpu_torch.utils import h5_lite
    from eincm_tpu_torch.utils.h5_latest import lookup3

    with h5_lite.File(path) as f:
        addr = f._find([name])[0]
    data = bytearray(Path(path).read_bytes())
    assert data[addr:addr + 4] == b"OHDR" and data[addr + 5] & 0x20, name
    flags = data[addr + 5]
    pos = addr + 6 + 16 + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    end = pos + width + int.from_bytes(data[pos:pos + width], "little")
    data[addr + 6:addr + 22] = bytes(16)
    data[end:end + 4] = lookup3(bytes(data[addr:end])).to_bytes(4, "little")
    Path(path).write_bytes(bytes(data))


def write_features(out, libver: str = "earliest", stem: str = "features",
                   seed: int = SEED) -> list:
    """`{stem}.h5` and its sources in `out` under h5py's `libver`; returns
    the files' names."""
    from make_hdf5_fixtures import _appended, _file, _group

    h5py = _h5py()
    out = Path(out)
    rng = np.random.default_rng(seed)
    main, src, raw = f"{stem}.h5", f"{stem}_source.h5", f"{stem}_raw.bin"
    parts = [f"{stem}_part{j}.h5" for j in range(3)]
    grid = np.arange(48, dtype="<i4").reshape(6, 8)
    with _file(out / src, libver) as s:
        s["x"] = rng.integers(0, 1000, 40).astype("<u2")
        s["grid"] = grid
        g = _group(s, "g")
        g["deep"] = rng.normal(size=5)
        s["soft"] = h5py.SoftLink("/g/deep")
        s["onward"] = h5py.ExternalLink(parts[0], "/d")
        _appended(s, "grow", np.arange(9, dtype="<i4") * 3, (4,), 3)
    for j, name in enumerate(parts):
        with _file(out / name, libver) as p:
            p["d"] = np.arange(4, dtype="<i4") + 10 * j
    (out / raw).write_bytes(np.arange(100, 140, dtype="<i4").tobytes())

    with _file(out / main, libver) as f:
        f["plain"] = np.arange(6, dtype="<i2")
        f["grid"] = grid[::-1].copy()
        # 1. committed datatypes, plain and compound
        t_int = _commit(f, "T_int", "<i8")
        f.create_dataset("committed", data=np.arange(5) * 7, dtype=t_int)
        t_pair = _commit(f, "T_pair", [("a", "<i4"), ("b", "<f8")])
        pairs = np.zeros(3, [("a", "<i4"), ("b", "<f8")])
        pairs["a"], pairs["b"] = [1, 2, 3], rng.normal(size=3)
        f.create_dataset("committed_compound", data=pairs, dtype=t_pair)
        f.create_dataset("committed_scalar", data=np.int64(-42), dtype=t_int)
        # 2. compound types
        kind = h5py.enum_dtype({"LOW": 0, "HIGH": 1, "BAD": -1}, basetype="i1")
        inner = np.dtype([("x", ">i4"), ("y", "<f8", (2,))])
        rec = np.dtype([("id", "<u2"), ("pos", "<f4", (3,)), ("flag", "?"), ("name", "S6"),
                        ("nested", inner), ("kind", kind), ("grid", "<i2", (2, 2))])
        a = np.zeros(7, rec)
        a["id"], a["pos"] = np.arange(7), rng.normal(size=(7, 3))
        a["flag"], a["name"] = rng.uniform(size=7) < 0.5, [b"ev%d" % i * (i % 3) for i in range(7)]
        a["nested"]["x"], a["nested"]["y"] = rng.integers(-9, 9, 7), rng.normal(size=(7, 2))
        a["kind"], a["grid"] = rng.integers(-1, 2, 7), rng.integers(0, 99, (7, 2, 2))
        f["compound"] = a
        f.create_dataset("compound_chunked", data=np.tile(a, 5), chunks=(4,), compression="gzip")
        f["complex"] = (rng.normal(size=5) + 1j * rng.normal(size=5)).astype("<c8")
        f["complex128_scalar"] = np.complex128(1.5 - 2.5j)
        f["array_member_scalar"] = np.zeros((), [("v", "<f8", (4,))])
        # 3. variable-length sequences
        f.create_dataset("vlen_i4", data=np.array(
            [np.arange(n, dtype="<i4") for n in (3, 0, 1, 7)], dtype=object),
            dtype=h5py.vlen_dtype("<i4"))
        f.create_dataset("vlen_f8_chunked", data=np.array(
            [rng.normal(size=n) for n in range(9)], dtype=object),
            dtype=h5py.vlen_dtype("<f8"), chunks=(4,), compression="gzip")
        grid_of_seqs = np.empty((2, 3), object)
        for i, j in np.ndindex(2, 3):
            grid_of_seqs[i, j] = np.arange(i + j, dtype="u1")
        f.create_dataset("vlen_u1_2d", data=grid_of_seqs, dtype=h5py.vlen_dtype("u1"))
        # 4. external links, into the source file and on from it
        f["ext"] = h5py.ExternalLink(src, "/x")
        f["ext_soft"] = h5py.ExternalLink(src, "/soft")
        f["ext_group"] = h5py.ExternalLink(src, "/g")
        f["ext_chain"] = h5py.ExternalLink(src, "/onward")
        # 5. an external data file: two slots, the second to its end
        f.create_dataset("external", shape=(3, 4), dtype="<i4",
                         external=[(raw, 8, 20), (raw, 48, h5py.h5f.UNLIMITED)])
        # 6. references
        g = _group(f, "group")
        g["inner"] = np.arange(3.0)
        f["refs"] = np.array([f["plain"].ref, f["compound"].ref, f.ref, g.ref,
                              g["inner"].ref, h5py.Reference()], dtype=h5py.ref_dtype)
        grid_ds = f["grid"]
        f["regions"] = np.array([
            f["plain"].regionref[1:4], grid_ds.regionref[::2, 1:3], grid_ds.regionref[...],
            grid_ds.regionref[np.array([[i % 3 == 0 and j % 4 == 1 for j in range(8)]
                                        for i in range(6)])],
            grid_ds.regionref[2:3, 5]], dtype=h5py.regionref_dtype)
        # 7. virtual datasets
        _virtual(f, "virtual", (30,), "<u2", [
            (("hyperslab", (0,), (1,), (1,), (10,)), src, "x", (40,), None,
             ("hyperslab", (10,), (1,), (1,), (10,))),
            (("hyperslab", (10,), (5,), (2,), (1,)), src, "x", (40,), None,
             ("blocks", [((30,), (1,), (1,), (2,)), ((3,), (1,), (1,), (1,)),
                         ((36,), (1,), (1,), (2,))])),
            (("hyperslab", (21,), (3,), (4,), (1,)), ".", "plain", (6,), None,
             ("hyperslab", (0,), (3,), (2,), (1,))),
            (("hyperslab", (26,), (1,), (1,), (2,)), "missing.h5", "x", (2,), None, None),
        ], fill=7)
        _virtual(f, "virtual_2d", (6, 8), "<i4", [
            (("hyperslab", (0, 0), (2, 2), (3, 4), (2, 3)), src, "grid", (6, 8), None,
             ("hyperslab", (1, 1), (1, 1), (1, 1), (4, 6))),
            (None, ".", "nothing_here", (6, 8), None, None),
        ], fill=-5)
        u = h5py.h5s.UNLIMITED
        _virtual(f, "virtual_unlimited", (4,), "<i4", [
            (("hyperslab", (1,), (u,), (2,), (1,)), src, "grow", (9,), (u,),
             ("hyperslab", (0,), (u,), (1,), (1,))),
        ], fill=-1, maxshape=(u,))
        _virtual(f, "virtual_printf", (4,), "<i4", [
            (("hyperslab", (0,), (u,), (4,), (4,)), f"{stem}_part%b.h5", "d", (4,), None, None),
        ], fill=-1, maxshape=(u,))
        # 8. an empty dataset
        f["empty"] = h5py.Empty("<f4")
    return [main, src, raw] + parts


def write_dsec_virtual(out, source: Path) -> str:
    """dsec_events_virtual.h5 over `source` (the latest-format events
    file), named `DSEC_SOURCE` in its mappings and link."""
    from make_hdf5_fixtures import _file, _group

    h5py = _h5py()
    name = "dsec_events_virtual.h5"
    with h5py.File(source, "r") as s:
        info = {k: (s[f"events/{k}"].shape[0], s[f"events/{k}"].dtype.str)
                for k in ("x", "y", "t", "p")}
        t_offset = s["t_offset"][()]
    with _file(Path(out) / name, "latest") as f:
        g = _group(f, "events")
        for key, (n, dtype) in info.items():
            cuts = np.linspace(0, n, DSEC_PIECES + 1).astype(int)
            # the pieces mapped in reverse, so the mappings' order is not the data's
            maps = [(("hyperslab", (int(a),), (1,), (1,), (int(b - a),)), DSEC_SOURCE,
                     f"events/{key}", (n,), None,
                     ("hyperslab", (int(a),), (1,), (1,), (int(b - a),)))
                    for a, b in zip(cuts[:-1], cuts[1:])][::-1]
            _virtual(g, key, (n,), dtype, maps, fill=0)
        f["ms_to_idx"] = h5py.ExternalLink(DSEC_SOURCE, "/ms_to_idx")
        f.create_dataset("t_offset", data=t_offset, dtype=_commit(f, "t_offset_type", "<i8"))
    _untimed(Path(out) / name, "t_offset_type")
    return name


def payload_sha(a: np.ndarray, deref=None) -> str:
    """tests/make_hdf5_fixtures.py:payload_sha, with object arrays of
    arrays (each element as its dtype, shape and bytes) and of references
    (`deref(ref)`: the bytes that stand for it) besides bytes."""
    if a.dtype != object:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    parts = []
    for x in a.reshape(-1):
        if isinstance(x, np.ndarray):
            x = f"{x.dtype.str}{x.shape}".encode() + np.ascontiguousarray(x).tobytes()
        elif not isinstance(x, bytes):
            x = deref(x)
        parts.append(len(x).to_bytes(8, "little") + x)
    return hashlib.sha256(b"".join(parts)).hexdigest()


def h5py_deref(f):
    """h5py's `deref` for `payload_sha`: an object's path; a region's path
    and its elements' payload_sha."""
    h5py = _h5py()

    def deref(ref) -> bytes:
        if not ref:
            return b"null"
        obj = f[ref]
        if isinstance(ref, h5py.RegionReference):
            sel = obj[ref]
            return f"{obj.name}:{sel.dtype.str}{sel.shape}:{payload_sha(sel)}".encode()
        return obj.name.encode()

    return deref


def dataset_keys(path):
    """Every dataset h5py finds in the file (external links followed one
    level, as their targets read), but the empty ones."""
    h5py = _h5py()
    keys = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: keys.append(name) if isinstance(obj, h5py.Dataset)
                     and obj.shape is not None else None)
        for name in f:
            link = f.get(name, getlink=True)
            if isinstance(link, h5py.ExternalLink):
                obj = f[name]
                if isinstance(obj, h5py.Dataset):
                    keys.append(name)
                else:
                    keys += [f"{name}/{k}" for k in obj]
    return sorted(set(keys))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    # where the manifest's files find theirs, set before HDF5 starts
    env = fixture_env(out)
    for k, v in env.items():
        os.environ[k] = str((out / v).resolve())
    h5py = _h5py()
    names = write_features(out) + [write_dsec_virtual(out, HDF5_FIXTURES / DSEC_SOURCE)]
    manifest = {"files": {}, "payloads": {}, "empty": {}, "env": env}
    for name in sorted(names):
        data = (out / name).read_bytes()
        manifest["files"][name] = {"sha256": hashlib.sha256(data).hexdigest(),
                                   "bytes": len(data)}
    for name in sorted(n for n in names if n in ("features.h5", "dsec_events_virtual.h5")):
        with h5py.File(out / name, "r") as f:
            for key in dataset_keys(out / name):
                a = np.asarray(f[key])
                p = {"sha256": payload_sha(a, h5py_deref(f)), "dtype": a.dtype.str,
                     "shape": list(a.shape)}
                if a.dtype.names:
                    p["dtype_full"] = str(a.dtype)
                manifest["payloads"][f"{name}:{key}"] = p
            f.visititems(lambda key, obj: manifest["empty"].__setitem__(
                f"{name}:{key}", obj.dtype.str) if isinstance(obj, h5py.Dataset)
                and obj.shape is None else None)
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(v["bytes"] for v in manifest["files"].values())
    print(f"wrote {len(manifest['files'])} files, {total} bytes, "
          f"{len(manifest['payloads'])} datasets, to {out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))  # make_hdf5_fixtures
    sys.path.insert(0, str(HERE.parent))  # the port, run from anywhere
    raise SystemExit(main())
