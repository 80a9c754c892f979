"""Write the committed codec fixtures in tests/data/codecs/ from fixed seeds.

    python tests/make_codec_fixtures.py [--out DIR]

The reference encoders write them: the `zstandard` package (libzstd),
c-blosc 1.x through ctypes (`libblosc.so.1`) and h5py. The card's machine
has none of the three, so `chip_smoke.py` [h5] decodes these files with
the port's native decoders and holds each to `manifest.json`:

- `zstd/*.zst`: Zstandard frames at levels -5, 1, 3, 19 and 22, with and
  without a checksum and a content size, Huffman weights FSE-coded and
  direct, one with long-distance matching, one over 128 KiB (many blocks),
  one frame of nothing, and two frames joined by skippable frames;
- `blosc/*.blosc`: c-blosc chunks of every codec (blosclz, lz4, lz4hc,
  snappy, zlib, zstd) at every shuffle (none, byte, bit);
- `events.h5`: a DSEC events file (`events/x,y,t,p`, `ms_to_idx`,
  `t_offset`) of `utils/dataset_trees.py:write_dsec_tree`'s scene at
  480x640 (2 windows, about 2^18 events) whose chunks are Blosc-Zstd,
  written with `write_direct_chunk`;
- `zstd_filter.h5`: datasets under hdf5plugin's Zstandard filter (32015),
  one behind the shuffle filter with one chunk left unfiltered (its filter
  mask bit set);
- `lzf.h5`: datasets under h5py's LZF filter (32000), one behind the
  shuffle filter, with an incompressible chunk that h5py stores unfiltered.

`manifest.json` gives each file's sha256 and byte count, the sha256, dtype
and shape of each payload (a frame's or chunk's bytes, or a dataset's array
in C order) as the encoder was given it, and `write_dsec_tree`'s arguments
for the scene of `events.h5` (`events_tree`).
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "data" / "codecs"

# c-blosc's compressor names and the codes the HDF5 Blosc filter's
# cd_values[6] takes (blosc.h: BLOSC_BLOSCLZ .. BLOSC_ZSTD)
BLOSC_CODECS = {"blosclz": 0, "lz4": 1, "lz4hc": 2, "snappy": 3, "zlib": 4, "zstd": 5}
SHUFFLES = {"none": 0, "byte": 1, "bit": 2}
# the DSEC fixture's scene (dataset_trees.write_dsec_tree's arguments)
EVENTS_TREE = dict(n_windows=2, events_per_window=1 << 17, seed=3)
EVENTS_CHUNK = 1 << 15  # elements per chunk


def libblosc():
    """c-blosc 1.x through ctypes, or None where it is not installed."""
    name = ctypes.util.find_library("blosc")
    if name is None:
        return None
    lib = ctypes.CDLL(name)
    lib.blosc_compress_ctx.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.blosc_compress_ctx.restype = ctypes.c_int
    lib.blosc_decompress_ctx.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_int]
    lib.blosc_decompress_ctx.restype = ctypes.c_int
    return lib


def blosc_compress(lib, data: bytes, typesize: int, cname: str, clevel: int = 5,
                   shuffle: str = "byte", blocksize: int = 0) -> bytes:
    """One c-blosc chunk of `data` (blocksize 0: c-blosc's own choice)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(2 * len(data) + 64, np.uint8)  # room for snappy_max_compressed_length
    n = lib.blosc_compress_ctx(clevel, SHUFFLES[shuffle], typesize, len(data), src.ctypes.data,
                               out.ctypes.data, out.nbytes, cname.encode(), blocksize, 1)
    if n <= 0:
        raise RuntimeError(f"blosc_compress_ctx({cname}) returned {n}")
    return out[:n].tobytes()


def blosc_decompress(lib, chunk: bytes, nbytes: int) -> bytes:
    """c-blosc's own decoding of a chunk."""
    src = np.frombuffer(chunk, np.uint8)
    out = np.empty(nbytes, np.uint8)
    n = lib.blosc_decompress_ctx(src.ctypes.data, out.ctypes.data, nbytes, 1)
    if n != nbytes:
        raise RuntimeError(f"blosc_decompress_ctx returned {n} of {nbytes}")
    return out.tobytes()


def skippable(payload: bytes, nibble: int = 0) -> bytes:
    """A skippable frame (magic 0x184D2A50 + nibble) holding `payload`."""
    return ((0x184D2A50 + nibble).to_bytes(4, "little") + len(payload).to_bytes(4, "little")
            + payload)


def payloads(seed: int = 0) -> dict:
    """Byte strings shaped like what the datasets hold: event coordinates
    and timestamps (small increments), text-like bytes, runs and noise."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(0, 40, 1 << 16)).astype("<i8")
    x = (320 + np.cumsum(rng.integers(-2, 3, 1 << 14))).astype("<u2")
    text = bytes(rng.choice(np.frombuffer(b"ACGT acgt\n", np.uint8), 48 << 10))
    noise = rng.integers(0, 256, 48 << 10, dtype=np.uint8).tobytes()
    runs = b"".join(bytes([rng.integers(0, 256)]) * int(rng.integers(1, 4000))
                    for _ in range(60))
    # 16 symbols: libzstd writes their Huffman weights directly, 4 bits each
    small = np.minimum(rng.geometric(0.25, 20000) - 1, 15).astype(np.uint8).tobytes()
    return {"t": t.tobytes(), "x": x.tobytes(), "text": text, "noise": noise, "runs": runs,
            "small_alphabet": small,
            "mixed": text[:20000] + runs[:30000] + noise[:8000] + x.tobytes()[:20000]}


def zstd_frames(seed: int = 0) -> dict:
    """{name: (frame bytes, decoded bytes)}."""
    import zstandard as zs

    p = payloads(seed)

    def frame(data, level, checksum=True, content_size=True, **params):
        cp = zs.ZstdCompressionParameters.from_level(
            level, write_checksum=checksum, write_content_size=content_size, **params)
        return zs.ZstdCompressor(compression_params=cp).compress(data), data

    big = p["t"] * 4 + p["text"]  # 2 MiB + 48 KiB: many 128 KiB blocks
    far = p["noise"] + p["runs"] * 2 + p["t"][: 1 << 18] + p["noise"]  # a match ~1 MiB back
    a, b = frame(p["mixed"], 3), frame(p["x"], 19, checksum=False)
    return {
        "level-5_text": frame(p["text"], -5),
        "level1_t_nochecksum_nosize": frame(p["t"], 1, checksum=False, content_size=False),
        "level3_mixed": frame(p["mixed"], 3),
        "level19_x_nosize": frame(p["x"], 19, content_size=False),
        "level19_small_alphabet": frame(p["small_alphabet"], 19),
        "level22_runs_nochecksum": frame(p["runs"] + p["x"], 22, checksum=False),
        "level19_ldm": frame(far, 19, enable_ldm=True, window_log=22),
        "level3_multiblock": frame(big, 3),
        "level3_empty": frame(b"", 3),
        "concatenated_skippable": (skippable(b"user data", 5) + a[0] + skippable(b"", 15)
                                   + b[0], a[1] + b[1]),
    }


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _payload(array: np.ndarray) -> dict:
    a = np.asarray(array)
    return {"sha256": _sha(a.tobytes()), "dtype": a.dtype.str, "shape": list(a.shape)}


def blosc_dataset(f, key, a, lib, cname="zstd", clevel=5, shuffle="byte", chunk=EVENTS_CHUNK):
    """A 1-D dataset under the Blosc filter (cd_values as hdf5plugin writes
    them), its chunks compressed by c-blosc and written directly; the last
    chunk padded with zeros, as HDF5 stores it."""
    chunk = min(chunk, len(a))
    opts = (2, 2, a.dtype.itemsize, chunk * a.dtype.itemsize, clevel, SHUFFLES[shuffle],
            BLOSC_CODECS[cname])
    d = f.create_dataset(key, shape=a.shape, dtype=a.dtype, chunks=(chunk,), compression=32001,
                         compression_opts=opts, allow_unknown_filter=True)
    for start in range(0, len(a), chunk):
        block = np.zeros(chunk, a.dtype)
        part = a[start:start + chunk]
        block[:len(part)] = part
        d.id.write_direct_chunk((start,), blosc_compress(lib, block.tobytes(), a.dtype.itemsize,
                                                         cname, clevel, shuffle), 0)


def dsec_events(tmp) -> dict:
    """The events of write_dsec_tree's scene (EVENTS_TREE) as the tree's
    events.h5 holds them."""
    from eincm_tpu_torch.utils import dataset_trees, h5_lite

    tree = dataset_trees.write_dsec_tree(Path(tmp) / "tree", **EVENTS_TREE)
    path = (tree["root"] / f"Train/train_events/{tree['sequence']}/events/left/events.h5")
    with h5_lite.File(path) as f:
        return {k: f.read(k) for k in ("events/x", "events/y", "events/t", "events/p",
                                       "ms_to_idx", "t_offset")}


def write_events_h5(path, events: dict, lib) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for key, a in events.items():
            if a.ndim == 0:
                f[key] = a
            else:
                blosc_dataset(f, key, a, lib)


def write_zstd_filter_h5(path, seed: int = 1) -> dict:
    """Datasets under filter 32015: a float32 map in 2-D chunks, and int64
    timestamps behind the shuffle filter, one of whose chunks is stored
    shuffled but not compressed (its filter mask bit 1 set)."""
    import h5py
    import zstandard as zs

    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:60, 0:80].astype(np.float32)
    rect = np.stack([gx + 0.3 * np.sin(gy / 23.0), gy + 0.3 * np.cos(gx / 31.0)], axis=-1)
    t = np.cumsum(rng.integers(0, 50, 20000)).astype(np.int64)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("rectify_map", shape=rect.shape, dtype=rect.dtype,
                             chunks=(16, 80, 2), compression=32015, compression_opts=(5,),
                             allow_unknown_filter=True)
        for r in range(0, 60, 16):
            block = np.zeros((16, 80, 2), np.float32)
            block[:min(16, 60 - r)] = rect[r:r + 16]
            d.id.write_direct_chunk((r, 0, 0), zs.ZstdCompressor(level=5).compress(
                block.tobytes()), 0)
        d = f.create_dataset("t", shape=t.shape, dtype=t.dtype, chunks=(4096,), shuffle=True,
                             compression=32015, compression_opts=(19,),
                             allow_unknown_filter=True)
        for k, start in enumerate(range(0, len(t), 4096)):
            block = np.zeros(4096, np.int64)
            part = t[start:start + 4096]
            block[:len(part)] = part
            shuffled = block.view(np.uint8).reshape(-1, 8).T.tobytes()
            if k == 1:  # stored without the Zstandard filter
                d.id.write_direct_chunk((start,), shuffled, 0b10)
            else:
                d.id.write_direct_chunk((start,), zs.ZstdCompressor(level=19).compress(
                    shuffled), 0)
    return {"rectify_map": rect, "t": t}


def write_lzf_h5(path, seed: int = 2) -> dict:
    import h5py

    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.choice([0.0, 0.5, 1.0], 30000))
    b = np.concatenate([np.repeat(rng.integers(0, 9, 600), 20).astype(np.uint8),
                        rng.integers(0, 256, 8192, dtype=np.uint8)])  # the last chunk: noise
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=a, chunks=(4096,), compression="lzf", shuffle=True)
        f.create_dataset("b", data=b, chunks=(8192,), compression="lzf")
    return {"a": a, "b": b}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    lib = libblosc()
    if lib is None:
        raise SystemExit("c-blosc (libblosc.so.1) is needed to write the fixtures")
    out = args.out
    (out / "zstd").mkdir(parents=True, exist_ok=True)
    (out / "blosc").mkdir(parents=True, exist_ok=True)
    manifest = {"files": {}, "payloads": {}, "events_tree": EVENTS_TREE}

    def put(rel: str, data: bytes):
        (out / rel).write_bytes(data)

    for name, (frame, data) in zstd_frames().items():
        put(f"zstd/{name}.zst", frame)
        manifest["payloads"][f"zstd/{name}.zst"] = _payload(np.frombuffer(data, np.uint8))
    x = np.frombuffer(payloads()["x"], "<u2")
    for cname in BLOSC_CODECS:
        for shuffle in SHUFFLES:
            rel = f"blosc/{cname}_{shuffle}.blosc"
            chunk = blosc_compress(lib, x.tobytes(), 2, cname, 5, shuffle)
            assert blosc_decompress(lib, chunk, x.nbytes) == x.tobytes()
            put(rel, chunk)
            manifest["payloads"][rel] = _payload(x)
    with tempfile.TemporaryDirectory() as tmp:
        events = dsec_events(tmp)
    write_events_h5(out / "events.h5", events, lib)
    for key, a in events.items():
        manifest["payloads"][f"events.h5:{key}"] = _payload(a)
    for key, a in write_zstd_filter_h5(out / "zstd_filter.h5").items():
        manifest["payloads"][f"zstd_filter.h5:{key}"] = _payload(a)
    for key, a in write_lzf_h5(out / "lzf.h5").items():
        manifest["payloads"][f"lzf.h5:{key}"] = _payload(a)
    for path in sorted(p for p in out.rglob("*") if p.is_file() and p.name != "manifest.json"):
        data = path.read_bytes()
        manifest["files"][path.relative_to(out).as_posix()] = {"sha256": _sha(data),
                                                               "bytes": len(data)}
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(v["bytes"] for v in manifest["files"].values())
    print(f"wrote {len(manifest['files'])} files, {total} bytes, to {out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))  # the port, run from anywhere
    raise SystemExit(main())
