"""`eincm_tpu_torch/utils/h5_lite.py` against h5py: it reads bitwise what
h5py writes by default (contiguous, compact and chunked layouts, gzip and
shuffle, scalars and 1-3-D arrays of every dtype the loaders use, nested
groups, object headers continued in a second block); h5py reads what
`write_h5` writes; what it does not read raises `UnsupportedHDF5` naming
the feature, and what it once refused (Fletcher-32, strings, bools, the
latest format) reads as the JAX package reads it. The newer format's
structures are held to h5py in tests/test_torch_h5_latest.py."""

import struct
import zlib

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
    (h5py reads them as their fill value, here the default: zeros)."""
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
    ("zstd_dictionary", "filter 32015 \\(Zstandard\\) a Zstd dictionary"),
    ("fletcher32", "filter 3 \\(fletcher32\\)"),
    ("string", "datatype class 3 \\(string\\)"),
    ("bool", "datatype class 8 \\(enumerated\\)"),
    ("compound", "datatype class 6 \\(compound\\)"),
])
def test_unsupported_features_raise(tmp_path, what, feature):
    """Compound types and Zstd dictionaries raise UnsupportedHDF5 naming the
    feature. Fletcher-32, strings and bools, refused here until h5_lite read
    them, now read bitwise as the JAX package's reader (h5py) reads them,
    and a chunk whose Fletcher-32 does not match raises as h5py refuses
    it."""
    path = tmp_path / f"{what}.h5"
    with h5py.File(path, "w") as f:
        if what == "zstd_dictionary":  # a chunk whose frame names a dictionary
            zs = pytest.importorskip("zstandard")
            samples = [bytes(np.random.default_rng(s).integers(0, 20, 400, dtype=np.uint8))
                       for s in range(200)]
            frame = zs.ZstdCompressor(dict_data=zs.train_dictionary(2048, samples)).compress(
                samples[0])
            d = f.create_dataset("d", shape=(400,), dtype="u1", chunks=(400,),
                                 compression=32015, allow_unknown_filter=True)
            d.id.write_direct_chunk((0,), frame, 0)
        elif what == "fletcher32":
            f.create_dataset("d", data=np.arange(100.0), chunks=(10,), fletcher32=True)
        elif what == "string":
            f["d"] = np.bytes_(b"abc")
        elif what == "bool":
            f["d"] = np.array([True, False])
        else:
            f["d"] = np.zeros(3, [("a", "i4"), ("b", "f8")])
    if what in ("fletcher32", "string", "bool"):
        from eincm_tpu.data.readers import HDF5FileReader

        with HDF5FileReader(path) as r:
            ref = r.read_dataset("d")
        got = read_h5(path, "d")
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
        if what == "fletcher32":  # one byte of the second chunk changed
            with h5py.File(path, "r") as f:
                at = f["d"].id.get_chunk_info(1).byte_offset
            bad = bytearray(path.read_bytes())
            bad[at + 3] ^= 0x40
            path.write_bytes(bytes(bad))
            with pytest.raises(OSError):
                with h5py.File(path, "r") as f:
                    f["d"][()]
            with pytest.raises(ValueError, match="/d: the chunk at \\(10,\\): Fletcher-32 "
                                                 "checksum mismatch"):
                read_h5(path, "d")
        return
    with pytest.raises(UnsupportedHDF5, match=f"{path}: /d: {feature}"):
        read_h5(path, "d")


def test_latest_format_raises(tmp_path):
    """A libver="latest" file (superblock v3, checksummed) reads as h5py
    reads it; marked open for writing (its consistency flags, the checksum
    made good), it raises, as h5py refuses it."""
    from eincm_tpu_torch.utils import h5_latest

    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(3)
        f.create_dataset("y", data=np.arange(10.0), chunks=(4,), maxshape=(None,))
    assert path.read_bytes()[8] == 3
    with h5py.File(path, "r") as f, h5_lite.File(path) as g:
        for key in ("x", "y"):
            _same(g.read(key), np.asarray(f[key]))
    marked = bytearray(path.read_bytes())
    marked[11] |= 0x01
    marked[44:48] = h5_latest.lookup3(bytes(marked[:44])).to_bytes(4, "little")
    (tmp_path / "open.h5").write_bytes(bytes(marked))
    with pytest.raises(OSError):
        h5py.File(tmp_path / "open.h5", "r")
    with pytest.raises(ValueError, match="marked open for writing"):
        h5_lite.File(tmp_path / "open.h5")


def test_not_hdf5_raises(tmp_path):
    (tmp_path / "x.h5").write_bytes(b"not an hdf5 file at all")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        h5_lite.File(tmp_path / "x.h5")


# ---- Blosc chunks (filter 32001), written here to the format's spec -----------------
#
# These chunks are encoded by the small encoders below, from the format's
# published description (c-blosc's README_HEADER.rst, the blosclz and LZ4
# block formats); the tests after them hold the reader to c-blosc's own
# output too (ctypes, where libblosc is installed).

from eincm_tpu_torch.native import blosc as native_blosc  # noqa: E402
from eincm_tpu_torch.utils import blosc  # noqa: E402

CODEC_IDS = {"blosclz": 0, "lz4": 1, "zlib": 3}


def _matches(data: bytes, min_len: int, max_dist: int):
    """Greedy (position, distance, length) matches of at least `min_len`
    bytes within `max_dist`, found through a hash of the next 4 bytes; the
    last 5 bytes stay literals."""
    last, out, i, n = {}, [], 0, len(data)
    while i + 5 < n:
        key = data[i:i + 4]
        j = last.get(key)
        last[key] = i
        if j is not None and 0 < i - j <= max_dist:
            length = 0
            while i + length < n - 5 and data[j + length] == data[i + length]:
                length += 1
            if length >= min_len:
                out.append((i, i - j, length))
                for k in range(i + 1, i + length):
                    last[data[k:k + 4]] = k
                i += length
                continue
        i += 1
    return out


def _extend(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def blosclz_encode(data: bytes) -> bytes:
    out, pos = bytearray(), 0

    def literals(lit):
        for k in range(0, len(lit), 32):
            part = lit[k:k + 32]
            out.append(len(part) - 1)
            out.extend(part)

    matches = [m for m in _matches(data, 3, 8192 + 65535) if m[0] > 0]
    for i, dist, length in matches:
        literals(data[pos:i])
        code = length - 2  # the control's length field
        d = dist - 1  # the biased distance
        far = d >= 8191
        hi = 31 if far else d >> 8
        out.append((min(code, 7) << 5) | hi)
        if code >= 7:
            out.extend(_extend(code - 7))
        if far:
            out.extend([255, (d - 8191) >> 8, (d - 8191) & 255])
        else:
            out.append(d & 255)
        pos = i + length
    literals(data[pos:])
    return bytes(out)


def lz4_encode(data: bytes) -> bytes:
    out, pos = bytearray(), 0

    def token(lit, match):
        out.append((min(lit, 15) << 4) | min(match, 15))
        if lit >= 15:
            out.extend(_extend(lit - 15))

    for i, dist, length in _matches(data, 4, 65535):
        lit = data[pos:i]
        token(len(lit), length - 4)
        out.extend(lit)
        out.extend([dist & 255, dist >> 8])
        if length - 4 >= 15:
            out.extend(_extend(length - 4 - 15))
        pos = i + length
    token(len(data) - pos, 0)
    out.extend(data[pos:])
    return bytes(out)


ENCODERS = {"blosclz": blosclz_encode, "lz4": lz4_encode, "zlib": lambda d: zlib.compress(d, 6)}


def byte_shuffle(block: np.ndarray, ts: int) -> np.ndarray:
    n = len(block) // ts * ts
    out = block.copy()
    out[:n] = block[:n].reshape(-1, ts).T.reshape(-1)
    return out


def bit_shuffle(block: np.ndarray, ts: int) -> np.ndarray:
    size = len(block) // ts
    if size % 8:
        return block.copy()
    bits = np.unpackbits(block.reshape(size, ts, 1), axis=2, bitorder="little")
    rows = bits.transpose(1, 2, 0).reshape(8 * ts, size)  # row j * 8 + b
    return np.packbits(rows, axis=1, bitorder="little").reshape(-1)


def blosc_chunk(data: bytes, typesize: int, codec: str, shuffle: str = "none",
                blocksize: int = 4096, split: bool = True, version: int = 2) -> bytes:
    """One Blosc1 chunk of `data`, to README_HEADER.rst."""
    nbytes = len(data)
    flags = {"none": 0, "byte": 0x1, "bit": 0x4}[shuffle] | CODEC_IDS[codec] << 5
    if not split:
        flags |= 0x10
    n_blocks = -(-nbytes // blocksize)
    arr = np.frombuffer(data, np.uint8)
    body, starts = bytearray(), []
    offset = 16 + 4 * n_blocks
    for b in range(n_blocks):
        block = arr[b * blocksize:(b + 1) * blocksize]
        short = len(block) < blocksize
        if shuffle == "byte" and typesize > 1:
            block = byte_shuffle(block, typesize)
        elif shuffle == "bit" and len(block) >= typesize:
            block = bit_shuffle(block, typesize)
        n_streams = typesize if (split and typesize <= 16 and blocksize // typesize >= 128
                                 and not short) else 1
        size = len(block) // n_streams
        starts.append(offset + len(body))
        for s in range(n_streams):
            raw = block[s * size:(s + 1) * size].tobytes()
            enc = ENCODERS[codec](raw)
            if len(enc) >= size:  # stored raw
                enc = raw
            body += struct.pack("<i", len(enc)) + enc
    cbytes = offset + len(body)
    head = struct.pack("<BBBBIII", version, 1, flags, typesize, nbytes, blocksize, cbytes)
    return head + struct.pack(f"<{n_blocks}i", *starts) + bytes(body)


def memcpy_chunk(data: bytes, typesize: int) -> bytes:
    return struct.pack("<BBBBIII", 2, 1, 0x2, typesize, len(data), 4096,
                       16 + len(data)) + data


def _payload(dtype, n, seed=0):
    """Event-stream-like data: small increments, repeats and noise."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return np.cumsum(rng.choice([0.0, 0.5, 1.0], n)).astype(dt)
    base = np.cumsum(rng.integers(0, 3, n)) % int(min(np.iinfo(dt).max, 1 << 20))
    base[rng.uniform(size=n) < 0.05] = rng.integers(0, 100, 1)
    return base.astype(dt)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("shuffle", ["none", "byte", "bit"])
@pytest.mark.parametrize("codec", ["blosclz", "lz4", "zlib"])
def test_blosc_chunk_decodes(codec, shuffle, split):
    """Every codec without a package, every shuffle, split streams and one
    stream a block, a short last block: native and plain decoders alike."""
    data = _payload("u4", 3000).tobytes()  # 12000 bytes: 2 blocks + 3808
    chunk = blosc_chunk(data, 4, codec, shuffle, blocksize=4096, split=split)
    assert len(chunk) < len(data)  # something was compressed
    for native in (True, False):
        assert blosc.decompress(chunk, native=native) == data


def test_blosc_memcpyed_typesizes_and_raw_streams():
    data = _payload("i8", 700, 1).tobytes()
    assert blosc.decompress(memcpy_chunk(data, 8)) == data
    noise = np.random.default_rng(2).integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for ts in (1, 2, 8):  # incompressible streams are stored raw
        for shuffle in ("none", "byte", "bit"):
            chunk = blosc_chunk(noise, ts, "lz4", shuffle, blocksize=2048)
            assert blosc.decompress(chunk) == noise
    assert blosc.decompress(blosc_chunk(b"", 1, "blosclz")) == b""


def test_blosc_bit_shuffle_layout():
    """The bit shuffle's rows by hand: 8 uint16 elements 0..7, row j * 8 + b
    holding bit b of byte j of each element, element 0 in the lowest bit."""
    block = np.arange(8, dtype="<u2").view(np.uint8)
    rows = np.zeros(16, np.uint8)
    rows[:3] = [0xAA, 0xCC, 0xF0]
    np.testing.assert_array_equal(bit_shuffle(block, 2), rows)
    np.testing.assert_array_equal(blosc.bitunshuffle(rows, 2), block)
    np.testing.assert_array_equal(blosc.unshuffle(np.arange(6, dtype=np.uint8), 2),
                                  [0, 3, 1, 4, 2, 5])
    # 12 elements: not a multiple of 8, the block was left as it was
    odd = np.arange(24, dtype=np.uint8)
    np.testing.assert_array_equal(blosc.bitunshuffle(odd, 2), odd)


@pytest.mark.parametrize("codec", ["blosclz", "lz4"])
def test_native_blosc_decoders_match_plain(codec):
    """native/blosc.cpp against the plain Python decoders: long literal
    runs and matches (extension bytes), overlapping runs, blosclz's far
    matches (16-bit distance past 8192); malformed streams fail in both."""
    assert native_blosc.available()
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    cases = [noise[:300] + b"\x07" * 700 + noise[:300],  # a long run, a long match
             noise + noise[:2000] + b"ab" * 400,  # far matches, short period
             _payload("u2", 20000, 4).tobytes(), b"x", b"xyz" * 3]
    plain = {"blosclz": blosc.blosclz_decompress_plain, "lz4": blosc.lz4_decompress_plain}[codec]
    fast = {"blosclz": native_blosc.blosclz_decompress, "lz4": native_blosc.lz4_decompress}[codec]
    for data in cases:
        enc = ENCODERS[codec](data)
        assert plain(enc, len(data)) == data
        assert fast(enc, len(data)) == data
    far = blosclz_encode(cases[1])
    assert any(b == 255 for b in far)  # the far-match marker appears
    bad = ENCODERS[codec](cases[2])
    for broken, n in ((bad[: len(bad) // 2], len(cases[2])), (bad, len(cases[2]) - 1),
                      (b"\x00" if codec == "lz4" else b"\x1f", 5)):
        with pytest.raises(ValueError, match="stream"):
            plain(broken, n)
        with pytest.raises(ValueError, match="stream"):
            fast(broken, n)


def _blosc_h5(path, arrays, codec, shuffle):
    """h5py datasets with the Blosc filter (cd_values as hdf5plugin writes
    them), their chunks written directly."""
    with h5py.File(path, "w") as f:
        for key, (a, chunk) in arrays.items():
            opts = (2, 2, a.dtype.itemsize, chunk * a.dtype.itemsize, 5,
                    {"none": 0, "byte": 1, "bit": 2}[shuffle], CODEC_IDS.get(codec, 4))
            d = f.create_dataset(key, shape=a.shape, dtype=a.dtype, chunks=(chunk,),
                                 compression=32001, compression_opts=opts,
                                 allow_unknown_filter=True)
            for start in range(0, len(a), chunk):
                block = np.zeros(chunk, a.dtype)
                part = a[start:start + chunk]
                block[:len(part)] = part
                data = block.tobytes()
                enc = (memcpy_chunk(data, a.dtype.itemsize) if codec == "memcpy" else
                       blosc_chunk(data, a.dtype.itemsize, codec, shuffle, blocksize=8192))
                d.id.write_direct_chunk((start,), enc, 0)


@pytest.mark.parametrize("codec,shuffle", [("blosclz", "byte"), ("lz4", "bit"),
                                           ("zlib", "none"), ("memcpy", "none")])
def test_reads_blosc_datasets(tmp_path, codec, shuffle):
    """A DSEC events group's dtypes (x, y u2; t i8; p u1) through h5_lite,
    the last chunk partial."""
    n = 50_000
    arrays = {"events/x": (_payload("u2", n, 1), 16384), "events/y": (_payload("u2", n, 2), 16384),
              "events/t": (_payload("i8", n, 3), 8192), "events/p": (_payload("u1", n, 4), 32768)}
    path = tmp_path / "blosc.h5"
    _blosc_h5(path, arrays, codec, shuffle)
    with h5_lite.File(path) as f:
        for key, (a, _) in arrays.items():
            _same(f.read(key), a)


@pytest.mark.parametrize("codec_id", [5, 6, 7])
def test_blosc_codecs_without_a_decoder_raise(tmp_path, codec_id):
    """Header codecs 5-7, which c-blosc 1.x never writes, raise naming the
    codec, through `blosc.decompress` and through h5_lite."""
    data = _payload("u2", 4096).tobytes()
    chunk = bytearray(blosc_chunk(data, 2, "lz4", "byte"))
    chunk[2] = (chunk[2] & 0x1F) | codec_id << 5
    with pytest.raises(blosc.UnsupportedBlosc, match=f"codec {codec_id} \\(unknown\\)"):
        blosc.decompress(bytes(chunk))
    path = tmp_path / "z.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("d", shape=(2048,), dtype="u2", chunks=(2048,), compression=32001,
                             compression_opts=(2, 2, 2, 4096, 5, 1, codec_id),
                             allow_unknown_filter=True)
        d.id.write_direct_chunk((0,), bytes(chunk), 0)
    with pytest.raises(UnsupportedHDF5,
                       match=f"/d: filter 32001 \\(Blosc\\) codec {codec_id} \\(unknown\\)"):
        read_h5(path, "d")
    bad = bytearray(memcpy_chunk(data, 2))
    bad[0] = 3
    with pytest.raises(blosc.UnsupportedBlosc, match="format version 3"):
        blosc.decompress(bytes(bad))


# ---- c-blosc's own chunks, h5py's LZF, hdf5plugin's Zstandard filter -----------------

from make_codec_fixtures import (  # noqa: E402
    BLOSC_CODECS, SHUFFLES, blosc_dataset, blosc_compress, libblosc,
)

PLAIN = {"blosclz": blosc.blosclz_decompress_plain, "lz4": blosc.lz4_decompress_plain,
         "lz4hc": blosc.lz4_decompress_plain, "snappy": blosc.snappy_decompress_plain}


@pytest.fixture(scope="module")
def cblosc():
    lib = libblosc()
    if lib is None:
        pytest.skip("c-blosc (libblosc.so.1) is not installed")
    return lib


@pytest.mark.parametrize("shuffle", list(SHUFFLES))
@pytest.mark.parametrize("cname", list(BLOSC_CODECS))
def test_c_blosc_chunks_decode_bitwise(cblosc, cname, shuffle):
    """Chunks that c-blosc itself writes, for every codec and shuffle at
    clevels 1, 5 and 9, of u1, u2, u4 and f8 data (c-blosc's blocksize at
    clevels 1 and 9; 4096 bytes and a short last block at 5): bitwise
    through the native decoders and, where the codec has them, the plain
    ones."""
    for clevel in (1, 5, 9):
        for dtype in ("u1", "u2", "u4", "f8"):
            a = _payload(dtype, (40_000 + 24) // np.dtype(dtype).itemsize, clevel)
            data = a.tobytes()
            chunk = blosc_compress(cblosc, data, a.dtype.itemsize, cname, clevel, shuffle,
                                   4096 if clevel == 5 else 0)
            assert chunk[2] & 0x2 == 0, (clevel, dtype)  # compressed, not copied whole
            assert blosc.decompress(chunk) == data, (clevel, dtype)
            if cname in PLAIN:
                assert blosc.decompress(chunk, native=False) == data, (clevel, dtype)


@pytest.mark.parametrize("cname", list(BLOSC_CODECS))
def test_reads_c_blosc_datasets(tmp_path, cblosc, cname):
    """A DSEC events group's dtypes whose chunks c-blosc wrote (the last one
    partial), through h5_lite."""
    n = 50_000
    arrays = {"events/x": _payload("u2", n, 1), "events/y": _payload("u2", n, 2),
              "events/t": _payload("i8", n, 3), "events/p": _payload("u1", n, 4)}
    path = tmp_path / "c_blosc.h5"
    with h5py.File(path, "w") as f:
        for key, a in arrays.items():
            blosc_dataset(f, key, a, cblosc, cname, 5, "byte", 16384)
    with h5_lite.File(path) as f:
        for key, a in arrays.items():
            _same(f.read(key), a)


def _filter_masks(path, key):
    with h5py.File(path, "r") as f:
        d = f[key]
        return [d.id.get_chunk_info(k).filter_mask for k in range(d.id.get_num_chunks())]


@pytest.mark.parametrize("shuffle", [False, True])
def test_reads_lzf_datasets(tmp_path, monkeypatch, shuffle):
    """h5py's LZF filter (32000), behind the shuffle filter or not, every
    loader dtype, 1-3 D chunks; an incompressible chunk, which h5py stores
    unfiltered with its filter mask bit set. Native and plain decoders."""
    rng = np.random.default_rng(5)
    arrays = {f"d_{dt}": _payload(dt, 30_000, k) for k, dt in
              enumerate(["u1", "u2", "i8", "f4", "f8", ">i4"])}
    arrays["grid"] = _payload("f4", 6 * 40 * 50, 9).reshape(6, 40, 50)
    arrays["noise"] = np.concatenate([np.zeros(4096, np.uint8),
                                      rng.integers(0, 256, 4096, dtype=np.uint8)])
    path = tmp_path / "lzf.h5"
    with h5py.File(path, "w") as f:
        for key, a in arrays.items():
            chunks = (4, 16, 25) if a.ndim == 3 else (4096,)
            f.create_dataset(key, data=a, chunks=chunks, compression="lzf", shuffle=shuffle)
    lzf_bit = 1 << (1 if shuffle else 0)
    assert [m & lzf_bit for m in _filter_masks(path, "noise")] == [0, lzf_bit]
    for native in (True, False):
        if not native:
            monkeypatch.setattr(native_blosc, "available", lambda: False)
        with h5_lite.File(path) as f:
            for key, a in arrays.items():
                _same(f.read(key), a)


def test_reads_zstd_filter_datasets(tmp_path, monkeypatch):
    """hdf5plugin's Zstandard filter (32015; the chunks libzstd frames,
    written directly): a 3-D float32 map, int64 timestamps behind the
    shuffle filter with one chunk stored unfiltered (mask bit 1); without
    the native library, filter 32015 raises naming the cause."""
    zs = pytest.importorskip("zstandard")
    from make_codec_fixtures import write_zstd_filter_h5

    path = tmp_path / "zstd.h5"
    arrays = write_zstd_filter_h5(path, seed=4)
    assert sorted(_filter_masks(path, "t")) == [0, 0, 0, 0, 0b10]
    with h5_lite.File(path) as f:
        for key, a in arrays.items():
            _same(f.read(key), a)
    # a chunk that is two frames with a skippable frame between them
    a = _payload("u2", 5000, 6)
    with h5py.File(path, "a") as f:
        d = f.create_dataset("two_frames", shape=a.shape, dtype=a.dtype, chunks=a.shape,
                             compression=32015, allow_unknown_filter=True)
        raw = a.tobytes()
        d.id.write_direct_chunk((0,), zs.ZstdCompressor(level=1).compress(raw[:3000])
                                + b"\x50\x2a\x4d\x18\x02\x00\x00\x00ab"
                                + zs.ZstdCompressor(level=9).compress(raw[3000:]), 0)
    _same(read_h5(path, "two_frames"), a)
    monkeypatch.setattr(native_blosc, "available", lambda: False)
    with pytest.raises(UnsupportedHDF5, match="/t: filter 32015 \\(Zstandard\\) needs the "
                                              "native library, which did not build"):
        read_h5(path, "t")
