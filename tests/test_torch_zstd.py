"""The port's Zstandard decoder (eincm_tpu_torch/native/zstd.cpp) against the
reference encoder's output: every frame that the `zstandard` package
(libzstd) writes decodes bitwise, at levels -5 to 22, with and without a
checksum and a content size, from 0 bytes to 2 MiB, with long-distance
matching, concatenated and skippable frames; the matrix is checked to hold
every block, literals and sequence-table kind of RFC 8878. Malformed input
(truncated, bits flipped, random bytes) raises in a subprocess that must
survive it; a dictionary frame raises. The committed fixtures
(tests/data/codecs/, tests/make_codec_fixtures.py) match their manifest,
and the port's DSEC loader reads a Blosc-Zstd events.h5 bitwise as the JAX
package's loader reads the same events uncompressed."""

import functools
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

zs = pytest.importorskip("zstandard")

from eincm_tpu_torch.native import blosc as nb  # noqa: E402
from eincm_tpu_torch.utils import blosc  # noqa: E402

from make_codec_fixtures import payloads, skippable, zstd_frames  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "codecs"
LEVELS = [-5, 1, 3, 19, 22]


def _frame(data: bytes, level: int, checksum=True, content_size=True, **params) -> bytes:
    cp = zs.ZstdCompressionParameters.from_level(
        level, write_checksum=checksum, write_content_size=content_size, **params)
    return zs.ZstdCompressor(compression_params=cp).compress(data)


@functools.lru_cache(maxsize=None)
def matrix_payloads() -> dict:
    """Contents that make libzstd write each kind of block: raw and RLE
    blocks, raw, RLE, Huffman (1 and 4 streams) and Treeless literals, every
    sequence-table mode; 0 bytes to 1 MiB."""
    p = payloads()
    rng = np.random.default_rng(7)
    base = rng.integers(1, 256, 4096, dtype=np.uint8).tobytes()
    # slices of `base` behind two zero bytes: past the first block the
    # literals are only zeros (RLE literals at levels 19 and 22)
    zeros_then_matches = base + b"".join(b"\0\0" + base[o:o + 32]
                                        for o in rng.integers(0, 4064, 12000))
    return {
        "empty": b"", "one": b"x", "short": p["text"][:100], "noise": p["noise"],
        "x": p["x"], "runs": p["runs"], "mixed": p["mixed"],
        "small_alphabet": p["small_alphabet"],
        "t_1MiB": p["t"] * 2,
        "rle_blocks": b"\x07" * 300_000,
        "zeros_then_matches": zeros_then_matches,
        "text_400k": bytes(rng.choice(np.frombuffer(b"ACGT acgt\n", np.uint8), 400_000)),
    }


@functools.lru_cache(maxsize=None)
def matrix_frames(level: int, checksum: bool, content_size: bool) -> dict:
    return {name: _frame(d, level, checksum, content_size)
            for name, d in matrix_payloads().items()}


LITERALS = ("raw", "rle", "huffman", "treeless")
MODES = ("predefined", "rle", "fse", "repeat")


def block_kinds(frame: bytes) -> set:
    """What one frame's blocks hold, read from their headers: ("block",
    type), ("literals", type, streams), ("huffman", "direct" or "fse") for a
    tree description, ("sequences", table, mode)."""
    fhd = frame[4]
    single = fhd & 0x20
    fcs = (0, 2, 4, 8)[fhd >> 6] or (1 if single else 0)
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + fcs
    kinds = set()
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        pos += 3
        kinds.add(("block", ("raw", "rle", "compressed")[btype]))
        if btype == 2:
            b = frame[pos:pos + size]
            lt, sf = b[0] & 3, (b[0] >> 2) & 3
            if lt < 2:
                hs = (1, 2, 1, 3)[sf]
                n = b[0] >> 3 if sf in (0, 2) else int.from_bytes(b[:hs], "little") >> 4
                used = hs + (n if lt == 0 else 1)
                kinds.add(("literals", LITERALS[lt], 0))
            else:
                hs, field = (3, 3, 4, 5)[sf], (10, 10, 14, 18)[sf]
                used = hs + ((int.from_bytes(b[:hs], "little") >> (4 + field))
                             & ((1 << field) - 1))
                kinds.add(("literals", LITERALS[lt], 1 if sf == 0 else 4))
                if lt == 2:
                    kinds.add(("huffman", "direct" if b[hs] >= 128 else "fse"))
            s = b[used:]
            if s[0]:
                modes = s[1 if s[0] < 128 else (2 if s[0] < 255 else 3)]
                for name, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
                    kinds.add(("sequences", name, MODES[(modes >> shift) & 3]))
        pos += 1 if btype == 1 else size
        if last:
            return kinds


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("level", LEVELS)
def test_zstd_frames_decode_bitwise(level, checksum, content_size):
    """Each payload of the matrix, as libzstd writes it at this level and
    with these options, decodes bitwise into its exact size."""
    assert nb.available()
    for name, frame in matrix_frames(level, checksum, content_size).items():
        data = matrix_payloads()[name]
        assert nb.zstd_decompress(frame, len(data)) == data, name


def test_zstd_matrix_holds_every_block_kind():
    """The matrix above holds every kind of block content RFC 8878 defines
    (dictionaries aside): raw, RLE and compressed blocks; raw, RLE, Huffman
    (1 and 4 streams, weights direct and FSE-coded) and Treeless literals;
    each sequence-table mode."""
    kinds = set()
    for level in LEVELS:
        for frame in matrix_frames(level, True, True).values():
            kinds |= block_kinds(frame)
    want = {("block", b) for b in ("raw", "rle", "compressed")}
    want |= {("literals", "raw", 0), ("literals", "rle", 0), ("literals", "huffman", 1),
             ("literals", "huffman", 4), ("literals", "treeless", 4),
             ("huffman", "direct"), ("huffman", "fse")}
    assert want <= kinds, sorted(want - kinds)
    modes = {m for k, _, m in (x for x in kinds if x[0] == "sequences")}
    assert modes == set(MODES), modes


def test_zstd_long_distance_concatenated_and_skippable():
    """Long-distance matching (window 2^22, a match ~1 MiB back), frames
    joined with skippable frames of every magic nibble in between, a frame
    of nothing, and the committed fixtures' frames, built here again."""
    p = payloads()
    far = p["noise"] + p["runs"] * 2 + p["t"][:1 << 18] + p["noise"]
    frame = _frame(far, 19, enable_ldm=True, window_log=22)
    assert nb.zstd_decompress(frame, len(far)) == far
    parts = [p["x"], b"", p["mixed"], p["runs"]]
    joined = b"".join(skippable(bytes([k]) * k, k) + _frame(d, 3, checksum=k % 2 == 0)
                      for k, d in enumerate(parts))
    joined += b"".join(skippable(bytes([k]) * k, k) for k in range(len(parts), 16))
    assert nb.zstd_decompress(joined, sum(map(len, parts))) == b"".join(parts)
    assert nb.zstd_decompress(skippable(b"abc") + _frame(b"", 1), 0) == b""
    for name, (frame, data) in zstd_frames().items():
        assert nb.zstd_decompress(frame, len(data)) == data, name


_chunks = st.one_of(
    st.binary(max_size=300),
    st.tuples(st.integers(0, 255), st.integers(1, 5000)).map(lambda t: bytes([t[0]]) * t[1]),
    st.integers(0, 2**32 - 1).map(
        lambda s: np.random.default_rng(s).integers(0, 4, 2000, dtype=np.uint8).tobytes()),
)


@settings(max_examples=60, deadline=None)
@given(parts=st.lists(_chunks, max_size=12), repeat=st.integers(1, 4),
       level=st.sampled_from([-5, 1, 3, 9, 19]), checksum=st.booleans())
def test_zstd_decodes_any_content(parts, repeat, level, checksum):
    """Contents and sizes drawn by hypothesis: literal bytes, runs, small
    alphabets, the whole repeated (long matches, repeat offsets)."""
    data = b"".join(parts) * repeat
    frame = _frame(data, level, checksum=checksum)
    assert nb.zstd_decompress(frame, len(data)) == data


def test_zstd_errors_raise():
    """A wrong output size, a wrong checksum, a wrong content size, a bad
    magic number, a truncated frame and trailing bytes raise ValueError
    naming the fault; a frame that names a dictionary raises UnsupportedZstd
    (also inside a Blosc chunk, as UnsupportedBlosc)."""
    data = payloads()["mixed"]
    frame = _frame(data, 3)
    with pytest.raises(ValueError, match="output longer than"):
        nb.zstd_decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match=f"{len(data)} of {len(data) + 1} bytes decoded"):
        nb.zstd_decompress(_frame(data, 3, content_size=False), len(data) + 1)
    bad = bytearray(frame)
    bad[-1] ^= 0x40  # the checksum's last byte
    with pytest.raises(ValueError, match="checksum mismatch"):
        nb.zstd_decompress(bytes(bad), len(data))
    with pytest.raises(ValueError, match="bad magic"):
        nb.zstd_decompress(b"\x28\xb5\x2f\xfe" + frame[4:], len(data))
    with pytest.raises(ValueError, match="truncated"):
        nb.zstd_decompress(frame[:len(frame) // 2], len(data))
    with pytest.raises(ValueError, match="truncated"):
        nb.zstd_decompress(frame + b"\x28\xb5", len(data))
    # a single-segment frame whose stated size is one byte more than it holds
    small = _frame(b"abcdef" * 10, 3, checksum=False)
    assert small[4] & 0x20 and small[5] == 60
    with pytest.raises(ValueError, match="Frame_Content_Size"):
        nb.zstd_decompress(small[:5] + bytes([61]) + small[6:], 61)
    samples = [bytes(np.random.default_rng(s).integers(0, 20, 400, dtype=np.uint8))
               for s in range(200)]
    dictionary = zs.train_dictionary(2048, samples)
    with_dict = zs.ZstdCompressor(level=3, dict_data=dictionary).compress(samples[0])
    with pytest.raises(nb.UnsupportedZstd, match="Zstd dictionary"):
        nb.zstd_decompress(with_dict, len(samples[0]))
    chunk = _blosc_zstd_chunk(with_dict, len(samples[0]))
    with pytest.raises(blosc.UnsupportedBlosc, match="codec 4 \\(Zstd\\): a Zstd dictionary"):
        blosc.decompress(chunk)


def _header(frame: bytes):
    """(descriptor, window descriptor, Dictionary_ID field, content size,
    the rest) of a frame."""
    fhd = frame[4]
    single = fhd & 0x20
    pos = 5 + (0 if single else 1)
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (0, 2, 4, 8)[fhd >> 6] or (1 if single else 0)
    fcs = int.from_bytes(frame[pos + did_size:pos + did_size + fcs_size], "little")
    return (fhd, frame[5:5 + (0 if single else 1)], frame[pos:pos + did_size],
            fcs + (256 if fcs_size == 2 else 0), frame[pos + did_size + fcs_size:])


def _rewritten(frame: bytes, fcs_size: int, did_size: int = 0, did: int = 0) -> bytes:
    """`frame` with its Frame_Content_Size in the `fcs_size`-byte form and a
    `did_size`-byte Dictionary_ID field holding `did`."""
    fhd, window, _, fcs, rest = _header(frame)
    fhd = ((fhd & 0x3C) | {1: 0, 2: 1, 4: 2, 8: 3}[fcs_size] << 6
           | {0: 0, 1: 1, 2: 2, 4: 3}[did_size])
    value = fcs - 256 if fcs_size == 2 else fcs
    return (frame[:4] + bytes([fhd]) + window + did.to_bytes(did_size, "little")
            + value.to_bytes(fcs_size, "little") + rest)


def test_zstd_frame_header_forms():
    """Frame_Content_Size in each of its forms (1 byte under Single_Segment;
    2 bytes, which add 256; 4; 8; none, in the frames written without a
    content size above) and Dictionary_ID fields of 1, 2 and 4 bytes: 0
    decodes, any other value raises UnsupportedZstd; a reserved block type
    raises."""
    p = payloads()
    for data, forms in ((p["text"][:100], (1, 4, 8)), (p["x"], (2, 4, 8))):
        frame = _frame(data, 3)
        assert frame[4] & 0x20  # Single_Segment: the window is the content size
        for size in forms:
            assert nb.zstd_decompress(_rewritten(frame, size), len(data)) == data, size
            for did_size in (1, 2, 4):
                ok = _rewritten(frame, size, did_size, 0)
                assert nb.zstd_decompress(ok, len(data)) == data, (size, did_size)
                with pytest.raises(nb.UnsupportedZstd, match="Zstd dictionary"):
                    nb.zstd_decompress(_rewritten(frame, size, did_size, 7), len(data))
        rest = bytearray(_header(frame)[4])
        rest[0] |= 0b110  # the first block's type: 3, reserved
        with pytest.raises(ValueError, match="corrupt data"):
            nb.zstd_decompress(frame[:len(frame) - len(rest)] + bytes(rest), len(data))


def _blosc_zstd_chunk(stream: bytes, nbytes: int) -> bytes:
    """A Blosc1 chunk of one block, one Zstd stream (typesize 1)."""
    import struct

    head = struct.pack("<BBBBIII", 2, 1, 0x10 | 4 << 5, 1, nbytes, nbytes, 20 + 4 + len(stream))
    return head + struct.pack("<i", 20) + struct.pack("<i", len(stream)) + stream


def test_zstd_without_the_native_library_raises(monkeypatch):
    """Codec 4 has no plain decoder: where the native library did not build,
    a Blosc-Zstd chunk raises naming the cause (no Python path is taken)."""
    data = payloads()["x"]
    chunk = _blosc_zstd_chunk(_frame(data, 3), len(data))
    assert blosc.decompress(chunk) == data
    assert blosc.decompress(chunk, native=False) == data  # Zstd's native either way
    monkeypatch.setattr(nb, "available", lambda: False)
    with pytest.raises(blosc.UnsupportedBlosc,
                       match="codec 4 \\(Zstd\\) needs the native library, which did not build"):
        blosc.decompress(chunk)


# ---- malformed input, in a subprocess that must survive it ------------------

_FUZZ = r"""
import json, sys
import numpy as np
import zstandard as zs
sys.path.insert(0, sys.argv[1])
from make_codec_fixtures import payloads, libblosc, blosc_compress
from eincm_tpu_torch.native import blosc as nb
from eincm_tpu_torch.utils import blosc

rng = np.random.default_rng(11)
p = payloads()
sources = [p["mixed"], p["x"], p["runs"], p["t"][:100000], p["text"][:30000]]
frames = [(zs.ZstdCompressor(level=lv, write_checksum=True).compress(d), d)
          for lv in (-5, 1, 19) for d in sources]

def mutate(b, kind):
    b = bytearray(b)
    if kind == 0:  # truncated
        return bytes(b[:rng.integers(0, len(b))])
    if kind == 1:  # 1-3 bits flipped
        for _ in range(rng.integers(1, 4)):
            i = rng.integers(0, len(b))
            b[i] ^= 1 << rng.integers(0, 8)
        return bytes(b)
    i = rng.integers(0, len(b))  # a run of random bytes
    j = min(len(b), i + rng.integers(1, 48))
    b[i:j] = rng.integers(0, 256, j - i, dtype=np.uint8).tobytes()
    return bytes(b)

counts = {"zstd": 0, "zstd_raised": 0, "zstd_random": 0, "streams": 0, "blosc": 0}
for k in range(900):
    frame, data = frames[k % len(frames)]
    bad = mutate(frame, k % 3)
    counts["zstd"] += 1
    try:
        out = nb.zstd_decompress(bad, len(data))
    except ValueError:
        counts["zstd_raised"] += 1
        continue
    # it decoded: with its checksum intact that can only be the content
    assert out == data, ("checksummed frame decoded to other bytes", k)
for k in range(300):
    bad = rng.integers(0, 256, rng.integers(1, 3000), dtype=np.uint8).tobytes()
    if k % 2:
        bad = (0xFD2FB528).to_bytes(4, "little") + bad
    counts["zstd_random"] += 1
    try:
        nb.zstd_decompress(bad, int(rng.integers(0, 100000)))
    except ValueError:
        pass
# each LZ77 stream decoder: native and plain agree on every mutated stream
# (the same bytes, or both raise)
lib = libblosc()
if lib is not None:
    for codec, plain, fast in (("snappy", blosc.snappy_decompress_plain, nb.snappy_decompress),
                               ("lz4", blosc.lz4_decompress_plain, nb.lz4_decompress),
                               ("blosclz", blosc.blosclz_decompress_plain,
                                nb.blosclz_decompress)):
        data = p["t"][:16384]
        chunk = blosc_compress(lib, data, 1, codec, 9, "none", 16384)
        stream = chunk[24:]  # one block, one stream, after its length
        assert not chunk[2] & 0x2, codec  # compressed, not copied
        assert plain(stream, len(data)) == data == fast(stream, len(data))
        for k in range(150):
            bad = mutate(stream, k % 3)
            res = []
            for fn in (plain, fast):
                try:
                    res.append(fn(bad, len(data)))
                except ValueError:
                    res.append(None)
            assert res[0] == res[1], (codec, k)
            counts["streams"] += 1
    for codec in ("zstd", "snappy", "lz4", "blosclz", "zlib"):
        for shuffle in ("none", "byte", "bit"):
            chunk = blosc_compress(lib, p["x"], 2, codec, 5, shuffle)
            for k in range(20):
                counts["blosc"] += 1
                try:
                    blosc.decompress(mutate(chunk, k % 3))
                except ValueError:
                    pass
print(json.dumps(counts))
"""


def test_malformed_input_raises_and_never_crashes():
    """Over a thousand truncated, bit-flipped and random-byte inputs to the
    Zstd decoder (checksummed frames: each raises ValueError or, where the
    damage missed everything that counts, decodes to the content), the
    native Snappy, LZ4 and blosclz decoders against their plain versions on
    mutated c-blosc streams, and mutated c-blosc chunks of every codec
    through `blosc.decompress` (ValueError or bytes), all in one process
    that must exit cleanly."""
    assert nb.available()  # built here, so the subprocess loads it
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(REPO / "tests")], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts["zstd"] + counts["zstd_random"] >= 1000, counts
    assert counts["zstd_raised"] >= 0.9 * counts["zstd"], counts


# ---- the committed fixtures and the slice -----------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_fixtures_match_their_manifest():
    """tests/data/codecs/ as tests/make_codec_fixtures.py wrote it: each file
    by its sha256, each payload decoded by the native decoders (chip_smoke.py
    [h5]'s check, run here) by its sha256, dtype and shape; and the frames
    are still what libzstd writes from the same seeds."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    counts = _chip_smoke().check_codec_fixtures(FIXTURES)
    assert sum(c[0] for c in counts.values()) == len(manifest["payloads"])
    assert {"zstd", "blosc", "events.h5", "zstd_filter.h5", "lzf.h5"} == set(counts)
    assert sum(v["bytes"] for v in manifest["files"].values()) <= 2 << 20
    for name, (frame, data) in zstd_frames().items():
        p = manifest["payloads"][f"zstd/{name}.zst"]
        assert hashlib.sha256(data).hexdigest() == p["sha256"], name


def test_dsec_loader_reads_blosc_zstd_events(tmp_path, monkeypatch):
    """The slice: the port's DSEC loader, h5py blocked (so `utils/h5_lite.py`
    reads, as on the card), over a tree whose events.h5 is the committed
    Blosc-Zstd fixture, gives bitwise the JAX package's DSEC loader's
    samples over the same tree with the events written uncompressed by
    h5py."""
    import h5py

    from eincm_tpu.data.dsec import DSECDataLoader as JaxDSEC
    from eincm_tpu_torch.data import DSECDataLoader
    from eincm_tpu_torch.utils import dataset_trees, h5_lite

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    tree = dataset_trees.write_dsec_tree(tmp_path / "zstd", **manifest["events_tree"])
    rel = Path(f"Train/train_events/{tree['sequence']}/events/left/events.h5")
    shutil.copytree(tmp_path / "zstd", tmp_path / "plain")
    with h5_lite.File(tmp_path / "zstd" / rel) as f:
        events = {k: f.read(k) for k in ("events/x", "events/y", "events/t", "events/p",
                                         "ms_to_idx", "t_offset")}
    (tmp_path / "plain" / rel).unlink()
    with h5py.File(tmp_path / "plain" / rel, "w") as f:
        for key, a in events.items():
            f[key] = a
    shutil.copyfile(FIXTURES / "events.h5", tmp_path / "zstd" / rel)
    with h5_lite.File(tmp_path / "zstd" / rel) as f:  # the fixture is this scene
        for key, a in events.items():
            got = f.read(key)
            assert got.dtype == a.dtype and got.shape == a.shape, key
            np.testing.assert_array_equal(got, a, err_msg=key)
    kw = dict(des_n_events=100_000, data_split="train")
    jax_loader = JaxDSEC(tmp_path / "plain", tree["sequence"], **kw)
    jax_loader.get_ready()
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = DSECDataLoader(tmp_path / "zstd", tree["sequence"], **kw)
    port.get_ready()
    assert len(port) == len(jax_loader) == manifest["events_tree"]["n_windows"]
    for i in range(len(port)):
        _same(jax_loader[i], port[i], f"window {i}")


def _same(a, b, where):
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
