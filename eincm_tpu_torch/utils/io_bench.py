"""Host read rates of the real-data path: PNG frames and HDF5 events.

    python -m eincm_tpu_torch.utils.io_bench [--out FILE]

Times `utils/png16.py:read_png16` on a 480x640 RGB frame (a DSEC frame's
size) written twice: with filter 0 on every row (as `write_png16` writes)
and with Paeth on every row (as PNG encoders that pick filters adaptively
write most rows of a natural image; the port's encoder below), and
`utils/h5_lite.py` reading 1.5M DSEC events (x, y, t, p) from a file
`write_h5` wrote, and the DSEC events files of the committed fixtures
(3.4 MB decoded each): `tests/data/codecs/events.h5` (Blosc-Zstd chunks)
and `tests/data/hdf5/dsec_events_latest.h5` (`libver="latest"`, gzip and
shuffle), null where that h5_lite refuses the file. The median of `reps`
runs each, host clock. Prints one JSON object.

To time two trees with one bench, run this file as a script with
`PYTHONPATH` set to each tree in turn: it times the `eincm_tpu_torch`
found there (`package` in the output) on this checkout's fixtures.
"""

from __future__ import annotations

import argparse
import json
import struct
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

from eincm_tpu_torch.utils import h5_lite
from eincm_tpu_torch.utils.png16 import read_png16, write_png16

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "data"
DSEC_KEYS = ("events/x", "events/y", "events/t", "events/p", "ms_to_idx", "t_offset")


def write_paeth_png(path, img: np.ndarray) -> None:
    """An 8-bit PNG whose every row is Paeth-filtered."""
    h, w, c = img.shape
    x = img.astype(np.int16).reshape(h, w * c)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]  # up-left
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _median_ms(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def fixture_mb_s(path, reps) -> float | None:
    """h5_lite's read rate of the DSEC events fixture at `path` (MB/s)."""
    def read():
        with h5_lite.File(path) as f:
            return sum(f.read(k).nbytes for k in DSEC_KEYS)
    try:
        n_bytes = read()
    except h5_lite.UnsupportedHDF5:  # a tree before the latest format was read
        return None
    return n_bytes / 1e6 / (_median_ms(read, reps) / 1e3)


def measure(reps: int = 5, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:480, :640]
    scene = 110 + 80 * np.sin(xx / 13.0) * np.cos(yy / 9.0)
    img = np.clip(np.stack([scene, scene[::-1], (xx + yy) % 256], -1)
                  + rng.normal(0, 4, (480, 640, 3)), 0, 255).astype(np.uint8)
    n = 1_500_000
    events = {"events/x": rng.integers(0, 640, n).astype(np.uint16),
              "events/y": rng.integers(0, 480, n).astype(np.uint16),
              "events/t": np.sort(rng.integers(0, 10**8, n)).astype(np.int64),
              "events/p": rng.integers(0, 2, n).astype(np.uint8)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_png16(tmp / "none.png", img)
        write_paeth_png(tmp / "paeth.png", img)
        for name in ("none", "paeth"):
            assert np.array_equal(read_png16(tmp / f"{name}.png"), img)
        h5_lite.write_h5(tmp / "events.h5", events)
        n_bytes = sum(a.nbytes for a in events.values())

        def read_events():
            with h5_lite.File(tmp / "events.h5") as f:
                for key in events:
                    f.read(key)

        h5_ms = _median_ms(read_events, reps)
        return {
            "png_decode_ms_filter0": _median_ms(lambda: read_png16(tmp / "none.png"), reps),
            "png_decode_ms_paeth": _median_ms(lambda: read_png16(tmp / "paeth.png"), reps),
            "h5_lite_events_mb_s": n_bytes / 1e6 / (h5_ms / 1e3),
            "h5_lite_blosc_zstd_mb_s": fixture_mb_s(FIXTURES / "codecs" / "events.h5", reps),
            "h5_lite_latest_mb_s": fixture_mb_s(FIXTURES / "hdf5" / "dsec_events_latest.h5", reps),
            "package": str(Path(h5_lite.__file__).resolve().parents[1]),
            "frame": [480, 640, 3], "events": n, "reps": reps,
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = measure(args.reps)
    print(json.dumps(res))
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
