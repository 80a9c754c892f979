"""Build the native host library with g++ (no external dependencies).

Usage: python -m eincm_tpu_torch.native.build
Carried over from eincm_tpu/native/build.py. The ctypes bindings
(`events.py`, `vision.py`) build it at first use when the shared object is
missing or older than a source. It goes to `eincm_tpu_torch/_build/`
(git-ignored), compiled under a name of its own and renamed into place, so
processes that build at once never load a half-written file; threads of
one process (the staging prefetcher's) build one at a time.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRCS = [HERE / "vision.cpp", HERE / "events.cpp", HERE / "blosc.cpp", HERE / "zstd.cpp"]
LIB = HERE.parent / "_build" / "libeincm_native.so"

_failed = False  # a failed build is final for the process: g++ runs and
# reports once, not on every `available()` probe (staging probes per frame)
_LOCK = threading.Lock()


def build(force: bool = False) -> Path | None:
    """The shared object's path, or None when g++ cannot build it."""
    with _LOCK:
        return _build(force)


def _build(force: bool) -> Path | None:
    global _failed
    if _failed and not force:
        return None
    if (
        not force
        and LIB.exists()
        and all(LIB.stat().st_mtime >= s.stat().st_mtime for s in SRCS)
    ):
        return LIB
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.stem}.{os.getpid()}.tmp.so")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", *[str(s) for s in SRCS], "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", None) or ""
        print(f"[eincm_tpu_torch.native] build failed: {e}\n{stderr}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        _failed = True
        return None
    os.replace(tmp, LIB)
    _failed = False
    return LIB


if __name__ == "__main__":
    print(f"built: {build(force=True)}")
