"""Build and bind the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (`extern "C"` entry points
returning `cudaError_t`). It is compiled by `nvcc` into
`eincm_tpu_torch/_build/lib<name>-<hash>.so` at first use and loaded with
ctypes; the hash of the source and of every `csrc/*.cuh` header it
includes names the library, so an edited source or header is rebuilt and a
stale library is never loaded. Nothing here runs at import time, so the
CPU-only test suite imports every module without a toolkit.

Every kernel wrapper is a `Kernel`: it resolves its entry point lazily,
raises when the launch returns a CUDA error, and counts its launches, so a
run can show that the main path went through the kernel. While a CUDA
graph is captured (`tally_launches`) a call launches nothing, so it is
counted in the graph's tally instead, and each replay of the graph adds
that tally (`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
# the tally of the CUDA graph being captured (Kernel -> calls), if any: a
# process-wide setting, since autograd's backward launches from its own
# thread
_TALLY: Optional[Dict["Kernel", int]] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and every csrc header it includes, transitively."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose and (proc.stdout or proc.stderr):
        print(f"[nvcc -Xptxas -v] {name}.cu\n{proc.stdout}{proc.stderr}", end="", flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def build_all(verbose: Tuple[str, ...] = ()) -> float:
    """Build every kernel library, one nvcc per source, all at once, with
    `-Xptxas -v`'s report printed for the sources named in `verbose`;
    returns the wall seconds it took."""
    t0 = time.perf_counter()
    names = sorted(src.stem for src in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(lambda n: build(n, verbose=n in verbose), names))
    return time.perf_counter() - t0


def check_cuda(name: str, tensors, shapes, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous `dtype` tensor of the
    given shape on one CUDA device: what a kernel's pointers assume."""
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


class Kernel:
    """One `extern "C"` entry point plus its launch count."""

    def __init__(self, lib: str, symbol: str, argtypes):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: cudaError_t {err}"
            )
        if _TALLY is None:
            self.launches += 1
        else:
            _TALLY[self] = _TALLY.get(self, 0) + 1


@contextlib.contextmanager
def tally_launches(tally: Dict[Kernel, int]):
    """Count the block's kernel calls into `tally` and not as launches: a
    CUDA graph's capture, whose calls launch nothing until it is replayed."""
    global _TALLY
    prev, _TALLY = _TALLY, tally
    try:
        yield
    finally:
        _TALLY = prev


def add_launches(tally: Dict[Kernel, int]) -> None:
    """Count a graph's replay: the calls its capture tallied."""
    for kernel, n in tally.items():
        kernel.launches += n


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
D = ctypes.c_double
LL = ctypes.c_longlong

KERNELS: Dict[str, Kernel] = {
    # (theta, xs, ys, out, n_events, head, groups, vec, h, w, scale_y,
    #  scale_x, staged, blocks, threads, stream)
    "interp_fwd": Kernel(
        "interp", "eincm_interp_fwd",
        (P, P, P, P, LL, LL, LL, I, I, I, F, F, I, I, I, P),
    ),
    # (g, xs, ys, dtheta, partials, ticket, n_events, head, groups, vec, h,
    #  w, scale_y, scale_x, mode, blocks, threads, slices, stream)
    "interp_bwd": Kernel(
        "interp", "eincm_interp_bwd",
        (P, P, P, P, P, P, LL, LL, LL, I, I, I, F, F, I, I, I, I, P),
    ),
    # (wx, wy, sums, frames, n_refs, n_events, H, W, hw, tile_rows,
    #  tile_cols, row_slabs, col_slabs, chunks, threads, stream)
    "splat_fwd": Kernel(
        "splat", "eincm_splat_fwd", (P, P, P, P, I, LL, I, I, I, I, I, I, I, I, I, P)
    ),
    # kernel 2 in exact sums, any grid (csrc/exact.cuh): (g, xs, ys, dtheta,
    #  scratch, n_events, head, groups, vec, h, w, scale_y, scale_x,
    #  band_rows, blocks, threads, stream)
    "interp_bwd_exact": Kernel(
        "interp", "eincm_interp_bwd_exact",
        (P, P, P, P, P, LL, LL, LL, I, I, I, F, F, I, I, I, P),
    ),
    # (wx, wy, grad_frames, dwx, dwy, n_refs, n_events, H, W, hw,
    #  stream_kernel, blocks, threads, vec, stream)
    "splat_bwd": Kernel(
        "splat", "eincm_splat_bwd", (P, P, P, P, P, I, LL, I, I, I, I, I, I, I, P)
    ),
    # (xi, yi, ts, thx, thy, frame, n_events, t_ref, H, W, hw, cluster,
    #  tile_rows, bands, chunks, threads, per_thread, queue, stream)
    "fused_warp_splat": Kernel(
        "fused", "eincm_fused_warp_splat",
        (P, P, P, P, P, P, LL, F, I, I, I, I, I, I, I, I, I, I, P),
    ),
    # (xi, yi, ts, theta, frame, n_events, t_ref, H, W, hw, h, w,
    #  scale_y, scale_x, cluster, tile_rows, bands, chunks, threads, staged,
    #  per_thread, queue, stream)
    "fully_fused_warp_splat": Kernel(
        "fused", "eincm_fully_fused_warp_splat",
        (P, P, P, P, P, LL, F, I, I, I, I, I, F, F, I, I, I, I, I, I, I, I, P),
    ),
    # (theta, xs, ys, out, n_events, h, w, hp, wp, scale_y, scale_x, mode,
    #  stream)
    "interp_dense": Kernel(
        "interp_dense", "eincm_interp_dense", (P, P, P, P, LL, I, I, I, I, F, F, I, P)
    ),
    # the direct kernels of float64 and of the wrap-compat splat:
    # (wx, wy, sums, frames, n_refs, n_events, H, W, hw, f64, wrap,
    #  tile_rows, tile_cols, row_slabs, col_slabs, chunks, threads, stream)
    "splat_direct_fwd": Kernel(
        "direct", "eincm_splat_direct_fwd",
        (P, P, P, P, I, LL, I, I, I, I, I, I, I, I, I, I, I, P),
    ),
    # (wx, wy, grad_frames, dwx, dwy, n_refs, n_events, H, W, hw, f64, wrap,
    #  per_thread, vec, blocks, threads, stream)
    "splat_direct_bwd": Kernel(
        "direct", "eincm_splat_direct_bwd",
        (P, P, P, P, P, I, LL, I, I, I, I, I, I, I, I, I, P),
    ),
    # (theta, xs, ys, out, n_events, h, w, scale_y, scale_x, f64, round,
    #  staged, per_thread, vec, blocks, threads, stream): float64 rounded,
    #  and float32 at the coordinates as given (kernel 8's route)
    "interp_direct_fwd": Kernel(
        "direct", "eincm_interp_direct_fwd",
        (P, P, P, P, LL, I, I, D, D, I, I, I, I, I, I, I, P),
    ),
    # (g, xs, ys, dtheta, scratch, n_events, h, w, scale_y, scale_x,
    #  band_rows, blocks, threads, stream), float64
    "interp_direct_bwd": Kernel(
        "direct", "eincm_interp_direct_bwd", (P, P, P, P, P, LL, I, I, D, D, I, I, I, P)
    ),
}


# The clusters of a kernel's launch that the card runs at once
# (`cudaOccupancyMaxActiveClusters`), by (library, symbol, arguments): a
# question to the CUDA runtime, not a launch.
_ACTIVE_CLUSTERS: Dict[tuple, int] = {}


def active_clusters(lib: str, symbol: str, *args: int) -> int:
    key = (lib, symbol, torch.cuda.current_device(), args)
    if key not in _ACTIVE_CLUSTERS:
        fn = getattr(load(lib), symbol)
        fn.argtypes = [I] * len(args)
        fn.restype = ctypes.c_int
        n = fn(*args)
        if n < 1:
            raise RuntimeError(
                f"{symbol}{args}: no cluster of this launch fits the card"
                + (f" (cudaError_t {-n})" if n < 0 else "")
            )
        _ACTIVE_CLUSTERS[key] = n
    return _ACTIVE_CLUSTERS[key]


def launch_counts() -> Dict[str, int]:
    return {k: v.launches for k, v in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
