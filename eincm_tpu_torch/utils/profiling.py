"""Profiling and timing utilities (the port of eincm_tpu/utils/profiling.py).

- `trace(dir)` wraps a block in a `torch.profiler` trace (CPU, and CUDA
  where there is a card), written to `dir` for TensorBoard or Perfetto;
- `annotate(name)` adds a named region to such a trace;
- `Timer` / `timed` measure wall time on the host clock, ending in
  `force_sync` so that the device work is inside the measurement;
- `cuda_ms` times device work with CUDA events;
- `card()` names the card and its power limit, as nvidia-smi reports them,
  to stand beside every number taken on it.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict

import torch
from torch.profiler import record_function

annotate = record_function


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force_sync(tree) -> None:
    """Wait for the work queued on every CUDA device that holds a tensor of
    `tree` (a tensor, or nested lists, tuples and dicts of them). CPU
    tensors need no wait."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the block, written into `log_dir` when it
    ends; yields the profiler (its `key_averages()` sums ops by name)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(
        activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))
    ) as prof:
        yield prof


class Timer:
    """Accumulating named wall-clock timers with device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                force_sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: total {t:.3f}s over {c} calls ({t/c*1000:.1f} ms/call)")
        return "\n".join(lines)


def timed(fn, *args, iters: int = 10, warmup: int = 1):
    """Amortized host-clock timing of fn(*args) with one final sync.

    Returns (seconds_per_call, last_output).
    """
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    force_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    force_sync(out)
    return (time.perf_counter() - t0) / iters, out


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device ms of fn() over `reps` back-to-back calls, after a
    warm-up: the smaller of two such means. The card first sleeps for
    longer than the host needs to enqueue the calls, so the events time the
    device work, not the host's launch rate (at 30k events a kernel is
    shorter than its launch). A host stall longer than that sleep (a
    garbage-collection pause of ~1 ms was seen) leaves the card idle between
    two launches and would enter a single mean; it would have to hit both."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    means = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(4 * reps * host_s, 2.0) * 2e9))  # ~2 GHz clock
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / reps)
    return min(means)


def card() -> str:
    """The first card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
