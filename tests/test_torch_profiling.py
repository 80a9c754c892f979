"""eincm_tpu_torch.utils.profiling on CPU tensors: the timers, the sync
(a no-op without a card) and the torch.profiler trace."""

import time

import pytest
import torch

from eincm_tpu_torch.utils import profiling as prof


def test_force_sync_walks_nested_cpu_tensors():
    tree = {"a": torch.zeros(3), "b": [torch.ones(2), (torch.zeros(1), 4)], "c": None}
    assert len(list(prof._tensors(tree))) == 3
    prof.force_sync(tree)
    prof.force_sync(torch.zeros(2))
    prof.force_sync([])


def test_timer_accumulates_sections():
    t = prof.Timer()
    for _ in range(3):
        with t.section("sleep", sync_on=torch.zeros(2)):
            time.sleep(0.01)
    with t.section("none"):
        pass
    assert t.counts == {"sleep": 3, "none": 1}
    assert t.totals["sleep"] >= 0.03
    lines = t.report().splitlines()
    assert lines[0].startswith("sleep: total") and "over 3 calls" in lines[0]
    assert lines[1].startswith("none:")


def test_timed_returns_seconds_per_call_and_last_output():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.005)
        return torch.full((2,), float(len(calls)))

    s, out = prof.timed(fn, 7, iters=4, warmup=2)
    assert calls == [7] * 6
    assert s >= 0.005
    assert torch.equal(out, torch.full((2,), 6.0))


def test_trace_writes_a_profile(tmp_path):
    with prof.trace(tmp_path) as p:
        with prof.annotate("matmul region"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert list(tmp_path.iterdir()), "no trace file written"
    assert any(e.key == "matmul region" for e in p.key_averages())


def test_cuda_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises((RuntimeError, AssertionError)):
        prof.cuda_ms(lambda: None)
