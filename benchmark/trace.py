"""Reduce the chains' `torch.profiler` traces to what the readers need.

Each chain's trace covers the same span of the measured window, from the
common start for the mix's `profile_seconds`, in the profiler's time base
(unix ns, one clock for every process of the host). Its device operations
(kernels, copies, fills) give: their number, their seconds by name, and
the intervals in which any of them ran. The card runs one process's
kernels at a time, so the union of every chain's intervals is the time in
which the card ran anything. Chain 0's trace also has its host
operations: each gap between its own device operations is named by what
its host was doing at the gap's middle, the innermost host operation open
then, under the harness's span ("solve", "flow") around it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

SPANS = ("solve", "flow")
TOP = 10


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()


def reduce(events: Iterable, t0_ns: int, t1_ns: int, name_gaps: bool = False) -> Dict:
    """One chain's trace over [t0_ns, t1_ns]: device operations by name,
    its busy intervals (ns from t0_ns, merged) and, with `name_gaps`, its
    idle gaps by host operation."""
    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    cpu: List[Tuple[int, int, str]] = []
    for e in events:
        if _is_device(e):
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            rec = by_name[e.name()]
            rec[0] += 1
            rec[1] += d * 1e-9
        elif name_gaps and str(e.device_type()).endswith("CPU"):
            s = e.start_ns()
            cpu.append((s, s + e.duration_ns(), e.name()))
    busy = merge([(max(s, t0_ns) - t0_ns, min(e, t1_ns) - t0_ns) for s, e in dev])
    out = {
        "span_s": (t1_ns - t0_ns) * 1e-9,
        "device_ops": len(dev),
        "by_name": dict(by_name),
        "busy": busy,
    }
    if name_gaps:
        out["idle_gaps"] = _name_gaps(gaps(busy, t1_ns - t0_ns), cpu, t0_ns)
    return out


def merge(intervals) -> List[List[int]]:
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: List[List[int]], span: int) -> List[Tuple[int, int]]:
    out, cur = [], 0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if span > cur:
        out.append((cur, span))
    return out


def busy_s(chains: List[List[List[int]]]) -> float:
    """Seconds in which any chain's device operation ran."""
    return sum(e - s for s, e in merge(i for c in chains for i in c)) * 1e-9


def _open_at(points: List[int], events: List[Tuple[int, int, str]]) -> List[str]:
    """For each time of `points` (ascending), the latest-started event of
    `events` open then, or '-'."""
    events = sorted(events)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "-")
    return out


def _name_gaps(idle, cpu, t0_ns) -> List[List]:
    mids = [t0_ns + (a + b) // 2 for a, b in idle]
    inner = _open_at(mids, [c for c in cpu if c[2] not in SPANS])
    outer = _open_at(mids, [c for c in cpu if c[2] in SPANS])
    by: Dict[str, float] = defaultdict(float)
    for (a, b), o, i in zip(idle, outer, inner):
        by[f"{o}/{i}"] += (b - a) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def top_ops(by_name: Dict[str, List[float]]) -> List[List]:
    """The device operations with the most seconds, names cut to 100."""
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return [[k[:100], v[1]] for k, v in ranked]


def summed(traces: List[Dict]) -> Dict:
    """The chains' traces added up: device operations, seconds by name,
    launches, windows and evaluations."""
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    launches: Dict[str, int] = defaultdict(int)
    for t in traces:
        for k, (n, sec) in t["by_name"].items():
            by_name[k][0] += n
            by_name[k][1] += sec
        for k, n in t["launches"].items():
            launches[k] += n
    return {"device_ops": sum(t["device_ops"] for t in traces),
            "by_name": dict(by_name), "launches": dict(launches),
            "windows": sum(t["windows"] for t in traces),
            "evals": sum(t["evals"] for t in traces)}
