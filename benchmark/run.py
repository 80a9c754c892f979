"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...`), from the root of a checkout. The
cell's chains (`chain.py`) start as processes of their own, stage and warm
up; the measured window then runs for `--seconds`, and every chain
finishes the window it has in flight at the deadline. Standard error gets
the run's diagnostics and, last, each number the check compared beside
its limit; the last line of standard output is the result:
`{"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}`.
With `--trace 0` the metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, every chain under `torch.profiler` for
the mix's first `profile_seconds`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = str(ROOT)  # run as a file: import `benchmark` from the root

# every build and kernel cache at a fixed path in the checkout: the port
# builds into eincm_tpu_torch/_build/; these take the caches of a kernel
# built with torch's extensions or Triton, which this file cannot be
# edited to add later
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))

from benchmark import spec  # noqa: E402
from benchmark import trace as trace_mod  # noqa: E402
from benchmark import traffic  # noqa: E402

READY_S = 900.0  # set-up of every chain, the first run's builds included
AFTER_S = 240.0  # the window in flight at the deadline; the check
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


class ChainProcess:
    """A chain in a process of its own, spoken to through its pipes."""

    def __init__(self, orders: Dict):
        env = dict(os.environ, **CHILD_ENV)
        env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.chain"], cwd=str(ROOT), env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.inbox: "queue.Queue" = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.send(orders)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.inbox.put(json.loads(line))
        self.inbox.put({"error": f"chain process ended (exit {self.proc.wait()})"})

    def send(self, msg: Dict) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def recv(self, timeout: float) -> Dict:
        return self.inbox.get(timeout=timeout)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)


class ChainThread:
    """A chain in a thread of this process (the tests' way to break the
    program underneath a run)."""

    def __init__(self, orders: Dict):
        self.to_chain: "queue.Queue" = queue.Queue()
        self.inbox: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(
            target=self._serve, args=(orders,), daemon=True)
        self.thread.start()

    def _serve(self, orders: Dict) -> None:
        from benchmark import chain

        try:
            chain.serve(orders, self.to_chain.get, self.inbox.put)
        except Exception:  # noqa: BLE001 - serve() reported it
            pass

    def send(self, msg: Dict) -> None:
        self.to_chain.put(msg)

    def recv(self, timeout: float) -> Dict:
        return self.inbox.get(timeout=timeout)

    def close(self) -> None:
        self.thread.join(timeout=60)


def _expect(chains, key: str, timeout: float) -> List[Dict]:
    end = time.monotonic() + timeout
    out = []
    for i, c in enumerate(chains):
        try:
            msg = c.recv(max(1.0, end - time.monotonic()))
        except queue.Empty:
            raise RuntimeError(f"chain {i}: no {key!r} within {timeout:.0f} s") from None
        if key not in msg:
            raise RuntimeError(f"chain {i} failed:\n{msg.get('error', msg)}")
        out.append(msg[key])
    return out


def build_program(device: str) -> float:
    """Build the port's CUDA kernels and its native host library before the
    chains start, so that they only load them."""
    t0 = time.perf_counter()
    from eincm_tpu_torch.native import build as native_build

    native_build.build()
    if device.startswith("cuda"):
        from eincm_tpu_torch.ops import _build

        _build.build_all()
    return time.perf_counter() - t0


class NoDevice(RuntimeError):
    pass


def check_device(device: str, chips: int) -> None:
    import torch

    if device.startswith("cuda") and (not torch.cuda.is_available()
                                      or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"the cell needs {chips} CUDA device(s); {found} found")


def run_cell(cell: "spec.Cell", seed: int, seconds: float, trace: bool, device: str = "cuda:0",
             launch=ChainProcess, control: bool = False, t_start: float = None) -> Dict:
    """One run of `cell`: the raw readings of every chain (`assemble`
    turns them into the result). The chains start first and import while
    this process checks the card and builds the program."""
    t_start = T_START if t_start is None else t_start
    t_spawn = time.monotonic()
    n = int(cell.mix["chains"])
    chains = []
    try:
        for c in range(n):
            chains.append(launch({"config": cell.config, "mix": cell.mix, "chain": c,
                                  "seed": int(seed), "device": device, "trace": bool(trace)}))
        check_device(device, cell.chips)
        build_s = build_program(device)
        for c in chains:
            c.send({"built": True})
        ready = _expect(chains, "ready", READY_S)
        setup_s = time.perf_counter() - t_start
        t0 = time.monotonic() + 0.2
        for c in chains:
            c.send({"t0": t0, "deadline": t0 + seconds})
        done = _expect(chains, "done", seconds + AFTER_S)
        for c in chains:
            c.send({"control": control})
        t_check = time.monotonic()
        final = _expect(chains, "final", AFTER_S)
        t_closing = time.monotonic()
    finally:
        for c in chains:
            c.close()
    print(f"[bench] check {t_closing - t_check:.2f} s, chains' exit "
          f"{time.monotonic() - t_closing:.2f} s", file=sys.stderr)
    return SimpleNamespace(cell=cell, seed=seed, t0=t0, setup_s=setup_s, build_s=build_s,
                           t_spawn=t_spawn, ready=ready, done=done, final=final, device=device)


def torch_index(device: str) -> int:
    return int(device.split(":")[1]) if ":" in device else 0


JUDGED = ("program", "control", "prior")


def compared_numbers(run, judged: str = "program") -> Dict[str, float]:
    """The numbers the check compares, each the largest over the chains:
    the reference's three on the sample (`compare.py`), `tv_rel` and
    `tv_grad_rel` where the configuration sets gamma, and `aee_max`, the
    largest AEE of any window the run completed.

    `judged` says whose they are: the program's; the control's, the plain
    reference in bfloat16 put in the program's place (at the program's
    thetas, so `aee_max` stays the program's); or a solve that hands back
    its prior unchanged (every window's answer its prior, the rest as the
    program's). The last two need a run made with `control`."""
    from benchmark import compare

    if judged not in JUDGED:
        raise ValueError(f"judged must be one of {JUDGED}")
    src = "control" if judged == "control" else None
    compared = [f["compared"][src] if src else f["compared"] for f in run.final]
    names = compare.NUMBERS + tuple(n for n in compare.TV_NUMBERS if n in compared[0])
    out = {name: max(c[name] for c in compared) for name in names}
    aees = [a for f in run.final for a in f["aee_prior" if judged == "prior" else "aee"]]
    out["aee_max"] = compare.finite_max(aees) if aees else math.inf
    return out


def assemble(run, trace: bool, judged: str = "program") -> Dict:
    """The result line of a run (module docstring); `judged` as in
    `compared_numbers`, for the readings of the check's limits."""
    cell = run.cell
    records = [r for d in run.done for r in d["records"]]
    n_windows = len(records)
    t_end = max(d["t_end"] for d in run.done)
    aees = [a for f in run.final for a in f["aee"]]
    failed = sum(f["failed"] for f in run.final)
    numbers = compared_numbers(run, judged)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    compared = sum(f["compared"]["windows"] for f in run.final)
    correct = (compared > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        run.trace = card_trace(run.final)
        run.records = [d["records"] for d in run.done]
        run.shape = shape(cell.config)
        values = {m["name"]: spec.reader(m["name"])(run) for m in cell.per_layer}
    else:
        values = {"windows_per_s": n_windows / (t_end - run.t0),
                  "aee_px": sum(aees) / len(aees) if aees else float("nan"),
                  "setup_s": run.setup_s}
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    dev = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
           "kind": device_name(run.device), "count": 1,
           "memory_peak_bytes": sum(d["memory_bytes"] for d in run.done)}
    out = {"correct": bool(correct), "attempted": n_windows, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["span_s"]
        out["breakdown"] = {"device_ops": trace_mod.top_ops(run.trace["by_name"]),
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def card_trace(final: List[Dict]):
    """Every chain's trace added up, with the card's busy seconds (the
    union of all chains' device intervals) over the common traced span."""
    traces = [f["trace"] for f in final if "trace" in f]
    if not traces:
        return None
    span = min(t["span_s"] for t in traces)
    end = int(span * 1e9)
    out = trace_mod.summed(traces)
    out["span_s"] = span
    out["busy_s"] = trace_mod.busy_s(
        [[[s, min(e, end)] for s, e in t["busy"] if s < end] for t in traces])
    out["idle_gaps"] = traces[0].get("idle_gaps", [])
    return out


def shape(config: Dict):
    """(frames, events, H, W) of a configuration's windows."""
    ds = config["experiment"]["dataset"]
    h, w = ds["sensor_size"]
    return traffic.frames_per_window(config), int(ds["des_n_events"]), int(h), int(w)


def device_name(device: str) -> str:
    import torch

    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch_index(device))
    return "cpu"


def report(run, result: Dict) -> None:
    """Diagnostics, then the compared numbers last, on standard error."""
    err = sys.stderr
    rd = run.ready
    print(f"[bench] {run.cell.name} seed {run.seed}: build {run.build_s:.1f} s, set-up "
          f"{run.setup_s:.2f} s; chains' imports {[round(r['imported'] - run.t_spawn, 2) for r in rd]}"
          f" s, CUDA {[round(r['cuda_s'], 2) for r in rd]} s, waiting {[round(r['wait_s'], 2) for r in rd]} s, staging "
          f"{[round(r['stage_s'], 2) for r in rd]} s, warm-up {[round(r['warm_s'], 2) for r in rd]} s",
          file=err)
    ends = [d["t_end"] - run.t0 for d in run.done]
    print(f"[bench] chains end {[round(e, 3) for e in ends]} s after the start; sum of the "
          f"chains' rates {sum(len(d['records']) / e for d, e in zip(run.done, ends))!r} "
          f"windows/s", file=err)
    for i, d in enumerate(run.done):
        recs = d["records"]
        print(f"[bench] chain {i}: {len(recs)} windows, "
              f"{sum(r['ms'] for r in recs) / max(1, len(recs)):.1f} ms a window, "
              f"{sum(r['evals'] for r in recs)} evals; windows {[r['k'] for r in recs]}", file=err)
    for i, f in enumerate(run.final):
        c = f["compared"]
        print(f"[bench] chain {i} check: {c['windows']} windows, {c['levels']} levels, "
              f"{f['seconds']}; "
              + ", ".join(f"{k} {v!r}" for k, v in c.items() if k not in ("windows", "levels")),
              file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell.named(args.workload)
    try:
        run = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"[bench] {args.workload}: {e}", file=sys.stderr)
        return 2
    except (RuntimeError, ImportError) as e:
        print(f"[bench] run failed: {e}", file=sys.stderr)
        return 1
    from benchmark.chain import banned_modules

    banned = sorted(set(banned_modules()).union(
        *[d["banned"] for d in run.done]))
    if banned:
        print(f"[bench] JAX or the JAX package loaded: {banned}", file=sys.stderr)
        return 3
    result = assemble(run, bool(args.trace))
    report(run, result)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
