"""One chain of the fleet: a process that solves its windows one after another.

    python3 -m benchmark.chain        (started by `benchmark/run.py`)

The chain reads its orders as JSON lines on standard input and answers in
JSON lines on the standard output it was started with; whatever the
program prints goes to standard error. The exchange:

1. orders: the cell's configuration and mix, the chain's number, the
   seed, the device, whether to trace. The chain loads the program and
   reaches the card; then, told that the program is `built`, it stages
   its windows through the port's staging, solves its first window from a
   zero prior and the next as a handover window (every shape and kernel
   of the loop is then loaded), and answers `ready`.
2. `go` with the common start and the deadline (`time.monotonic()`,
   one clock for every process of the host): it solves window after
   window, each from the last one's final theta pyramid, until the
   deadline has passed, then waits for the card and answers `done` with
   each window's host-clock time, its BFGS evaluations and host reads,
   the card memory it held and when it finished. In a traced run every
   chain runs under `torch.profiler` from the start until the window in
   flight `profile_seconds` later ends (chain 0 with its host operations,
   to name the card's idle gaps).
3. `compare`: it frees the program's state and runs the plain reference
   on a sample of its windows drawn from the seed (`compare.py`), works
   out each window's AEE, reduces its trace, and answers `final`.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from typing import Callable, Dict, List

import torch

from benchmark import compare, trace, traffic

T_IMPORTED = time.monotonic()
BANNED = ("jax", "jaxlib", "flax", "eincm_tpu")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Chain:
    def __init__(self, orders: Dict):
        self.config = orders["config"]
        self.mix = orders["mix"]
        self.device = torch.device(orders["device"])
        self.trace = bool(orders["trace"])
        self.host_ops = self.trace and orders["chain"] == 0
        self.plan = traffic.ChainPlan(self.mix, self.config, orders["seed"], orders["chain"])

    def start(self) -> None:
        """Load the program and reach the card."""
        from eincm_tpu_torch.data import staging  # noqa: F401
        from eincm_tpu_torch.experiments import config  # noqa: F401
        from eincm_tpu_torch.models import pyramid  # noqa: F401

        self.t_cuda = time.monotonic()
        torch.zeros(1, device=self.device)
        self.t_built = time.monotonic()

    def setup(self) -> Dict:
        """Stage the chain's windows and warm up (once the program is
        built)."""
        from eincm_tpu_torch.data import staging
        from eincm_tpu_torch.experiments import config as port_config
        from eincm_tpu_torch.models import pyramid

        t_staging = time.monotonic()
        exp = port_config.ExperimentConfig.from_dict(self.config["experiment"])
        self.scfg = exp.solver_config()
        edge_fn = exp.edge.make_edge_fn()
        self.raw = [self.plan.window(k) for k in range(self.plan.n_windows)]
        self.windows = [
            staging.stage_datasample(ds, self.device, edge_fn=edge_fn,
                                     preprocess=exp.edge.enable_image_preprocessing,
                                     pad_to=exp.dataset.des_n_events).window
            for ds in self.raw]
        _sync(self.device)
        t_warm = time.monotonic()
        self.solver = pyramid.make_window_solver(self.scfg, self.device)
        prior = self.scfg.zero_pyramid(device=self.device)
        for step in (0, 1):
            res, _ = self._solve(step, prior)
            prior = res.final_theta_pyr
        if self.trace:  # the profiler's first start costs seconds: pay it here
            with self._profiler():
                torch.ones(8, device=self.device).sum()
        _sync(self.device)
        self.prior = prior
        t_ready = time.monotonic()
        return {"imported": T_IMPORTED, "cuda_s": self.t_built - self.t_cuda,
                "wait_s": t_staging - self.t_built, "stage_s": t_warm - t_staging,
                "warm_s": t_ready - t_warm}

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host_ops else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts or [ProfilerActivity.CPU])

    def _solve(self, step: int, prior):
        """Solve the window at `step` of the walk from `prior`; the answer
        is the flow at the sensor, the level-0 theta upscaled."""
        from eincm_tpu_torch.ops import resize
        from torch.profiler import record_function

        k = self.plan.position(step)
        with record_function("solve"):
            res = self.solver(self.windows[k], prior, is_first=(step == 0))
        with record_function("flow"):
            flow = resize.scale_theta_to_sensor_size(
                res.final_theta_pyr[0], self.scfg.sensor_size,
                self.scfg.scale_to_sensor_size_method)
        return res, flow

    def run(self, t0: float, deadline: float) -> Dict:
        """Solve until the deadline; each window's record and results."""
        from eincm_tpu_torch.ops import _build

        self.results, self.records, self.priors = [], [], []
        self.profile = None
        prior, step = self.prior, 2
        prof = None
        time.sleep(max(0.0, t0 - time.monotonic()))
        if self.trace:
            # the traced span in the profiler's time base (unix ns)
            span0 = time.time_ns() + int((t0 - time.monotonic()) * 1e9)
            span1 = span0 + int(float(self.mix["profile_seconds"]) * 1e9)
            counts0 = _build.launch_counts()
            prof = self._profiler()
            prof.start()
        while time.monotonic() < deadline:
            ta = time.perf_counter()
            res, flow = self._solve(step, prior)
            tb = time.perf_counter()
            states = res.theta_opt_states
            self.records.append({
                "k": self.plan.position(step),
                "ms": (tb - ta) * 1e3,
                "evals": int(sum(s.n_fun_evals for s in states)),
                "syncs": int(res.n_host_syncs),
                "status0": int(states[0].status),
                "profiled": prof is not None,
            })
            self.results.append((res, flow))
            self.priors.append(prior[0])
            prior = res.final_theta_pyr
            step += 1
            if prof is not None and time.time_ns() >= span1:
                _sync(self.device)
                prof.stop()
                self.profile = (prof, span0, span1, counts0, _build.launch_counts())
                prof = None
        _sync(self.device)
        t_end = time.monotonic()
        if prof is not None:  # the deadline came first
            span1 = min(span1, time.time_ns())
            prof.stop()
            self.profile = (prof, span0, span1, counts0, _build.launch_counts())
        mem = (torch.cuda.max_memory_reserved(self.device)
               if self.device.type == "cuda" else 0)
        return {"records": self.records, "t_end": t_end, "memory_bytes": int(mem),
                "banned": banned_modules()}

    def finish(self, control: bool) -> Dict:
        """After every chain's window: the trace, then, with the program's
        state freed, the AEE and the reference's check. With `control`,
        also the control's readings (`compare.py`) and the AEE of each
        window's prior, the answer of a solve that returns its prior."""
        out = {}
        t_trace = time.monotonic()
        if self.profile is not None:
            prof, span0, span1, c0, c1 = self.profile
            self.profile = None
            summary = trace.reduce(prof.profiler.kineto_results.events(), span0, span1,
                                   name_gaps=self.host_ops)
            summary["launches"] = {k: c1[k] - c0[k] for k in c1}
            recs = [r for r in self.records if r["profiled"]]
            summary["windows"] = len(recs)
            summary["evals"] = sum(r["evals"] for r in recs)
            out["trace"] = summary
            del prof
        kept = [(rec["k"], res.theta_opt_states,
                 [tuple(t.shape) for t in res.final_theta_pyr], res.final_theta_pyr[0], flow)
                for rec, (res, flow) in zip(self.records, self.results)]
        program_edges = [w.edges for w in self.windows]
        priors = self.priors
        del self.results, self.windows, self.solver, self.prior, self.priors
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        checker = compare.Checker(self.config, self.raw, self.device)
        out["aee"] = [checker.aee(k, th0, self.plan.velocity(k)) for k, _, _, th0, _ in kept]
        if control:
            out["aee_prior"] = [checker.aee(k, p0, self.plan.velocity(k))
                                for (k, _, _, _, _), p0 in zip(kept, priors)]
        del priors
        out["failed"] = sum(1 for (_, _, _, th0, _), r in zip(kept, self.records)
                            if r["status0"] == 3 or not bool(torch.isfinite(th0).all()))
        t_check = time.monotonic()
        sample = self.plan.compare_sample(len(kept))
        out["compared"] = checker.check([kept[i] for i in sample], control, program_edges)
        out["seconds"] = {"trace": t_check - t_trace, "check": time.monotonic() - t_check}
        return out


def serve(orders: Dict, recv: Callable[[], Dict], send: Callable[[Dict], None]) -> None:
    """One chain's side of the exchange (module docstring)."""
    try:
        torch.set_num_threads(1)
        chain = Chain(orders)
        chain.start()
        recv()  # the program is built
        send({"ready": chain.setup()})
        go = recv()
        send({"done": chain.run(go["t0"], go["deadline"])})
        msg = recv()
        send({"final": chain.finish(bool(msg.get("control")))})
    except Exception:  # noqa: BLE001 - the parent reports it and stops the run
        send({"error": traceback.format_exc()})
        raise


def main() -> int:
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the program's prints go to standard error
    sys.stdout = sys.stderr

    def send(msg: Dict) -> None:
        proto.write(json.dumps(msg) + "\n")
        proto.flush()

    def recv() -> Dict:
        line = sys.stdin.readline()
        if not line:
            raise EOFError("the harness closed the orders")
        return json.loads(line)

    try:
        serve(recv(), recv, send)
    except Exception:  # noqa: BLE001 - already reported to the parent
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
