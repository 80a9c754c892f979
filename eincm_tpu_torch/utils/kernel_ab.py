"""Time the splat forward and backward, the fused warp+splat kernels (7
and 8), the dense-layout interp (kernel 9) and the coarse-theta interp
(kernels 1 and 2) of one source tree, so that two commits can be timed in
turns on one card.

    python3 eincm_tpu_torch/utils/kernel_ab.py --tree DIR --label NAME \
        [--out FILE] [--sweep [interp] [splat_bwd] [fused]] [--chains N]

Imports `eincm_tpu_torch` from DIR (a checkout or a `git archive` of any
commit that has these entry points) and builds its kernels there. Inputs,
the same in every tree: the splat at the MVSEC shape (staged window 0 at
its ground-truth flow, 2 refs x 30k events, 256x336), the DSEC shape (the
staged 1.5M-event window, 2 refs, 480x640) and the fused bench's uniform
events (2 refs, 480x640), forward and, with a seeded cotangent, backward
(`splat_bwd_*`), both also with a 5x5 window where the tree takes one
(`*_w5`); kernels 7 and 8 on window 0's events with its 16x16 GT theta and
on the fused bench's 1.5M events, for window sizes 3 and 5
(`fused_{7,8}_*`); kernel 9 (`highest`, `dot3`, `bf16`) on window 0's
events and on the dense-interp bench's 1.5M events, beside kernel 1 and
`F.grid_sample`. Where the tree has the splat's slab plan, the splat is
also timed at several tile budgets (and, at MVSEC, event chunks): time
that grows with the number of slabs is time spent re-reading events. The
interp forward and backward are timed at the chain's five grids (1x1 to
16x16) on both staged windows' events, beside `F.grid_sample` and
`torch.einsum` at 16x16. Where the tree has the direct kernels of float64
and the wrap-compat splat (`csrc/direct.cu`), they are timed at both
staged windows' shapes (`direct_*`).

`--chains N` also solves the MVSEC handover chain N times with the
tree's solver, reading the launch counters around each run: launches per
loss evaluation of each chain kernel, the evaluations and the mean AEE of
windows 1..5 (`chains`). A tree whose splat forward adds its tiles as
float atomics varies from run to run with their order; one whose forward
sums exactly (64-bit fixed point) repeats bitwise.

`--sweep` names what else to time (no name: all three), each where the
tree has the plan: `interp`, the interp kernels over `plan_interp`'s
choices (events in groups of four or one by one, threads, blocks per SM,
theta staged or gathered, the backward's modes up to 64x64); `splat_bwd`,
the backward with its events as staged, sorted by texel and permuted (what
the gather's locality is worth), both its kernels over threads and blocks
per SM, and both on the first 2^14 to 2^20 events (where one overtakes
the other); `fused`, kernel 8 and, where the tree plans it, kernel 7 over
`plan_fused`'s choices (cluster size, threads, chunks, events per round,
queues of the least size) on their events as they are and permuted, and
both kernels of each on the first 2^14 to 2^20 permuted events.

Times are device ms per call from CUDA events (the tree's
`utils/profiling.cuda_ms`). Prints the card, one line per time and one
JSON line; exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import sys
from pathlib import Path


SWEEPS = ("interp", "splat_bwd", "fused")


def _grid_sample(theta, xs, ys, sensor):
    """interp fwd as one `F.grid_sample` call at the rounded coordinates
    (chip_smoke.py's yardstick)."""
    import torch
    import torch.nn.functional as F

    H, W = sensor
    img = theta.permute(2, 0, 1)[None].contiguous()
    gx = (torch.round(xs) + 0.5) * (2.0 / W) - 1.0
    gy = (torch.round(ys) + 0.5) * (2.0 / H) - 1.0
    grid = torch.stack([gx, gy], -1)[None, None]
    return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)


def sweep_splat_bwd(sk, splat_in, cot, timed, res):
    """The splat backward's gather of 9 cotangent texels per event, by the
    order of the events: as staged, sorted by (round(y), round(x)) so that
    neighbouring threads read neighbouring texels, and randomly permuted;
    on the crowded (staged) and the uniform DSEC events and at MVSEC. Where
    the tree has `plan_splat_bwd`, also over the plan's choices: both
    kernels' threads and blocks per SM, the stream kernel with and without
    its float4s."""
    import dataclasses

    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    for tag in ("dsec", "dsec_uniform", "mvsec"):
        wx, wy, sensor = splat_in[tag]
        G = cot[tag]
        R, E = wx.shape
        orders = {
            "sorted": torch.argsort(torch.round(wy) * 4096.0 + torch.round(wx), dim=1),
            "permuted": torch.stack([torch.randperm(E, generator=gen, device=wx.device)
                                     for _ in range(R)]),
        }
        inputs = {"staged": (wx, wy)}
        for name, order in orders.items():
            inputs[name] = (torch.gather(wx, 1, order).contiguous(),
                            torch.gather(wy, 1, order).contiguous())
        for name, (ox, oy) in inputs.items():
            timed(f"sweep_splat_bwd_{tag}_{name}",
                  lambda: sk.splat_bwd_cuda(ox, oy, G, sensor))
        if not hasattr(sk, "plan_splat_bwd"):
            continue
        for name, (ox, oy) in inputs.items():
            for kernel, sizes in (("gather", (128, 256, 512, 1024)),
                                  ("stream", (64, 128, 256, 512))):
                for threads in sizes:
                    for per_sm in (1, 2, 4, 8, 16):
                        if threads * per_sm > 2048:
                            continue
                        blocks = sk.N_SM * per_sm // (R if kernel == "stream" else 1)
                        p = sk.plan_splat_bwd(R, E, *sensor, kernel, threads, blocks)
                        key = f"sweep_splat_bwd_{tag}_{name}_{kernel}_{threads}t_{p.blocks}b"
                        timed(key, lambda: sk.splat_bwd_cuda(ox, oy, G, sensor, plan=p))
            p = dataclasses.replace(sk.plan_splat_bwd(R, E, *sensor, "stream"), vec=False)
            timed(f"sweep_splat_bwd_{tag}_{name}_stream_scalar",
                  lambda: sk.splat_bwd_cuda(ox, oy, G, sensor, plan=p))
        if tag != "dsec":
            continue
        # where the stream kernel overtakes the gather kernel: the first n
        # events of each ref
        for n in (1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
            ox, oy = wx[:, :n].contiguous(), wy[:, :n].contiguous()
            for kernel in ("gather", "stream"):
                p = sk.plan_splat_bwd(R, n, *sensor, kernel)
                timed(f"sweep_splat_bwd_{tag}_first{n}_{kernel}",
                      lambda: sk.splat_bwd_cuda(ox, oy, G, sensor, plan=p))


def sweep_fused(sf, ti, fused_in, timed, res):
    """Kernel 8 over its plan's choices (cluster size, threads, chunks,
    events per thread and round), and with its events permuted: events
    sorted by row add into their own block's tile, permuted events travel
    to a sibling's queue seven times in eight. With queues of the least
    size most permuted events find theirs full and go into the sibling's
    tile by remote atomics, one by one. The same for kernel 7, on the same
    stage with the events' velocities as inputs, where the tree's
    `fused_warp_splat_cuda` takes a plan."""
    import dataclasses

    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    plans = res.setdefault("plans", {})
    kernels = (8, 7) if "plan" in inspect.signature(sf.fused_warp_splat_cuda).parameters else (8,)
    for tag, (xi, yi, ts, theta, t_ref, sensor) in fused_in.items():
        E = xi.shape[0]
        th = ti.interp_fwd_cuda(theta, xi, yi, sensor)
        thx, thy = th[:, 0].contiguous(), th[:, 1].contiguous()
        order = torch.randperm(E, generator=gen, device=xi.device)
        inputs = {"staged": (xi, yi, ts, thx, thy),
                  "permuted": tuple(a[order].contiguous() for a in (xi, yi, ts, thx, thy))}

        def run(k, key, ev, ws, n=E, **choices):
            h, w = theta.shape[:2] if k == 8 else (0, 0)
            try:
                p = sf.plan_fused(n, *sensor, h, w, **choices)
            except ValueError:
                return  # does not fit a block's shared memory
            key = f"sweep_fused_{k}_{tag}_{key}_w{ws}_{p.kernel}_{p.threads}t_{p.chunks}chunks"
            if p.kernel == "cluster":
                key += (f"_cluster{p.cluster}_{p.per_thread}each_{p.queue}queue_"
                        f"{p.bands}bands")
            plans[key] = dataclasses.asdict(p)
            if k == 8:
                timed(key, lambda: sf.fully_fused_warp_splat_cuda(
                    *ev[:3], theta, t_ref, sensor, ws, p))
            else:
                timed(key, lambda: sf.fused_warp_splat_cuda(*ev, t_ref, sensor, ws, plan=p))

        for k in kernels:
            h, w = theta.shape[:2] if k == 8 else (0, 0)
            for ws in (3, 5):
                plans[f"fused_{k}_{tag}_w{ws}"] = dataclasses.asdict(
                    sf.card_plan(E, *sensor, h, w, ws))
            for name, ev in inputs.items():
                base = sf.plan_fused(E, *sensor, h, w, "cluster")
                for ws in (3, 5):
                    run(k, name, ev, ws, kernel="scatter")
                    for S in (1, 2, 4, 8):
                        for threads in (256, 512, 1024):
                            run(k, name, ev, ws, kernel="cluster", cluster=S, threads=threads)
                    for chunks in sorted({1, max(1, base.chunks // 4), max(1, base.chunks // 2),
                                          base.chunks - 2, base.chunks - 1, base.chunks + 1,
                                          2 * base.chunks, 4 * base.chunks} - {0, -1}):
                        for threads in (256, 512, 1024):
                            run(k, name, ev, ws, kernel="cluster", chunks=chunks,
                                threads=threads)
                    for per_thread in (1, 2, 3, 4, 6, 8):
                        run(k, name, ev, ws, kernel="cluster", per_thread=per_thread)
                    run(k, name + "_full_queues", ev, ws, kernel="cluster", queue=sf.MIN_QUEUE)
            if tag != "dsec":
                continue
            # where the cluster kernel overtakes the scatter kernel: the first
            # n of the permuted events (spread over the frame, in no order)
            for n in (1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
                ev = tuple(a[:n].contiguous() for a in inputs["permuted"])
                for kernel in ("scatter", "cluster"):
                    run(k, f"first{n}", ev, 3, n=n, kernel=kernel)


def time_direct(sk, ti, splat_in, cot, theta, timed):
    """The direct kernels at both staged windows' shapes: the splat forward
    and backward in float64 and with the wrap in float32, and the interp
    forward and backward in float64 on the 16x16 theta."""
    import torch

    for tag in ("mvsec", "dsec"):
        wx, wy, sensor = splat_in[tag]
        G = cot[tag]
        wx64, wy64, G64 = wx.double(), wy.double(), G.double()
        timed(f"direct_splat_fwd_{tag}_f64", lambda: sk.splat_direct_fwd_cuda(wx64, wy64, sensor))
        timed(f"direct_splat_bwd_{tag}_f64",
              lambda: sk.splat_direct_bwd_cuda(wx64, wy64, G64, sensor))
        timed(f"direct_splat_fwd_{tag}_wrap_f32",
              lambda: sk.splat_direct_fwd_cuda(wx, wy, sensor, 3, True))
        timed(f"direct_splat_bwd_{tag}_wrap_f32",
              lambda: sk.splat_direct_bwd_cuda(wx, wy, G, sensor, 3, True))
        # the unwarped coordinates of ref 0 stand in for the events
        xs, ys = wx64[0].contiguous(), wy64[0].contiguous()
        th64 = theta.double()
        g = torch.ones(xs.shape[0], 2, dtype=torch.float64, device=xs.device)
        timed(f"direct_interp_fwd_{tag}_f64", lambda: ti.interp_direct_fwd_cuda(th64, xs, ys, sensor))
        timed(f"direct_interp_bwd_{tag}_f64",
              lambda: ti.interp_direct_bwd_cuda(g, xs, ys, tuple(th64.shape), sensor))


def run_chains(n, device, windows, vels, _build, wl):
    """n runs of the MVSEC handover chain through the tree's
    `make_window_solver`, each with the launch counters read around it."""
    import numpy as np
    import torch

    from eincm_tpu_torch.models.pyramid import make_window_solver

    cfg = wl.mvsec_solver_config()
    solver = make_window_solver(cfg, device)
    runs = []
    for r in range(n):
        _build.reset_launch_counts()
        recs = [rec for _, rec in wl.solve_chain(solver, cfg, windows, vels)]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        evals = sum(rec["evals"] for rec in recs)
        run = {"evals": evals, "mean_aee": float(np.mean([rec["aee"] for rec in recs[1:]])),
               "launches": {k: counts[k] for k in
                            ("interp_fwd", "interp_bwd", "splat_fwd", "splat_bwd")}}
        run["per_eval"] = {k: v / evals for k, v in run["launches"].items()}
        print(f"chain {r}: {evals} evaluations, launches per evaluation "
              f"{[round(v, 4) for v in run['per_eval'].values()]}, AEE {run['mean_aee']:.4f}")
        runs.append(run)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True, help="source tree to time")
    ap.add_argument("--label", required=True, help="name of the run in the output")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    ap.add_argument("--sweep", nargs="*", choices=SWEEPS, default=None,
                    help="also time these kernels over their launch plans' choices "
                         "(no name: all of them)")
    ap.add_argument("--chains", type=int, default=0,
                    help="also solve the MVSEC chain this many times, counting launches")
    args = ap.parse_args(argv)
    sweeps = set(SWEEPS if args.sweep == [] else args.sweep or ())
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import eincm_tpu_torch
    from eincm_tpu_torch.experimental import fused_splat_bench as fb
    from eincm_tpu_torch.experimental import interp_proto as ip
    from eincm_tpu_torch.experimental import splat_fused as sf
    from eincm_tpu_torch.models.loss import _sanitize_events
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.ops import interp as ti
    from eincm_tpu_torch.ops import splat_kernel as sk
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse
    from eincm_tpu_torch.utils import workloads as wl
    from eincm_tpu_torch.utils.profiling import card, cuda_ms

    pkg = Path(eincm_tpu_torch.__file__).resolve().parent
    if pkg.parent != args.tree.resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {args.tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = card()
    print(f"[{args.label}] {name}; package {pkg}")
    _build.build_all()
    res = {"label": args.label, "card": name, "ms": {}}
    ms = res["ms"]

    def timed(key, fn, reps=20):
        ms[key] = cuda_ms(fn, reps)
        print(f"[{args.label}] {key}: {ms[key]:.4f} ms")

    mvsec, vels = wl.stage_mvsec_windows(device)
    dsec = wl.stage_dsec_window(device)
    shapes = {"mvsec": (mvsec[0], vels[0], (wl.MVSEC_H, wl.MVSEC_W)),
              "dsec": (dsec, (7.2 * math.cos(math.atan2(-4.0, 6.0)),
                              7.2 * math.sin(math.atan2(-4.0, 6.0))),
                       (wl.DSEC_H, wl.DSEC_W))}
    splat_in = {}
    for tag, (win, vel, sensor) in shapes.items():
        theta = torch.empty((16, 16, 2), device=device)
        theta[..., 0], theta[..., 1] = vel
        xs, ys, ts = _sanitize_events(win.xs, win.ys, win.ts)
        wx, wy = warp_events_multi_ref_coarse(theta, xs, ys, ts, win.edge_ts, sensor)
        splat_in[tag] = (wx.contiguous(), wy.contiguous(), sensor)
        if tag == "mvsec":
            interp_in = {"mvsec": (theta, xs.contiguous(), ys.contiguous(), sensor)}
    bench = fb.make_inputs(device)
    wx, wy = warp_events_multi_ref_coarse(bench["theta"], bench["xs"], bench["ys"],
                                          bench["ts"], bench["t_refs"], fb.SENSOR)
    splat_in["dsec_uniform"] = (wx.contiguous(), wy.contiguous(), fb.SENSOR)
    del bench
    theta, xs, ys = ip.make_inputs(device)
    interp_in["dsec"] = (theta, xs, ys, ip.SENSOR)

    window5 = "window_size" in inspect.signature(sk.splat_fwd_cuda).parameters
    for tag, (wx, wy, sensor) in splat_in.items():
        timed(f"splat_fwd_{tag}", lambda: sk.splat_fwd_cuda(wx, wy, sensor))
        if window5:
            timed(f"splat_fwd_{tag}_w5", lambda: sk.splat_fwd_cuda(wx, wy, sensor, 5))
    if hasattr(sk, "plan_splat"):
        # tile budgets (KB) x event chunks (None: the plan's own)
        budgets_by_tag = {"mvsec": ((227, 113, 56, 28), (None, 1, 16)),
                          "dsec": ((227, 113, 56, 28), (None,))}
        res["plans"] = {}
        for tag, (budgets, chunk_counts) in budgets_by_tag.items():
            wx, wy, sensor = splat_in[tag]
            R, E = wx.shape
            for kb in budgets:
                base = sk.plan_splat(R, E, *sensor, smem_budget=min(kb * 1024, sk.SMEM_MAX))
                for c in chunk_counts:
                    p = base if c is None else dataclasses.replace(base, chunks=c)
                    key = f"splat_fwd_{tag}_{kb}k_{p.row_slabs}slabs_{p.chunks}chunks"
                    res["plans"][key] = dataclasses.asdict(p)
                    timed(key, lambda: sk.splat_fwd_cuda(wx, wy, sensor, plan=p))
    # the splat backward (kernels 4 and 6) on the same inputs, with a seeded
    # cotangent, and the fused warp+splat kernels (7 and 8) at both shapes
    # and both window sizes
    gen = torch.Generator(device="cuda").manual_seed(1)
    cot = {}
    for tag, (wx, wy, sensor) in splat_in.items():
        cot[tag] = torch.randn(wx.shape[0], *sensor, generator=gen, device=device)
        G = cot[tag]
        timed(f"splat_bwd_{tag}", lambda: sk.splat_bwd_cuda(wx, wy, G, sensor))
        if window5:
            timed(f"splat_bwd_{tag}_w5", lambda: sk.splat_bwd_cuda(wx, wy, G, sensor, 5))
    w0 = mvsec[0]
    xs, ys, ts = _sanitize_events(w0.xs, w0.ys, w0.ts)
    bench = fb.make_inputs(device)
    fused_in = {
        "mvsec": (torch.round(xs), torch.round(ys), ts.contiguous(),
                  interp_in["mvsec"][0], float(w0.edge_ts[0]), shapes["mvsec"][2]),
        "dsec": (bench["xi"], bench["yi"], bench["ts"], bench["theta"],
                 bench["t_ref_values"][0], fb.SENSOR),
    }
    del bench
    for tag, (xi, yi, ts, theta, t_ref, sensor) in fused_in.items():
        th = ti.interp_fwd_cuda(theta, xi, yi, sensor)
        thx, thy = th[:, 0].contiguous(), th[:, 1].contiguous()
        for ws in (3, 5):
            timed(f"fused_7_{tag}_w{ws}",
                  lambda: sf.fused_warp_splat_cuda(xi, yi, ts, thx, thy, t_ref, sensor, ws))
            timed(f"fused_8_{tag}_w{ws}",
                  lambda: sf.fully_fused_warp_splat_cuda(xi, yi, ts, theta, t_ref, sensor, ws))
    if hasattr(sk, "splat_direct_fwd_cuda"):
        time_direct(sk, ti, splat_in, cot, interp_in["mvsec"][0], timed)
    if "splat_bwd" in sweeps:
        sweep_splat_bwd(sk, splat_in, cot, timed, res)
    if "fused" in sweeps and hasattr(sf, "plan_fused"):
        sweep_fused(sf, ti, fused_in, timed, res)
    del cot, fused_in
    for tag, (theta, xs, ys, sensor) in interp_in.items():
        for mode in ("highest", "dot3", "bf16"):
            timed(f"interp_dense_{mode}_{tag}",
                  lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, mode))
        timed(f"interp_fwd_{tag}", lambda: ti.interp_fwd_cuda(theta, xs, ys, sensor))
        timed(f"grid_sample_{tag}", _grid_sample(theta, xs, ys, sensor))
    # the coarse-theta interp (kernels 1 and 2) at the five grids of the
    # chain and both shapes, on the staged windows' events
    GRIDS = (1, 2, 4, 8, 16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, (win, _, sensor) in shapes.items():
        xs, ys, _ = _sanitize_events(win.xs, win.ys, win.ts)
        xs, ys = xs.contiguous(), ys.contiguous()
        E = xs.shape[0]
        g = torch.randn(E, 2, generator=gen, device=device)
        for n in GRIDS:
            theta = torch.randn(n, n, 2, generator=gen, device=device)
            timed(f"interp_fwd_{tag}_{n}x{n}", lambda: ti.interp_fwd_cuda(theta, xs, ys, sensor))
            timed(f"interp_bwd_{tag}_{n}x{n}",
                  lambda: ti.interp_bwd_cuda(g, xs, ys, (n, n, 2), sensor))
        timed(f"grid_sample_{tag}_16x16", _grid_sample(theta, xs, ys, sensor))
        uy = ti._axis_weights(ys, 16, 16, 16.0 / sensor[0], True)
        vx = ti._axis_weights(xs, 16, 16, 16.0 / sensor[1], True)
        timed(f"einsum_{tag}_16x16", lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g))
        del uy, vx
        if not ("interp" in sweeps and hasattr(ti, "plan_interp")):
            continue
        # the launch plan's choices: events one by one or in groups of four,
        # threads per block, blocks per SM (0: one trip per thread), and the
        # backward's mode
        offs = tuple(map(ti.float_offset, (xs, ys, g)))
        for n in GRIDS + (32, 64):
            theta = torch.randn(n, n, 2, generator=gen, device=device)
            for grouped in (True, False):
                work = -(-E // 4) if grouped else E
                for threads in (128, 256, 512, 1024):
                    for per_sm in (0, 1, 2, 4, 8):
                        full = -(-work // threads)
                        blocks = full if per_sm == 0 else min(full, ti.N_SM * per_sm)
                        if per_sm and blocks == full:
                            continue  # the same launch as per_sm == 0
                        key = f"{tag}_{n}x{n}_{'groups' if grouped else 'single'}_{threads}t_{blocks}b"
                        for mode in ("staged", "ldg") if n <= 16 and threads <= 512 else ():
                            p = ti.plan_interp(E, n, n, False, offs, mode, blocks, threads, grouped)
                            timed(f"sweep_fwd_{mode}_{key}",
                                  lambda: ti.interp_fwd_cuda(theta, xs, ys, sensor, p))
                        if blocks > 8 * ti.N_SM:
                            continue  # a partial grid per block: too many to sum
                        modes = ("registers",) if n <= 4 else (
                            ("fixed",) + getattr(ti, "EXACT_MODES", ("float",)))
                        for mode in modes if threads <= 512 or n > 4 else ():
                            try:
                                p = ti.plan_interp(E, n, n, True, offs, mode, blocks,
                                                   threads, grouped)
                            except ValueError:
                                continue  # too few threads to sum this grid
                            timed(f"sweep_bwd_{mode}_{key}",
                                  lambda: ti.interp_bwd_cuda(g, xs, ys, (n, n, 2), sensor, p))
    if args.chains:
        res["chains"] = run_chains(args.chains, device, mvsec, vels, _build, wl)
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(name)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
