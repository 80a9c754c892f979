"""Time the splat forward, the dense-layout interp (kernel 9) and the
coarse-theta interp (kernels 1 and 2) of one source tree, so that two
commits can be timed in turns on one card.

    python3 eincm_tpu_torch/utils/kernel_ab.py --tree DIR --label NAME \
        [--out FILE] [--sweep]

Imports `eincm_tpu_torch` from DIR (a checkout or a `git archive` of any
commit that has these entry points) and builds its kernels there. Inputs,
the same in every tree: the splat at the MVSEC shape (staged window 0 at
its ground-truth flow, 2 refs x 30k events, 256x336), the DSEC shape (the
staged 1.5M-event window, 2 refs, 480x640) and the fused bench's uniform
events (2 refs, 480x640); kernel 9 (`highest`, `dot3`, `bf16`) on
window 0's events with its 16x16 GT theta and on the dense-interp bench's
1.5M events, beside kernel 1 and `F.grid_sample`. Where the tree has the
splat's slab plan, the splat is also timed at several tile budgets (and,
at MVSEC, event chunks): time that grows with the number of slabs is time
spent re-reading events. The interp forward and backward are timed at the
chain's five grids (1x1 to 16x16) on both staged windows' events, beside
`F.grid_sample` and `torch.einsum` at 16x16; with `--sweep`, where the
tree has `plan_interp`, also over the plan's choices (events in groups of
four or one by one, threads, blocks per SM, theta staged or gathered, the
backward's modes up to 64x64).

Times are device ms per call from CUDA events (the tree's
`utils/profiling.cuda_ms`). Prints the card, one line per time and one
JSON line; exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True, help="source tree to time")
    ap.add_argument("--label", required=True, help="name of the run in the output")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the interp kernels over their launch plan's choices")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import eincm_tpu_torch
    from eincm_tpu_torch.experimental import fused_splat_bench as fb
    from eincm_tpu_torch.experimental import interp_proto as ip
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

    for tag, (wx, wy, sensor) in splat_in.items():
        timed(f"splat_fwd_{tag}", lambda: sk.splat_fwd_cuda(wx, wy, sensor))
    if hasattr(sk, "plan_splat"):
        # tile budgets (KB) x event chunks (None: the plan's own)
        sweeps = {"mvsec": ((227, 113, 56, 28), (None, 1, 16)),
                  "dsec": ((227, 113, 56, 28), (None,))}
        res["plans"] = {}
        for tag, (budgets, chunk_counts) in sweeps.items():
            wx, wy, sensor = splat_in[tag]
            R, E = wx.shape
            for kb in budgets:
                base = sk.plan_splat(R, E, *sensor, smem_budget=min(kb * 1024, sk.SMEM_MAX))
                for c in chunk_counts:
                    p = base if c is None else dataclasses.replace(base, chunks=c)
                    key = f"splat_fwd_{tag}_{kb}k_{p.row_slabs}slabs_{p.chunks}chunks"
                    res["plans"][key] = dataclasses.asdict(p)
                    timed(key, lambda: sk.splat_fwd_cuda(wx, wy, sensor, p))
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
        if not (args.sweep and hasattr(ti, "plan_interp")):
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
                        modes = ("registers",) if n <= 4 else ("fixed", "float")
                        for mode in modes if threads <= 512 or n > 4 else ():
                            try:
                                p = ti.plan_interp(E, n, n, True, offs, mode, blocks,
                                                   threads, grouped)
                            except ValueError:
                                continue  # too few threads to sum this grid
                            timed(f"sweep_bwd_{mode}_{key}",
                                  lambda: ti.interp_bwd_cuda(g, xs, ys, (n, n, 2), sensor, p))
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(name)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
