"""Scale-out demo: one event-window SEQUENCE over the window mesh.

    python -m eincm_tpu_torch.examples.sequence_sharding [--device cuda]
    torchrun --nproc-per-node 2 -m eincm_tpu_torch.examples.sequence_sharding

The port of examples/sequence_sharding.py. The reference pipeline is
sequential over windows: its handover prior chain makes window i depend on
window i-1 (src/eincm/solver.py:254-255). This demo runs one sequence of
16 synthetic windows three ways and prints each one's AEE (the mean
level-0 theta against the window's known velocity) and time:

  1. sequential  - the exact prior chain, one window at a time (the
                   reference schedule; on rank 0 alone);
  2. two-pass    - every window without a prior, then every window again
                   with its neighbour's pass-1 result as the prior
                   (`parallel/batch.py:two_pass_sequence_solve`);
  3. seq-sharded - each rank takes a contiguous chunk and runs the TRUE
                   in-chunk handover chain; chunk-boundary priors pass
                   between ranks (`parallel/batch.py:sequence_shard_solve`).

The mesh is the ranks of the process group under torchrun (one process
per device, gloo between them: two ranks may share one GPU) and this
process alone without it. Each rank builds only its own windows.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from eincm_tpu_torch.models.loss import LossParams
from eincm_tpu_torch.models.pyramid import HandoverSettings, SolverConfig, WindowSample
from eincm_tpu_torch.ops.filters import gaussian_blur_3x3
from eincm_tpu_torch.ops.normalize import normalize_to_unit_range
from eincm_tpu_torch.ops.splat import events_to_pdf_frame
from eincm_tpu_torch.parallel.batch import (
    make_window_mesh,
    sequence_shard_solve,
    stack_windows,
    two_pass_sequence_solve,
)
from eincm_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize_distributed,
    process_info,
    rank_device,
)

H = W = 48
N_WINDOWS = 16
N_EVENTS = 3072
# velocities drift smoothly across the sequence: the regime where the
# handover prior chain helps
ANGLES = np.linspace(0.0, 1.2, N_WINDOWS)
VELS = np.stack([3.0 * np.cos(ANGLES), -2.0 * np.sin(ANGLES) - 1.0], 1)


def make_window(i, device):
    """Window i: dots moving with VELS[i] (px / unit time), its own seed."""
    v = VELS[i]
    rng = np.random.default_rng(11 + i)
    n_feat = 40
    feat = rng.uniform(6, H - 6, size=(n_feat, 2))
    ts = rng.uniform(0, 1, N_EVENTS).astype(np.float32)
    which = rng.integers(0, n_feat, N_EVENTS)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def edge_map(t):
        m = events_to_pdf_frame(f32(feat[:, 0] + v[0] * t), f32(feat[:, 1] + v[1] * t), (H, W))
        return normalize_to_unit_range(gaussian_blur_3x3(m))

    return WindowSample(
        xs=f32(np.round(feat[which, 0] + v[0] * ts)),
        ys=f32(np.round(feat[which, 1] + v[1] * ts)),
        ts=f32(ts),
        edges=torch.stack([edge_map(0.0), edge_map(1.0)]),
        edge_ts=f32([0.0, 1.0]),
    )


def aee(final_lvl0) -> float:
    th = final_lvl0.cpu().numpy().reshape(N_WINDOWS, -1, 2).mean(1)
    return float(np.linalg.norm(th - VELS, axis=1).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # under torchrun
        initialize_distributed(DistributedConfig(enable=True))
    # a bare cuda takes its index here (set_device needs one)
    device = rank_device(DistributedConfig(), args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        torch.cuda.set_device(device)
    mesh = make_window_mesh(device=device)
    if N_WINDOWS % mesh.size:
        raise ValueError(f"{N_WINDOWS} windows do not divide over {mesh.size} ranks")
    lead = mesh.rank == 0
    if lead:
        print(f"mesh: {mesh.size} rank(s); {process_info(device)}")

    cfg = SolverConfig(
        n_pyr_lvls=3,
        sensor_size=(H, W),
        params=LossParams(alpha=40.0, beta=0.0, gamma=0.0),
        theta_opt_maxiters=(12, 8, 6),
        handover=HandoverSettings(use_handover=True, alpha_handover=0.5),
        max_ls_evals=6,
    )
    per = N_WINDOWS // mesh.size
    mine = stack_windows([make_window(i, device) for i in
                          range(mesh.rank * per, (mesh.rank + 1) * per)])

    results = {}
    if lead:  # 1. the sequential chain: one chunk on this rank alone
        every = stack_windows([make_window(i, device) for i in range(N_WINDOWS)])
        t0 = time.perf_counter()
        _, final = sequence_shard_solve(cfg, every, make_window_mesh(1, device=device))
        results["sequential"] = (aee(final[0]), time.perf_counter() - t0)
    for name, run in (
        ("two-pass", lambda: two_pass_sequence_solve(cfg, mine, mesh)),
        ("seq-sharded", lambda: sequence_shard_solve(cfg, mine, mesh)),
    ):
        t0 = time.perf_counter()
        _, final = run()
        results[name] = (aee(final[0]), time.perf_counter() - t0)
    if lead:
        for name, (err, secs) in results.items():
            print(f"{name:12s}: AEE {err:.3f} px   {secs:6.2f} s")
        vmag = float(np.linalg.norm(VELS, axis=1).mean())
        print(f"(mean |V| = {vmag:.2f} px; every schedule should sit well below)")
        if not all(err < 0.5 * vmag for err, _ in results.values()):
            raise AssertionError(f"a schedule did not recover the flow: {results}")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
