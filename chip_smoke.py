"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (any failure exits non-zero):

1. set-up: card name and power limit, torch and CUDA versions, and the
   nvcc build of every kernel in eincm_tpu_torch/csrc (one nvcc per
   source, all started together; `-Xptxas -v`'s registers, shared memory
   and spills for the interp, the splat, the fused warp+splat and the dense
   interp), and the launch plans of the splat forward, the splat backward
   and the fully fused warp+splat at both shapes;
2. each CUDA kernel of the solve against its plain PyTorch version on the
   card, at the MVSEC shape (16x16 theta, 30k events x 2 refs, 256x336)
   and the DSEC shape (1.5M events x 2 refs, 480x640), edge cases
   included, with the time of both and of one PyTorch library call that
   computes the same function, from CUDA events; the splat forward and
   both backward kernels also with a 5x5 window, with events up to 2.5
   rows off every slab edge; and both interp kernels at every grid the
   chain solves (1x1 to 16x16) and at 32x32, 64x64, 128x128 and 256x256
   (no block's shared memory holds that grid), where the backward takes
   exact sums in one unit per launch (`interp_bwd_exact`: in bands of rows
   or straight into device memory, both modes timed, bitwise equal to each
   other and with the events permuted), with unaligned views, each timed
   beside its bound and its library call, the backward twice for bitwise
   equal results at every grid; and both kernels of the splat backward (one
   event per thread, and four in a row as float4s), the stream kernel
   bitwise the gather kernel's and bitwise the same twice, each timed, with
   the one the plan chooses at that shape in the row; and the direct
   kernels (float64, and the wrap-compat splat in float32 and float64)
   against the plain versions in the same precision, every one bitwise the
   same twice (the splat forward also with 1 and 7 event chunks, the
   float64 interp backward also permuted, in both modes, at 16x16, 32x32,
   64x64 and 128x128), the float64 ones timed beside their bound and library
   call; the splat forward's frames bitwise the same launched again and
   with 1 and 7 event chunks (its sums are exact);
3. the measurement kernels (fused warp+splat, fully fused warp+splat,
   dense-layout interp) against their plain versions at the MVSEC shape
   (staged window 0, GT theta, both refs) and the DSEC shape of the fused
   bench (1.5M row-sorted events, theta N(0, 4)), timed the same way; both
   kernels of kernels 7 and 8 (scatter and cluster) at window sizes 3 and
   5, with windows on every edge of the cluster's tiles, and each cluster
   kernel with every event on one texel (its counters wrap); then their
   main path, the fused bench's paths A, B and C and the dense
   interp's comparison with the production interp, with every kernel's
   launch counter read around it;
4. the main path of the solve: a 6-window MVSEC-scale handover chain
   through `make_window_solver`, checked against the ground-truth flow,
   with the launch counters read around the chain;
5. one DSEC-scale `solver_loss` value and gradient with the kernels (on
   the card, its splat backward through the stream kernel) against the
   plain versions (on CPU tensors); in float64 on the card (the direct
   kernels, with the launch counters read around it) against float64 on
   the CPU, printed beside the float32 kernel loss with their relative
   gap; and with the wrap-compat switch on (float32: the interp kernels
   and the direct splat) against the CPU's;
6. [wolfe] the armijo rescue's configuration (strong Wolfe, 10 trials, the
   histories and the prior loss on) over the same 6-window MVSEC chain:
   statuses, finite theta, the prior loss (+inf on window 0 only), each
   level's history against its solve, the level-0 handover history, kernels
   1-4 launched, the chain AEE against the JAX package's Wolfe reading,
   and one window's host syncs read by the sync debug mode against the
   count the solver reports;
7. [eval] the EVAL path (`prepare_eval_inputs` + `evaluate_theta_array`)
   at DSEC (GT + noise theta, as phase 5) and on each Wolfe window's final
   theta, on the card against the CPU: every value of `evals`, the counts
   exactly, the splat forward launched once to prepare and twice per
   evaluation, the eval's ms per call and its host syncs;
8. [experiment] the port's experiment CLI (`python -m
   eincm_tpu_torch.experiments`'s `main`) on `configs/mvsec_indoor.yaml`,
   read by the port's YAML-free loader, with its own tuning (edge
   preprocessing and the armijo rescue on; IEDT edges) over a synthetic
   sequence at the config's 256x336 and 30k events: 8 windows at |V| =
   5 px, checkpoints every 25%, SOLVE and EVAL (no PLOT: the card's
   machine has no matplotlib), the launch counters read around it; the artifacts
   validated, the mean AEE of windows 1-7 against the JAX package's reading
   of the same experiment and every window's against zero flow; then a run
   resumed from the first checkpoint (only the later windows solved, the
   restored records bitwise the checkpoint's) and an EVAL-only run from the
   saved `opt_results.npz`, whose scores.txt has the first run's metrics
   and flow-error lines, and whose every window's flow errors equal the
   first run's exactly and IWE metrics within the splat's float atomics
   (TOL_SCORES relative, unrounded);
9. [dsec] the real-data path at DSEC's full size: a DSEC train-split tree
   written here (eincm_tpu_torch/utils/dataset_trees.py: 4 windows of
   100 ms at 480x640 with 1.6M events each, 700 dots at (6, -4) px per
   window, a non-identity rectify map, a calibration in block sequences,
   8-bit RGB frames, GT flow PNGs), read back with its HDF5 read rate and
   PNG decode time, then the CLI on `configs/dsec_test.yaml` (SOLVE and
   EVAL of every window, IEDT edges), the launch counters read around it:
   staging, solve, EVAL, host syncs and launches per BFGS evaluation per
   window; the native library built, kernels 1-4 launched, every window
   holding >= 1.5M events, the mean AEE of windows 1-3 against the JAX
   package's reading and every window's against zero flow's; then windows
   0-1 once more with the config's Gaussian edges, their AEE printed; and
   (after [parallel]'s DSEC run) the CLI's SOLVE in a subprocess, SIGKILLed
   once its first checkpoint loads, resumed here from it with SOLVE and
   EVAL: every window's record, only the later windows solved, the first
   of them from a level-0 prior bitwise the checkpoint's last final,
   kernels 1-4 launched, the mean AEE under [dsec]'s bound;
   [grids] (right after [dsec], on its tree): window 1 with the config's
   solver at `solver.n_pyr_lvls=6` (finest grid 32x32) solved from a zero
   prior twice in float32 (theta bitwise equal, kernel 2's exact sums
   launched, launches per evaluation printed, AEE below zero flow's and
   printed beside [dsec]'s 5-level AEE) and twice in float64 (the direct
   kernels launched, bitwise equal, AEE below zero flow's and within
   GRIDS_AEE_BAND of the float32 solve's); then [chain]'s window 1 from
   window 0's final with the wrap-compat splat, twice (bitwise equal, AEE
   <= MAX_MEAN_AEE);
10. [submission] a DSEC test-split tree of the same scene, the CLI with
   `dataset.extended=true` (the extended CSV reconstructed by the loader)
   solving 2 windows, `tools.dsec_extended_evals` writing that CSV (equal
   to the loader's rows) and `tools.dsec_submission` on the opt_results.npz:
   each PNG, read back, is the encoding of its window's level-0 theta
   upscaled on the card, and is named by its file index;
11. [mvsec] an MVSEC indoor_flying1 tree (260x346, a shear scene: spatially
   varying GT) and `configs/mvsec_indoor.yaml` over 3 windows, scored
   against the loader's GT; 12. [ecd] an ECD tree (240x180) and
   `configs/ecd_slider.yaml` over 3 windows, scored against the scene's
   velocity (ECD has no GT); both with the printouts and checks of [dsec];
13. [parallel] the window mesh of `eincm_tpu_torch/parallel/` on one
   member, the launch counters read around each run: on the 6 staged MVSEC
   windows `solve_window_batch_sharded` (each window's AEE within 0.05 px
   of its lone first-sample solve, and its theta bitwise that solve's), `two_pass_sequence_solve` (mean AEE of
   windows 1-5 <= MAX_MEAN_AEE) and `sequence_shard_solve` (the exact chain:
   within 0.05 px of [chain]'s mean, one solve a window, each window's
   level-0 prior bitwise its predecessor's final), each schedule's (window,
   pass) solves as expected, `python -m eincm_tpu_torch.examples.
   sequence_sharding` with its default bare cuda device (exit 0: every
   schedule recovered the flow), then `eval_batch_sharded` of those
   thetas against `evaluate_theta_array` window by window (counts exact,
   values within [eval]'s tolerances, the splat fwd 3 a window); the CLI at
   DSEC's full size on [dsec]'s tree (run right after [dsec]) with the
   CLI's default bare cuda device in sequence_shard with the sharded EVAL
   (mean AEE of windows 1-3 under [dsec]'s bound and within 0.05 px of
   [dsec]'s reading; one solve a window, the chain's priors bitwise); and the
   [experiment] sequence in two_pass with a super-step checkpoint at 50%,
   then a run resumed from it (only the second super-step solved, the
   restored records bitwise the checkpoint's);
14. [ranks] the [experiment] sequence in sequence_shard with the sharded
   EVAL, first on one member in this process, then over two CLI processes
   on this one card (`distributed.enable`, gloo on a free 127.0.0.1 port,
   `local_device_ids=[0]`; each process this script again with
   `--rank-cli`, reporting its own launch counts in a JSON line): both
   exit 0 in RANKS_TIMEOUT_S (a survivor of a failed rank is killed), rank
   0 writes the 8 windows' artifacts and rank 1 no file, each rank solves
   its 4 windows once (rank 1 only its pass 2), every window's level-0
   prior in rank 0's opt_results.npz bitwise its predecessor's final
   (window 4's crossed ranks; the one-member run's too), rank 0's chunk
   within 0.05 px of the one-member run, every window below zero flow,
   the mean of windows 1-7 <= MAX_EXPERIMENT_AEE, kernels 1-4 launched in
   both ranks;
15. [bench] each `build_*` bench of `eincm_tpu_torch/utils/benchmarks.py` at its
   full size, BENCH_ROUNDS rounds each: the MVSEC chain (6 windows; its
   seconds a window beside [chain]'s median), the DSEC chain (4 windows of
   1.5M events; beside [dsec]'s solve median), the batched solve (8
   windows on a mesh of this one process) with `solve_diag_str` of each,
   and the DSEC warp+splat throughput in Mevents/s; kernels 1-4 launched;
16. [studies] the seven studies of `eincm_tpu_torch/scripts/` at
   STUDY_WINDOWS windows and one round (the edge study over the 6-window
   chain with [chain]'s theta_ftol): each finishes with its JSON keys, the
   mean AEE of each chain it solves with the shipped edges finite and
   under MAX_MEAN_AEE (the edge study's baseline over windows 1-5: [chain]'s
   configuration and statistic), kernels 1-4 launched;
17. [h5] the codec fixtures of tests/data/codecs/ (libzstd's frames,
   c-blosc's chunks of every codec and shuffle, a Blosc-Zstd DSEC
   events.h5, datasets under the Zstandard and LZF filters) decoded by the
   native library built here and held to their manifest; `zstd_decompress`
   timed over the largest frame for ZSTD_RATE_S (MB/s of output); then the
   Blosc-Zstd events.h5 in a DSEC tree of its scene, read through h5_lite
   (its MB/s) and the port's DSEC loader, window 0 staged and solved on the
   card (DSEC tuning, zero prior): finite theta, kernels 1-4 launched, the
   AEE below zero flow's; then the HDF5 fixtures of tests/data/hdf5/ (files
   h5py wrote under libver "earliest", "v108" and "latest": superblocks
   0, 2 and 3, dense groups, soft links, the five chunk indexes of layout
   message 4, Fletcher-32, enums, strings, fill values) read through
   h5_lite and held to their manifest, and the latest-format DSEC events
   file of the same scene (extensible-array chunks, gzip and shuffle) read
   the same way (its MB/s beside the Blosc-Zstd file's): window 0's sample
   bitwise the Blosc-Zstd file's, staged and solved likewise, its AEE below
   zero flow's and within H5_AEE_BAND of the Blosc-Zstd window's.

Every kernel's time stands beside its bound: the least time the card could
take for the same work, the longer of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s (float64: 34 TFLOP/s; H100 SXM data sheet).

The last lines are the card as nvidia-smi names it, one JSON object of
per-kernel results, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from eincm_tpu_torch.utils.profiling import card as nvidia_smi
from eincm_tpu_torch.utils.profiling import cuda_ms

# tolerances, as max |kernel - plain| <= tol * max |plain|:
# the float32 splat fwd rounds each tap to 2^-24 (and the fused warp+splat
# adds with float atomics), and the plain version sums thousands of taps per
# texel in float32 in another order
TOL_ATOMIC = 1e-5
# interp fwd, splat bwd and the dense interp sum a fixed handful of terms
# per output (the dense interp's `highest` is 3xTF32, within ~2^-21 of f32
# per term)
TOL_GATHER = 1e-6
# interp bwd against the plain version's float32 terms summed in float64
# (`interp_bwd_plain`): a block's sums are exact (fixed point) or short f32
# sums (registers), and the blocks' partial grids are added in f32 in a
# fixed order; above 16x16 every term is rounded in one unit per launch and
# summed exactly (csrc/exact.cuh). Every grid, every run: bitwise repeatable.
TOL_INTERP_BWD = 1e-6
TOL_DSEC_LOSS = 1e-4  # relative loss difference, card kernels vs CPU plain
TOL_F64 = 1e-12  # float64 on the card vs on the CPU: the same plain versions
# px, mean over MVSEC chain windows 1..5 (|V| = 5 px): the JAX package's
# own reading on this chain (0.30 px in float32 on CPU,
# tests/test_torch_mvsec_chain.py) plus the 0.05 px band the CPU tests
# hold the port's chain to. A run on the card repeats bitwise (exact sums).
# Keeping each window's prior as it came scores ~1.5 px, zero flow 5 px.
MAX_MEAN_AEE = 0.35
# px, the same bound for the armijo rescue's strong-Wolfe configuration:
# the JAX package's Wolfe reading on this chain (WOLFE_JAX_AEE px in float32
# on CPU, tests/test_torch_mvsec_chain.py[wolfe]) plus the same 0.05 px band
WOLFE_JAX_AEE = 0.3181  # the port's own: 0.3099 px
MAX_WOLFE_AEE = WOLFE_JAX_AEE + 0.05
OK_STATUSES = {0, 1, 2, 4}
# The eval, card against CPU: every value of `evals` within TOL_DSEC_LOSS
# relative, the A{n}PE rates also within one pixel's share (100 / n_ee %)
# absolute, since they count pixels whose endpoint error passes a
# threshold and a pixel within the last bits of one may count on one side
# and not on the other (a rate of 0 has no relative room); the AEE within:
TOL_EVAL_AEE = 1e-5  # relative
# px, mean over the [experiment] phase's windows 1..7: the JAX package's
# reading of the same experiment (float32 on CPU,
# tests/test_torch_experiment.py::test_chip_experiment_reading) plus the
# 0.05 px band; zero flow scores |V| = 5 px at every window
EXPERIMENT_JAX_AEE = 0.0759  # the port's own: 0.0765 px
MAX_EXPERIMENT_AEE = EXPERIMENT_JAX_AEE + 0.05
EXPERIMENT_SPEED = 5.0
# The config's tuning stays (5 levels, alpha 20, beta 35, its Canny
# thresholds, extra attempts, handover at level 0, preprocessing, the armijo
# rescue). Its edges are smoothed with the EINCM IEDT, as the repo's MVSEC
# workloads do: with the default Gaussian blur of one-pixel Canny edges the
# beta term holds theta near zero on these dot scenes, in the JAX package
# as in the port (AEE above zero flow's; the [gaussian] reading of the same
# test)
EXPERIMENT_OVERRIDES = (
    "dataset.kind=synthetic", "dataset.n_windows=8", "dataset.velocity=[4.0, -3.0]",
    "edge.smoothen_method=eincm_iedt", "phases.checkpoint_every_percent=25",
    "phases.delete_checkpoints_at_end=false", "phases.plot=false",
)
# the EVAL-only rerun's metrics against the first run's, window by window
# (the splat forward's frames are exact sums, so the card repeats them)
TOL_SCORES = 1e-5  # relative

# The real-data phases write their trees (eincm_tpu_torch/utils/
# dataset_trees.py: h5_lite, write_png16, text) and run the experiment CLI
# on them with each config's own tuning; 3 windows each, DSEC 4 of 100 ms at
# 480x640 with 1.6M events written per window (the loader takes the last
# 1.5M). The bounds, px: the JAX package's reading of the same run (the
# same trees and overrides, float32 on the CPU,
# tests/test_torch_real_data.py, `pytest -m slow -s`) plus the 0.05 px
# band; DSEC and MVSEC score against the loader's GT (mean over windows
# 1..N: the first starts from a zero prior), ECD, which has no GT, the
# level-0 flow against the scene's velocity at the window's event pixels
# (mean over windows 0..N-1, each solved from the previous one's prior).
# The JAX package's splat on the CPU is a dense product (~1 TFLOP per
# reference frame and evaluation at 1.5M events), so its DSEC reading
# solves windows 0-1 of the same tree and scores window 1.
REAL_OVERRIDES = ("phases.plot=false", "phases.checkpoint_every_percent=0")
DSEC_WINDOWS, DSEC_EVENTS_PER_WINDOW, DSEC_SUBMISSION_WINDOWS = 4, 1_600_000, 2
REAL_AEE_BAND = 0.05
# tag: (config, its overrides, windows solved, the JAX package's reading).
# Every phase smooths its edges with the EINCM IEDT, as [experiment] does:
# with the configs' Gaussian blur of one-pixel Canny edges the solves drift
# off the dots (JAX on the CPU: MVSEC 19.3 px, ECD 2.85 px, above or near
# zero flow's; DSEC at 100k events a window 0.111 px against the IEDT's
# 0.086: tests/test_torch_real_data.py::test_gaussian_edges_reading; DSEC
# at 1.5M events on the card: [dsec] solves windows 0-1 once more with the
# Gaussian edges and prints their AEE)
IEDT = "edge.smoothen_method=eincm_iedt"
REAL_CASES = {
    # JAX: windows 0-1, window 1 scored (the port on the CPU: not measured)
    "dsec": ("dsec_test.yaml", ("dataset.data_split=train", IEDT), DSEC_WINDOWS, 0.056),
    "mvsec": ("mvsec_indoor.yaml", (IEDT,), 3, 0.059),  # the port's own: 0.0569
    "ecd": ("ecd_slider.yaml", (IEDT,), 3, 0.1842),  # the port's own: 0.1800
}

CHAIN_KERNELS = ("interp_fwd", "interp_bwd", "splat_fwd", "splat_bwd")
BENCH_KERNELS = ("fused_warp_splat", "fully_fused_warp_splat", "interp_dense")
SOURCES = {
    "interp_fwd": "eincm_tpu_torch/csrc/interp.cu",
    "interp_bwd": "eincm_tpu_torch/csrc/interp.cu",
    "interp_bwd_exact": "eincm_tpu_torch/csrc/interp.cu",
    "splat_fwd": "eincm_tpu_torch/csrc/splat.cu",
    "splat_bwd": "eincm_tpu_torch/csrc/splat.cu",
    "fused_warp_splat": "eincm_tpu_torch/csrc/fused.cu",
    "fully_fused_warp_splat": "eincm_tpu_torch/csrc/fused.cu",
    "interp_dense": "eincm_tpu_torch/csrc/interp_dense.cu",
    "interp_direct_fwd": "eincm_tpu_torch/csrc/direct.cu",
    "interp_direct_bwd": "eincm_tpu_torch/csrc/direct.cu",
    "splat_direct_fwd": "eincm_tpu_torch/csrc/direct.cu",
    "splat_direct_bwd": "eincm_tpu_torch/csrc/direct.cu",
}
# the float64 and wrap-compat routes of kernels 1-6 (the JAX package runs
# these calls on XLA instead of its Pallas kernels)
DIRECT_KERNELS = ("interp_direct_fwd", "interp_direct_bwd", "splat_direct_fwd",
                  "splat_direct_bwd")
REPLACES = {
    "interp_fwd": "eincm_tpu/ops/interp_pallas.py:197",
    "interp_bwd": "eincm_tpu/ops/interp_pallas.py:239",
    "interp_bwd_exact": "eincm_tpu/ops/interp_pallas.py:239",
    "splat_fwd": "eincm_tpu/ops/splat_banded.py:374",
    "splat_bwd": "eincm_tpu/ops/splat_banded.py:491",
    "fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:449",
    "fully_fused_warp_splat": "eincm_tpu/experimental/splat_fused.py:345",
    "interp_dense": "scripts/interp_kernel_proto.py:124",
    "interp_direct_fwd": "eincm_tpu/ops/interp_pallas.py:197",
    "interp_direct_bwd": "eincm_tpu/ops/interp_pallas.py:239",
    "splat_direct_fwd": "eincm_tpu/ops/splat_pallas.py:127",
    "splat_direct_bwd": "eincm_tpu/ops/splat_pallas.py:194",
}
ALSO_REPLACES = {
    "splat_fwd": "eincm_tpu/ops/splat_pallas.py:127",
    "splat_bwd": "eincm_tpu/ops/splat_pallas.py:194",
    "splat_direct_fwd": "eincm_tpu/ops/splat_banded.py:374",
    "splat_direct_bwd": "eincm_tpu/ops/splat_banded.py:491",
}

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # outside the tensor cores
# f32 operations per event (per event and ref for a splat), counted from
# the kernels' arithmetic with an exp as one operation:
# - interp weights, per axis 15: place u (3), floor, two triangle weights
#   (4 each), their sum, a clamp and two divisions;
# - the bilinear contraction: 2 channels x (4 products + 3 sums);
# - its backward: 4 taps x 2 channels x (2 products + 1 sum);
# - the warp: ts - t_ref, 2 products, 2 differences;
# - the splat: 2 roundings, 5 per Gaussian tap (2 per row and column) and a
#   product and a sum per texel;
# - the splat backward: 2n taps (5 each), 2n q g(q), and two n x n
#   contractions of n x (n products + n - 1 sums) + n products + n - 1 sums,
#   n = 2 hw + 1 (3: 30 + 6 + 40).
OPS_INTERP_WEIGHTS = 30
OPS_INTERP_CONTRACT = 14
OPS_INTERP_BWD = 30 + 24
OPS_WARP = 5


def ops_splat(hw: int) -> int:
    n = 2 * hw + 1
    return 2 + 2 * n * 5 + 2 * n * n


def ops_splat_bwd(hw: int) -> int:
    n = 2 * hw + 1
    return 2 * n * 5 + 2 * n + 2 * (n * (2 * n - 1) + 2 * n - 1)


def ops_dense(h: int, w: int) -> int:
    """The dense interp's own f32 operations per event in mode `highest`,
    on h, w padded to 8: weights of every cell (4 ops, a sum and a division
    each), then 2 channels x wp x hp products and sums and 2 x wp more.
    Not its bound: the function is kernel 1's, whose work bounds both."""
    hp, wp = max(8, -(-h // 8) * 8), max(8, -(-w // 8) * 8)
    return 6 + 6 * (hp + wp) + 4 * wp * hp + 4 * wp


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least ms, what bounds it) on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def record(rows, name, tag, err, ms, plain_ms, n_bytes, n_ops, library_ms,
           ops_per_s=F32_OPS_PER_S, **extra):
    bound_ms, bound_by = bound(n_bytes, n_ops, ops_per_s)
    rows.setdefault(name, {})[tag] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, **extra,
    }
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), library {lib}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaNs included (torch.equal holds NaN != NaN)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def max_err(kernel: torch.Tensor, plain: torch.Tensor, tol: float, what: str):
    """max |kernel - plain| over entries, NaN where the plain one is NaN."""
    kernel, plain = kernel.detach(), plain.detach()
    nk, npl = torch.isnan(kernel), torch.isnan(plain)
    if not torch.equal(nk, npl):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    k, p = kernel[~npl].double(), plain[~npl].double()
    err = float((k - p).abs().max()) if k.numel() else 0.0
    scale = float(p.abs().max()) if p.numel() else 0.0
    ok = err <= tol * scale
    print(f"  {what}: max|d| {err:.3e}  max|ref| {scale:.3e}  "
          f"rel {err / max(scale, 1e-30):.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


EDGE_XY = [  # (x, y) cases the CPU tests cover
    (-1e4, -1e4), (float("nan"), 5.0), (5.0, float("nan")), (2.5, 3.5),
    (0.0, 0.0), (-0.5, -0.5), (-1.0, 2.0), (-1.5, 2.0), (-2.0, 3.0),
    (1e10, 3.0), (-1e10, 3.0), (float("inf"), 4.0), (4.0, -float("inf")),
]


def with_edges(xs, ys, H, W):
    ex = [x for x, _ in EDGE_XY] + [W - 1.0, W - 0.5, W + 0.0, W + 0.5, W + 1.5]
    ey = [y for _, y in EDGE_XY] + [H - 1.0, H - 0.5, H + 0.0, H + 0.5, H + 1.5]
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=xs.device)
    return torch.cat([xs, t(ex)]), torch.cat([ys, t(ey)])


def slab_edge_events(tile_rows, H, W, device, seed):
    """(x, y) of events on and around every edge between slabs of
    `tile_rows` rows: their windows straddle two blocks' shared memory (a
    5x5 window's up to 2.5 rows off the edge)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    edges = torch.arange(tile_rows, H, tile_rows, dtype=torch.float32, device=device)
    offs = torch.tensor([-2.5, -2.0, -1.5, -1.0, -0.6, -0.5, 0.0, 0.4, 0.5, 1.0, 1.5,
                         2.0, 2.4], device=device)
    y = (edges[:, None] + offs[None, :]).reshape(-1)
    x = torch.rand(y.shape[0], generator=gen, device=device) * (W - 1)
    return x, y


def in_sensor(xs, ys, H, W):
    """Events whose rounded coordinates lie on the sensor."""
    rx, ry = torch.round(xs), torch.round(ys)
    return (rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1)


# ---- library yardsticks: one PyTorch call for a kernel's function ---------

def grid_sample_interp(theta, xs, ys, sensor):
    """interp fwd as `F.grid_sample(padding_mode="border",
    align_corners=False)` at the rounded coordinates: the same sample for
    in-sensor events; an event off the sensor (the -1e4 sentinel) samples
    theta's border there and 0 in the kernel. Returns (call, (E, 2) out)."""
    H, W = sensor
    img = theta.permute(2, 0, 1)[None].contiguous()  # (1, 2, h, w)
    gx = (torch.round(xs) + 0.5) * (2.0 / W) - 1.0
    gy = (torch.round(ys) + 0.5) * (2.0 / H) - 1.0
    grid = torch.stack([gx, gy], -1)[None, None]  # (1, 1, E, 2)
    call = lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=False
    )
    return call, call()[0, :, 0, :].T


def splat_planes(wx, wy, sensor):
    """The splat's dense separable weight planes, as the TPU formulates it:
    U (R, H, E) holds each event's 3 row taps, V (R, E, W) its 3 column
    taps, so the frames are U @ V. The backward's yardstick is the two
    products U^T G and V G^T it needs; the row sums with the derivative
    taps that follow them are left out. In the coordinates' dtype."""
    from eincm_tpu_torch.ops.splat_kernel import _gauss1d

    R, E = wx.shape
    H, W = sensor
    d = torch.tensor([-1.0, 0.0, 1.0], dtype=wx.dtype, device=wx.device)
    zero = torch.zeros((), dtype=wx.dtype, device=wx.device)
    rows = torch.round(wy)[..., None] + d  # (R, E, 3)
    cols = torch.round(wx)[..., None] + d
    vr = (rows >= 0) & (rows <= H - 1)
    vc = (cols >= 0) & (cols <= W - 1)
    gy = torch.where(vr, _gauss1d(torch.where(vr, rows - wy[..., None], zero)), zero)
    gx = torch.where(vc, _gauss1d(torch.where(vc, cols - wx[..., None], zero)), zero)
    U = torch.zeros((R, H, E), dtype=wx.dtype, device=wx.device)
    U.scatter_add_(1, torch.where(vr, rows, zero).long().transpose(1, 2),
                   gy.transpose(1, 2).contiguous())
    V = torch.zeros((R, E, W), dtype=wx.dtype, device=wx.device)
    V.scatter_add_(2, torch.where(vc, cols, zero).long(), gx)
    return U, V


# ---- phase 2 ----------------------------------------------------------------

INTERP_GRIDS = ((1, 1), (2, 2), (4, 4), (8, 8), (16, 16))  # the chain's levels
# kernel 2's exact sums: n_pyr_lvls=6 (32x32), 64x64, 128x128 (theta not
# staged in the forward), and 256x256, whose grid no block's shared memory
# holds (bands, or every term into device memory)
EXACT_GRIDS = ((32, 32), (64, 64), (128, 128), (256, 256))


def check_interp_grids(tag, xs, ys, sensor, rows):
    """Both interp kernels at each grid against the plain version, the
    backward bitwise the same twice (and, above 16x16, in both exact modes
    and under a permutation of the events), timed beside their bound and
    library call; results under `by_grid`, the exact kernel's at 32x32 in
    its own row."""
    from eincm_tpu_torch.ops import interp as ti

    H, W = sensor
    E = xs.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    ex, ey = with_edges(xs, ys, H, W)
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda")
    g_main = g[:E].contiguous()
    perm = torch.randperm(bx.shape[0], generator=gen, device="cuda")
    by_grid = {"interp_fwd": {}, "interp_bwd": {}, "interp_bwd_exact": {}}
    for h, w in INTERP_GRIDS + EXACT_GRIDS:
        name = f"{h}x{w}"
        theta = 3.0 * torch.randn(h, w, 2, generator=gen, device="cuda")
        p_fwd = ti.plan_interp(E, h, w)
        p_bwd = ti.plan_interp(E, h, w, True)
        print(f"[interp] {tag} {name}: fwd {p_fwd.mode}, {p_fwd.blocks} x {p_fwd.threads}; "
              f"bwd {p_bwd.mode}, {p_bwd.blocks} x {p_bwd.threads} x {p_bwd.bands} bands, "
              f"{p_bwd.slices} slices")
        out_p = ti.interp_theta_at_events_plain(theta, ex, ey, sensor)
        err_f = 0.0
        # whole, and as views that start 4 and 12 bytes into a 16-byte line
        # (in groups of four from the first aligned event, and one by one)
        for off in (0, 1, 3):
            for grouped in (True, False):
                vx, vy = ex[off:], ey[off:]
                plan = ti.plan_interp(vx.shape[0], h, w, grouped=grouped, offsets=(
                    ti.float_offset(vx), ti.float_offset(vy), 0))  # a new output
                out_k = ti.interp_fwd_cuda(theta, vx, vy, sensor, plan)
                torch.cuda.synchronize()
                what = f"interp_fwd {name} +{off} {'groups' if grouped else 'single'}"
                err_f = max(err_f, max_err(out_k, out_p[off:], TOL_GATHER, what))
                if not torch.equal(out_k[fin[off:]], out_p[off:][fin[off:]]):
                    raise AssertionError(f"{what}: not bitwise the plain version's")
        d_p = ti.interp_bwd_plain(g, bx, by, (h, w, 2), sensor, torch.float64)
        err_b = 0.0
        for off in (0, 1, 3):
            for grouped in (True, False):
                vx, vy, vg = bx[off:], by[off:], g[off:]
                plan = ti.plan_interp(vx.shape[0], h, w, True, tuple(
                    map(ti.float_offset, (vx, vy, vg))), grouped=grouped)
                d_k = ti.interp_bwd_cuda(vg, vx, vy, (h, w, 2), sensor, plan)
                d_again = ti.interp_bwd_cuda(vg, vx, vy, (h, w, 2), sensor, plan)
                torch.cuda.synchronize()
                ref = d_p if off == 0 else ti.interp_bwd_plain(
                    vg, vx, vy, (h, w, 2), sensor, torch.float64)
                what = f"interp_bwd {name} +{off} {'groups' if grouped else 'single'}"
                err_b = max(err_b, max_err(d_k, ref, TOL_INTERP_BWD, what))
                if not torch.equal(d_k, d_again):
                    raise AssertionError(f"{what}: two runs differ")
        n_bytes = 16 * E + 8 * h * w
        lib_call, _ = grid_sample_interp(theta, xs, ys, sensor)
        uy = ti._axis_weights(ys, h, h, float(h) / H, True)  # dense (E, h) weights
        vx = ti._axis_weights(xs, w, w, float(w) / W, True)
        reps = 3 if E * h > 10_000_000 else 10  # the large grid's einsum takes ms
        extra = {}
        if p_bwd.mode in ti.EXACT_MODES:
            # the exact sums: the same bits in both modes and for the events
            # permuted; each mode timed
            d_ref = ti.interp_bwd_cuda(g, bx, by, (h, w, 2), sensor)
            d_perm = ti.interp_bwd_cuda(g[perm].contiguous(), bx[perm].contiguous(),
                                        by[perm].contiguous(), (h, w, 2), sensor)
            for mode in ti.EXACT_MODES:
                plan = ti.plan_interp(bx.shape[0], h, w, True, tuple(
                    map(ti.float_offset, (bx, by, g))), mode)
                if not torch.equal(ti.interp_bwd_cuda(g, bx, by, (h, w, 2), sensor, plan), d_ref):
                    raise AssertionError(f"interp_bwd {name}: mode {mode} not bitwise the plan's")
                plan = ti.plan_interp(E, h, w, True, tuple(
                    map(ti.float_offset, (xs, ys, g_main))), mode)
                extra[f"{mode}_ms"] = cuda_ms(
                    lambda: ti.interp_bwd_cuda(g_main, xs, ys, (h, w, 2), sensor, plan))
                extra[f"{mode}_bands"] = plan.bands
            if not torch.equal(d_perm, d_ref):
                raise AssertionError(f"interp_bwd {name}: the events permuted give other bits")
            print(f"  interp_bwd {name}: bitwise in both exact modes and with the events "
                  f"permuted; banded {extra['banded_ms']:.4f} ms ({extra['banded_bands']} "
                  f"bands), global {extra['global_ms']:.4f} ms")
        bwd_name = "interp_bwd_exact" if p_bwd.mode in ti.EXACT_MODES else "interp_bwd"
        for kernel, err, ms, ops, lib in (
            ("interp_fwd", err_f,
             cuda_ms(lambda: ti.interp_fwd_cuda(theta, xs, ys, sensor)),
             OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT, cuda_ms(lib_call)),
            (bwd_name, err_b,
             cuda_ms(lambda: ti.interp_bwd_cuda(g_main, xs, ys, (h, w, 2), sensor)),
             OPS_INTERP_BWD,
             cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main), reps)),
        ):
            bound_ms, bound_by = bound(n_bytes, ops * E)
            by_grid[kernel][name] = {
                "max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib,
                "mode": (p_fwd if kernel == "interp_fwd" else p_bwd).mode,
                **({} if kernel == "interp_fwd" else extra),
            }
            print(f"  {kernel} {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), library {lib:.4f} ms")
        if (h, w) == EXACT_GRIDS[0]:
            # the exact kernel's row: at its first grid, beside the plain
            # version's autograd
            th = theta.detach().clone().requires_grad_(True)
            out_main = ti.interp_theta_at_events_plain(th, xs, ys, sensor)
            row = by_grid[bwd_name][name]
            record(rows, "interp_bwd_exact", tag, err_b, row["ms"],
                   cuda_ms(lambda: torch.autograd.grad(out_main, th, g_main, retain_graph=True)),
                   n_bytes, OPS_INTERP_BWD * E, row["library_ms"], grid=name, **extra)
            del out_main
        del uy, vx
    for kernel, grids in by_grid.items():
        rows[kernel][tag]["by_grid"] = grids


def check_kernels(tag, window, theta, sensor, rows):
    """Phase 2 at one shape; adds per-kernel results to `rows`."""
    from eincm_tpu_torch.models.loss import _sanitize_events
    from eincm_tpu_torch.ops.interp import (
        _axis_weights, interp_bwd_cuda, interp_bwd_plain, interp_fwd_cuda,
        interp_theta_at_events_plain,
    )
    from eincm_tpu_torch.ops.splat_kernel import (
        plan_splat, plan_splat_bwd, splat_bwd_cuda, splat_fwd_cuda, splat_plain,
    )
    from eincm_tpu_torch.ops.warp import warp_events_multi_ref_coarse

    H, W = sensor
    h, w, _ = theta.shape
    xs, ys, ts = _sanitize_events(window.xs, window.ys, window.ts)
    E = xs.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"[kernels] {tag}: theta {tuple(theta.shape)}, {E} events x "
          f"{window.edge_ts.shape[0]} refs, sensor {H}x{W}")

    # interp at the unwarped event coordinates, edge cases appended
    ex, ey = with_edges(xs, ys, H, W)
    out_k = interp_fwd_cuda(theta, ex, ey, sensor)
    torch.cuda.synchronize()
    out_p = interp_theta_at_events_plain(theta, ex, ey, sensor)
    err = max_err(out_k, out_p, TOL_GATHER, "interp_fwd")
    lib_call, lib_out = grid_sample_interp(theta, xs, ys, sensor)
    ins = in_sensor(xs, ys, H, W)
    print(f"  grid_sample vs interp_fwd: max|d| in-sensor "
          f"{float((lib_out[ins] - out_k[:E][ins]).abs().max()):.3e}, off-sensor "
          f"{float((lib_out[~ins] - out_k[:E][~ins]).abs().max()) if bool((~ins).any()) else 0.0:.3e}")
    lib_interp_ms = cuda_ms(lib_call)
    record(rows, "interp_fwd", tag, err,
           cuda_ms(lambda: interp_fwd_cuda(theta, xs, ys, sensor)),
           cuda_ms(lambda: interp_theta_at_events_plain(theta, xs, ys, sensor)),
           16 * E + 8 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           lib_interp_ms)
    # the backward is compared without the NaN events, which poison
    # different subsets of entries in the two versions
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda")
    d_k = interp_bwd_cuda(g, bx, by, tuple(theta.shape), sensor)
    torch.cuda.synchronize()
    d_p = interp_bwd_plain(g, bx, by, tuple(theta.shape), sensor, torch.float64)
    th = theta.detach().clone().requires_grad_(True)
    g_main = torch.randn(E, 2, generator=gen, device="cuda")
    out_main = interp_theta_at_events_plain(th, xs, ys, sensor)
    uy = _axis_weights(ys, h, h, float(h) / H, True)  # dense (E, h) weights
    vx = _axis_weights(xs, w, w, float(w) / W, True)
    record(rows, "interp_bwd", tag, max_err(d_k, d_p, TOL_INTERP_BWD, "interp_bwd"),
           cuda_ms(lambda: interp_bwd_cuda(g_main, xs, ys, tuple(theta.shape), sensor)),
           cuda_ms(lambda: torch.autograd.grad(out_main, th, g_main, retain_graph=True)),
           16 * E + 8 * h * w, OPS_INTERP_BWD * E,
           cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main)))
    del uy, vx
    check_interp_grids(tag, xs, ys, sensor, rows)

    # splat at the warped coordinates of the real window, edge cases appended
    wx, wy = warp_events_multi_ref_coarse(theta, xs, ys, ts, window.edge_ts, sensor)
    R = wx.shape[0]
    p_bwd = plan_splat_bwd(R, E, H, W)
    sx, sy = slab_edge_events(plan_splat(R, E, H, W).tile_rows, H, W, wx.device, 3)
    ew = [with_edges(torch.cat([wx[r], sx]), torch.cat([wy[r], sy]), H, W) for r in range(R)]
    wxe = torch.stack([a for a, _ in ew]).contiguous()
    wye = torch.stack([b for _, b in ew]).contiguous()
    f_k = splat_fwd_cuda(wxe, wye, sensor)
    torch.cuda.synchronize()
    wxr = wxe.clone().requires_grad_(True)
    wyr = wye.clone().requires_grad_(True)
    f_p = splat_plain(wxr, wyr, sensor)
    G = torch.randn(R, H, W, generator=gen, device="cuda")
    dx_k, dy_k = splat_bwd_cuda(wxe, wye, G, sensor)
    torch.cuda.synchronize()
    dx_p, dy_p = torch.autograd.grad(f_p, (wxr, wyr), G)
    wx, wy = wx.contiguous(), wy.contiguous()
    wxm, wym = wx.clone().requires_grad_(True), wy.clone().requires_grad_(True)
    f_main = splat_plain(wxm, wym, sensor)
    err = max_err(f_k, f_p, TOL_ATOMIC, "splat_fwd")
    # the frames' sums are exact: bitwise the same twice and for any chunks
    p_fwd = plan_splat(R, wxe.shape[1], H, W)
    for what, p in (("again", p_fwd), ("1 chunk", dataclasses.replace(p_fwd, chunks=1)),
                    ("7 chunks", dataclasses.replace(p_fwd, chunks=7))):
        if not torch.equal(splat_fwd_cuda(wxe, wye, sensor, plan=p), f_k):
            raise AssertionError(f"splat_fwd {what}: not bitwise the first launch's frames")
    print(f"  splat_fwd: bitwise the same again and with 1 and 7 chunks ({p_fwd.chunks} planned)")
    U, V = splat_planes(wx, wy, sensor)
    f_ref = f_main.detach()
    print(f"  bmm(U, V) vs splat_fwd: rel "
          f"{float((torch.bmm(U, V) - f_ref).abs().max() / f_ref.abs().max()):.3e}")
    reps = 3 if E > 100_000 else 10  # the yardsticks take tens of ms there
    record(rows, "splat_fwd", tag, err,
           cuda_ms(lambda: splat_fwd_cuda(wx, wy, sensor)),
           cuda_ms(lambda: splat_plain(wx, wy, sensor)),
           8 * R * E + 4 * R * H * W, ops_splat(1) * R * E,
           cuda_ms(lambda: torch.bmm(U, V), reps))
    Ut = U.transpose(1, 2)
    # both backward kernels, whichever the plan chooses at this shape: on the
    # window's events (float4s) and with the edge cases and the slab-edge
    # events appended (no multiple of 4 events: no float4s); the stream
    # kernel bitwise the gather kernel's, and bitwise the same twice
    by_kernel = {}
    for what, (ax, ay) in (("window", (wx, wy)), ("edge cases", (wxe, wye))):
        n = ax.shape[1]
        plans = {k: plan_splat_bwd(R, n, H, W, k) for k in ("gather", "stream")}
        out = {k: splat_bwd_cuda(ax, ay, G, sensor, plan=p) for k, p in plans.items()}
        again = splat_bwd_cuda(ax, ay, G, sensor, plan=plans["stream"])
        torch.cuda.synchronize()
        for k in (0, 1):
            if not torch.equal(out["stream"][k], out["gather"][k]):
                raise AssertionError(f"splat_bwd {what}: the stream kernel is not bitwise "
                                     f"the gather kernel's")
            if not torch.equal(out["stream"][k], again[k]):
                raise AssertionError(f"splat_bwd {what}: two runs of the stream kernel differ")
        print(f"  splat_bwd {what}: {plans['stream']}: bitwise the gather kernel's, and the "
              f"same twice")
        if what == "window":
            by_kernel = {k: cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor, plan=p))
                         for k, p in plans.items()}
    print(f"  splat_bwd at {tag}: the plan chooses {p_bwd.kernel}; gather "
          f"{by_kernel['gather']:.4f} ms, stream {by_kernel['stream']:.4f} ms")
    record(rows, "splat_bwd", tag,
           max(max_err(dx_k, dx_p, TOL_GATHER, "splat_bwd dwx"),
               max_err(dy_k, dy_p, TOL_GATHER, "splat_bwd dwy"),
               max_err(out["stream"][0], dx_p, TOL_GATHER, "splat_bwd stream dwx"),
               max_err(out["stream"][1], dy_p, TOL_GATHER, "splat_bwd stream dwy")),
           cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor)),
           cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G, retain_graph=True)),
           16 * R * E + 4 * R * H * W, ops_splat_bwd(1) * R * E,
           cuda_ms(lambda: (torch.bmm(Ut, G), torch.bmm(V, G.transpose(1, 2))), reps),
           kernel=p_bwd.kernel, gather_ms=by_kernel["gather"],
           stream_ms=by_kernel["stream"])
    check_splat_window5(tag, wx, wy, wxe, wye, G, sensor, rows)
    del U, V, Ut
    check_direct(tag, theta, xs, ys, wx, wy, wxe, wye, G, sensor, rows)
    return lib_interp_ms


def check_splat_window5(tag, wx, wy, wxe, wye, G, sensor, rows):
    """The splat forward and both backward kernels with a 5x5 window, on
    the window's events with the edge cases and the slab-edge events
    appended: the forward within TOL_ATOMIC of the plain version, both
    backward kernels within TOL_GATHER and bitwise equal to each other; the
    times at window 5 beside their bounds, under `window5_*` in the rows
    of window 3."""
    from eincm_tpu_torch.ops.splat_kernel import (
        plan_splat_bwd, splat_bwd_cuda, splat_fwd_cuda, splat_plain,
    )

    H, W = sensor
    R, E = wx.shape
    f_k = splat_fwd_cuda(wxe, wye, sensor, 5)
    torch.cuda.synchronize()
    wxr, wyr = wxe.clone().requires_grad_(True), wye.clone().requires_grad_(True)
    f_p = splat_plain(wxr, wyr, sensor, 5)
    err_f = max_err(f_k, f_p, TOL_ATOMIC, "splat_fwd window 5")
    dx_p, dy_p = torch.autograd.grad(f_p, (wxr, wyr), G)
    n = wxe.shape[1]
    out = {k: splat_bwd_cuda(wxe, wye, G, sensor, 5, plan_splat_bwd(R, n, H, W, k))
           for k in ("gather", "stream")}
    torch.cuda.synchronize()
    for k in (0, 1):
        if not torch.equal(out["stream"][k], out["gather"][k]):
            raise AssertionError("splat_bwd window 5: the stream kernel is not bitwise the "
                                 "gather kernel's")
    print("  splat_bwd window 5: the stream kernel is bitwise the gather kernel's")
    err_b = max(max_err(out[k][i], ref, TOL_GATHER, f"splat_bwd window 5 {k} {what}")
                for k in out for i, (what, ref) in enumerate((("dwx", dx_p), ("dwy", dy_p))))
    fwd_ms = cuda_ms(lambda: splat_fwd_cuda(wx, wy, sensor, 5))
    bwd_ms = cuda_ms(lambda: splat_bwd_cuda(wx, wy, G, sensor, 5))
    for name, err, ms, n_bytes, ops in (
        ("splat_fwd", err_f, fwd_ms, 8 * R * E + 4 * R * H * W, ops_splat(2) * R * E),
        ("splat_bwd", err_b, bwd_ms, 16 * R * E + 4 * R * H * W, ops_splat_bwd(2) * R * E),
    ):
        bound_ms, bound_by = bound(n_bytes, ops)
        row = rows[name][tag]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(window5_ms=ms, window5_bound_ms=bound_ms, window5_bound_by=bound_by)
        print(f"  {name} window 5: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")


# the float64 interp backward's grids beyond the chain's 16x16
DIRECT_GRIDS = ((32, 32), (64, 64), (128, 128))


def check_direct(tag, theta, xs, ys, wx, wy, wxe, wye, G, sensor, rows):
    """The direct kernels of csrc/direct.cu against the plain versions in
    the same precision, with the edge cases and slab-edge events: the
    float64 interp fwd and bwd and the splat fwd and bwd within TOL_F64,
    the wrap-compat splat in float32 (TOL_ATOMIC forward, TOL_GATHER
    backward) and float64 (TOL_F64) at windows 3 and 5; every kernel bitwise
    the same twice, the splat forward also with 1 and 7 event chunks and
    the interp backward with the events permuted; then the float64 kernels
    at the window's shape timed beside their plain version, bound (float64
    operations over F64_OPS_PER_S) and library call, in float64, the interp
    backward also at DIRECT_GRIDS."""
    from eincm_tpu_torch.ops import interp as ti
    from eincm_tpu_torch.ops import splat_kernel as sk

    H, W = sensor
    h, w, _ = theta.shape
    E = xs.shape[0]
    R = wx.shape[0]
    f64 = torch.float64
    gen = torch.Generator(device="cuda").manual_seed(6)
    th64 = theta.to(f64)
    ex, ey = (t.to(f64) for t in with_edges(xs, ys, H, W))
    out_k = ti.interp_direct_fwd_cuda(th64, ex, ey, sensor)
    err_if = max_err(out_k, ti.interp_theta_at_events_plain(th64, ex, ey, sensor), TOL_F64,
                     "interp_direct_fwd float64")
    if not same_bits(ti.interp_direct_fwd_cuda(th64, ex, ey, sensor), out_k):
        raise AssertionError("interp_direct_fwd: two runs differ")
    fin = torch.isfinite(ex) & torch.isfinite(ey)
    bx, by = ex[fin].contiguous(), ey[fin].contiguous()
    g = torch.randn(bx.shape[0], 2, generator=gen, device="cuda", dtype=f64)
    perm = torch.randperm(bx.shape[0], generator=gen, device="cuda")
    err_ib = 0.0
    for gh, gw in ((h, w),) + DIRECT_GRIDS:
        d_k = ti.interp_direct_bwd_cuda(g, bx, by, (gh, gw, 2), sensor)
        err_ib = max(err_ib, max_err(d_k, ti.interp_bwd_plain(g, bx, by, (gh, gw, 2), sensor),
                                     TOL_F64, f"interp_direct_bwd float64 {gh}x{gw}"))
        again = [ti.interp_direct_bwd_cuda(g, bx, by, (gh, gw, 2), sensor),
                 ti.interp_direct_bwd_cuda(g[perm].contiguous(), bx[perm].contiguous(),
                                           by[perm].contiguous(), (gh, gw, 2), sensor)]
        again += [ti.interp_direct_bwd_cuda(g, bx, by, (gh, gw, 2), sensor, ti.plan_interp(
            bx.shape[0], gh, gw, True, mode=mode, f64=True)) for mode in ti.EXACT_MODES]
        if not all(same_bits(d, d_k) for d in again):
            raise AssertionError(f"interp_direct_bwd {gh}x{gw}: not bitwise the same twice, "
                                 f"permuted and in both modes")
    print(f"  interp_direct_bwd: bitwise the same twice, with the events permuted and in "
          f"both modes at {[(h, w), *DIRECT_GRIDS]}")
    err_sf = err_sb = 0.0
    for dtype in (torch.float32, f64):
        ax, ay = wxe.to(dtype).contiguous(), wye.to(dtype).contiguous()
        Gd = G.to(dtype)
        for wrap in (False, True) if dtype == f64 else (True,):
            for ws in (3, 5):
                what = f"{dtype} window {ws}{' wrap' if wrap else ''}"
                ar, br = ax.clone().requires_grad_(True), ay.clone().requires_grad_(True)
                f_p = sk.splat_plain(ar, br, sensor, ws, wrap=wrap)
                f_k = sk.splat_direct_fwd_cuda(ax, ay, sensor, ws, wrap)
                d_p = torch.autograd.grad(f_p, (ar, br), Gd)
                d_k = sk.splat_direct_bwd_cuda(ax, ay, Gd, sensor, ws, wrap)
                torch.cuda.synchronize()
                tol_f, tol_b = (TOL_F64, TOL_F64) if dtype == f64 else (TOL_ATOMIC, TOL_GATHER)
                err_sf = max(err_sf, max_err(f_k, f_p, tol_f, f"splat_direct_fwd {what}"))
                for k, p, n in zip(d_k, d_p, ("dwx", "dwy")):
                    err_sb = max(err_sb, max_err(k, p, tol_b, f"splat_direct_bwd {what} {n}"))
                # exact sums: the same frames again and with 1 and 7 chunks
                plan = sk.plan_splat(R, ax.shape[1], H, W, texel_bytes=8 if dtype == f64 else 4)
                for p in (plan, dataclasses.replace(plan, chunks=1),
                          dataclasses.replace(plan, chunks=7)):
                    if not same_bits(sk.splat_direct_fwd_cuda(ax, ay, sensor, ws, wrap, p), f_k):
                        raise AssertionError(f"splat_direct_fwd {what}: not bitwise the first "
                                             f"launch's frames at {p.chunks} chunks")
                d_again = sk.splat_direct_bwd_cuda(ax, ay, Gd, sensor, ws, wrap)
                if not all(same_bits(a, b) for a, b in zip(d_again, d_k)):
                    raise AssertionError(f"splat_direct_bwd {what}: two runs differ")
                print(f"  splat_direct {what}: bitwise the same twice, the forward also with "
                      f"1 and 7 chunks ({plan.chunks} planned)")
    # times at the window's own shape, in float64
    x64, y64 = xs.to(f64), ys.to(f64)
    g_main = torch.randn(E, 2, generator=gen, device="cuda", dtype=f64)
    thr = th64.clone().requires_grad_(True)
    out_main = ti.interp_theta_at_events_plain(thr, x64, y64, sensor)
    lib_call, _ = grid_sample_interp(th64, x64, y64, sensor)
    record(rows, "interp_direct_fwd", tag, err_if,
           cuda_ms(lambda: ti.interp_direct_fwd_cuda(th64, x64, y64, sensor)),
           cuda_ms(lambda: ti.interp_theta_at_events_plain(th64, x64, y64, sensor)),
           32 * E + 16 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           cuda_ms(lib_call), F64_OPS_PER_S)
    by_grid = {}
    for gh, gw in ((h, w),) + DIRECT_GRIDS:
        uy = ti._axis_weights(y64, gh, gh, float(gh) / H, True)
        vx = ti._axis_weights(x64, gw, gw, float(gw) / W, True)
        p = ti.plan_interp(E, gh, gw, True, f64=True)
        ms = cuda_ms(lambda: ti.interp_direct_bwd_cuda(g_main, x64, y64, (gh, gw, 2), sensor))
        modes = {}
        for mode in ti.EXACT_MODES:
            plan = ti.plan_interp(E, gh, gw, True, mode=mode, f64=True)
            modes[f"{mode}_ms"] = cuda_ms(
                lambda: ti.interp_direct_bwd_cuda(g_main, x64, y64, (gh, gw, 2), sensor, plan))
            modes[f"{mode}_bands"] = plan.bands
        lib = cuda_ms(lambda: torch.einsum("eh,ew,ec->hwc", uy, vx, g_main),
                      3 if E * gh > 10_000_000 else 10)
        bound_ms, bound_by = bound(32 * E + 16 * gh * gw, OPS_INTERP_BWD * E, F64_OPS_PER_S)
        by_grid[f"{gh}x{gw}"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": lib, "mode": p.mode, **modes}
        print(f"  interp_direct_bwd {gh}x{gw} ({p.mode}): kernel {ms:.4f} ms (banded "
              f"{modes['banded_ms']:.4f} in {modes['banded_bands']} bands, global "
              f"{modes['global_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by}), einsum "
              f"{lib:.4f} ms")
        del uy, vx
    main = by_grid[f"{h}x{w}"]
    record(rows, "interp_direct_bwd", tag, err_ib, main["ms"],
           cuda_ms(lambda: torch.autograd.grad(out_main, thr, g_main, retain_graph=True)),
           32 * E + 16 * h * w, OPS_INTERP_BWD * E, main["library_ms"], F64_OPS_PER_S,
           by_grid=by_grid)
    del out_main
    wx64, wy64 = wx.to(f64), wy.to(f64)
    G64 = G.to(f64)
    wxm, wym = wx64.clone().requires_grad_(True), wy64.clone().requires_grad_(True)
    f_main = sk.splat_plain(wxm, wym, sensor)
    U, V = splat_planes(wx64, wy64, sensor)
    reps = 3 if E > 100_000 else 10
    # the plan's one wave of blocks against the chunks that overfill it
    # (ops/splat_kernel.py:plan_splat), where they differ
    p64 = sk.plan_splat(R, E, H, W, texel_bytes=8)
    over = dataclasses.replace(p64, chunks=-(-sk.N_SM // (R * p64.row_slabs * p64.col_slabs)))
    waves = {} if over.chunks == p64.chunks else {
        "blocks": R * p64.chunks * p64.row_slabs * p64.col_slabs,
        "overfull_blocks": R * over.chunks * over.row_slabs * over.col_slabs,
        "overfull_ms": cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx64, wy64, sensor, 3, False,
                                                                over))}
    record(rows, "splat_direct_fwd", tag, err_sf,
           cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx64, wy64, sensor)),
           cuda_ms(lambda: sk.splat_plain(wx64, wy64, sensor)),
           16 * R * E + 8 * R * H * W, ops_splat(1) * R * E,
           cuda_ms(lambda: torch.bmm(U, V), reps), F64_OPS_PER_S,
           wrap_f32_ms=cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx, wy, sensor, 3, True)),
           wrap_f32_bound_ms=bound(8 * R * E + 4 * R * H * W, ops_splat(1) * R * E)[0],
           wrap5_f32_ms=cuda_ms(lambda: sk.splat_direct_fwd_cuda(wx, wy, sensor, 5, True)),
           **waves)
    Ut = U.transpose(1, 2)
    record(rows, "splat_direct_bwd", tag, err_sb,
           cuda_ms(lambda: sk.splat_direct_bwd_cuda(wx64, wy64, G64, sensor)),
           cuda_ms(lambda: torch.autograd.grad(f_main, (wxm, wym), G64, retain_graph=True)),
           32 * R * E + 8 * R * H * W, ops_splat_bwd(1) * R * E,
           cuda_ms(lambda: (torch.bmm(Ut, G64), torch.bmm(V, G64.transpose(1, 2))), reps),
           F64_OPS_PER_S,
           wrap_f32_ms=cuda_ms(lambda: sk.splat_direct_bwd_cuda(wx, wy, G, sensor, 3, True)))
    del U, V, Ut, f_main
    torch.cuda.empty_cache()


# ---- phase 3 ----------------------------------------------------------------

def check_bench_kernels(tag, xs, ys, ts, t_refs, theta, sensor, rows, lib_interp_ms):
    """Phase 3 at one shape: the fused warp+splat kernels and the dense
    interp against their plain versions; adds results to `rows`."""
    from eincm_tpu_torch.experimental import interp_proto as ip
    from eincm_tpu_torch.experimental import splat_fused as sf
    from eincm_tpu_torch.ops.interp import interp_fwd_cuda

    H, W = sensor
    h, w, _ = theta.shape
    E = xs.shape[0]
    print(f"[fused] {tag}: theta {tuple(theta.shape)}, {E} events, t_refs "
          f"{t_refs}, sensor {H}x{W}")
    xi, yi = torch.round(xs), torch.round(ys)
    p8 = sf.card_plan(E, H, W, h, w)
    print(f"[plan] fully fused warp+splat at {tag}: {p8}")
    tiles = sf.plan_fused(E, H, W, h, w, "cluster")
    # events on every edge between the cluster's tiles, once at each
    # reference time, where they are not displaced
    sx, sy = slab_edge_events(tiles.tile_rows, H, W, xs.device, 4)
    n_slab = sx.shape[0]
    exi, eyi = with_edges(torch.cat([xi] + [torch.round(sx)] * len(t_refs)),
                          torch.cat([yi] + [torch.round(sy)] * len(t_refs)), H, W)
    ets = torch.cat([ts] + [torch.full((n_slab,), t, device=ts.device) for t in t_refs]
                    + [torch.full((exi.shape[0] - E - n_slab * len(t_refs),), 0.5,
                                  device=ts.device)])
    th = interp_fwd_cuda(theta, exi, eyi, sensor)
    ethx, ethy = th[:, 0].contiguous(), th[:, 1].contiguous()
    thx, thy = ethx[:E], ethy[:E]
    p7 = sf.card_plan(E, H, W, 0, 0)
    print(f"[plan] fused warp+splat (kernel 7) at {tag}: {p7}")
    e7, e8 = [], []
    for t in t_refs:
        for ws in (3, 5):
            p = sf.fused_warp_splat_frame_plain(exi, eyi, ets, ethx, ethy, t, sensor, ws)
            # both of kernel 7's kernels, whichever the plan chooses here
            for kernel in ("scatter", "cluster"):
                plan = sf.plan_fused(exi.shape[0], H, W, 0, 0, kernel)
                k = sf.fused_warp_splat_cuda(exi, eyi, ets, ethx, ethy, t, sensor, ws, plan)
                torch.cuda.synchronize()
                e7.append(max_err(k, p, TOL_ATOMIC,
                                  f"fused_warp_splat {kernel} t_ref {t} window {ws}"))
            p = sf.fully_fused_warp_splat_frame_plain(exi, eyi, ets, theta, t, sensor, ws)
            # both of kernel 8's kernels, whichever the plan chooses here
            for kernel in ("scatter", "cluster"):
                plan = sf.plan_fused(exi.shape[0], H, W, h, w, kernel)
                k = sf.fully_fused_warp_splat_cuda(exi, eyi, ets, theta, t, sensor, ws, plan)
                torch.cuda.synchronize()
                e8.append(max_err(k, p, TOL_ATOMIC,
                                  f"fully_fused_warp_splat {kernel} t_ref {t} window {ws}"))
    t0 = t_refs[0]
    by_kernel = {
        kernel: cuda_ms(lambda: sf.fused_warp_splat_cuda(
            xi, yi, ts, thx, thy, t0, sensor, 3, sf.plan_fused(E, H, W, 0, 0, kernel)))
        for kernel in ("scatter", "cluster")}
    print(f"  fused_warp_splat at {tag}: the plan chooses {p7.kernel}; scatter "
          f"{by_kernel['scatter']:.4f} ms, cluster {by_kernel['cluster']:.4f} ms")
    record(rows, "fused_warp_splat", tag, max(e7),
           cuda_ms(lambda: sf.fused_warp_splat_cuda(xi, yi, ts, thx, thy, t0, sensor)),
           cuda_ms(lambda: sf.fused_warp_splat_frame_plain(xi, yi, ts, thx, thy, t0, sensor)),
           20 * E + 4 * H * W, (OPS_WARP + ops_splat(1)) * E, None,
           kernel=p7.kernel, scatter_ms=by_kernel["scatter"], cluster_ms=by_kernel["cluster"],
           window5_ms=cuda_ms(lambda: sf.fused_warp_splat_cuda(
               xi, yi, ts, thx, thy, t0, sensor, 5)))
    by_kernel = {
        kernel: cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(
            xi, yi, ts, theta, t0, sensor, 3, sf.plan_fused(E, H, W, h, w, kernel)))
        for kernel in ("scatter", "cluster")}
    print(f"  fully_fused_warp_splat at {tag}: the plan chooses {p8.kernel}; scatter "
          f"{by_kernel['scatter']:.4f} ms, cluster {by_kernel['cluster']:.4f} ms")
    record(rows, "fully_fused_warp_splat", tag, max(e8),
           cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(xi, yi, ts, theta, t0, sensor)),
           cuda_ms(lambda: sf.fully_fused_warp_splat_frame_plain(xi, yi, ts, theta, t0, sensor)),
           12 * E + 8 * h * w + 4 * H * W,
           (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT + OPS_WARP + ops_splat(1)) * E, None,
           kernel=p8.kernel, scatter_ms=by_kernel["scatter"], cluster_ms=by_kernel["cluster"],
           window5_ms=cuda_ms(lambda: sf.fully_fused_warp_splat_cuda(
               xi, yi, ts, theta, t0, sensor, 5)))

    # the worst contention, and the counters' wrap: 40k events inside one
    # texel on a tile edge, kept there by a zero theta (kernel 8) or zero
    # velocities (kernel 7), through both cluster kernels; against the
    # plain version in f64
    gen = torch.Generator(device=xs.device).manual_seed(5)
    ox = 300.2 + 0.2 * torch.rand(40_000, generator=gen, device=xs.device)
    oy = tiles.tile_rows - 0.1 + 0.2 * torch.rand(40_000, generator=gen, device=xs.device)
    ot = torch.rand(40_000, generator=gen, device=xs.device)
    zero = torch.zeros_like(theta)
    zv = torch.zeros_like(ox)
    for ws in (3, 5):
        p = sf.fully_fused_warp_splat_frame_plain(
            ox.double(), oy.double(), ot.double(), zero.double(), 0.0, sensor, ws)
        if not float(p.max()) > 256.0:
            raise AssertionError("the one-texel case does not wrap a counter")
        k = sf.fully_fused_warp_splat_cuda(ox, oy, ot, zero, 0.0, sensor, ws,
                                           sf.plan_fused(40_000, H, W, h, w, "cluster"))
        torch.cuda.synchronize()
        max_err(k, p, TOL_ATOMIC,
                f"fully_fused_warp_splat every event on one texel, window {ws}")
        k = sf.fused_warp_splat_cuda(ox, oy, ot, zv, zv, 0.0, sensor, ws,
                                     sf.plan_fused(40_000, H, W, 0, 0, "cluster"))
        torch.cuda.synchronize()
        max_err(k, p, TOL_ATOMIC, f"fused_warp_splat every event on one texel, window {ws}")

    ex, ey = with_edges(xs, ys, H, W)
    e9 = []
    for mode in ip.MODES:
        k = ip.interp_dense_cuda(theta, ex, ey, sensor, mode)
        torch.cuda.synchronize()
        p = ip.interp_dense_plain(theta, ex, ey, sensor, mode)
        e9.append(max_err(k, p, TOL_GATHER, f"interp_dense {mode}"))
    # `highest` is 3xTF32 on the tensor cores, within ~2^-21 of f32 per
    # term: held to kernel 1 within TOL_GATHER, not bitwise
    ins = in_sensor(xs, ys, H, W)
    xin, yin = xs[ins].contiguous(), ys[ins].contiguous()
    max_err(ip.interp_dense_cuda(theta, xin, yin, sensor, "highest"),
            interp_fwd_cuda(theta, xin, yin, sensor), TOL_GATHER,
            f"interp_dense highest vs interp_fwd, {xin.shape[0]} in-sensor events")
    record(rows, "interp_dense", tag, max(e9),
           cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "highest")),
           cuda_ms(lambda: ip.interp_dense_plain(theta, xs, ys, sensor, "highest")),
           16 * E + 8 * h * w, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E,
           lib_interp_ms,
           dot3_ms=cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "dot3")),
           bf16_ms=cuda_ms(lambda: ip.interp_dense_cuda(theta, xs, ys, sensor, "bf16")),
           layout_ops_ms=ops_dense(h, w) * E / F32_OPS_PER_S * 1e3)


def count_syncs(fn):
    """(fn(), the synchronizing CUDA operations it made, {file:line: count}
    of the innermost lines of this repository that made them), read with
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import collections
    import os
    import traceback
    import warnings

    root = os.path.dirname(os.path.realpath(__file__))  # the path imports resolve to
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            path, line = [(os.path.realpath(f.filename), f.lineno)
                          for f in traceback.extract_stack()[:-1]  # not this frame
                          if os.path.realpath(f.filename).startswith(root)][-1]
            where[f"{os.path.relpath(path, root)}:{line}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # the first switch to "warn" in a process reports itself as a sync
        warnings.showwarning = lambda *args, **kw: None
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(where)


def eval_both(tag, theta_full, staged, params, sensor, device):
    """`prepare_eval_inputs` + `evaluate_theta_array` of a full-sensor theta
    over a staged sample's eval events and GT, on `device` and then on the
    CPU, the launch counters read around each call; the first's values held
    to the CPU's. Returns the first's (evals, ms per evaluation, ms to
    prepare, host syncs of one evaluation)."""
    from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, prepare_eval_inputs
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils.profiling import timed

    ev = staged.eval_events
    out = []
    for dev in (device, torch.device("cpu")):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        ex, ey, et = f32(ev["x"]), f32(ev["y"]), f32(ev["t"])
        edges, edge_ts = staged.window.edges.to(dev), staged.window.edge_ts.to(dev)
        gt, th = f32(staged.gt_flow), theta_full.to(dev)
        prep = lambda: prepare_eval_inputs(ex, ey, et, edges, sensor, dtype=th.dtype)
        evaluate = lambda: evaluate_theta_array(
            th, exs, eys, ets, edges, edge_ts, gt, params, sensor, window_statics=wstat)
        _build.reset_launch_counts()
        exs, eys, ets, wstat = prep()
        prep_launches = _build.launch_counts()
        _build.reset_launch_counts()
        _, eval_str, evals, _ = evaluate()
        eval_launches = _build.launch_counts()
        out.append(evals)
        if len(out) > 1:
            continue
        if dev.type == "cuda" and (prep_launches["splat_fwd"], eval_launches["splat_fwd"]) != (1, 2):
            raise AssertionError(f"[eval] {tag}: splat_fwd launched {prep_launches} to "
                                 f"prepare, {eval_launches} per evaluation; not 1 and 2")
        prep_s, _ = timed(prep, iters=3)
        eval_s, _ = timed(evaluate, iters=5)
        syncs = None
        if dev.type == "cuda":
            _, syncs, where = count_syncs(evaluate)
            if syncs != 1:
                raise AssertionError(f"[eval] {tag}: {syncs} host syncs per evaluation, "
                                     f"not the one transfer of its bundle: {where}")
        print(f"[eval] {tag}: {eval_str.strip()}")
        print(f"[eval] {tag}: {eval_s * 1e3:.3f} ms per evaluation, prepare "
              f"{prep_s * 1e3:.3f} ms; launches: prepare {prep_launches['splat_fwd']} "
              f"splat_fwd, evaluation {dict((n, c) for n, c in eval_launches.items() if c)}; "
              f"{syncs} host sync(s) per evaluation")
        first = (evals, eval_s * 1e3, prep_s * 1e3, syncs)
    compare_evals("[eval]", tag, out[0], out[1], "card vs CPU")
    return first


def compare_evals(phase, tag, k, p, what):
    """Hold one window's `evals` `k` to `p`: the counts equal, every value
    within TOL_DSEC_LOSS relative (the A{n}PE rates also within one pixel's
    share), the AEE within TOL_EVAL_AEE relative. Returns the worst
    relative difference."""
    counts = ("n_ee", "n_pred", "n_gt", "n_pixels")
    for key in counts:
        if int(k[key]) != int(p[key]):
            raise AssertionError(f"{phase} {tag}: {key} {k[key]}, {p[key]} ({what})")
    worst = 0.0
    for key, ref in p.items():
        if key in counts:
            continue
        ref, got = np.asarray(ref, np.float64), np.asarray(k[key], np.float64)
        atol = 100.0 / max(int(p["n_ee"]), 1) if key[0] == "A" and key.endswith("PE") else 0.0
        err = np.abs(got - ref)
        if not np.all(err <= TOL_DSEC_LOSS * np.abs(ref) + atol):
            raise AssertionError(f"{phase} {tag}: {key} {got}, {ref} ({what})")
        worst = max(worst, float(np.max(err / np.maximum(np.abs(ref), 1e-30))))
    aee_rel = abs(float(k["AEE"]) - float(p["AEE"])) / max(abs(float(p["AEE"])), 1e-30)
    if not aee_rel <= TOL_EVAL_AEE:
        raise AssertionError(f"{phase} {tag}: AEE {k['AEE']}, {p['AEE']} ({what})")
    print(f"{phase} {tag}: {what}, every value within {TOL_DSEC_LOSS:.0e} relative "
          f"(worst {worst:.3e}), AEE rel {aee_rel:.3e}, counts equal "
          f"(n_ee {int(k['n_ee'])}, n_pred {int(k['n_pred'])}, n_gt {int(k['n_gt'])})")
    return worst


def wolfe_chain(cfg, windows, vels, device):
    """Phase 6: the chain under the armijo rescue's configuration, each
    window checked (see the module docstring), then window 1 again under
    the sync debug mode. Returns (results, launches, evaluations, record)."""
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils import workloads as wl

    wcfg = dataclasses.replace(cfg, line_search="wolfe", max_ls_evals=10,
                               collect_intermediate=True, compute_prior_loss=True)
    solver = make_window_solver(wcfg, device)
    ho_cap = 2 + 2 + wcfg.handover_opt_maxiters[0]  # bounds, 2 interior, 1 a step
    _build.reset_launch_counts()
    seen = _build.launch_counts()
    aees, ms, evals, results, per_window = [], [], 0, [], []
    for res, rec in wl.solve_chain(solver, wcfg, windows, vels):
        k = rec["window"]
        now = _build.launch_counts()
        rec["launches_per_eval"] = {n: (now[n] - seen[n]) / rec["evals"] for n in CHAIN_KERNELS}
        seen = now
        for th in res.final_theta_pyr:
            if not bool(torch.isfinite(th).all()):
                raise AssertionError(f"[wolfe] window {k}: non-finite theta")
        if not set(rec["statuses"]) <= OK_STATUSES:
            raise AssertionError(f"[wolfe] window {k}: statuses {rec['statuses']}")
        prior_loss = float(res.prior_loss_lvl0)
        if (prior_loss == math.inf) != (k == 0) or math.isnan(prior_loss):
            raise AssertionError(f"[wolfe] window {k}: prior loss {prior_loss}")
        for lvl, (h, st) in enumerate(zip(res.theta_histories, res.theta_opt_states)):
            if h.n != st.total_iters or float(h.fs[h.n - 1]) != float(st.fun_val):
                raise AssertionError(f"[wolfe] window {k} level {lvl}: history n {h.n}, "
                                     f"last loss {float(h.fs[h.n - 1])}; the solve's "
                                     f"{st.total_iters}, {float(st.fun_val)}")
        ho = res.handover_histories[0]
        if ho.n != (0 if k == 0 else ho_cap) or ho.xs.shape != (ho_cap,):
            raise AssertionError(f"[wolfe] window {k}: handover history n {ho.n}, "
                                 f"{tuple(ho.xs.shape)} (capacity {ho_cap})")
        aees.append(rec["aee"])
        ms.append(rec["ms"])
        evals += rec["evals"]
        results.append(res)
        rec["prior_loss"] = prior_loss
        per_window.append(rec)
        print(f"[wolfe] window {k}: {rec['ms']:.1f} ms  AEE {rec['aee']:.4f} px  iters/level "
              f"{rec['iters']}  statuses {rec['statuses']}  evals {rec['evals']}  host syncs "
              f"{rec['host_syncs']}  prior loss {prior_loss:.6f}  launches per evaluation "
              f"{ {n: round(v, 4) for n, v in rec['launches_per_eval'].items()} }")
    launches = _build.launch_counts()
    mean_aee = float(np.mean(aees[1:]))
    print(f"[wolfe] mean AEE windows 1-5: {mean_aee:.4f} px (limit {MAX_WOLFE_AEE}; JAX on "
          f"CPU {WOLFE_JAX_AEE}); kernel launches {launches}; {evals} loss evaluations; "
          f"window ms median of 1-5 {float(np.median(ms[1:])):.1f}")
    if not mean_aee <= MAX_WOLFE_AEE:
        raise AssertionError(f"[wolfe] mean AEE {mean_aee} > {MAX_WOLFE_AEE}")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"[wolfe] kernels not launched: {missing}")
    row = {"windows": per_window, "mean_aee": mean_aee, "median_ms": float(np.median(ms[1:]))}
    if device.type == "cuda":
        # window 1 again from window 0's result: every synchronizing
        # operation of the solve, read by the sync debug mode, against the
        # count the solver reports
        res1, syncs, where = count_syncs(
            lambda: solver(windows[1], results[0].final_theta_pyr, False))
        print(f"[wolfe] window 1 again: {syncs} synchronizing operations seen, n_host_syncs "
              f"{res1.n_host_syncs}; made at {where}")
        if syncs != res1.n_host_syncs:
            raise AssertionError("[wolfe] the solve synchronizes where it does not count it")
        row["sync_check"] = {"seen": syncs, "n_host_syncs": res1.n_host_syncs, "where": where}
    return results, launches, evals, row


def _scores(path):
    """scores.txt -> {metric: its line}."""
    lines = [l for l in path.read_text().splitlines() if l and not l.startswith("#")]
    return {l.split(":")[0]: l for l in lines}


def _exact_metric(name):
    """The flow errors and counts, which the splat's atomics do not touch."""
    return name.startswith(("AEE", "AREE", "n_")) or re.fullmatch(r"A\d+PE", name)


def experiment_phase(card, device):
    """Phase 8 (see the module docstring). Returns (record, launches)."""
    import shutil
    import tempfile
    from pathlib import Path

    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader, validate_opt_results
    from eincm_tpu_torch.ops import _build

    config = Path(__file__).resolve().parent / "configs" / "mvsec_indoor.yaml"
    base = ["--device", str(device), "--config", str(config), *EXPERIMENT_OVERRIDES]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        exp = experiment_main([*base, f"output_dir={tmp}/first"])
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        first_s = time.perf_counter() - t0
        loader = EINCMOutputLoader()
        opt = loader.load_opt_results(exp.out_dir / "opt_results.npz")  # validates
        validate_opt_results(opt, exp.solver_cfg.n_pyr_lvls)
        loader.load_eval_results(exp.out_dir / "eval_results.npz")  # validates
        n = len(exp.stats)
        aees = [float(exp.eval_results[f"datasample_idx_{i}"]["evals"]["AEE"]) for i in range(n)]
        solve_ms = [exp.stats[i]["solve_ms"] for i in range(n)]
        rec = {
            "card": card, "config": str(config.relative_to(config.parent.parent)),
            "overrides": list(EXPERIMENT_OVERRIDES), "windows": n, "wall_s": first_s,
            "stage_s": [exp.stats[i]["stage_s"] for i in range(n)],
            "solve_ms": solve_ms,
            "solve_ms_median_1_7": float(np.median(solve_ms[1:])),
            "solve_ms_p90_1_7": float(np.percentile(solve_ms[1:], 90)),
            "eval_ms": [exp.stats[i]["eval_ms"] for i in range(n)],
            "host_syncs": [exp.stats[i]["host_syncs"] for i in range(n)],
            "evals": [exp.stats[i]["evals"] for i in range(n)],
            "rescue_attempts": exp.n_rescue_attempts, "rescued": exp.n_rescued,
            "launches": {k: launches[k] for k in CHAIN_KERNELS},
            "aee": aees, "mean_aee_1_7": float(np.mean(aees[1:])),
        }
        print(f"[experiment] {card}: {config.name} {' '.join(EXPERIMENT_OVERRIDES)}, "
              f"{n} windows in {first_s:.2f} s")
        print(f"[experiment] {card}: staging s per window "
              f"{[round(s, 3) for s in rec['stage_s']]}")
        print(f"[experiment] {card}: solve ms per window {[round(m, 1) for m in solve_ms]}; "
              f"windows 1-7 median {rec['solve_ms_median_1_7']:.1f}, p90 "
              f"{rec['solve_ms_p90_1_7']:.1f}")
        print(f"[experiment] {card}: EVAL ms per window "
              f"{[round(m, 2) for m in rec['eval_ms']]}")
        print(f"[experiment] {card}: host syncs per window {rec['host_syncs']}; armijo "
              f"rescue: {exp.n_rescue_attempts} attempts, {exp.n_rescued} replaced")
        n_evals = sum(rec["evals"])
        print(f"[experiment] {card}: kernel launches {rec['launches']}; {n_evals} BFGS loss "
              f"evaluations ({rec['evals']} per window): per evaluation "
              f"{ {k: round(v / n_evals, 4) for k, v in rec['launches'].items()} }")
        print(f"[experiment] {card}: AEE per window {[round(a, 4) for a in aees]}; mean of "
              f"windows 1-7 {rec['mean_aee_1_7']:.4f} px (limit {MAX_EXPERIMENT_AEE}; JAX on "
              f"CPU {EXPERIMENT_JAX_AEE}; zero flow {EXPERIMENT_SPEED} px)")
        missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"[experiment] kernels not launched: {missing}")
        if not rec["mean_aee_1_7"] <= MAX_EXPERIMENT_AEE:
            raise AssertionError(f"[experiment] mean AEE {rec['mean_aee_1_7']} > "
                                 f"{MAX_EXPERIMENT_AEE}")
        if not max(aees) < EXPERIMENT_SPEED:
            raise AssertionError(f"[experiment] a window's AEE is not below zero flow's: {aees}")

        # resumed from the first checkpoint: only the later windows solve
        ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
        if len(ckpts) != 4:
            raise AssertionError(f"[experiment] checkpoints {[c.name for c in ckpts]}, not 4")
        ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
        resumed = experiment_main([*base, f"output_dir={tmp}/resumed", "phases.eval=false",
                                   f"phases.run_from_checkpoint={ckpts[0]}"])
        solved = sorted(i for i, s in resumed.stats.items() if "solve_ms" in s)
        if solved != list(range(len(ck), n)) or len(resumed.opt_results) != n:
            raise AssertionError(f"[experiment] resumed from {ckpts[0].name} "
                                 f"({len(ck)} windows) solved {solved}")
        for key, r in ck.items():
            for group, levels in r["solver_final_results"].items():
                for lvl, v in levels.items():
                    got = resumed.opt_results[key]["solver_final_results"][group][lvl]
                    if isinstance(v, np.ndarray) and not np.array_equal(got, v):
                        raise AssertionError(f"[experiment] resumed {key} {group} {lvl} "
                                             "differs from the checkpoint")
        print(f"[experiment] {card}: resumed from {ckpts[0].name}: windows {solved} "
              f"solved, the {len(ck)} restored records bitwise the checkpoint's")

        # EVAL only, from the saved opt_results.npz
        only_dir = Path(tmp) / "eval_only" / exp.out_dir.name
        only_dir.mkdir(parents=True)
        shutil.copy(exp.out_dir / "opt_results.npz", only_dir / "opt_results.npz")
        only = experiment_main([*base, f"output_dir={only_dir.parent}", "phases.solve=false"])
        a, b = _scores(exp.out_dir / "scores.txt"), _scores(only.out_dir / "scores.txt")
        if list(a) != list(b):
            raise AssertionError(f"[experiment] EVAL-only metrics {list(b)}, first {list(a)}")
        for key in a:
            if _exact_metric(key) and a[key] != b[key]:
                raise AssertionError(f"[experiment] EVAL-only {b[key]!r}, first {a[key]!r}")
        # the IWE metrics window by window, unrounded: scores.txt prints 6
        # decimals, one unit of which is 1e-4 of a value near 0.01
        worst = 0.0
        for key, first in exp.eval_results.items():
            again = only.eval_results[key]["evals"]
            for metric, x in first["evals"].items():
                x, y = np.asarray(x), np.asarray(again[metric])
                if _exact_metric(metric):
                    if not np.array_equal(x, y):
                        raise AssertionError(f"[experiment] EVAL-only {key} {metric} {y}, "
                                             f"first {x}")
                    continue
                worst = max(worst, float(np.max(abs(x - y)) / max(np.max(abs(x)), 1e-30)))
        if not worst <= TOL_SCORES:
            raise AssertionError(f"[experiment] EVAL-only scores differ by {worst:.3e}")
        identical = (exp.out_dir / "scores.txt").read_text() == (
            only.out_dir / "scores.txt").read_text()
        print(f"[experiment] {card}: EVAL-only run from opt_results.npz: scores.txt "
              f"{'identical' if identical else 'equal in its flow errors'}; every window's "
              f"flow errors exactly, its IWE metrics worst {worst:.3e} relative")
        rec.update(resumed_solved=solved, eval_only_identical=identical,
                   eval_only_worst_rel=worst)
    return rec, launches


# ---- 13-14. the window mesh: [parallel] on one member, [ranks] over two ---

# the parallel CLI runs: sequence_shard (one member: the exact chain) with
# the sharded EVAL
PARALLEL_OVERRIDES = ("phases.parallel_windows=true", "phases.parallel_mode=sequence_shard",
                      "phases.parallel_eval=true")
PARALLEL_AEE_BAND = 0.05  # px, a schedule's AEE against its reference's
RANKS_TIMEOUT_S = 300


def _solve_record(stats, launches):
    """The per-solve records a schedule noted (`window_stats`) and the
    launch counts of its run, as one phase record."""
    evals = sum(s["evals"] for s in stats)
    return {
        "solves": [[s["window"], s["pass"]] for s in stats],
        "solve_ms": [s["ms"] for s in stats], "host_syncs": [s["host_syncs"] for s in stats],
        "evals": evals, "launches": {k: launches[k] for k in CHAIN_KERNELS},
        "launches_per_eval": {k: launches[k] / max(evals, 1) for k in CHAIN_KERNELS},
    }


def check_chain(phase, priors, finals):
    """The exact handover chain, whatever the card's run-to-run noise: each
    window's level-0 prior is its predecessor's kept level-0 final, bit for
    bit (across a rank boundary too: gloo carries the bits)."""
    for k in range(1, len(finals)):
        if not np.array_equal(np.asarray(priors[k]), np.asarray(finals[k - 1])):
            raise AssertionError(f"{phase}: window {k}'s prior is not window {k - 1}'s final")


def record_chain(phase, records, n):
    """`check_chain` on an experiment's records (opt_results.npz layout)."""
    sfr = [records[f"datasample_idx_{k}"]["solver_final_results"] for k in range(n)]
    check_chain(phase, [r["prior_theta_pyr"]["pyr_lvl_0"] for r in sfr],
                [r["final_theta_pyr"]["pyr_lvl_0"] for r in sfr])


def parallel_mvsec_phase(card, device, cfg, staged, vels, chain_mean_aee):
    """[parallel] on the 6 staged MVSEC windows, on a one-member mesh: the
    three schedules, each with the launch counters read around it, then
    `eval_batch_sharded` against `evaluate_theta_array`. Returns (record,
    {schedule: launches})."""
    from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, format_eval_result
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
    from eincm_tpu_torch.parallel import batch as pb
    from eincm_tpu_torch.utils import workloads as wl

    windows = [s.window for s in staged]
    n, sensor = len(windows), tuple(cfg.sensor_size)
    batch = pb.stack_windows(windows)
    mesh = pb.make_window_mesh(1, device=device)
    rec, launches = {"card": card}, {}

    def aees(theta0):
        return [wl.aee_at_events(theta0[k], windows[k], vels[k], sensor) for k in range(n)]

    # the reference of the batched solve: each window alone, first-sample
    solver = make_window_solver(cfg, device)
    ref_theta = [solver(windows[k], cfg.zero_pyramid(device=device), True).final_theta_pyr[0]
                 for k in range(n)]
    ref_aee = [wl.aee_at_events(ref_theta[k], windows[k], vels[k], sensor) for k in range(n)]

    schedules = {
        "batch_sharded": lambda st: pb.solve_window_batch_sharded(cfg, batch, mesh,
                                                                  window_stats=st),
        "two_pass": lambda st: pb.two_pass_sequence_solve(cfg, batch, mesh, window_stats=st)[0],
        "sequence_shard": lambda st: pb.sequence_shard_solve(cfg, batch, mesh,
                                                             window_stats=st)[0],
    }
    results = {}
    for name, run in schedules.items():
        stats = []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(stats)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches[name] = _build.launch_counts()
        r = {"wall_s": wall_s, "aee": aees(res.final_theta_pyr[0]), **_solve_record(stats, launches[name])}
        results[name], rec[name] = res, r
        print(f"[parallel] {card}: MVSEC {name}, {n} windows in {wall_s:.2f} s; solves (window, "
              f"pass) {r['solves']}, ms {[round(m, 1) for m in r['solve_ms']]}, host syncs "
              f"{r['host_syncs']}; AEE per window {[round(a, 4) for a in r['aee']]}; launches "
              f"{r['launches']}, per evaluation "
              f"{ {k: round(v, 4) for k, v in r['launches_per_eval'].items()} }")
        missing = [k for k in CHAIN_KERNELS if launches[name][k] == 0]
        if missing:
            raise AssertionError(f"[parallel] {name}: kernels not launched: {missing}")
    gap = [abs(a - b) for a, b in zip(rec["batch_sharded"]["aee"], ref_aee)]
    print(f"[parallel] batch_sharded against each window solved alone: AEE "
          f"{[round(a, 4) for a in ref_aee]}, worst gap {max(gap):.4f} px (limit "
          f"{PARALLEL_AEE_BAND})")
    if not max(gap) <= PARALLEL_AEE_BAND:
        raise AssertionError(f"[parallel] batch_sharded AEE off the lone solves by {gap}")
    # the kernels' sums are exact, so a solve is bitwise the same every time
    theta_bs = results["batch_sharded"].final_theta_pyr[0]
    off = [k for k in range(n) if not torch.equal(theta_bs[k], ref_theta[k])]
    if off:
        raise AssertionError(f"[parallel] batch_sharded windows {off}: theta not bitwise the "
                             f"lone solve's")
    print("[parallel] batch_sharded: every window's theta bitwise its lone solve's")
    rec["batch_sharded"]["reference_aee"] = ref_aee
    tp = float(np.mean(rec["two_pass"]["aee"][1:]))
    ss = float(np.mean(rec["sequence_shard"]["aee"][1:]))
    print(f"[parallel] mean AEE windows 1-5: two_pass {tp:.4f} px (limit {MAX_MEAN_AEE}), "
          f"sequence_shard {ss:.4f} px ([chain] {chain_mean_aee:.4f} +- {PARALLEL_AEE_BAND})")
    if not tp <= MAX_MEAN_AEE:
        raise AssertionError(f"[parallel] two_pass mean AEE {tp} > {MAX_MEAN_AEE}")
    if not abs(ss - chain_mean_aee) <= PARALLEL_AEE_BAND:
        raise AssertionError(f"[parallel] sequence_shard mean AEE {ss}, [chain] {chain_mean_aee}")
    rec["two_pass"]["mean_aee_1_5"], rec["sequence_shard"]["mean_aee_1_5"] = tp, ss
    # the schedules' structure: sequence_shard solves each window once,
    # seeded by its predecessor's final; two_pass skips window 0's pass 2
    # and the last window's pass 1
    expect = {"batch_sharded": [[k, 1] for k in range(n)],
              "two_pass": [[k, 1] for k in range(n - 1)] + [[k, 2] for k in range(1, n)],
              "sequence_shard": [[k, 1] for k in range(n)]}
    for name, solves in expect.items():
        if rec[name]["solves"] != solves:
            raise AssertionError(f"[parallel] {name} solved {rec[name]['solves']}, not {solves}")
    ss_res = results["sequence_shard"]
    check_chain("[parallel] sequence_shard", ss_res.prior_theta_pyr[0].cpu(),
                ss_res.final_theta_pyr[0].cpu())
    print(f"[parallel] solves as expected ({', '.join(expect)}); sequence_shard: every prior "
          f"bitwise its predecessor's final")

    # the example, run as its docstring gives it (the default bare cuda)
    rec["example"] = run_example(card)

    # the sharded EVAL of sequence_shard's thetas against evaluate_theta_array
    theta = results["sequence_shard"].final_theta_pyr[0]
    lens = [len(s.eval_events["x"]) for s in staged]
    pad_e = max(8192, -(-max(lens) // 8192) * 8192)
    ev = np.full((n, 3, pad_e), np.nan, np.float32)
    for k, s in enumerate(staged):
        ev[k, :, : lens[k]] = [s.eval_events["x"], s.eval_events["y"], s.eval_events["t"]]
    ev = torch.as_tensor(ev, device=device)
    gt = torch.as_tensor(np.stack([s.gt_flow for s in staged]), dtype=torch.float32,
                         device=device)
    p = cfg.params
    pvec = torch.tensor([p.alpha, p.beta, p.gamma, p.delta], dtype=torch.float32, device=device)
    method = cfg.scale_to_sensor_size_method
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    small = pb.eval_batch_sharded(theta, ev[:, 0], ev[:, 1], ev[:, 2], batch.edges,
                                  batch.edge_ts, gt, None, pvec, mesh, sensor, method)
    eval_s = time.perf_counter() - t0
    launches["eval"] = _build.launch_counts()
    if launches["eval"]["splat_fwd"] != 3 * n:
        raise AssertionError(f"[parallel] eval: splat_fwd launched {launches['eval']}, "
                             f"not 3 per window")
    worst = 0.0
    for k, s in enumerate(staged):
        _, _, got = format_eval_result(pb.bundle_at(small, k), sensor, True)
        _, _, ref, _ = evaluate_theta_array(
            scale_theta_to_sensor_size(theta[k], sensor, method), ev[k, 0, : lens[k]],
            ev[k, 1, : lens[k]], ev[k, 2, : lens[k]], batch.edges[k], batch.edge_ts[k],
            gt[k], p, sensor)
        worst = max(worst, compare_evals("[parallel]", f"MVSEC window {k}", got, ref,
                                         "eval_batch_sharded vs evaluate_theta_array"))
    rec["eval"] = {"ms_per_window": eval_s * 1e3 / n, "worst_rel": worst,
                   "launches": {k: launches["eval"][k] for k in CHAIN_KERNELS}}
    print(f"[parallel] {card}: eval_batch_sharded of {n} windows in {eval_s * 1e3:.1f} ms "
          f"({eval_s * 1e3 / n:.2f} ms a window), splat_fwd launched 3 a window")
    return rec, launches


EXAMPLE_TIMEOUT_S = 300


def run_example(card):
    """`python -m eincm_tpu_torch.examples.sequence_sharding` with no
    arguments (device cuda, one member): it exits 0 only if every schedule
    recovered the flow. Killed at EXAMPLE_TIMEOUT_S."""
    import subprocess
    from pathlib import Path

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "eincm_tpu_torch.examples.sequence_sharding"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=EXAMPLE_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[parallel] the sequence_sharding example exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    lines = [l for l in proc.stdout.splitlines() if "AEE" in l]
    print(f"[parallel] {card}: examples.sequence_sharding (bare cuda) in {wall_s:.2f} s: "
          + "; ".join(l.strip() for l in lines))
    return {"wall_s": wall_s, "lines": lines}


def parallel_cli(device, config, overrides):
    """The experiment CLI in this process, the launch counters read around
    it. Returns (experiment, launches, wall seconds)."""
    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    exp = experiment_main(["--device", str(device), "--config", str(config), *overrides])
    torch.cuda.synchronize()
    return exp, _build.launch_counts(), time.perf_counter() - t0


def _stats_record(exp, launches, wall_s):
    n = len(exp.opt_results)
    stats = [exp.stats.get(i, {}) for i in range(n)]
    evals = sum(st.get("evals", 0) for st in stats)
    return {
        "windows": n, "wall_s": wall_s, "stage_s": [st.get("stage_s") for st in stats],
        "solve_ms": [st.get("solve_ms") for st in stats],
        "passes": [st.get("passes") for st in stats],
        "host_syncs": [st.get("host_syncs") for st in stats],
        "eval_ms": [st.get("eval_ms") for st in stats], "evals": evals,
        "launches": {k: launches[k] for k in CHAIN_KERNELS},
        "launches_per_eval": {k: launches[k] / max(evals, 1) for k in CHAIN_KERNELS},
    }


def _print_stats(phase, card, what, r):
    rnd = lambda xs, d: [None if x is None else round(x, d) for x in xs]
    print(f"[{phase}] {card}: {what}: {r['windows']} windows in {r['wall_s']:.2f} s; staging s "
          f"{rnd(r['stage_s'], 3)}; solve ms {rnd(r['solve_ms'], 1)} (passes {r['passes']}); "
          f"host syncs {r['host_syncs']}; EVAL ms {rnd(r['eval_ms'], 2)}; launches "
          f"{r['launches']}, per evaluation "
          f"{ {k: round(v, 4) for k, v in r['launches_per_eval'].items()} }")


def parallel_dsec_phase(card, device, tree, serial):
    """[parallel] at DSEC's full size: the CLI on [dsec]'s tree and config
    in sequence_shard with the sharded EVAL; its mean AEE of windows 1-3
    under [dsec]'s bound and within PARALLEL_AEE_BAND of [dsec]'s serial
    reading. Returns (record, launches)."""
    from pathlib import Path

    config = Path(__file__).resolve().parent / "configs" / REAL_CASES["dsec"][0]
    # the CLI's default device, as the README runs it: a bare cuda
    exp, launches, wall_s = parallel_cli(
        "cuda", config, [*real_args("dsec", tree, tree["root"].parent / "out_parallel"),
                         *PARALLEL_OVERRIDES])
    aee, zero, mean_aee = score(exp, tree, device)
    r = {"card": card, "overrides": list(PARALLEL_OVERRIDES), **_stats_record(exp, launches, wall_s),
         "aee": aee, "mean_aee": mean_aee, "serial_mean_aee": serial["mean_aee"],
         "max_aee": serial["max_aee"]}
    _print_stats("parallel", card, f"DSEC {' '.join(PARALLEL_OVERRIDES)}", r)
    print(f"[parallel] {card}: DSEC AEE per window {[round(a, 4) for a in aee]}; mean of "
          f"windows 1-3 {mean_aee:.4f} px (limit {serial['max_aee']}; [dsec] serial "
          f"{serial['mean_aee']:.4f} +- {PARALLEL_AEE_BAND})")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[parallel] DSEC: kernels not launched: {missing}")
    if not (mean_aee <= serial["max_aee"]
            and abs(mean_aee - serial["mean_aee"]) <= PARALLEL_AEE_BAND):
        raise AssertionError(f"[parallel] DSEC mean AEE {mean_aee}, serial {serial['mean_aee']}")
    if not all(a < z for a, z in zip(aee, zero)):
        raise AssertionError(f"[parallel] DSEC: a window's AEE is not below zero flow's: {aee}")
    if r["passes"] != [1] * r["windows"]:
        raise AssertionError(f"[parallel] DSEC: passes {r['passes']}, not one a window")
    record_chain("[parallel] DSEC", exp.opt_results, r["windows"])
    print(f"[parallel] DSEC: one solve a window, every prior bitwise its predecessor's final")
    return r, launches


def parallel_experiment_phase(card, device):
    """[parallel] the [experiment] sequence in two_pass with super-step
    checkpoints every 50% and the sharded EVAL, then a run resumed from its
    checkpoint: only the second super-step solved, the restored records
    bitwise the checkpoint's. Returns (record, launches)."""
    import tempfile
    from pathlib import Path

    config = Path(__file__).resolve().parent / "configs" / "mvsec_indoor.yaml"
    base = [*EXPERIMENT_OVERRIDES, "phases.parallel_windows=true",
            "phases.parallel_mode=two_pass", "phases.parallel_eval=true",
            "phases.parallel_checkpoint_every_percent=50"]
    with tempfile.TemporaryDirectory() as tmp:
        exp, launches, wall_s = parallel_cli(device, config, [*base, f"output_dir={tmp}/first"])
        n = len(exp.opt_results)
        aees = [float(exp.eval_results[f"datasample_idx_{i}"]["evals"]["AEE"]) for i in range(n)]
        r = {"card": card, **_stats_record(exp, launches, wall_s), "aee": aees,
             "mean_aee_1_7": float(np.mean(aees[1:]))}
        _print_stats("parallel", card, "[experiment] sequence, two_pass, checkpoints every 50%", r)
        print(f"[parallel] {card}: two_pass AEE per window {[round(a, 4) for a in aees]}; mean "
              f"of windows 1-7 {r['mean_aee_1_7']:.4f} px (zero flow {EXPERIMENT_SPEED})")
        missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"[parallel] two_pass: kernels not launched: {missing}")
        if not max(aees) < EXPERIMENT_SPEED:
            raise AssertionError(f"[parallel] two_pass: a window's AEE is not below zero "
                                 f"flow's: {aees}")
        ckpts = sorted(exp.ckpt_dir.glob("checkpoint_*.npz"))
        if [c.name for c in ckpts] != [f"checkpoint_{n // 2 - 1}_{n}.npz"]:
            raise AssertionError(f"[parallel] checkpoints {[c.name for c in ckpts]}")
        ck = np.load(ckpts[0], allow_pickle=True)["opt_results"].item()
        resumed, _, resumed_s = parallel_cli(device, config, [
            *base, f"output_dir={tmp}/resumed", "phases.eval=false",
            f"phases.run_from_checkpoint={ckpts[0]}"])
        solved = sorted(i for i, st in resumed.stats.items() if "solve_ms" in st)
        if solved != list(range(len(ck), n)) or len(resumed.opt_results) != n:
            raise AssertionError(f"[parallel] resumed from {ckpts[0].name} ({len(ck)} windows) "
                                 f"solved {solved}")
        for key, rk in ck.items():
            for group, levels in rk["solver_final_results"].items():
                for lvl, v in levels.items():
                    got = resumed.opt_results[key]["solver_final_results"][group][lvl]
                    if isinstance(v, np.ndarray) and not np.array_equal(got, v):
                        raise AssertionError(f"[parallel] resumed {key} {group} {lvl} differs "
                                             "from the checkpoint")
        print(f"[parallel] {card}: resumed from {ckpts[0].name} in {resumed_s:.2f} s: windows "
              f"{solved} solved, the {len(ck)} restored records bitwise the checkpoint's")
        r.update(resumed_solved=solved, resumed_wall_s=resumed_s)
    return r, launches


def rank_cli_worker(device, config, overrides) -> int:
    """One rank of [ranks]: the experiment CLI on `device` (a bare "cuda":
    the rank's device from `distributed.local_device_ids`) and `config`
    with `overrides`, then one JSON line of this process's launch counts
    and per-window stats."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp, launches, wall_s = parallel_cli(device, config, overrides)
    rank = torch.distributed.get_rank()
    print(json.dumps({"rank_cli": {
        "rank": rank, "wall_s": wall_s, "records": len(exp.opt_results),
        "launches": {k: launches[k] for k in CHAIN_KERNELS},
        "stats": {str(i): st for i, st in exp.stats.items()}}}))
    torch.distributed.destroy_process_group()
    return 0


def ranks_phase(card, device):
    """[ranks] (see the module docstring): the [experiment] sequence in
    sequence_shard with the sharded EVAL, first on one member in this
    process, then over two CLI processes on this one card, joined by gloo.
    Returns (record, {"one_member": launches, "rank0": ..., "rank1": ...})."""
    import os
    import socket
    import subprocess
    import tempfile
    from pathlib import Path

    from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader

    here = Path(__file__).resolve().parent
    config = here / "configs" / "mvsec_indoor.yaml"
    base = [*EXPERIMENT_OVERRIDES, *PARALLEL_OVERRIDES]
    rec, launches = {"card": card}, {}
    with tempfile.TemporaryDirectory() as tmp:
        one, launches["one_member"], wall_s = parallel_cli(
            device, config, [*base, f"output_dir={tmp}/one"])
        n = len(one.opt_results)
        one_aee = [float(one.eval_results[f"datasample_idx_{i}"]["evals"]["AEE"])
                   for i in range(n)]
        rec["one_member"] = {**_stats_record(one, launches["one_member"], wall_s), "aee": one_aee}
        _print_stats("ranks", card, "one member, sequence_shard", rec["one_member"])
        if rec["one_member"]["passes"] != [1] * n:
            raise AssertionError(f"[ranks] one member: passes {rec['one_member']['passes']}")
        record_chain("[ranks] one member", one.opt_results, n)
        name = one.out_dir.name
        del one
        torch.cuda.empty_cache()

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs, logs = [], []
        t0 = time.perf_counter()
        for r in (0, 1):
            argv = [sys.executable, str(here / "chip_smoke.py"), "--rank-cli", device.type,
                    str(config), *base, "distributed.enable=true",
                    f"distributed.coordinator_address=127.0.0.1:{port}",
                    "distributed.num_processes=2", f"distributed.process_id={r}",
                    "distributed.local_device_ids=[0]", f"output_dir={tmp}/rank{r}"]
            out, err = open(f"{tmp}/rank{r}.out", "w"), open(f"{tmp}/rank{r}.err", "w")
            logs.append((out, err))
            procs.append(subprocess.Popen(argv, cwd=here, stdout=out, stderr=err,
                                          env=dict(os.environ)))
        try:
            # a rank that fails makes the phase kill the other at once
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.perf_counter() - t0 > RANKS_TIMEOUT_S:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for out, err in logs:
                out.close()
                err.close()
        wall_s = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if codes != [0, 0]:
            tails = [Path(f"{tmp}/rank{r}.err").read_text()[-3000:] for r in (0, 1)]
            raise AssertionError(f"[ranks] exit codes {codes} after {wall_s:.1f} s:\n"
                                 + "\n".join(tails))
        reports = []
        for r in (0, 1):
            lines = [l for l in Path(f"{tmp}/rank{r}.out").read_text().splitlines()
                     if l.startswith('{"rank_cli"')]
            reports.append(json.loads(lines[-1])["rank_cli"])
        files = [sorted(str(p.relative_to(tmp)) for p in Path(tmp, f"rank{r}").rglob("*")
                        if p.is_file()) for r in (0, 1)]
        if files[1]:
            raise AssertionError(f"[ranks] rank 1 wrote {files[1]}")
        out_dir = Path(tmp, "rank0", name)
        opt = EINCMOutputLoader().load_opt_results(out_dir / "opt_results.npz")
        ev = EINCMOutputLoader().load_eval_results(out_dir / "eval_results.npz")
        if sorted(opt) != [f"datasample_idx_{i}" for i in range(n)] or len(ev) != n:
            raise AssertionError(f"[ranks] rank 0 wrote {len(opt)} records, {len(ev)} evals")
        aees = [float(ev[f"datasample_idx_{i}"]["evals"]["AEE"]) for i in range(n)]
        # the exact chain over two ranks: window n/2's prior is window
        # n/2 - 1's kept pass-1 final, which crossed from rank 0 to rank 1
        record_chain("[ranks] two ranks (rank 0's opt_results.npz)", opt, n)
        for r, report in enumerate(reports):
            launches[f"rank{r}"] = report["launches"]
            st = [report["stats"].get(str(i), {}) for i in range(n)]
            mine = [i for i in range(n) if "solve_ms" in st[i]]
            evals = sum(st[i]["evals"] for i in mine)
            rec[f"rank{r}"] = {
                "wall_s": report["wall_s"], "windows_solved": mine,
                "stage_s": [st[i].get("stage_s") for i in mine],
                "solve_ms": [st[i]["solve_ms"] for i in mine],
                "passes": [st[i]["passes"] for i in mine],
                "host_syncs": [st[i]["host_syncs"] for i in mine],
                "eval_ms": [st[i].get("eval_ms") for i in mine], "evals": evals,
                "launches": report["launches"],
                "launches_per_eval": {k: report["launches"][k] / max(evals, 1)
                                      for k in CHAIN_KERNELS},
            }
            rr = rec[f"rank{r}"]
            print(f"[ranks] {card}: rank {r}: windows {mine} in {rr['wall_s']:.2f} s (CLI, "
                  f"process start not counted); staging s "
                  f"{[round(x, 3) for x in rr['stage_s'] if x is not None]}; solve ms "
                  f"{[round(x, 1) for x in rr['solve_ms']]} (passes {rr['passes']}); host syncs "
                  f"{rr['host_syncs']}; EVAL ms {[round(x, 2) for x in rr['eval_ms'] if x]}; "
                  f"launches {rr['launches']}, per evaluation "
                  f"{ {k: round(v, 4) for k, v in rr['launches_per_eval'].items()} }")
            missing = [k for k in CHAIN_KERNELS if report["launches"][k] == 0]
            if missing:
                raise AssertionError(f"[ranks] rank {r}: kernels not launched: {missing}")
            # rank 0 keeps its pass 1, rank 1 (the last) solves only pass 2
            half = list(range(r * n // 2, (r + 1) * n // 2))
            if mine != half or rr["passes"] != [1] * len(half):
                raise AssertionError(f"[ranks] rank {r} solved windows {mine}, passes "
                                     f"{rr['passes']}; expected {half} once each")
        gap = [abs(a - b) for a, b in zip(aees[: n // 2], one_aee[: n // 2])]
        mean = float(np.mean(aees[1:]))
        rec.update(wall_s=wall_s, aee=aees, mean_aee_1_7=mean, files_rank0=files[0],
                   chunk0_gap=gap)
        print(f"[ranks] {card}: two ranks on one card in {wall_s:.2f} s (processes started "
              f"to exit), rank 0 wrote {files[0]}, rank 1 nothing; AEE per window "
              f"{[round(a, 4) for a in aees]} (one member {[round(a, 4) for a in one_aee]}); "
              f"rank 0's chunk within {max(gap):.4f} px of one member (limit "
              f"{PARALLEL_AEE_BAND}); mean of windows 1-7 {mean:.4f} px (limit "
              f"{MAX_EXPERIMENT_AEE}; zero flow {EXPERIMENT_SPEED})")
        if not max(gap) <= PARALLEL_AEE_BAND:
            raise AssertionError(f"[ranks] rank 0's chunk off the one-member run: {gap}")
        if not mean <= MAX_EXPERIMENT_AEE:
            raise AssertionError(f"[ranks] mean AEE {mean} > {MAX_EXPERIMENT_AEE}")
        if not max(aees) < EXPERIMENT_SPEED:
            raise AssertionError(f"[ranks] a window's AEE is not below zero flow's: {aees}")
    return rec, launches


# ---- 9-12. the real-data path: trees on disk through the CLI -------------

def _median_p90(values):
    return float(np.median(values)), float(np.percentile(values, 90))


def hdf5_rate(h5_path, keys):
    """(HDF5 backend, MB/s reading `keys`), host clock."""
    from eincm_tpu_torch.data.readers import HDF5FileReader

    t0 = time.perf_counter()
    with HDF5FileReader(h5_path) as rdr:
        n_bytes = sum(rdr.read_dataset(k).nbytes for k in keys)
        backend = rdr.backend
    return backend, n_bytes / 1e6 / (time.perf_counter() - t0)


def png_decode_ms(frames):
    """Median ms of `read_png16` over `frames`, host clock."""
    from eincm_tpu_torch.utils.png16 import read_png16

    ms = []
    for path in frames:
        t0 = time.perf_counter()
        read_png16(path)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def flow_aee_at_events(theta0, sample, velocity, sensor, device):
    """Mean |flow - velocity| over the window's event pixels (ECD: no GT)."""
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    flow = scale_theta_to_sensor_size(torch.as_tensor(theta0, device=device), sensor)
    err = torch.linalg.norm(flow - torch.tensor(velocity, device=device), dim=-1).cpu()
    ev = sample["events"]
    pix = np.unique(ev["y"].astype(np.int64) * sensor[1] + ev["x"].astype(np.int64))
    return float(err.reshape(-1)[torch.as_tensor(pix)].mean())


def zero_flow_aee(sample, sensor):
    """Mean |GT| over the window's event pixels: the AEE of zero flow."""
    ev = sample["events"]
    pix = np.unique(ev["y"].astype(np.int64) * sensor[1] + ev["x"].astype(np.int64))
    return float(np.linalg.norm(sample["flow_gt"].reshape(-1, 2)[pix], axis=-1).mean())


def write_tree(tag, root):
    """The tree of REAL_CASES[tag] under `root`, as dataset_trees describes it."""
    from eincm_tpu_torch.utils import dataset_trees as dt

    n = REAL_CASES[tag][2]
    if tag == "dsec":
        return dt.write_dsec_tree(root, "train", n_windows=n,
                                  events_per_window=DSEC_EVENTS_PER_WINDOW)
    return {"mvsec": dt.write_mvsec_tree, "ecd": dt.write_ecd_tree}[tag](root, n_windows=n)


def real_args(tag, tree, out_dir, n=None):
    """The CLI's overrides for REAL_CASES[tag] over `tree`, solving its first
    `n` windows (default: the case's)."""
    config, overrides, n_case, _ = REAL_CASES[tag]
    n = n_case if n is None else n
    return [*REAL_OVERRIDES, *overrides, f"dataset.root_dir={tree['root']}",
            f"dataset.sequence_name={tree['sequence']}", f"phases.run_idx_range=[0, {n}]",
            f"output_dir={out_dir}"]


def score(exp, tree, device):
    """(AEE per window, zero flow's per window, the mean the bound holds):
    against the loader's GT where it has one (mean over windows 1..N),
    else against the scene's velocity at the event pixels (all windows).
    `exp` is either package's experiment after its run."""
    n = len(exp.opt_results)
    sensor = tuple(exp.cfg.dataset.sensor_size)
    samples = [exp.dataloader[i] for i in range(n)]
    if "flow_gt" in samples[0]:
        aee = [float(np.asarray(exp.eval_results[f"datasample_idx_{i}"]["evals"]["AEE"]))
               for i in range(n)]
        return aee, [zero_flow_aee(smp, sensor) for smp in samples], float(np.mean(aee[1:]))
    aee = [flow_aee_at_events(np.array(
        exp.opt_results[f"datasample_idx_{i}"]["solver_final_results"]["final_theta_pyr"]
        ["pyr_lvl_0"]), samples[i], tree["velocity"], sensor, device) for i in range(n)]
    return aee, [float(np.hypot(*tree["velocity"]))] * n, float(np.mean(aee))


def real_data_phase(tag, card, device, tree):
    """Run REAL_CASES[tag] over `tree` through the CLI, SOLVE and EVAL, the
    launch counters read around it. Returns (record, launches, experiment)."""
    from pathlib import Path

    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.native import events as native_events
    from eincm_tpu_torch.native import vision as native_vision
    from eincm_tpu_torch.ops import _build

    config, overrides, _, jax_aee = REAL_CASES[tag]
    config = Path(__file__).resolve().parent / "configs" / config
    args = ["--device", str(device), "--config", str(config),
            *real_args(tag, tree, tree["root"].parent / f"out_{tag}")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    exp = experiment_main(args)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    wall_s = time.perf_counter() - t0
    n = len(exp.opt_results)
    stats = [exp.stats[i] for i in range(n)]
    n_evals = sum(st["evals"] for st in stats)
    sensor = tuple(exp.cfg.dataset.sensor_size)
    aee, zero, mean_aee = score(exp, tree, device)
    solve_ms = [st["solve_ms"] for st in stats]
    rec = {
        "card": card, "config": config.name, "overrides": [*REAL_OVERRIDES, *overrides],
        "sensor": list(sensor), "windows": n, "events_per_window": [
            int(len(exp.dataloader[i]["events"]["x"])) for i in range(n)],
        "wall_s": wall_s, "stage_s": [st["stage_s"] for st in stats], "solve_ms": solve_ms,
        "solve_ms_median_1_n": _median_p90(solve_ms[1:])[0],
        "solve_ms_p90_1_n": _median_p90(solve_ms[1:])[1],
        "eval_ms": [st.get("eval_ms") for st in stats],
        "host_syncs": [st["host_syncs"] for st in stats], "evals": [st["evals"] for st in stats],
        "rescue_attempts": exp.n_rescue_attempts, "rescued": exp.n_rescued,
        "launches": {k: launches[k] for k in CHAIN_KERNELS},
        "launches_per_eval": {k: launches[k] / n_evals for k in CHAIN_KERNELS},
        "native": bool(native_vision.available() and native_events.available()),
        "aee": aee, "zero_flow_aee": zero, "mean_aee": mean_aee,
        "max_aee": round(jax_aee + REAL_AEE_BAND, 4), "jax_aee": jax_aee,
    }
    print(f"[{tag}] {card}: {config.name} {' '.join(rec['overrides'])}, {n} windows at "
          f"{sensor[0]}x{sensor[1]}, events per window {rec['events_per_window']}, "
          f"SOLVE + EVAL in {wall_s:.2f} s")
    print(f"[{tag}] {card}: staging s per window {[round(x, 3) for x in rec['stage_s']]} "
          f"(edge filters {'native' if rec['native'] else 'numpy'})")
    print(f"[{tag}] {card}: solve ms per window {[round(m, 1) for m in solve_ms]}; windows "
          f"1-{n - 1} median {rec['solve_ms_median_1_n']:.1f}, p90 {rec['solve_ms_p90_1_n']:.1f}")
    print(f"[{tag}] {card}: EVAL ms per window "
          f"{[None if m is None else round(m, 2) for m in rec['eval_ms']]}; host syncs per "
          f"window {rec['host_syncs']}; armijo rescue: {exp.n_rescue_attempts} attempts, "
          f"{exp.n_rescued} replaced")
    print(f"[{tag}] {card}: kernel launches {rec['launches']}; {n_evals} BFGS loss evaluations "
          f"({rec['evals']} per window): per evaluation "
          f"{ {k: round(v, 4) for k, v in rec['launches_per_eval'].items()} }")
    print(f"[{tag}] {card}: AEE per window {[round(a, 4) for a in aee]} (zero flow "
          f"{[round(z, 4) for z in zero]}); mean {rec['mean_aee']:.4f} px (limit "
          f"{rec['max_aee']}; JAX on CPU {jax_aee})")
    if not rec["native"]:
        raise AssertionError(f"[{tag}] the native library did not build")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched: {missing}")
    if not all(math.isfinite(a) for a in aee) or not rec["mean_aee"] <= rec["max_aee"]:
        raise AssertionError(f"[{tag}] mean AEE {rec['mean_aee']} > {rec['max_aee']}")
    if not all(a < z for a, z in zip(aee, zero)):
        raise AssertionError(f"[{tag}] a window's AEE is not below zero flow's: {aee}, {zero}")
    return rec, launches, exp


# ---- [grids] kernel 2's exact sums and the direct kernels on the solve ------

GRIDS_AEE_BAND = 0.05  # px, the float64 solve's AEE against the float32 one's


def _grids_aee(theta0, staged, sensor, params, device):
    """The EVAL path's AEE of a level-0 theta on a staged window (its eval
    events and GT flow), in float32 on the card."""
    from eincm_tpu_torch.evals.theta_metrics import evaluate_theta_array, prepare_eval_inputs
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    ev = staged.eval_events
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    edges = staged.window.edges.to(device, torch.float32)
    edge_ts = staged.window.edge_ts.to(device, torch.float32)
    exs, eys, ets, wstat = prepare_eval_inputs(f32(ev["x"]), f32(ev["y"]), f32(ev["t"]),
                                               edges, sensor)
    full = scale_theta_to_sensor_size(theta0.to(device, torch.float32), sensor)
    _, _, evals, _ = evaluate_theta_array(full, exs, eys, ets, edges, edge_ts,
                                          f32(staged.gt_flow), params, sensor,
                                          window_statics=wstat)
    return float(evals["AEE"])


def _solve_twice(label, solver, window, prior, is_first):
    """Solve one window twice on the card, the launch counters set to 0
    just before each solve and read just after; the two final pyramids
    must be bitwise equal. Returns (result, launches of one solve, ms of
    each, loss evaluations of one solve)."""
    from eincm_tpu_torch.ops import _build

    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = solver(window, prior, is_first)
        torch.cuda.synchronize()
        out.append((res, _build.launch_counts(), (time.perf_counter() - t0) * 1e3))
    (a, launches, ms_a), (b, launches_b, ms_b) = out
    if not _finite_theta(a):
        raise AssertionError(f"[grids] {label}: non-finite theta")
    same = all(torch.equal(x, y) for x, y in zip(a.final_theta_pyr, b.final_theta_pyr))
    if not same or launches != launches_b:
        raise AssertionError(f"[grids] {label}: the two solves differ (theta bitwise "
                             f"{same}, launches {launches} / {launches_b})")
    evals = sum(s.n_fun_evals for s in a.theta_opt_states)
    return a, launches, (ms_a, ms_b), evals


def grids_phase(card, device, tree, dsec_rec, chain):
    """[grids] (see the module docstring). `chain`: (MVSEC solver, its
    config, window 1, its velocity, window 0's final pyramid)."""
    from pathlib import Path

    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.experiments.config import load_config
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops.splat import set_splat_wrap_compat
    from eincm_tpu_torch.utils import workloads as wl

    t0 = time.perf_counter()
    config = Path(__file__).resolve().parent / "configs" / REAL_CASES["dsec"][0]
    cfg = load_config(str(config), [*REAL_CASES["dsec"][1], f"dataset.root_dir={tree['root']}",
                                    f"dataset.sequence_name={tree['sequence']}",
                                    "solver.n_pyr_lvls=6"])
    sensor = tuple(cfg.dataset.sensor_size)
    loader = cfg.dataset.make_loader()
    loader.get_ready()
    sample = loader[1]
    stage = lambda dtype: stage_datasample(
        sample, device, edge_fn=cfg.edge.make_edge_fn(),
        preprocess=cfg.edge.enable_image_preprocessing, pad_to=cfg.dataset.des_n_events,
        dtype=dtype)
    staged = stage(torch.float32)
    staged64 = stage(torch.float64)
    scfg = cfg.solver_config()
    shapes = [scfg.level_shape(lvl) for lvl in range(scfg.n_pyr_lvls)]
    print(f"[grids] {card}: DSEC window 1 ({int(len(sample['events']['x']))} events, "
          f"{sensor[0]}x{sensor[1]}) staged in float32 and float64 in "
          f"{time.perf_counter() - t0:.2f} s; {REAL_CASES['dsec'][0]} with "
          f"solver.n_pyr_lvls=6: grids {shapes}, maxiters {scfg.theta_opt_maxiters}")
    if shapes[0] != (32, 32):
        raise AssertionError(f"[grids] the finest grid is {shapes[0]}, not 32x32")
    solver = make_window_solver(scfg, device)
    zero_aee = zero_flow_aee(sample, sensor)  # as [dsec] scores it
    rec = {"card": card, "grids": shapes, "zero_flow_aee": zero_aee,
           "dsec_5_level_aee": dsec_rec["aee"][1]}
    for label, st, dtype in (("float32", staged, torch.float32),
                             ("float64", staged64, torch.float64)):
        res, launches, ms, evals = _solve_twice(
            f"DSEC 32x32 {label}", solver, st.window, scfg.zero_pyramid(dtype, device=device),
            True)
        aee = _grids_aee(res.final_theta_pyr[0], st, sensor, cfg.loss_params, device)
        launched = {k: n for k, n in launches.items() if n}
        per_eval = {k: n / evals for k, n in launched.items()}
        rec[label] = {"aee": aee, "solve_ms": list(ms), "evals": evals, "launches": launched,
                      "launches_per_eval": per_eval,
                      "iters": [s.total_iters for s in res.theta_opt_states],
                      "statuses": [s.status for s in res.theta_opt_states]}
        print(f"[grids] {card}: DSEC window 1 at 32x32 in {label}, solved twice: theta "
              f"bitwise equal; {ms[0]:.1f} / {ms[1]:.1f} ms; AEE {aee:.4f} px (zero flow "
              f"{zero_aee:.4f}; [dsec]'s 5-level solve {dsec_rec['aee'][1]:.4f}); iterations "
              f"{rec[label]['iters']}; {evals} loss evaluations; launches {launched}, per "
              f"evaluation { {k: round(v, 4) for k, v in per_eval.items()} }")
        if not aee < zero_aee:
            raise AssertionError(f"[grids] {label}: AEE {aee} not below zero flow's {zero_aee}")
        if label == "float32" and not launches["interp_bwd_exact"]:
            raise AssertionError(f"[grids] float32: kernel 2's exact sums not launched at "
                                 f"32x32: {launched}")
        if label == "float64":
            missing = [k for k in DIRECT_KERNELS if not launches[k]]
            if missing:
                raise AssertionError(f"[grids] float64: direct kernels not launched: {missing}")
            gap = abs(aee - rec["float32"]["aee"])
            print(f"[grids] {card}: float64 AEE - float32 AEE {gap:.4f} px (limit "
                  f"{GRIDS_AEE_BAND})")
            if not gap <= GRIDS_AEE_BAND:
                raise AssertionError(f"[grids] float64 AEE {aee} off the float32 one by {gap}")
    del staged, staged64
    # the wrap-compat switch on [chain]'s window 1, from window 0's final
    mv_solver, mv_cfg, window1, vel1, prior = chain
    set_splat_wrap_compat(True)
    try:
        res, launches, ms, evals = _solve_twice("wrap-compat chain window 1", mv_solver,
                                                window1, prior, False)
    finally:
        set_splat_wrap_compat(False)
    aee = wl.aee_at_events(res.final_theta_pyr[0], window1, vel1, mv_cfg.sensor_size)
    launched = {k: n for k, n in launches.items() if n}
    rec["wrap"] = {"aee": aee, "solve_ms": list(ms), "evals": evals, "launches": launched}
    print(f"[grids] {card}: [chain]'s window 1 with the wrap-compat splat, solved twice: "
          f"theta bitwise equal; {ms[0]:.1f} / {ms[1]:.1f} ms; AEE {aee:.4f} px (limit "
          f"{MAX_MEAN_AEE}); launches {launched}")
    if not aee <= MAX_MEAN_AEE:
        raise AssertionError(f"[grids] wrap-compat: AEE {aee} > {MAX_MEAN_AEE}")
    if not (launches["splat_direct_fwd"] and launches["splat_direct_bwd"]):
        raise AssertionError(f"[grids] wrap-compat: the direct splat not launched: {launched}")
    return rec


def real_data_phases(card, device, grids=None):
    """Phases 9-12 (see the module docstring), with `grids(tree, record)`
    run on [dsec]'s tree right after [dsec] (its record under "grids").
    Returns ({tag: record}, {tag: launches})."""
    import shutil
    import tempfile
    from pathlib import Path

    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.utils import dataset_trees as dt
    from eincm_tpu_torch.utils import io_bench

    recs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- 9. [dsec] -----------------------------------------------------
        t0 = time.perf_counter()
        tree = write_tree("dsec", tmp / "dsec")
        write_s = time.perf_counter() - t0
        ev_dir = tree["root"] / f"Train/train_events/{tree['sequence']}/events/left"
        frames = sorted((tree["root"] / f"Train/train_images/{tree['sequence']}/images/left/"
                         "rectified").glob("*.png"))
        backend, mb_s = hdf5_rate(ev_dir / "events.h5",
                                  ("events/x", "events/y", "events/t", "events/p"))
        png_ms = png_decode_ms(frames)
        io = io_bench.measure(reps=3)
        print(f"[dsec] tree written in {write_s:.2f} s: {tree['n_events']} events, "
              f"{len(frames)} RGB frames; HDF5 read by {backend} at {mb_s:.1f} MB/s; PNG "
              f"decode {png_ms:.2f} ms per 480x640 RGB frame; io_bench: {io}")
        rec, launches["dsec"], exp = real_data_phase("dsec", card, device, tree)
        rec.update(hdf5_backend=backend, hdf5_mb_s=mb_s, png_decode_ms=png_ms,
                   tree_write_s=write_s, io_bench=io)
        if min(rec["events_per_window"]) < exp.cfg.dataset.des_n_events:  # 1.5M
            raise AssertionError(f"[dsec] windows of {rec['events_per_window']} events")
        # the config's own Gaussian edges on windows 0-1, for the record
        gauss = experiment_main(["--device", str(device), "--config",
                                 str(Path(__file__).resolve().parent / "configs" / "dsec_test.yaml"),
                                 *real_args("dsec", tree, tmp / "out_dsec_gaussian", 2),
                                 "edge.smoothen_method=gaussian"])
        rec["gaussian_aee"] = score(gauss, tree, device)[0]
        print(f"[dsec] {card}: with the config's Gaussian edges instead, AEE of windows 0-1 "
              f"{[round(a, 4) for a in rec['gaussian_aee']]} (IEDT "
              f"{[round(a, 4) for a in rec['aee'][:2]]}; zero flow "
              f"{rec['zero_flow_aee'][0]:.4f})")
        recs["dsec"] = rec
        del exp, gauss
        torch.cuda.empty_cache()
        if grids is not None:
            recs["grids"] = grids(tree, rec)
            torch.cuda.empty_cache()
        # 13. [parallel] at DSEC's full size, on the same tree
        recs["parallel_dsec"], launches["parallel_dsec"] = parallel_dsec_phase(
            card, device, tree, rec)
        torch.cuda.empty_cache()
        rec["kill_resume"], launches["dsec_resume"] = dsec_kill_resume_phase(
            card, device, tree, rec)
        torch.cuda.empty_cache()
        shutil.rmtree(tree["root"])

        # ---- 10. [submission] ----------------------------------------------
        test = dt.write_dsec_tree(tmp / "dsec_test", "test", n_windows=DSEC_WINDOWS,
                                  events_per_window=DSEC_EVENTS_PER_WINDOW)
        rec, launches["submission"], exp = submission_phase(card, device, test)
        recs["submission"] = rec
        del exp
        torch.cuda.empty_cache()

        # ---- 11. [mvsec] and 12. [ecd] -------------------------------------
        tree = write_tree("mvsec", tmp / "mvsec")
        backend, mb_s = hdf5_rate(tree["root"] / "hdf5/indoor_flying/indoor_flying1_data.hdf5",
                                  ("davis/left/events", "davis/left/image_raw"))
        print(f"[mvsec] tree written: {tree['n_events']} events; HDF5 (events and 260x346 "
              f"frames) read by {backend} at {mb_s:.1f} MB/s")
        rec, launches["mvsec"], _ = real_data_phase("mvsec", card, device, tree)
        rec.update(hdf5_backend=backend, hdf5_mb_s=mb_s)
        recs["mvsec"] = rec
        tree = write_tree("ecd", tmp / "ecd")
        frames = sorted((tree["root"] / tree["sequence"] / "images").glob("*.png"))
        png_ms = png_decode_ms(frames)
        print(f"[ecd] tree written: {tree['n_events']} events as text, {len(frames)} frames; "
              f"PNG decode {png_ms:.2f} ms per 240x180 grey frame")
        rec, launches["ecd"], _ = real_data_phase("ecd", card, device, tree)
        rec.update(png_decode_ms=png_ms)
        recs["ecd"] = rec
    return recs, launches


def submission_phase(card, device, tree):
    """[submission]: `dataset.extended=true` on a test-split tree (the
    extended CSV reconstructed in memory by the loader), SOLVE on
    DSEC_SUBMISSION_WINDOWS windows, the extended CSV written by
    `tools.dsec_extended_evals`, then `tools.dsec_submission` on the
    opt_results.npz; the PNGs read back and held to the port's upscale and
    encoding of each solved level-0 theta, named by the file indices."""
    from pathlib import Path

    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size
    from eincm_tpu_torch.tools import dsec_extended_evals, dsec_submission
    from eincm_tpu_torch.utils.png16 import read_png16

    config = Path(__file__).resolve().parent / "configs" / "dsec_test.yaml"
    out = tree["root"].parent / "out_submission"
    args = ["--device", str(device), "--config", str(config), *REAL_OVERRIDES, IEDT,
            "dataset.extended=true", "phases.eval=false",
            f"dataset.root_dir={tree['root']}", f"dataset.sequence_name={tree['sequence']}",
            f"phases.run_idx_range=[0, {DSEC_SUBMISSION_WINDOWS}]", f"output_dir={out}"]
    extended = tree["official_csv"].with_name(tree["sequence"] + "_.csv")
    if extended.exists():
        raise AssertionError(f"[submission] {extended} exists before the run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    exp = experiment_main(args)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    solve_s = time.perf_counter() - t0
    rows = exp.dataloader.eval_ts_us
    csv = dsec_extended_evals.main(["--root_dir", str(tree["root"]),
                                    "--sequence_name", tree["sequence"]])
    written = np.loadtxt(csv, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    if not np.array_equal(written, rows):
        raise AssertionError("[submission] the written extended CSV differs from the "
                             "loader's reconstruction")
    t0 = time.perf_counter()
    pngs = dsec_submission.main([
        "--sequence_name", tree["sequence"], "--opt_results_path",
        str(exp.out_dir / "opt_results.npz"), "--eval_ts_path", str(csv),
        "--output_dir", str(out / "submission"), "--device", str(device)])
    export_s = time.perf_counter() - t0
    want = [f"{int(rows[i, 2]):06d}.png" for i in range(DSEC_SUBMISSION_WINDOWS)]
    if [p.name for p in pngs] != want:
        raise AssertionError(f"[submission] PNGs {[p.name for p in pngs]}, not {want}")
    for i, path in enumerate(pngs):
        theta = exp.opt_results[f"datasample_idx_{i}"]["solver_final_results"][
            "final_theta_pyr"]["pyr_lvl_0"]
        flow = scale_theta_to_sensor_size(torch.as_tensor(theta, device=device),
                                          (480, 640)).cpu().numpy()
        enc = np.ones((480, 640, 3), np.uint16)
        enc[..., :2] = np.clip(flow * 128.0 + 2**15, 0, 65535).astype(np.uint16)
        got = read_png16(path)
        if got.dtype != np.uint16 or not np.array_equal(got, enc):
            raise AssertionError(f"[submission] {path.name} is not the encoding of window "
                                 f"{i}'s level-0 theta")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[submission] kernels not launched: {missing}")
    stats = [exp.stats[i] for i in range(len(exp.opt_results))]
    rec = {"card": card, "extended_rows": rows[:, 2].tolist(), "windows": len(stats),
           "solve_s": solve_s, "solve_ms": [st["solve_ms"] for st in stats],
           "evals": [st["evals"] for st in stats], "export_s": export_s,
           "pngs": [p.name for p in pngs], "launches": {k: launches[k] for k in CHAIN_KERNELS}}
    print(f"[submission] {card}: extended eval rows (file index) {rec['extended_rows']} "
          f"reconstructed from {tree['official_csv'].name}; SOLVE of {rec['windows']} windows "
          f"in {solve_s:.2f} s (ms {[round(m, 1) for m in rec['solve_ms']]}); launches "
          f"{rec['launches']}")
    print(f"[submission] {card}: {len(pngs)} PNGs {rec['pngs']} in {export_s:.2f} s, each "
          "equal to the upscale and encoding of its window's level-0 theta")
    return rec, launches, exp


BENCH_ROUNDS = 3
STUDY_WINDOWS = 3
KILL_DEADLINE_S = 300


def _loadable(path) -> bool:
    """A checkpoint counts once it loads: the file may be mid-write."""
    try:
        with np.load(path, allow_pickle=True) as z:
            z["opt_results"].item()
        return True
    except Exception:
        return False


def dsec_kill_resume_phase(card, device, tree, serial):
    """[dsec] killed and resumed: the CLI's SOLVE on [dsec]'s tree in a
    subprocess, SIGKILLed once its first checkpoint loads, then resumed in
    this process from it with SOLVE and EVAL, the launch counters read
    around the resume: every window's record, only the windows after the
    checkpoint solved, the first of them from a level-0 prior bitwise the
    checkpoint's last final, kernels 1-4 launched, the mean AEE of windows
    1-3 under [dsec]'s bound. Returns (record, launches)."""
    import signal
    import subprocess
    from pathlib import Path

    from eincm_tpu_torch.experiments.__main__ import main as experiment_main
    from eincm_tpu_torch.experiments.config import load_config
    from eincm_tpu_torch.experiments.outputs import EINCMOutputLoader
    from eincm_tpu_torch.ops import _build

    here = Path(__file__).resolve().parent
    config = here / "configs" / REAL_CASES["dsec"][0]
    out = tree["root"].parent / "out_resume"
    args = [*real_args("dsec", tree, out), "phases.checkpoint_every_percent=25",
            "phases.delete_checkpoints_at_end=false"]
    name = load_config(str(config), args).experiment_name
    ckpt_dir = out / name / "checkpoints"
    log = tree["root"].parent / "resume_solve.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eincm_tpu_torch.experiments", "--device", str(device),
             "--config", str(config), *args, "phases.eval=false"],
            cwd=here, stdout=f, stderr=subprocess.STDOUT)
        ckpt, deadline = None, time.time() + KILL_DEADLINE_S
        try:
            while ckpt is None and proc.poll() is None and time.time() < deadline:
                landed = [c for c in sorted(ckpt_dir.glob("checkpoint_*.npz")) if _loadable(c)]
                ckpt = landed[0] if landed else None
                time.sleep(0.05)
        finally:
            killed = proc.poll() is None
            if killed:
                proc.send_signal(signal.SIGKILL)
            proc.wait()
    kill_s = time.perf_counter() - t0
    if not killed or ckpt is None:
        raise AssertionError(f"[dsec] the SOLVE was not killed after a checkpoint (rc "
                             f"{proc.returncode}): {log.read_text()[-3000:]}")
    saved = EINCMOutputLoader().load_opt_results(str(ckpt))
    last = max(int(k.rsplit("_", 1)[1]) for k in saved)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _build.reset_launch_counts()
    exp = experiment_main(["--device", str(device), "--config", str(config), *args,
                           f"phases.run_from_checkpoint={ckpt}"])
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    resume_s = time.perf_counter() - t1
    n = len(exp.opt_results)
    aee, zero, mean_aee = score(exp, tree, device)
    solved = sorted(i for i, st in exp.stats.items() if "solve_ms" in st)  # EVAL: every window
    prior = exp.opt_results[f"datasample_idx_{last + 1}"]["solver_final_results"][
        "prior_theta_pyr"]["pyr_lvl_0"]
    final = saved[f"datasample_idx_{last}"]["solver_final_results"]["final_theta_pyr"]["pyr_lvl_0"]
    rec = {"card": card, "killed_after_s": kill_s, "checkpoint": ckpt.name,
           "checkpoint_windows": last + 1, "resume_s": resume_s, "wall_s": kill_s + resume_s,
           "solved": solved, "aee": aee, "mean_aee": mean_aee, "max_aee": serial["max_aee"],
           "launches": {k: launches[k] for k in CHAIN_KERNELS},
           "prior_bitwise": bool(np.array_equal(prior, final))}
    print(f"[dsec] {card}: SOLVE killed {kill_s:.2f} s after its start, once {ckpt.name} "
          f"(windows 0-{last}) loaded; resumed with SOLVE + EVAL in {resume_s:.2f} s (wall "
          f"{rec['wall_s']:.2f} s): windows solved {solved}, kernel launches {rec['launches']}")
    print(f"[dsec] {card}: resumed AEE per window {[round(a, 4) for a in aee]}; mean of "
          f"windows 1-3 {mean_aee:.4f} px (limit {serial['max_aee']}); window {last + 1}'s "
          f"level-0 prior bitwise window {last}'s final in the checkpoint: "
          f"{rec['prior_bitwise']}")
    if n != REAL_CASES["dsec"][2] or solved != list(range(last + 1, n)):
        raise AssertionError(f"[dsec] resume: {n} records, windows {solved} solved after "
                             f"checkpoint window {last}")
    if not rec["prior_bitwise"]:
        raise AssertionError(f"[dsec] resume: window {last + 1}'s prior is not the checkpoint's")
    for key, r in saved.items():
        if not np.array_equal(exp.opt_results[key]["solver_final_results"]["final_theta_pyr"]
                              ["pyr_lvl_0"], r["solver_final_results"]["final_theta_pyr"]
                              ["pyr_lvl_0"]):
            raise AssertionError(f"[dsec] resume: {key} is not the checkpoint's")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[dsec] resume: kernels not launched: {missing}")
    if not all(math.isfinite(a) for a in aee) or not mean_aee <= serial["max_aee"]:
        raise AssertionError(f"[dsec] resume: mean AEE {mean_aee} > {serial['max_aee']}")
    return rec, launches


def _finite_theta(res) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in res.final_theta_pyr)


def bench_phase(card, device, chain_median_ms, dsec_median_ms):
    """[bench] each `build_*` bench of utils/benchmarks.py at its full size,
    BENCH_ROUNDS rounds each, the launch counters read around them all.
    Returns (record, launches)."""
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.utils import benchmarks as bm

    rec = {"card": card, "rounds": BENCH_ROUNDS}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for tag, build in (("mvsec", lambda: bm.build_mvsec_solve_bench(device=device)),
                       ("dsec", lambda: bm.build_dsec_solve_bench(device=device)),
                       ("parallel", lambda: bm.build_parallel_solve_bench(device=device))):
        t1 = time.perf_counter()
        one_round, res = build()
        build_s = time.perf_counter() - t1
        s = [one_round() for _ in range(BENCH_ROUNDS)]
        diag = bm.solve_diag_str(res)
        rec[tag] = {"s_per_window": s, "median_s": float(np.median(s)), "build_s": build_s,
                    "diag": diag}
        if tag == "mvsec":
            ref = f"[chain] median {chain_median_ms:.1f} ms"
        elif tag == "dsec":
            ref = f"[dsec] solve median {dsec_median_ms:.1f} ms"
        else:
            ref = f"mesh of {one_round.mesh.size}, 8 first-sample solves a round"
        print(f"[bench] {card}: {tag} solve bench: {np.median(s) * 1e3:.1f} ms a window "
              f"(median of {[round(x * 1e3, 1) for x in s]}; {ref}); built (staging, warm-up "
              f"solves) in {build_s:.2f} s; {diag}")
        if not _finite_theta(res) or not all(x > 0 for x in s):
            raise AssertionError(f"[bench] {tag}: non-finite theta or times {s}")
    one_round = bm.build_dsec_throughput_bench(device=device)
    s = [one_round() for _ in range(BENCH_ROUNDS)]
    mev = bm.DSEC_N_EVENTS * bm.DSEC_N_REFS / float(np.median(s)) / 1e6
    rec["throughput"] = {"s_per_iter": s, "median_s": float(np.median(s)), "mevents_per_s": mev}
    print(f"[bench] {card}: DSEC warp+splat throughput {mev:.1f} Mevents/s "
          f"({bm.DSEC_N_EVENTS} events x {bm.DSEC_N_REFS} refs, {np.median(s) * 1e3:.3f} ms "
          f"an iteration, median of {[round(x * 1e3, 3) for x in s]})")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: launches[k] for k in CHAIN_KERNELS}
    print(f"[bench] {card}: kernel launches {rec['launches']}; {rec['wall_s']:.2f} s")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[bench] kernels not launched: {missing}")
    return rec, launches


def studies_phase(card, device):
    """[studies] each study of eincm_tpu_torch/scripts/ on the card at
    STUDY_WINDOWS windows and one round (the edge study over the whole
    6-window chain with [chain]'s theta_ftol), the launch counters read
    around them all: each
    finishes with its JSON keys, and the mean AEE of each chain it solves
    with the shipped edges is finite and under MAX_MEAN_AEE. Returns
    (record, launches)."""
    import tempfile

    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.scripts import armijo_interp_probe as aip
    from eincm_tpu_torch.scripts import armijo_rescue_validation as arv
    from eincm_tpu_torch.scripts import edge_sensitivity as es
    from eincm_tpu_torch.scripts import ftol_ab
    from eincm_tpu_torch.scripts import hessian_warmstart_probe as hwp
    from eincm_tpu_torch.scripts import ls_evals_ab
    from eincm_tpu_torch.scripts import mvsec_loss_breakdown as mlb

    n = STUDY_WINDOWS
    rec = {"card": card}

    def check_aee(name, aee):
        if not (all(math.isfinite(a) for a in aee) and float(np.mean(aee)) <= MAX_MEAN_AEE):
            raise AssertionError(f"[studies] {name}: AEE {aee} (mean limit {MAX_MEAN_AEE})")

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "armijo_rescue_validation": lambda: arv.study(f"{tmp}/rescue", device=device,
                                                          n_windows=n),
            "ftol_ab": lambda: ftol_ab.study(f"{tmp}/ftol", device=device, n_windows=n,
                                             rounds=1, mvsec_windows=n, dsec_rounds=1,
                                             dsec_windows=2),
            "ls_evals_ab": lambda: ls_evals_ab.study(f"{tmp}/lscap", device=device,
                                                     n_windows=n, rounds=1, mvsec_windows=n),
            "mvsec_loss_breakdown": lambda: mlb.breakdown(device=device, rounds=1, iters=50),
            # the whole chain with [chain]'s theta_ftol (the JAX script leaves
            # it unset), so that its baseline is [chain]'s configuration and
            # statistic, which MAX_MEAN_AEE bounds
            "edge_sensitivity": lambda: es.study(device=device, n_windows=6,
                                                 solver_overrides={"theta_ftol": 1e-5}),
            "armijo_interp_probe": lambda: aip.probe(device=device, n_windows=n, rounds=1,
                                                     bench_rounds=1),
            "hessian_warmstart_probe": lambda: hwp.probe(device=device, n_windows=n, rounds=1),
        }
        for name, run in runs.items():
            t1 = time.perf_counter()
            out = run()
            rec[name] = {"wall_s": time.perf_counter() - t1, "result": out}
            print(f"[studies] {card}: {name} in {rec[name]['wall_s']:.2f} s, keys "
                  f"{sorted(out)}: {json.dumps(out)}")
            if name in ("armijo_rescue_validation", "ftol_ab", "ls_evals_ab"):
                for key, v in out.items():
                    if re.fullmatch(r"aee_(?!mean|worst).*", key):
                        check_aee(f"{name} {key}", v)
            elif name == "edge_sensitivity":  # windows 1-5, as [chain]
                check_aee(name, out["baseline"]["aee_per_window"][1:])
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: launches[k] for k in CHAIN_KERNELS}
    print(f"[studies] {card}: the seven studies in {rec['wall_s']:.2f} s; kernel launches "
          f"{rec['launches']}")
    missing = [k for k in CHAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[studies] kernels not launched: {missing}")
    return rec, launches


# ---- 17. [h5] the codec fixtures and a Blosc-Zstd DSEC events file ---------

CODEC_FIXTURES = "tests/data/codecs"  # written by tests/make_codec_fixtures.py
HDF5_FIXTURES = "tests/data/hdf5"  # written by tests/make_hdf5_fixtures.py
LATEST_EVENTS = "dsec_events_latest.h5"  # HDF5_FIXTURES' DSEC file of events.h5's scene
H5_AEE_BAND = 0.05  # px: the latest-format window's AEE against the Blosc-Zstd one's
ZSTD_RATE_S = 0.5  # the Zstd decoder is timed over at least this long
H5_DES_N_EVENTS = 100_000  # events a window of the fixture's tree (~130k written)
EVENT_KEYS = ("events/x", "events/y", "events/t", "events/p", "ms_to_idx", "t_offset")


def payload_sha(a) -> str:
    """sha256 of an array's bytes; an object array of bytes (variable-length
    strings) hashes as each element's 8-byte little-endian length and
    bytes, in C order."""
    import hashlib

    if a.dtype == object:
        return hashlib.sha256(b"".join(len(x).to_bytes(8, "little") + x
                                       for x in a.reshape(-1))).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check_codec_fixtures(root):
    """The committed codec or HDF5 fixtures under `root` against their
    manifest.json: each file by its sha256 and size, then each payload,
    decoded by the port (a `.zst` frame by `zstd_decompress`, a `.blosc`
    chunk by `blosc.decompress`, an HDF5 dataset by `h5_lite`; native
    decoders where the library is built), by its sha256 (`payload_sha`),
    dtype and shape. Returns {kind: [payloads, decoded bytes]}."""
    import hashlib
    from pathlib import Path

    from eincm_tpu_torch.native import blosc as nb
    from eincm_tpu_torch.utils import blosc, h5_lite

    root = Path(root)
    manifest = json.loads((root / "manifest.json").read_text())
    for rel, f in manifest["files"].items():
        data = (root / rel).read_bytes()
        if len(data) != f["bytes"] or hashlib.sha256(data).hexdigest() != f["sha256"]:
            raise AssertionError(f"[h5] {rel}: not the file its manifest names")
    counts: dict = {}
    for key, p in manifest["payloads"].items():
        rel, _, dataset = key.partition(":")
        dtype, shape = np.dtype(p["dtype"]), tuple(p["shape"])
        if dataset:
            with h5_lite.File(root / rel) as f:
                a = f.read(dataset)
            kind = rel
        else:
            raw = (root / rel).read_bytes()
            if rel.endswith(".zst"):
                raw = nb.zstd_decompress(raw, dtype.itemsize * math.prod(shape))
                kind = "zstd"
            else:
                raw = blosc.decompress(raw)
                kind = "blosc"
            a = np.frombuffer(raw, dtype).reshape(shape)
        if a.dtype != dtype or a.shape != shape or payload_sha(a) != p["sha256"]:
            raise AssertionError(f"[h5] {key}: decoded to other data ({a.dtype}, {a.shape})")
        c = counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += sum(map(len, a.reshape(-1))) if a.dtype == object else a.nbytes
    return counts


def _same_sample(a, b, where: str) -> None:
    """Two loader samples bitwise equal, dtypes included."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            raise AssertionError(f"{where}: other keys")
        for k in a:
            _same_sample(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: other lengths")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_sample(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        x, y = np.asarray(a), np.asarray(b)
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{where}: not bitwise equal")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def _h5_window(label, events, tree, sensor, device, cfg, solver):
    """The DSEC tree's events.h5 (`events`) read through
    `data/readers.py:HDF5FileReader` (h5_lite: MB/s, host clock) and the
    port's DSEC loader, window 0 staged as `utils/workloads.py` stages its
    DSEC window (IEDT edges, padded) and solved on the card from a zero
    prior, the launch counters set to 0 just before the solve and read just
    after it: finite theta, kernels 1-4 launched, the AEE below zero
    flow's. Returns (record, sample, launches)."""
    from eincm_tpu_torch.data import DSECDataLoader
    from eincm_tpu_torch.data.staging import stage_datasample
    from eincm_tpu_torch.experiments.config import EdgeConfig
    from eincm_tpu_torch.ops import _build

    backend, read_mb_s = hdf5_rate(events, EVENT_KEYS)
    if backend != "h5_lite":
        raise AssertionError(f"[h5] {label}: events.h5 read by {backend}, not h5_lite")
    t0 = time.perf_counter()
    loader = DSECDataLoader(tree["root"], tree["sequence"], des_n_events=H5_DES_N_EVENTS,
                            data_split="train")
    loader.get_ready()
    sample = loader[0]
    edge_fn = EdgeConfig(enable_image_preprocessing=False,
                         smoothen_method="eincm_iedt").make_edge_fn()
    staged = stage_datasample(sample, device, edge_fn=edge_fn, preprocess=False,
                              pad_to=H5_DES_N_EVENTS)
    stage_s = time.perf_counter() - t0
    prior = cfg.zero_pyramid(device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver(staged.window, prior, is_first=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = _build.launch_counts()
    aee = flow_aee_at_events(res.final_theta_pyr[0], sample, tree["velocity"], sensor, device)
    zero = zero_flow_aee(sample, sensor)
    rec = {"read_backend": backend, "read_mb_per_s": read_mb_s,
           "events": int(len(sample["events"]["x"])), "stage_s": stage_s,
           "solve_ms": solve_ms, "aee": aee, "zero_flow_aee": zero,
           "launches": {k: launches[k] for k in CHAIN_KERNELS}}
    print(f"[h5] {label} events.h5 read at {read_mb_s:.1f} MB/s ({backend}); DSEC loader + "
          f"staging of window 0 ({rec['events']} events) in {stage_s:.2f} s; solved in "
          f"{solve_ms:.1f} ms: AEE {aee:.4f} px (zero flow {zero:.4f}); kernel launches "
          f"{rec['launches']}")
    if not _finite_theta(res):
        raise AssertionError(f"[h5] {label}: non-finite theta")
    missing = [k for k in CHAIN_KERNELS if device.type == "cuda" and launches[k] == 0]
    if missing:
        raise AssertionError(f"[h5] {label}: kernels not launched: {missing}")
    if not aee < zero:
        raise AssertionError(f"[h5] {label}: AEE {aee} not below zero flow's {zero}")
    return rec, sample, launches


def h5_phase(card, device):
    """[h5] the committed codec fixtures decoded by the native library built
    here and the HDF5 fixtures read by h5_lite, each held to its manifest;
    the Zstd decoder's rate (MB/s of output, host clock) over the largest
    frame; then, in a DSEC tree of the scene of both, the Blosc-Zstd
    events.h5 and the latest-format one (`_h5_window` each): window 0's
    sample bitwise the same, the latest-format window's AEE within
    H5_AEE_BAND of the Blosc-Zstd window's. Returns (record, {"blosc_zstd":
    launches, "latest": launches})."""
    import shutil
    import tempfile
    from pathlib import Path

    from eincm_tpu_torch.models.pyramid import SolverConfig, make_window_solver
    from eincm_tpu_torch.native import blosc as nb
    from eincm_tpu_torch.utils import benchmarks, dataset_trees

    root = Path(__file__).resolve().parent / CODEC_FIXTURES
    h5_root = Path(__file__).resolve().parent / HDF5_FIXTURES
    t0 = time.perf_counter()
    if not nb.available():
        raise AssertionError("[h5] the native library did not build")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = check_codec_fixtures(root)
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h5_counts = check_codec_fixtures(h5_root)
    h5_check_s = time.perf_counter() - t0
    rec = {"card": card, "native_load_s": build_s, "check_s": check_s,
           "fixtures": {k: {"payloads": c[0], "bytes": c[1]} for k, c in counts.items()},
           "hdf5_check_s": h5_check_s,
           "hdf5_fixtures": {k: {"datasets": c[0], "bytes": c[1]} for k, c in h5_counts.items()}}
    print(f"[h5] {card}: every codec fixture matches its manifest, decoded natively in "
          f"{check_s:.3f} s: {rec['fixtures']} (library loaded in {build_s:.2f} s)")
    print(f"[h5] {card}: every HDF5 fixture (superblocks 0, 2, 3; the v4 chunk indexes) "
          f"matches its manifest through h5_lite in {h5_check_s:.3f} s: {rec['hdf5_fixtures']}")

    manifest = json.loads((root / "manifest.json").read_text())
    rel, p = max(((k, v) for k, v in manifest["payloads"].items() if k.endswith(".zst")),
                 key=lambda kv: math.prod(kv[1]["shape"]))
    frame, n_out = (root / rel).read_bytes(), math.prod(p["shape"])
    reps, t0 = 0, time.perf_counter()
    while True:
        nb.zstd_decompress(frame, n_out)
        reps += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ZSTD_RATE_S:
            break
    rec["zstd"] = {"frame": rel, "frame_bytes": len(frame), "out_bytes": n_out, "reps": reps,
                   "s": elapsed, "mb_per_s": n_out * reps / elapsed / 1e6}
    print(f"[h5] {card}: zstd_decompress {rec['zstd']['mb_per_s']:.1f} MB/s of output over "
          f"{rel} ({len(frame)} -> {n_out} bytes, {reps} runs in {elapsed:.3f} s)")

    sensor = (benchmarks.DSEC_H, benchmarks.DSEC_W)
    cfg = SolverConfig(**benchmarks.dsec_config_kwargs())
    solver = make_window_solver(cfg, device)
    runs, samples, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = dataset_trees.write_dsec_tree(Path(tmp), **manifest["events_tree"])
        events = tree["root"] / f"Train/train_events/{tree['sequence']}/events/left/events.h5"
        for label, src in (("blosc_zstd", root / "events.h5"),
                           ("latest", h5_root / LATEST_EVENTS)):
            shutil.copyfile(src, events)
            runs[label], samples[label], launches[label] = _h5_window(
                f"{card}: {label}", events, tree, sensor, device, cfg, solver)
    _same_sample(samples["blosc_zstd"], samples["latest"],
                 "[h5] window 0 of the latest-format file against the Blosc-Zstd file's")
    gap = abs(runs["latest"]["aee"] - runs["blosc_zstd"]["aee"])
    rec.update(runs["blosc_zstd"])
    rec["latest"] = {**runs["latest"], "aee_gap_to_blosc_zstd": gap}
    print(f"[h5] {card}: latest-format events.h5 read at {runs['latest']['read_mb_per_s']:.1f} "
          f"MB/s, Blosc-Zstd at {runs['blosc_zstd']['read_mb_per_s']:.1f} MB/s (h5_lite, host "
          f"clock); window 0 bitwise the same; AEE {runs['latest']['aee']:.4f} px against "
          f"{runs['blosc_zstd']['aee']:.4f} px (|gap| {gap:.4f} <= {H5_AEE_BAND})")
    if not gap <= H5_AEE_BAND:
        raise AssertionError(f"[h5] the latest-format window's AEE is {gap} px off the "
                             f"Blosc-Zstd window's (band {H5_AEE_BAND})")
    return rec, launches


def gt_theta(vel, shape, device):
    th = torch.empty((*shape, 2), dtype=torch.float32, device=device)
    th[..., 0], th[..., 1] = vel
    return th


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    # one rank of [ranks]: DEVICE CONFIG OVERRIDE...
    ap.add_argument("--rank-cli", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    if args.rank_cli:
        return rank_cli_worker(args.rank_cli[0], args.rank_cli[1], args.rank_cli[2:])
    from eincm_tpu_torch.experimental import fused_splat_bench as fb
    from eincm_tpu_torch.experimental import interp_proto as ip
    from eincm_tpu_torch.models.loss import (
        LossParams, LossStatics, _sanitize_events, compute_window_statics,
        solver_loss,
    )
    from eincm_tpu_torch.models.pyramid import make_window_solver
    from eincm_tpu_torch.ops import _build
    from eincm_tpu_torch.ops.splat import set_splat_wrap_compat
    from eincm_tpu_torch.ops.splat_kernel import plan_splat, plan_splat_bwd
    from eincm_tpu_torch.utils import workloads as wl

    # full-f32 matmuls (resize, BFGS); the port's filters use no convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # ---- 1. set-up --------------------------------------------------------
    card = nvidia_smi()
    print(f"[setup] {card}")
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    print("[setup] TF32 off for matmul and cuDNN")
    build_s = _build.build_all(verbose=("interp", "splat", "fused", "interp_dense", "direct"))
    print(f"[setup] built {sorted(p.stem for p in _build.CSRC.glob('*.cu'))} "
          f"with nvcc for sm_90a in {build_s:.2f} s (ptxas report above)")

    # ---- 2. the solve's kernels vs plain -------------------------------------
    t0 = time.perf_counter()
    mvsec_staged, vels = wl.stage_mvsec_samples(device)
    mvsec = [s.window for s in mvsec_staged]
    print(f"[stage] 6 MVSEC windows in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dsec_staged = wl.stage_dsec_sample(device)
    dsec = dsec_staged.window
    print(f"[stage] DSEC window in {time.perf_counter() - t0:.2f} s")
    rows: dict = {}
    mvsec_sensor, dsec_sensor = (wl.MVSEC_H, wl.MVSEC_W), (wl.DSEC_H, wl.DSEC_W)
    for tag, win, sensor in (("mvsec", mvsec[0], mvsec_sensor), ("dsec", dsec, dsec_sensor)):
        R, E = win.edge_ts.shape[0], win.xs.shape[0]
        print(f"[plan] splat fwd at {tag}, {R} refs x {E} events: "
              f"{plan_splat(R, E, *sensor)}")
        print(f"[plan] splat bwd at {tag}: {plan_splat_bwd(R, E, *sensor)}")
    mvsec_theta = gt_theta(vels[0], (16, 16), device)
    lib_ms = {"mvsec": check_kernels("mvsec", mvsec[0], mvsec_theta, mvsec_sensor, rows)}
    dsec_vel = (7.2 * math.cos(math.atan2(-4.0, 6.0)),
                7.2 * math.sin(math.atan2(-4.0, 6.0)))
    lib_ms["dsec"] = check_kernels("dsec", dsec, gt_theta(dsec_vel, (16, 16), device),
                                   dsec_sensor, rows)
    torch.cuda.empty_cache()

    # ---- 3. the measurement kernels, and the fused bench's paths -----------
    w0 = mvsec[0]
    xs, ys, ts = _sanitize_events(w0.xs, w0.ys, w0.ts)
    check_bench_kernels("mvsec", xs, ys, ts, [float(t) for t in w0.edge_ts.cpu()],
                        mvsec_theta, mvsec_sensor, rows, lib_ms["mvsec"])
    with torch.no_grad():
        bench_in = fb.make_inputs(device)
        check_bench_kernels("dsec", bench_in["xs"], bench_in["ys"], bench_in["ts"],
                            bench_in["t_ref_values"], bench_in["theta"], fb.SENSOR,
                            rows, lib_ms["dsec"])
        fns = fb.paths(bench_in)
        proto_in = ip.make_inputs(device)
        print("[fused] main path: the fused bench's paths A, B, C, then the dense "
              "interp against kernel 1 (1.5M events, 480x640)")
        _build.reset_launch_counts()
        fb.check_agreement(fns)
        ip.compare_with_kernel1(*proto_in)
        torch.cuda.synchronize()
        bench_launches = _build.launch_counts()
    print(f"[fused] kernel launches on that path: {bench_launches}")
    missing = [k for k in BENCH_KERNELS if bench_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the fused path: {missing}")
    del fns, bench_in, proto_in
    torch.cuda.empty_cache()

    # ---- 4. main path of the solve: the MVSEC handover chain ---------------
    cfg = wl.mvsec_solver_config()
    solver = make_window_solver(cfg, device)
    _build.reset_launch_counts()
    aees, evals, chain_recs = [], 0, []
    for res, rec in wl.solve_chain(solver, cfg, mvsec, vels):
        k = rec["window"]
        chain_recs.append(rec)
        if k == 0:
            chain_w0_final = res.final_theta_pyr
        for th in res.final_theta_pyr:
            if not bool(torch.isfinite(th).all()):
                raise AssertionError(f"window {k}: non-finite theta")
        if not set(rec["statuses"]) <= OK_STATUSES:
            raise AssertionError(f"window {k}: statuses {rec['statuses']}")
        aees.append(rec["aee"])
        evals += rec["evals"]
        print(f"[chain] window {k}: {rec['ms']:.1f} ms  AEE {rec['aee']:.4f} px  "
              f"(prior kept: {rec['prior_aee']:.4f})  iters/level {rec['iters']}  "
              f"statuses {rec['statuses']}  evals {rec['evals']}  "
              f"host syncs {rec['host_syncs']}  w0 {rec['w0']:.4f}")
    chain_launches = _build.launch_counts()
    mean_aee = float(np.mean(aees[1:]))
    print(f"[chain] mean AEE windows 1-5: {mean_aee:.4f} px (limit {MAX_MEAN_AEE})")
    print(f"[chain] kernel launches during the chain: {chain_launches}; "
          f"{evals} loss evaluations")
    if not mean_aee <= MAX_MEAN_AEE:
        raise AssertionError(f"mean AEE {mean_aee} > {MAX_MEAN_AEE}")
    missing = [k for k in CHAIN_KERNELS if chain_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- 5. DSEC-scale loss: kernels on the card vs plain on CPU -----------
    params = LossParams(alpha=2000.0, beta=4000.0)
    statics = LossStatics(dsec_sensor, 5)
    gen = torch.Generator().manual_seed(1)
    theta = gt_theta(dsec_vel, (16, 16), "cpu") + 0.5 * torch.randn(16, 16, 2, generator=gen)
    out = []  # (loss, grad) with the kernels, then with the plain versions
    _build.reset_launch_counts()
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
        th = theta.to(dev).requires_grad_(True)
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        out.append((float(loss.detach()), grad.cpu()))
    dsec_launches = _build.launch_counts()
    print(f"[dsec loss] kernel launches: {dsec_launches}; its splat backward runs "
          f"the {plan_splat_bwd(dsec.edge_ts.shape[0], dsec.xs.shape[0], *dsec_sensor).kernel} kernel")
    (lk, gk), (lp, gp) = out
    rel = abs(lk - lp) / abs(lp)
    grel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"[dsec loss] kernels {lk:.7f}  plain {lp:.7f}  rel {rel:.3e} "
          f"(limit {TOL_DSEC_LOSS:.0e})  grad max rel {grel:.3e}")
    if not rel <= TOL_DSEC_LOSS:
        raise AssertionError("DSEC-scale loss: kernels disagree with plain")
    # float64: the direct kernels on the card (routed by dtype), the
    # launch counters read around it, against the plain versions on the CPU
    out64 = []
    for dev in (device, torch.device("cpu")):
        win = [t.to(dev, torch.float64) for t in dsec]
        wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
        th = theta.to(dev, torch.float64).requires_grad_(True)
        _build.reset_launch_counts()
        loss = solver_loss(th, *win, params, 0, statics, wstat)
        (grad,) = torch.autograd.grad(loss, th)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            f64_launches = _build.launch_counts()
        if loss.dtype != torch.float64:
            raise AssertionError(f"float64 loss came out {loss.dtype}")
        out64.append((float(loss.detach()), grad.cpu()))
    (l64, g64), (l64c, g64c) = out64
    rel64 = abs(l64 - l64c) / abs(l64c)
    grel64 = float((g64 - g64c).abs().max() / g64c.abs().max())
    print(f"[dsec loss] float64 on the card {l64:.15f}  on the CPU {l64c:.15f}  rel "
          f"{rel64:.3e}, grad max rel {grel64:.3e} (limit {TOL_F64:.0e}); float32 kernels "
          f"vs float64: rel {abs(lk - l64) / abs(l64):.3e}, grad max rel "
          f"{float((gk - g64).abs().max() / g64.abs().max()):.3e}; launches {f64_launches}")
    launched = {k for k, n in f64_launches.items() if n}
    if launched != set(DIRECT_KERNELS):
        raise AssertionError(f"the float64 loss launched {sorted(launched)}, not the "
                             f"direct kernels {DIRECT_KERNELS}")
    if not (rel64 <= TOL_F64 and grel64 <= TOL_F64):
        raise AssertionError("float64 DSEC-scale loss: the card disagrees with the CPU")
    # the wrap-compat splat (float32): the interp kernels and the direct
    # splat on the card, the launch counters read around it, against the
    # plain versions on the CPU
    out_wrap = []
    set_splat_wrap_compat(True)
    try:
        for dev in (device, torch.device("cpu")):
            win = [t.to(dev) for t in dsec]
            wstat = compute_window_statics(win[0], win[1], win[3], dsec_sensor)
            th = theta.to(dev).requires_grad_(True)
            _build.reset_launch_counts()
            loss = solver_loss(th, *win, params, 0, statics, wstat)
            (grad,) = torch.autograd.grad(loss, th)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                wrap_launches = _build.launch_counts()
            out_wrap.append((float(loss.detach()), grad.cpu()))
    finally:
        set_splat_wrap_compat(False)
    (lw, gw), (lwc, gwc) = out_wrap
    relw = abs(lw - lwc) / abs(lwc)
    print(f"[dsec loss] wrap-compat: card {lw:.7f}  CPU {lwc:.7f}  rel {relw:.3e} (limit "
          f"{TOL_DSEC_LOSS:.0e}), grad max rel "
          f"{float((gw - gwc).abs().max() / gwc.abs().max()):.3e}; without the wrap "
          f"{lk:.7f}; launches {wrap_launches}")
    launched = {k for k, n in wrap_launches.items() if n}
    if launched != {"interp_fwd", "interp_bwd", "splat_direct_fwd", "splat_direct_bwd"}:
        raise AssertionError(f"the wrap-compat loss launched {sorted(launched)}")
    if not relw <= TOL_DSEC_LOSS:
        raise AssertionError("wrap-compat DSEC-scale loss: the card disagrees with the CPU")

    # ---- 6. [wolfe] the armijo rescue's configuration on the chain -----------
    wolfe_results, wolfe_launches, wevals, wolfe_row = wolfe_chain(cfg, mvsec, vels, device)

    # ---- 7. [eval] the EVAL path: card vs CPU -------------------------------
    from eincm_tpu_torch.ops.resize import scale_theta_to_sensor_size

    eval_rows = {}
    ev_params = LossParams(alpha=2000.0, beta=4000.0)  # phase 5's
    card_ev = eval_both("dsec", scale_theta_to_sensor_size(theta.to(device), dsec_sensor),
                        dsec_staged, ev_params, dsec_sensor, device)
    eval_rows["dsec"] = {"ms": card_ev[1], "prepare_ms": card_ev[2], "host_syncs": card_ev[3],
                         "aee": float(card_ev[0]["AEE"])}
    mv = []
    for k, (res, staged) in enumerate(zip(wolfe_results, mvsec_staged)):
        full = scale_theta_to_sensor_size(res.final_theta_pyr[0], mvsec_sensor)
        mv.append(eval_both(f"mvsec window {k}", full, staged, cfg.params, mvsec_sensor,
                            device))
    eval_rows["mvsec"] = {
        "ms": [m[1] for m in mv], "prepare_ms": [m[2] for m in mv],
        "host_syncs": [m[3] for m in mv], "aee": [float(m[0]["AEE"]) for m in mv]}
    print(f"[eval] MVSEC Wolfe windows: eval AEE {[round(a, 4) for a in eval_rows['mvsec']['aee']]}"
          f", ms per evaluation {[round(m, 3) for m in eval_rows['mvsec']['ms']]}")

    # ---- 8. [experiment] the experiment CLI over a config file --------------
    exp_row, exp_launches = experiment_phase(card, device)

    # ---- 9-12. the real-data path: DSEC, submission, MVSEC, ECD trees ------
    # (and 13. [parallel] at DSEC's size on the [dsec] tree)
    real_rows, real_launches = real_data_phases(
        card, device, lambda tree, rec: grids_phase(
            card, device, tree, rec, (solver, cfg, mvsec[1], vels[1], chain_w0_final)))
    grids_row = real_rows.pop("grids")

    # ---- 13. [parallel] one member: the schedules, the sharded EVAL, the
    # parallel experiment with its super-step checkpoint and resume --------
    t0 = time.perf_counter()
    par_row, par_launches = parallel_mvsec_phase(card, device, cfg, mvsec_staged, vels, mean_aee)
    par_row["experiment"], par_launches["experiment"] = parallel_experiment_phase(card, device)
    par_row["dsec"] = real_rows.pop("parallel_dsec")
    par_launches["dsec"] = real_launches.pop("parallel_dsec")
    par_row["wall_s"] = time.perf_counter() - t0
    print(f"[parallel] {card}: MVSEC schedules, eval and experiment in "
          f"{par_row['wall_s']:.2f} s; DSEC in {par_row['dsec']['wall_s']:.2f} s")

    # ---- 14. [ranks] two processes on this one card, joined by gloo -------
    ranks_row, ranks_launches = ranks_phase(card, device)
    torch.cuda.empty_cache()

    # ---- 15. [bench] the benches of utils/benchmarks.py at full size --------
    chain_median_ms = float(np.median([r["ms"] for r in chain_recs[1:]]))
    bench_row, bench_phase_launches = bench_phase(
        card, device, chain_median_ms, real_rows["dsec"]["solve_ms_median_1_n"])
    torch.cuda.empty_cache()

    # ---- 16. [studies] the seven studies at reduced size ------------------
    studies_row, studies_launches = studies_phase(card, device)

    # ---- 17. [h5] the codec and HDF5 fixtures, the Zstd rate, two DSEC files --
    h5_row, h5_launches = h5_phase(card, device)

    launches = {**{k: chain_launches[k] for k in CHAIN_KERNELS},
                **{k: bench_launches[k] for k in BENCH_KERNELS},
                **{k: f64_launches[k] + wrap_launches[k] for k in DIRECT_KERNELS},
                # kernel 2's exact sums: [grids]' float32 DSEC solve at 32x32
                "interp_bwd_exact": grids_row["float32"]["launches"].get("interp_bwd_exact", 0)}
    kernels = []
    for name in SOURCES:
        m, d = rows[name]["mvsec"], rows[name]["dsec"]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"], d["max_abs_err"]),
            **{k: v for k, v in m.items() if k != "max_abs_err"},
            **{f"dsec_{k}": v for k, v in d.items() if k != "max_abs_err"},
        }
        if name in CHAIN_KERNELS:
            entry["launches_per_loss_eval"] = launches[name] / evals
            entry["dsec_loss_launches"] = dsec_launches[name]
            entry["wolfe_launches"] = wolfe_launches[name]
            entry["wolfe_launches_per_loss_eval"] = wolfe_launches[name] / wevals
            entry["experiment_launches"] = exp_launches[name]
            for tag, counts in real_launches.items():
                entry[f"{tag}_launches"] = counts[name]
            entry["dsec_launches_per_loss_eval"] = real_rows["dsec"]["launches_per_eval"][name]
            entry["parallel_launches"] = {k: c[name] for k, c in par_launches.items()}
            entry["ranks_launches"] = {k: c[name] for k, c in ranks_launches.items()}
            entry["bench_launches"] = bench_phase_launches[name]
            entry["studies_launches"] = studies_launches[name]
            entry["h5_launches"] = h5_launches["blosc_zstd"][name]
            entry["h5_latest_launches"] = h5_launches["latest"][name]
        if name == "splat_fwd":
            entry["eval_launches_per_call"] = 2
            entry["eval_prepare_launches"] = 1
        if name in DIRECT_KERNELS:
            entry["f64_loss_launches"] = f64_launches[name]
            entry["wrap_loss_launches"] = wrap_launches[name]
            entry["grids_f64_solve_launches"] = grids_row["float64"]["launches"].get(name, 0)
            entry["grids_wrap_solve_launches"] = grids_row["wrap"]["launches"].get(name, 0)
        if name == "interp_bwd_exact":
            entry["grids_launches_per_loss_eval"] = (
                grids_row["float32"]["launches_per_eval"]["interp_bwd_exact"])
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(entry)
    paths = {"card": card, "armijo": {"windows": chain_recs, "mean_aee": mean_aee,
                                      "median_ms": chain_median_ms},
             "wolfe": wolfe_row, "eval": eval_rows, "experiment": exp_row, **real_rows,
             "grids": grids_row,
             "parallel": par_row, "ranks": ranks_row, "bench": bench_row,
             "studies": studies_row, "h5": h5_row}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, **paths}, f, indent=1)
    print(json.dumps({"paths": paths}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
