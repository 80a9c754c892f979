"""The card's peaks and the least time of each kernel call.

Frozen copy of `chip_smoke.py`'s bound arithmetic (commit eee0051):
peaks from NVIDIA's H100 SXM data sheet at 700 W, operations per event
counted from the kernels' arithmetic with an exp as one operation, each
input byte read once and each output byte written once. A call's least
time is the longer of its bytes over the memory's rate and its operations
over the float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per event (per event and frame for a splat):
# interp weights 30 (per axis: place u, floor, two triangle weights, their
# sum, a clamp and two divisions), the bilinear contraction 14 (2 channels
# x 4 products + 3 sums), its backward 54 (the weights again and 4 taps x
# 2 channels x (2 products + 1 sum)); the splat and its backward below
OPS_INTERP_WEIGHTS = 30
OPS_INTERP_CONTRACT = 14
OPS_INTERP_BWD = 30 + 24


def ops_splat(hw: int) -> int:
    """2 roundings, 5 per Gaussian tap (2 per row and column), a product
    and a sum per texel."""
    n = 2 * hw + 1
    return 2 + 2 * n * 5 + 2 * n * n


def ops_splat_bwd(hw: int) -> int:
    """2n taps (5 each), 2n q g(q), and two n x n contractions."""
    n = 2 * hw + 1
    return 2 * n * 5 + 2 * n + 2 * (n * (2 * n - 1) + 2 * n - 1)


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


# one call of each kernel entry point on E events (theta grid bytes, at
# most 2 KB, left out), R frames of H x W, window 3 (hw = 1)
def interp_fwd_s(E: int) -> float:
    return least_s(16 * E, (OPS_INTERP_WEIGHTS + OPS_INTERP_CONTRACT) * E)


def interp_bwd_s(E: int) -> float:
    return least_s(16 * E, OPS_INTERP_BWD * E)


def splat_fwd_s(R: int, E: int, H: int, W: int) -> float:
    return least_s(8 * R * E + 4 * R * H * W, ops_splat(1) * R * E)


def splat_bwd_s(R: int, E: int, H: int, W: int) -> float:
    return least_s(16 * R * E + 4 * R * H * W, ops_splat_bwd(1) * R * E)
