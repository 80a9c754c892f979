"""splat layer (ops/splat.py, ops/splat_kernel.py, csrc/splat.cu): the
splat kernels' share (%) of their least time, from every chain's trace.

Least time: each call of the forward and backward entry points counted by
the port's launch counters over the traced windows, by the frozen
arithmetic of `benchmark/roofline.py`: every call on all frames of the
window, but one forward a window on the unwarped events alone (the loss's
statistics of the unwarped frame); time: the device seconds of the
kernels named splat_fwd_ / splat_bwd_. The forward's memset of its sums
is not counted: memsets carry no name of their caller."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["launches"]
    secs = sum(v[1] for k, v in t["by_name"].items()
               if "splat_fwd_" in k or "splat_bwd_" in k)
    R, E, H, W = run.shape
    fwd = n.get("splat_fwd", 0)
    statics = min(fwd, t["windows"])
    least = ((fwd - statics) * roofline.splat_fwd_s(R, E, H, W)
             + statics * roofline.splat_fwd_s(1, E, H, W)
             + n.get("splat_bwd", 0) * roofline.splat_bwd_s(R, E, H, W))
    return 100.0 * least / secs if secs > 0 and least > 0 else None
