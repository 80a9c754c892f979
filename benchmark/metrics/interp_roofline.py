"""interp + warp layer (ops/interp.py, csrc/interp.cu): the interp
kernels' share (%) of their least time, from every chain's trace.

Least time: each call of the forward and backward entry points counted by
the port's launch counters over the traced windows, on the window's
events, by the frozen arithmetic of `benchmark/roofline.py`; time: the
device seconds of the kernels named interp_fwd / interp_bwd. Nothing to
read where no interp kernel ran, or where the exact backward ran (its
kernels' names do not say their call)."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["launches"]
    if n.get("interp_bwd_exact", 0):
        return None
    secs = sum(v[1] for k, v in t["by_name"].items()
               if "interp_fwd_kernel" in k or "interp_bwd_" in k)
    _, E, _, _ = run.shape
    least = (n.get("interp_fwd", 0) * roofline.interp_fwd_s(E)
             + n.get("interp_bwd", 0) * roofline.interp_bwd_s(E))
    return 100.0 * least / secs if secs > 0 and least > 0 else None
