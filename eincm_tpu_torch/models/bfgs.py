"""BFGS with strong-Wolfe or Armijo line search, and a bounded golden-section search.

Port of eincm_tpu/models/bfgs.py (reference: scipy's BFGS driven through
jaxopt, src/eincm/solver.py:165-183; retry loop :218-239). JAX runs the
whole optimization in one `lax.while_loop`; here the loop runs on the host
and the tensors stay on their device. The host needs values back from the
device at exactly three kinds of places, each one transfer through
`utils/host.py:to_host`, and each counted in `BFGSResult.n_host_syncs`
and, by cause, in the counters `bfgs.reads.probe` (the first two) and
`bfgs.reads.status` (the third; `utils/profiling.py`):

- every Armijo probe's accept/reject decision (one per probe);
- every strong-Wolfe trial's branch bits: the sufficient-decrease and
  curvature tests and the sign of the slope, which pick bracket or zoom,
  done, extend or shrink (one per trial);
- the status bits at the end of each iteration (one), which carry the
  loss for the heartbeat when there is one, and the first gradient's
  convergence test (one a solve).

Everything else (search direction, step heuristic, the line searches'
interpolations and state, the Hessian update, the history buffers) is
computed on the device, with `torch.where` or with the branch the host
read. The golden-section search needs no transfer at all: both branches of
each bracketing step are computed and selected on the device.

Each iteration is an `eincm.bfgs` span, each line search an
`eincm.linesearch` span inside it, and each backward of `value_and_grad`
an `eincm.grad` span, counted in `loss.grad_evals` with its host ns in
`loss.dispatch_ns`.

Semantics kept from the JAX package: Nocedal-Wright bracket and zoom with
safeguarded quadratic interpolation (falling back to the best point seen),
scipy's interpolated Armijo backtracking, the dense inverse-Hessian update
with its curvature skip, the Hessian-reset retry on failure (status
1/2/3), the opt-in `ftol` noise-floor stop (status 4, never retried) with
patience clamped to at least 2, and scipy's initial-step heuristic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from eincm_tpu_torch.utils import host, profiling

PROBE = "bfgs.reads.probe"  # an Armijo probe's or a Wolfe trial's read
STATUS = "bfgs.reads.status"  # an iteration's status bits, or the first test


class BFGSResult(NamedTuple):
    x: torch.Tensor  # (D,) final parameters
    fun_val: torch.Tensor  # () final loss
    grad: torch.Tensor  # (D,) final gradient
    iter_num: int  # iterations in the LAST attempt
    total_iters: int  # iterations across all attempts
    # evaluations: Wolfe trials, or Armijo probes + 1, the JAX package's
    # count (a failed Armijo search counts one evaluation it never makes;
    # the counter `loss.evals` counts those made)
    n_fun_evals: int
    n_attempts: int  # 1 + retries performed
    success: bool  # gradient sup-norm <= gtol
    # 0 ok, 1 maxiter, 2 line-search fail, 3 nan, 4 ftol noise-floor stop
    status: int
    n_host_syncs: int  # device -> host transfers the loop made


class BFGSHistory(NamedTuple):
    """Per-iteration trajectory in preallocated device buffers (the
    reference collects it through host-side scipy callbacks,
    src/eincm/callbacks.py:100-221). Entries beyond `n` are zero."""

    xs: torch.Tensor  # (capacity, D) iterates
    fs: torch.Tensor  # (capacity,) losses
    n: int  # valid entries


@profiling.spanned("eincm.grad", "loss.grad_evals", "loss.dispatch_ns")
def _grad(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    (g,) = torch.autograd.grad(f, x)
    return g


def value_and_grad(
    fun: Callable[[torch.Tensor], torch.Tensor]
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """x -> (fun(x), d fun / dx), both detached."""

    def fg(x: torch.Tensor):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg)
            g = _grad(f, xg)
        return f.detach(), g

    return fg


def _zoom_trial(a_lo, phi_lo, dphi_lo, a_hi, phi_hi) -> torch.Tensor:
    """Safeguarded quadratic interpolation inside [a_lo, a_hi]: the
    bisection when the minimizer is undefined or within 10% of an end."""
    d = a_hi - a_lo
    denom = 2.0 * (phi_hi - phi_lo - dphi_lo * d)
    a_q = a_lo - dphi_lo * d * d / torch.where(denom == 0, 1.0, denom)
    mid = a_lo + 0.5 * d
    lo_b = torch.minimum(a_lo, a_hi)
    hi_b = torch.maximum(a_lo, a_hi)
    margin = 0.1 * (hi_b - lo_b)
    bad = (
        (denom == 0)
        | ~torch.isfinite(a_q)
        | (a_q < lo_b + margin)
        | (a_q > hi_b - margin)
    )
    return torch.where(bad, mid, a_q)


@profiling.spanned("eincm.linesearch")
def _strong_wolfe(phi_fn, phi0, dphi0, g0, alpha1, c1, c2, max_evals, read):
    """Strong-Wolfe line search (Nocedal & Wright Algs. 3.5/3.6).

    `phi_fn`: alpha -> (phi(alpha), dphi(alpha), gradient at alpha).
    Each trial's three branch bits cross to the host in one `read`; the
    state stays on the device. Returns (alpha, phi, grad, n_trials, ok),
    `ok` a device bool: the conditions held, or the best point seen
    improves on phi0 (the step then falls back to it).
    """
    zero = torch.zeros_like(phi0)
    stage, first, n = 0, True, 0  # stage 0 bracket, 1 zoom, 2 done
    a_prev, phi_prev, dphi_prev, g_prev = zero, phi0, dphi0, g0
    a_lo, phi_lo, dphi_lo, g_lo = zero, phi0, dphi0, g0  # the best point seen
    a_hi, phi_hi, dphi_hi = zero, phi0, dphi0
    a_next = alpha1
    while stage < 2 and n < max_evals:
        in_bracket = stage == 0
        a = a_next if in_bracket else _zoom_trial(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        phi, dphi, g = phi_fn(a)
        n += 1
        armijo_fail = phi > phi0 + c1 * a * dphi0
        if not (first and in_bracket):
            armijo_fail = armijo_fail | (phi >= (phi_prev if in_bracket else phi_lo))
        curvature_ok = torch.abs(dphi) <= -c2 * dphi0
        fail, curv, ascending = read(
            torch.stack([armijo_fail, curvature_ok, dphi >= 0]), PROBE
        )
        if fail:
            if in_bracket:  # bracket [a_prev, a]
                stage = 1
                a_lo, phi_lo, dphi_lo, g_lo = a_prev, phi_prev, dphi_prev, g_prev
            a_hi, phi_hi, dphi_hi = a, phi, dphi  # (zoom: shrink the high end)
        elif curv:
            return a, phi, g, n, torch.ones((), dtype=torch.bool, device=phi.device)
        elif in_bracket and ascending:  # bracket [a, a_prev]
            stage = 1
            a_hi, phi_hi, dphi_hi = a_prev, phi_prev, dphi_prev
            a_lo, phi_lo, dphi_lo, g_lo = a, phi, dphi, g
        elif in_bracket:  # extend
            better = phi < phi_lo
            a_lo = torch.where(better, a, a_lo)
            phi_lo = torch.where(better, phi, phi_lo)
            g_lo = torch.where(better, g, g_lo)
            a_prev, phi_prev, dphi_prev, g_prev = a, phi, dphi, g
            a_next = torch.clamp_max(2.0 * a, 1e3)
            first = False
        else:  # zoom: move the low end, flipping the bracket on a sign change
            flip = dphi * (a_hi - a_lo) >= 0
            a_hi = torch.where(flip, a_lo, a_hi)
            phi_hi = torch.where(flip, phi_lo, phi_hi)
            dphi_hi = torch.where(flip, dphi_lo, dphi_hi)
            a_lo, phi_lo, dphi_lo, g_lo = a, phi, dphi, g
    improved = phi_lo < phi0
    return (
        torch.where(improved, a_lo, zero),
        torch.where(improved, phi_lo, phi0),
        torch.where(improved, g_lo, g0),
        n,
        improved,
    )


@profiling.spanned("eincm.linesearch")
def _armijo_backtrack(
    fun, fun_and_grad, x, p, f0, dphi0, g0, alpha1, c1, max_evals, interpolate, read
):
    """Backtracking with value-only probes until f(x + a p) <= f0 + c1 a
    dphi0 or the probe budget runs out; then the gradient once at the
    accepted point. Halving, or with `interpolate` the minimizer of the
    quadratic through (0, f0) with slope dphi0 and (a, f(x + a p)) clipped
    to [0.1, 0.5] a (scipy's `scalar_search_armijo`). Returns the tuple of
    `_strong_wolfe`, with probes + 1 evaluations."""
    zero = torch.zeros_like(f0)
    alpha, n, ok = alpha1, 0, False
    while n < max_evals:
        f_trial = fun(x + alpha * p)
        n += 1
        ok = read(f_trial <= f0 + c1 * alpha * dphi0, PROBE)
        if ok:
            break
        if interpolate:
            denom = 2.0 * (f_trial - f0 - dphi0 * alpha)
            a_q = -dphi0 * alpha * alpha / torch.where(denom == 0, 1.0, denom)
            alpha = torch.where(
                (denom == 0) | ~torch.isfinite(a_q),
                0.5 * alpha,
                torch.clamp(a_q, 0.1 * alpha, 0.5 * alpha),
            )
        else:
            alpha = alpha * 0.5
    if not ok:  # the reference evaluates at alpha = 0 and keeps (f, g)
        return zero, f0, g0, n + 1, torch.zeros((), dtype=torch.bool, device=f0.device)
    f_acc, g_acc = fun_and_grad(x + alpha * p)
    improved = f_acc < f0
    return (
        torch.where(improved, alpha, zero),
        torch.where(improved, f_acc, f0),
        torch.where(improved, g_acc, g0),
        n + 1,
        improved,
    )


@torch.no_grad()
def minimize_bfgs(
    fun_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    maxiter: int,
    gtol: float = 1e-5,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls_evals: int = 25,
    n_extra_attempts: int = 0,
    record_history: bool = False,
    unit_initial_step: bool = False,
    line_search: str = "wolfe",
    armijo_interpolate: bool = False,
    fun: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    heartbeat_fn: Optional[Callable[[int, float], None]] = None,
    h0: Optional[torch.Tensor] = None,
    return_h_inv: bool = False,
    ftol: Optional[float] = None,
    ftol_patience: int = 2,
):
    """Dense-Hessian BFGS; semantics follow eincm_tpu's `minimize_bfgs`.

    Args:
        fun_and_grad: x (D,) -> (f (), g (D,)), e.g. `value_and_grad(f)`.
        x0: initial parameters, flat.
        maxiter: max iterations per attempt.
        c1, c2: the sufficient-decrease and (Wolfe) curvature constants.
        max_ls_evals: the line search's budget per iteration: Wolfe
            trials, or value-only Armijo probes.
        n_extra_attempts: failed-convergence restarts (Hessian reset to
            identity, iteration continues from the current iterate).
        record_history: also return a `BFGSHistory` of every iteration's
            (x, f), capacity maxiter * (n_extra_attempts + 1).
        unit_initial_step: try alpha = 1 first instead of scipy's
            heuristic min(1, 1.01 * 2 (f - f_old) / dphi0).
        line_search: 'wolfe' (strong Wolfe, scipy-parity; every trial
            evaluates value and gradient) or 'armijo' (backtracking with
            value-only probes; the gradient once at the accepted point).
        armijo_interpolate: 'armijo' only: quadratic-interpolated
            backtracking instead of halving.
        fun: value-only objective, evaluated under `torch.no_grad()`;
            required for 'armijo'.
        heartbeat_fn: called once per iteration with (iterations so far,
            loss); the loss crosses to the host in the iteration's status
            transfer, so it costs no extra sync.
        h0: (D, D) initial inverse Hessian (a warm start); identity when
            None, and when any entry is not finite.
        return_h_inv: also return the final (D, D) inverse Hessian.
        ftol: opt-in noise-floor stop: when the relative loss improvement
            (f_k - f_{k+1}) / max(|f_k|, |f_{k+1}|, 1) stays <= ftol for
            `ftol_patience` consecutive iterations, stop with status 4. An
            exhausted line search arriving with the floor already indicated
            completes the patience. None keeps the reference retry
            semantics.
        ftol_patience: clamped to >= 2, so an isolated line-search
            exhaustion still gets its status-2 Hessian-reset retry.

    Returns:
        `BFGSResult`, or a tuple (result[, history][, h_inv]) when
        `record_history` or `return_h_inv` asks for more.
    """
    if line_search not in ("wolfe", "armijo"):
        raise ValueError(f"line_search {line_search!r}")
    if line_search == "armijo" and fun is None:
        raise ValueError("'armijo' needs the value-only objective `fun`")
    ftol_patience = max(int(ftol_patience), 2)
    syncs = 0

    def read(t: torch.Tensor, cause: str):
        nonlocal syncs
        syncs += 1
        profiling.count(cause)
        return host.to_host(t)

    dtype, dev = x0.dtype, x0.device
    d = x0.shape[0]
    eye = torch.eye(d, dtype=dtype, device=dev)
    capacity = maxiter * (n_extra_attempts + 1) if record_history else 0
    hist_xs = torch.zeros((capacity, d), dtype=dtype, device=dev)
    hist_fs = torch.zeros((capacity,), dtype=dtype, device=dev)

    x = x0
    f, g = fun_and_grad(x0)
    if h0 is None:
        h_inv = eye
    else:  # a poisoned warm start falls back to identity wholesale
        h0 = torch.as_tensor(h0, dtype=dtype, device=dev)
        h_inv = torch.where(torch.isfinite(h0).all(), h0, eye)
    f_old = f + torch.linalg.norm(g) / 2.0 + 1.0
    k_att = k_total = attempt = n_small = 0
    n_evals = 1
    converged = read(torch.max(torch.abs(g)) <= gtol, STATUS)
    status = 0 if converged else -1

    while status == -1:
        with profiling.annotate("eincm.bfgs"):
            p = -h_inv @ g
            dphi0 = torch.dot(p, g)
            # not a descent direction (numerical breakdown): steepest descent
            bad_dir = (dphi0 >= 0) | ~torch.isfinite(dphi0)
            p = torch.where(bad_dir, -g, p)
            dphi0 = torch.where(bad_dir, -torch.dot(g, g), dphi0)
            if unit_initial_step:
                alpha1 = torch.ones((), dtype=dtype, device=dev)
            else:  # scipy's heuristic: alpha1 = min(1, 1.01 * 2 * (f - f_old) / dphi0)
                rel = 1.01 * 2.0 * (f - f_old) / torch.where(dphi0 == 0, 1.0, dphi0)
                alpha1 = torch.where(
                    torch.isfinite(rel) & (rel > 0), torch.clamp_max(rel, 1.0), 1.0
                )

            if line_search == "armijo":
                alpha, f_new, g_new, ls_evals, ls_ok = _armijo_backtrack(
                    fun, fun_and_grad, x, p, f, dphi0, g, alpha1, c1, max_ls_evals,
                    armijo_interpolate, read,
                )
            else:
                def phi_fn(a, x=x, p=p):
                    fk, gk = fun_and_grad(x + a * p)
                    return fk, torch.dot(gk, p), gk

                alpha, f_new, g_new, ls_evals, ls_ok = _strong_wolfe(
                    phi_fn, f, dphi0, g, alpha1, c1, c2, max_ls_evals, read
                )

            x_new = x + alpha * p
            sk = x_new - x
            yk = g_new - g
            ys = torch.dot(yk, sk)
            # inverse-Hessian update; skipped when the curvature condition fails
            rho = 1.0 / torch.where(ys == 0, 1.0, ys)
            vl = eye - rho * torch.outer(sk, yk)
            h_new = vl @ h_inv @ vl.T + rho * torch.outer(sk, sk)
            do_update = (ys > 1e-10 * torch.dot(sk, sk)) & torch.isfinite(ys)
            h_inv = torch.where(do_update, h_new, h_inv)
            if record_history:
                hist_xs[k_total] = x_new
                hist_fs[k_total] = f_new

            gnorm = torch.max(torch.abs(g_new))
            bits = [
                ls_ok,
                ~torch.isfinite(f_new) | ~torch.isfinite(gnorm),
                gnorm <= gtol,
            ]
            if ftol is not None:
                denom = torch.clamp_min(
                    torch.maximum(torch.abs(f), torch.abs(f_new)), 1.0
                )
                bits.append((f - f_new) / denom <= ftol)
            bits = torch.stack(bits)
            if heartbeat_fn is None:
                ls_ok, nan_hit, converged, *small = read(bits, STATUS)
            else:  # the loss rides along with the status bits
                *flags, f_host = read(torch.cat([bits.to(dtype), f_new.reshape(1)]), STATUS)
                ls_ok, nan_hit, converged, *small = (v != 0 for v in flags)
                heartbeat_fn(k_total + 1, f_host)

            k_att += 1
            ftol_stop = False
            if ftol is not None:
                inc = 1 if ls_ok else (ftol_patience if n_small >= 1 else 1)
                n_small = n_small + inc if small[0] else 0
                ftol_stop = n_small >= ftol_patience
            if nan_hit:
                status = 3
            elif converged:
                status = 0
            elif ftol_stop:
                status = 4
            elif not ls_ok:
                status = 2
            elif k_att >= maxiter:
                status = 1
            else:
                status = -1
            # retry on failure (1/2/3) with attempts left: reset the Hessian and
            # continue from the current point; the ftol stop is never retried.
            # n_small survives a retry: failure -> reset -> failure again is the
            # noise-floor confirmation.
            if status > 0 and status != 4 and attempt < n_extra_attempts:
                status = -1
                h_inv = eye
                k_att = 0
                attempt += 1

            n_evals += ls_evals
            k_total += 1
            f_old = f
            x, f, g = x_new, f_new, g_new

    result = BFGSResult(
        x=x,
        fun_val=f,
        grad=g,
        iter_num=k_att,
        total_iters=k_total,
        n_fun_evals=n_evals,
        n_attempts=attempt + 1,
        success=bool(converged),
        status=status,
        n_host_syncs=syncs,
    )
    rets = (result,)
    if record_history:
        rets += (BFGSHistory(xs=hist_xs, fs=hist_fs, n=k_total),)
    if return_h_inv:
        rets += (h_inv,)
    return rets if len(rets) > 1 else result


@torch.no_grad()
def minimize_bounded_scalar(
    fun: Callable[[torch.Tensor], torch.Tensor],
    bounds: Tuple[float, float],
    maxiter: int = 30,
    record_history: bool = False,
    n_grid_probes: int = 0,
    *,
    device,
):
    """Bounded scalar minimization by golden-section search -> (x*, f*).

    Replaces the reference's 1-D L-BFGS-B handover-weight solve
    (src/eincm/solver.py:175-183, 302-347). `n_grid_probes >= 3` first
    evaluates a uniform grid over the bounds and shrinks the bracket to
    the best probe's neighbours, which makes the solve robust to
    multi-modal landscapes. The probe points are float32, as in the JAX
    package; `fun` takes a 0-dim tensor on `device`. With `record_history`
    returns ((x*, f*), BFGSHistory) of every probe in order: the grid (or
    the bounds), the two interior points, then one per iteration
    (n_init + 2 + maxiter entries; the reference collects them through its
    handover callback, src/eincm/callbacks.py:223-364).
    """
    lo, hi = bounds
    invphi = 0.6180339887498949
    n_init = max(2, n_grid_probes)
    xs_init = torch.linspace(lo, hi, n_init, dtype=torch.float32, device=device)
    fs_init = torch.stack([fun(w) for w in xs_init])
    # `torch.take`: indexing by a 0-dim tensor would read it on the host
    i_init = torch.argmin(fs_init)
    i_a = torch.clamp_min(i_init - 1, 0)
    i_b = torch.clamp_max(i_init + 1, n_init - 1)
    a, b = torch.take(xs_init, i_a), torch.take(xs_init, i_b)
    fa, fb = torch.take(fs_init, i_a), torch.take(fs_init, i_b)
    c = b - (b - a) * invphi
    d = a + (b - a) * invphi
    fc, fd = fun(c), fun(d)
    a0, b0 = a, b  # (fa, fb) belong to these points; the loop shrinks a/b
    n_pre = n_init + 2
    cap = n_pre + maxiter if record_history else 0
    hist_xs = torch.zeros((cap,), dtype=a.dtype, device=device)
    hist_fs = torch.zeros((cap,), dtype=fc.dtype, device=device)
    if record_history:
        hist_xs[:n_init] = xs_init
        hist_fs[:n_init] = fs_init
        hist_xs[n_init:n_pre] = torch.stack([c, d])
        hist_fs[n_init:n_pre] = torch.stack([fc, fd])

    for i in range(maxiter):
        left = fc < fd
        # left: keep [a, d], old c becomes d, probe a new c;
        # right: keep [c, b], old d becomes c, probe a new d
        c_left = d - (d - a) * invphi
        d_right = c + (b - c) * invphi
        a, b, c, d = (
            torch.where(left, a, c),
            torch.where(left, d, b),
            torch.where(left, c_left, d),
            torch.where(left, c, d_right),
        )
        keep = torch.where(left, fc, fd)
        probe = torch.where(left, c_left, d_right)
        f_probe = fun(probe)
        fc, fd = torch.where(left, f_probe, keep), torch.where(left, keep, f_probe)
        if record_history:
            hist_xs[n_pre + i] = probe
            hist_fs[n_pre + i] = f_probe

    x_star = torch.where(fc < fd, c, d)
    f_star = torch.minimum(fc, fd)
    # the pre-evaluated bracket ends and best init probe compete too; one
    # argmin keeps (x, f) a consistent pair (the interior wins ties)
    xs_cand = torch.stack([x_star, a0, b0, torch.take(xs_init, i_init)])
    fs_cand = torch.stack([f_star, fa, fb, torch.take(fs_init, i_init)])
    i_best = torch.argmin(fs_cand)
    best = (torch.take(xs_cand, i_best), torch.take(fs_cand, i_best))
    if record_history:
        return best, BFGSHistory(xs=hist_xs, fs=hist_fs, n=n_pre + maxiter)
    return best
