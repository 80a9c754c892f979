"""BFGS with Armijo backtracking, and a bounded golden-section search.

Port of eincm_tpu/models/bfgs.py (reference: scipy's BFGS driven through
jaxopt, src/eincm/solver.py:165-183; retry loop :218-239). JAX runs the
whole optimization in one `lax.while_loop`; here the loop runs on the host
and the tensors stay on their device. The host needs a value back from the
device at exactly two kinds of places, and each is counted in
`BFGSResult.n_host_syncs`:

- every Armijo probe's accept/reject decision (one sync per probe);
- the status bits at the end of each iteration (one sync).

Everything else (search direction, step heuristic, Hessian update, the
choice between accepted and rejected candidates) is computed on the device
with `torch.where`. The golden-section search needs no sync at all: both
branches of each bracketing step are computed and selected on the device.

Semantics kept from the JAX package: the dense inverse-Hessian update with
its curvature skip, the Hessian-reset retry on failure (status 1/2/3), the
opt-in `ftol` noise-floor stop (status 4, never retried) with patience
clamped to at least 2, and scipy's initial-step heuristic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class BFGSResult(NamedTuple):
    x: torch.Tensor  # (D,) final parameters
    fun_val: torch.Tensor  # () final loss
    grad: torch.Tensor  # (D,) final gradient
    iter_num: int  # iterations in the LAST attempt
    total_iters: int  # iterations across all attempts
    n_fun_evals: int  # loss+grad evaluations (a value-only probe counts 1)
    n_attempts: int  # 1 + retries performed
    success: bool  # gradient sup-norm <= gtol
    # 0 ok, 1 maxiter, 2 line-search fail, 3 nan, 4 ftol noise-floor stop
    status: int
    n_host_syncs: int  # device -> host transfers the loop made


def value_and_grad(
    fun: Callable[[torch.Tensor], torch.Tensor]
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """x -> (fun(x), d fun / dx), both detached."""

    def fg(x: torch.Tensor):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg)
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g

    return fg


@torch.no_grad()
def minimize_bfgs(
    fun_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    maxiter: int,
    gtol: float = 1e-5,
    c1: float = 1e-4,
    max_ls_evals: int = 25,
    n_extra_attempts: int = 0,
    line_search: str = "armijo",
    fun: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ftol: Optional[float] = None,
    ftol_patience: int = 2,
) -> BFGSResult:
    """Dense-Hessian BFGS; semantics follow eincm_tpu's `minimize_bfgs`
    with `line_search='armijo'`.

    Args:
        fun_and_grad: x (D,) -> (f (), g (D,)), e.g. `value_and_grad(f)`.
        x0: initial parameters, flat.
        maxiter: max iterations per attempt.
        max_ls_evals: cap on the value-only Armijo probes per iteration.
        n_extra_attempts: failed-convergence restarts (Hessian reset to
            identity, iteration continues from the current iterate).
        line_search: 'armijo' (backtracking by halving with value-only
            probes; the gradient is evaluated once at the accepted point).
            'wolfe' is not ported yet.
        fun: value-only objective, evaluated under `torch.no_grad()`.
        ftol: opt-in noise-floor stop: when the relative loss improvement
            (f_k - f_{k+1}) / max(|f_k|, |f_{k+1}|, 1) stays <= ftol for
            `ftol_patience` consecutive iterations, stop with status 4. An
            exhausted line search arriving with the floor already indicated
            completes the patience. None keeps the reference retry
            semantics.
        ftol_patience: clamped to >= 2, so an isolated line-search
            exhaustion still gets its status-2 Hessian-reset retry.
    """
    if line_search == "wolfe":
        raise NotImplementedError("the strong-Wolfe line search is not ported")
    if line_search != "armijo":
        raise ValueError(f"line_search {line_search!r}")
    if fun is None:
        raise ValueError("'armijo' needs the value-only objective `fun`")
    ftol_patience = max(int(ftol_patience), 2)
    syncs = 0

    def host(t: torch.Tensor):
        nonlocal syncs
        syncs += 1
        return t.tolist()

    dtype, dev = x0.dtype, x0.device
    eye = torch.eye(x0.shape[0], dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    x = x0
    f, g = fun_and_grad(x0)
    h_inv = eye
    f_old = f + torch.linalg.norm(g) / 2.0 + 1.0
    k_att = k_total = attempt = n_small = 0
    n_evals = 1
    converged = host(torch.max(torch.abs(g)) <= gtol)
    status = 0 if converged else -1

    while status == -1:
        p = -h_inv @ g
        dphi0 = torch.dot(p, g)
        # not a descent direction (numerical breakdown): steepest descent
        bad_dir = (dphi0 >= 0) | ~torch.isfinite(dphi0)
        p = torch.where(bad_dir, -g, p)
        dphi0 = torch.where(bad_dir, -torch.dot(g, g), dphi0)
        # scipy's heuristic: alpha1 = min(1, 1.01 * 2 * (f - f_old) / dphi0)
        rel = 1.01 * 2.0 * (f - f_old) / torch.where(dphi0 == 0, 1.0, dphi0)
        alpha = torch.where(
            torch.isfinite(rel) & (rel > 0), torch.clamp_max(rel, 1.0), 1.0
        )

        # Armijo backtracking by halving, value-only probes
        n_probes, ok = 0, False
        while n_probes < max_ls_evals:
            f_trial = fun(x + alpha * p)
            n_probes += 1
            ok = host(f_trial <= f + c1 * alpha * dphi0)
            if ok:
                break
            alpha = alpha * 0.5

        if ok:
            f_acc, g_acc = fun_and_grad(x + alpha * p)
            improved = f_acc < f
            f_new = torch.where(improved, f_acc, f)
            g_new = torch.where(improved, g_acc, g)
            alpha = torch.where(improved, alpha, zero)
        else:  # the reference evaluates at alpha = 0 and keeps (f, g)
            improved = torch.zeros((), dtype=torch.bool, device=dev)
            f_new, g_new, alpha = f, g, zero

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

        gnorm = torch.max(torch.abs(g_new))
        bits = [
            improved,
            ~torch.isfinite(f_new) | ~torch.isfinite(gnorm),
            gnorm <= gtol,
        ]
        if ftol is not None:
            denom = torch.clamp_min(
                torch.maximum(torch.abs(f), torch.abs(f_new)), 1.0
            )
            bits.append((f - f_new) / denom <= ftol)
        ls_ok, nan_hit, converged, *small = host(torch.stack(bits))

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

        n_evals += n_probes + 1
        k_total += 1
        f_old = f
        x, f, g = x_new, f_new, g_new

    return BFGSResult(
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


@torch.no_grad()
def minimize_bounded_scalar(
    fun: Callable[[torch.Tensor], torch.Tensor],
    bounds: Tuple[float, float],
    maxiter: int = 30,
    n_grid_probes: int = 0,
    *,
    device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded scalar minimization by golden-section search -> (x*, f*).

    Replaces the reference's 1-D L-BFGS-B handover-weight solve
    (src/eincm/solver.py:175-183, 302-347). `n_grid_probes >= 3` first
    evaluates a uniform grid over the bounds and shrinks the bracket to
    the best probe's neighbours, which makes the solve robust to
    multi-modal landscapes. The probe points are float32, as in the JAX
    package; `fun` takes a 0-dim tensor on `device`.
    """
    lo, hi = bounds
    invphi = 0.6180339887498949
    n_init = max(2, n_grid_probes)
    xs_init = torch.linspace(lo, hi, n_init, dtype=torch.float32, device=device)
    fs_init = torch.stack([fun(w) for w in xs_init])
    i_init = torch.argmin(fs_init)
    i_a = torch.clamp_min(i_init - 1, 0)
    i_b = torch.clamp_max(i_init + 1, n_init - 1)
    a, b = xs_init[i_a], xs_init[i_b]
    fa, fb = fs_init[i_a], fs_init[i_b]
    c = b - (b - a) * invphi
    d = a + (b - a) * invphi
    fc, fd = fun(c), fun(d)
    a0, b0 = a, b  # (fa, fb) belong to these points; the loop shrinks a/b

    for _ in range(maxiter):
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
        f_probe = fun(torch.where(left, c_left, d_right))
        fc, fd = torch.where(left, f_probe, keep), torch.where(left, keep, f_probe)

    x_star = torch.where(fc < fd, c, d)
    f_star = torch.minimum(fc, fd)
    # the pre-evaluated bracket ends and best init probe compete too; one
    # argmin keeps (x, f) a consistent pair (the interior wins ties)
    xs_cand = torch.stack([x_star, a0, b0, xs_init[i_init]])
    fs_cand = torch.stack([f_star, fa, fb, fs_init[i_init]])
    i_best = torch.argmin(fs_cand)
    return xs_cand[i_best], fs_cand[i_best]
