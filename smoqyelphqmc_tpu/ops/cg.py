"""Batched preconditioned conjugate gradient under `lax.while_loop`.

Re-design of /root/reference/src/IterativeSolvers/ConjugateGradient.jl for
accelerator execution: one CG drives MANY right-hand sides at once (complex channel pairs,
random vectors, walkers — all leading axes of a (..., Ltau, N) real array), with
per-system convergence masks so early-converged systems freeze while the rest
iterate. Iteration count is data-dependent, so the loop is a `lax.while_loop`
with the whole Krylov state as carry; everything else in the sweep stays traced.

Numerical-failure semantics: instead of the reference's try/catch-and-reject
(/root/reference/src/EFAPFFHMCUpdater.jl:168-187), the returned stats carry a
`converged` flag that is False on NaN/Inf or iteration exhaustion; callers fold it
into the Metropolis accept probability (P = 0) with `jnp.where`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
from jax import lax


class CGStats(NamedTuple):
    iters: jnp.ndarray  # scalar int: while-loop iterations executed
    eps: jnp.ndarray  # per-system relative residual |r| / |b|
    converged: jnp.ndarray  # scalar bool: all systems converged to finite solutions


def _sys_dot(a: jnp.ndarray, b: jnp.ndarray, sys_ndim: int = 2) -> jnp.ndarray:
    """Per-system inner product: reduce over the trailing sys_ndim axes
    ((Ltau, N) for a real operator; (channel, Ltau, N) when the operator couples
    the complex channel pair)."""
    return jnp.sum(a * b, axis=tuple(range(-sys_ndim, 0)))


def cg_solve(
    apply_A: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    x0: Optional[jnp.ndarray] = None,
    sys_ndim: int = 2,
):
    """Solve A x = b for symmetric positive definite A with left preconditioner.

    Args:
      apply_A: linear map on (..., Ltau, N) arrays (broadcasts leading axes).
      b: right-hand sides; every leading axis (up to the trailing sys_ndim axes)
        indexes an independent system.
      precond: z = P^{-1} r map (same signature); None = identity.
      tol: relative residual tolerance |r| / |b|.
      maxiter: iteration cap.
      x0: optional initial guess (default zero).
      sys_ndim: trailing axes forming ONE system (3 when the operator couples the
        complex channel pair).

    Returns:
      (x, CGStats)
    """
    if precond is None:
        precond = lambda r: r

    def bshape(v):
        return v.reshape(v.shape + (1,) * sys_ndim)

    normb = jnp.sqrt(_sys_dot(b, b, sys_ndim))
    safe_normb = jnp.where(normb > 0, normb, 1.0)

    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - apply_A(x0)

    z = precond(r)
    p = z
    rdotz = _sys_dot(r, z, sys_ndim)
    eps = jnp.sqrt(_sys_dot(r, r, sys_ndim)) / safe_normb
    active = eps >= tol

    def cond(carry):
        x, r, p, rdotz, eps, active, it = carry
        return jnp.logical_and(jnp.any(active), it < maxiter)

    def body(carry):
        x, r, p, rdotz, eps, active, it = carry
        Ap = apply_A(p)
        pAp = _sys_dot(p, Ap, sys_ndim)
        alpha = jnp.where(active, rdotz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        a = bshape(alpha)
        x = x + a * p
        r = r - a * Ap
        eps_new = jnp.sqrt(_sys_dot(r, r, sys_ndim)) / safe_normb
        eps = jnp.where(active, eps_new, eps)
        active_new = jnp.logical_and(active, eps >= tol)
        z = precond(r)
        new_rdotz = _sys_dot(r, z, sys_ndim)
        beta = jnp.where(active_new, new_rdotz / jnp.where(rdotz != 0, rdotz, 1.0), 0.0)
        p = jnp.where(bshape(active_new), z + bshape(beta) * p, p)
        rdotz = jnp.where(active_new, new_rdotz, rdotz)
        return (x, r, p, rdotz, eps, active_new, it + 1)

    x, r, p, rdotz, eps, active, iters = lax.while_loop(
        cond, body, (x, r, p, rdotz, eps, active, jnp.asarray(0, jnp.int32))
    )

    finite = jnp.all(jnp.isfinite(x))
    converged = jnp.logical_and(finite, jnp.logical_not(jnp.any(active)))
    return x, CGStats(iters=iters, eps=eps, converged=converged)


def cg_solve_mixed(
    apply_A: Callable[[jnp.ndarray], jnp.ndarray],
    apply_A_low: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    inner_tol: float = 1e-5,
    max_outer: int = 12,
    sys_ndim: int = 2,
    x0: Optional[jnp.ndarray] = None,
):
    """Mixed-precision defect-correction (reliable-update) CG.

    The standard accelerator formulation from the lattice-QCD literature (see
    PAPERS.md): the Krylov work runs in float32 while an outer loop computes true float64 residuals and accumulates corrections,

        r = b - A x   (f64);   solve A e ~= r in f32 to inner_tol;   x += e,

    so the result converges to the float64 solution of the float64 operator.
    Each outer cycle gains ~inner_tol in relative residual, so reaching 1e-10
    takes 2-3 cycles of cheap f32 iterations plus a handful of f64 matvecs.

    apply_A_low (and the preconditioner) operate on float32 arrays. `x0`
    warm-starts the correction (e.g. with the f32 force solution carried along
    an HMC trajectory): its f64 residual is already ~inner_tol, so the first
    full-scale inner cycle is skipped entirely. The loop order is
    correct-then-check, so the f64 residual matvec runs exactly once per
    correction (plus one for a warm start) — a cold solve's first residual is
    just b, and the converged eps doubles as the final check.
    """
    if precond is None:
        precond = lambda r: r

    normb = jnp.sqrt(_sys_dot(b, b, sys_ndim))
    safe_normb = jnp.where(normb > 0, normb, 1.0)

    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0.astype(b.dtype)
        r = b - apply_A(x)
    eps = jnp.sqrt(_sys_dot(r, r, sys_ndim)) / safe_normb
    done = jnp.all(eps < tol)

    def outer_cond(carry):
        x, r, eps, it_total, outer, done = carry
        return jnp.logical_and(~done, outer < max_outer)

    def outer_body(carry):
        x, r, eps, it_total, outer, done = carry
        # Adaptive per-cycle tolerance: a correction cycle only needs to gain
        # eps -> ~tol/4, so the LAST cycle — whose starting eps already sits
        # just above tol because each f32 cycle's gain floors at ~kappa*eps_f32
        # (measured: cycle 2 lands at ~2e-10 for tol = 1e-10 at the headline
        # config regardless of inner_tol) — runs at a loose relative tolerance
        # (a handful of iterations) instead of a full inner_tol solve. Never
        # looser than 0.25, never tighter than inner_tol, so early cycles are
        # untouched.
        itol = jnp.maximum(
            inner_tol, jnp.minimum(0.25, 0.25 * tol / jnp.maximum(jnp.max(eps), 1e-300))
        )
        e32, stats = cg_solve(
            apply_A_low,
            r.astype(jnp.float32),
            precond=precond,
            tol=itol,
            maxiter=maxiter,
            sys_ndim=sys_ndim,
        )
        x = x + e32.astype(x.dtype)
        r = b - apply_A(x)
        eps = jnp.sqrt(_sys_dot(r, r, sys_ndim)) / safe_normb
        done = jnp.all(eps < tol)
        return (x, r, eps, it_total + stats.iters, outer + 1, done)

    carry = (x, r, eps, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), done)
    x, r, eps, it_total, outer, done = lax.while_loop(outer_cond, outer_body, carry)
    finite = jnp.all(jnp.isfinite(x))
    converged = jnp.logical_and(finite, jnp.all(eps < tol))
    return x, CGStats(iters=it_total, eps=eps, converged=converged)
