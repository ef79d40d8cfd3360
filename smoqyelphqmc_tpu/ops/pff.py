"""Pseudofermion-field sampling, action, and forces.

Re-design of /root/reference/src/PFFCalculator.jl as pure functions of
(model, phonon field x, pseudofermion field Phi, rng key). The fermionic action is

  S_f = Phi^dag [Lambda^dag M^dag M Lambda]^{-1} Phi,

with Phi a complex field carried as a (2, Ltau, N) channel pair. The single
expensive step is one preconditioned CG solve of [M^T M] psi = Lambda^{-T} Phi
— both channels ride the same batched solve."""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.electron_phonon import ElectronPhononParameters
from .cg import CGStats
from .derivatives import ForcePlan, add_M_derivative_force
from .fermion_det import FermionDetMatrix
from .lambda_shift import (
    add_lambda_derivative_force,
    build_lambda,
    ldiv_lambda,
    ldiv_lambda_T,
    mul_lambda,
    mul_lambda_T,
)


class ActionResult(NamedTuple):
    Sf: jnp.ndarray  # real part of the fermionic action
    Sf_imag: jnp.ndarray  # imaginary part (sanity diagnostic, PFFCalculator.jl:110-112)
    psi: jnp.ndarray  # (2, Ltau, N) solution Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi
    psi_raw: jnp.ndarray  # pre-Lambda CG solution [M^T M]^{-1} Lambda^{-T} Phi (warm starts)
    stats: CGStats


def sample_pseudofermion_fields(
    key,
    elph: ElectronPhononParameters,
    fdm: FermionDetMatrix,
    x: jnp.ndarray,
):
    """Sample Phi = Lambda^T M^T R with R ~ CN(0, 1); returns (Phi, Sf = |R|^2)
    (sample_pseudofermion_fields!, PFFCalculator.jl:56-76)."""
    Lam = build_lambda(elph, x, fdm.n_sites)
    R = jax.random.normal(key, (2, fdm.Ltau, fdm.n_sites)) / jnp.sqrt(2.0)
    Sf = jnp.sum(R * R)
    Phi = mul_lambda_T(Lam, fdm.mul_Mt(R))
    return Phi, Sf


def fermionic_action(
    Phi: jnp.ndarray,
    elph: ElectronPhononParameters,
    fdm: FermionDetMatrix,
    x: jnp.ndarray,
    precond: Optional[object] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    mixed: bool = False,
    warm_start: Optional[jnp.ndarray] = None,
) -> ActionResult:
    """S_f = Phi^dag Lambda^{-1} [M^T M]^{-1} Lambda^{-T} Phi — one CG solve
    (calculate_fermionic_action!, PFFCalculator.jl:79-116). `warm_start` is the
    previous solve's psi_raw for trajectory-consecutive systems."""
    from .fermion_det import solve_MtM

    Lam = build_lambda(elph, x, fdm.n_sites)
    rhs = ldiv_lambda_T(Lam, Phi)
    psi_raw, stats = solve_MtM(
        fdm, rhs, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed, x0=warm_start
    )
    psi = ldiv_lambda(Lam, psi_raw)
    # complex dot Phi^dag psi: Re = sum_ch Phi.psi ; Im = Phi_re.psi_im - Phi_im.psi_re
    Sf = jnp.sum(Phi * psi)
    Sf_im = jnp.sum(Phi[0] * psi[1] - Phi[1] * psi[0])
    return ActionResult(Sf=Sf, Sf_imag=Sf_im, psi=psi, psi_raw=psi_raw, stats=stats)


class ForceResult(NamedTuple):
    Sf: jnp.ndarray
    force: jnp.ndarray  # (n_phonon, Ltau) dS_f/dx
    psi_raw: jnp.ndarray  # pre-Lambda CG solution (warm start for the next step)
    stats: CGStats


def fermionic_action_and_force(
    Phi: jnp.ndarray,
    elph: ElectronPhononParameters,
    fdm: FermionDetMatrix,
    x: jnp.ndarray,
    plan: ForcePlan,
    precond: Optional[object] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    mixed: bool = False,
    solve_dtype: str = "float64",
    warm_start: Optional[jnp.ndarray] = None,
) -> ForceResult:
    """dS_f/dx = -2 Re([A psi]^T [dM/dx][Lambda psi]) - 2 Re([M^T A psi]^T [dLambda/dx][psi]),
    A = M Lambda (calculate_derivative_fermionic_action!, PFFCalculator.jl:119-158).

    solve_dtype='float32' runs this whole evaluation in f32: the force tolerance
    (sqrt(tol) ~ 1e-5, EFAPFFHMCUpdater.jl:116) is far above f32 resolution, and
    Metropolis exactness depends only on the trajectory-endpoint ACTION solves,
    which stay f64 — an inexact force merely perturbs the proposal, never the
    stationary distribution. CG stagnation surfaces as converged=False =>
    rejection, so the failure path is also exact."""
    if solve_dtype != "float64":
        dt = jnp.dtype(solve_dtype)

        def lower(a):
            return a.astype(dt) if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a

        elph = jax.tree_util.tree_map(lower, elph)
        fdm = fdm.astype(dt)
        Phi = Phi.astype(dt)
        x = x.astype(dt)
        if warm_start is not None:
            warm_start = warm_start.astype(dt)
    res = fermionic_action(
        Phi, elph, fdm, x, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed,
        warm_start=warm_start,
    )
    Lam = build_lambda(elph, x, fdm.n_sites)
    lam_psi = mul_lambda(Lam, res.psi)
    A_psi = fdm.mul_M(lam_psi)
    force = jnp.zeros((elph.n_phonon, elph.Ltau), dtype=Phi.dtype)
    force = add_M_derivative_force(force, -2.0, A_psi, lam_psi, fdm, elph, x, plan)
    Mt_A_psi = fdm.mul_Mt(A_psi)
    force = add_lambda_derivative_force(force, -2.0, Mt_A_psi, res.psi, Lam, elph, x)
    return ForceResult(
        Sf=res.Sf, force=force.astype(jnp.float64), psi_raw=res.psi_raw, stats=res.stats
    )
