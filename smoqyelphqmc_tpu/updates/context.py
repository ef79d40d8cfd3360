"""Simulation context + Markov-chain state pytrees.

The accelerator-side replacement for the reference's web of mutable structs
(FermionPathIntegral / FermionDetMatrix / PFFCalculator / preconditioner /
updater all updated in place): here

  - `QMCContext` bundles everything *constant along the chain* (expanded model
    parameters, checkerboard structure, force plan, Fourier accelerator, solver
    knobs); it is a pytree so jitted update functions close over it as an
    argument, and a leading walker axis can be vmapped over states only.
  - `QMCState` is the full Markov-chain state: the phonon field, the RNG key and
    the carried preconditioner data. Every update is a pure function
    (ctx, state) -> (state', stats); rejection keeps the old x via jnp.where.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.electron_phonon import ElectronPhononParameters
from ..models.fermion_path_integral import FermionPathIntegral, build_path_integral
from ..models.tight_binding import TightBindingParameters
from ..ops.checkerboard import CheckerboardStructure, build_checkerboard_structure
from ..ops.derivatives import ForcePlan, build_force_plan
from ..ops.efa import FourierAccelerator
from ..ops.fermion_det import FermionDetMatrix
from ..ops.preconditioner import build_preconditioner
from ..utils.pytree import register_pytree_dataclass, static_field


@register_pytree_dataclass
class QMCContext:
    tbp: TightBindingParameters
    elph: ElectronPhononParameters  # coupling arrays; the live field x is in QMCState
    efa: FourierAccelerator
    structure: CheckerboardStructure = static_field()
    plan: ForcePlan = static_field()
    symmetric: bool = static_field()
    tol: float = static_field()
    tol_force: float = static_field()
    maxiter: int = static_field()
    mixed_precision: bool = static_field(default=False)
    force_dtype: str = static_field(default="float64")
    # refresh the carried preconditioner inside reflection/swap/radial proposals.
    # Off by default: a global move changes one phonon mode out of N, so Bbar (a
    # tau- AND site-averaged object) barely moves, and the preconditioner only
    # affects CG iteration count, never the sampled distribution. The HMC update
    # still refreshes once per trajectory. Saves 2 of 3 refreshes per sweep,
    # which matters when the refresh is an eigendecomposition.
    refresh_precond_global: bool = static_field(default=False)

    @property
    def Ltau(self) -> int:
        return self.elph.Ltau

    @property
    def n_sites(self) -> int:
        return self.tbp.n_sites


@register_pytree_dataclass
class QMCState:
    x: jnp.ndarray  # (n_phonon, Ltau) phonon field
    key: jnp.ndarray  # PRNG key
    precond: Optional[object]  # carried preconditioner state (KPM/spectral) or None


def make_fdm(ctx: QMCContext, x: jnp.ndarray, dtype=None) -> FermionDetMatrix:
    """Propagator factors at phonon field x.

    dtype='float32' casts (V, t) BEFORE exponentiation so the exp/cosh/sinh
    transcendentals run in f32. Only the force path uses this
    (forces shape proposals; Metropolis exactness rests on the f64 endpoint
    actions, which keep the default f64 tables). exp(f32 V) and
    exp(f64 V).astype(f32) differ by <= 1 ulp f32, far below the force solve
    tolerance sqrt(tol) ~ 1e-5."""
    fpi = build_path_integral(ctx.tbp, ctx.elph, x)
    if dtype is not None and jnp.dtype(dtype) != fpi.V.dtype:
        dt = jnp.dtype(dtype)
        fpi = FermionPathIntegral(
            V=fpi.V.astype(dt),
            t=fpi.t.astype(dt),
            t_im=None if fpi.t_im is None else fpi.t_im.astype(dt),
            dtau=fpi.dtau, Ltau=fpi.Ltau, n_sites=fpi.n_sites,
        )
    return FermionDetMatrix.from_path_integral(fpi, ctx.structure, symmetric=ctx.symmetric)


def initialize_qmc(
    tbp: TightBindingParameters,
    elph: ElectronPhononParameters,
    seed: int = 0,
    symmetric: bool = True,
    tol: float = 1e-10,
    tol_force: Optional[float] = None,
    maxiter: int = 10_000,
    eta: float = 0.0,
    use_preconditioner: bool = True,
    preconditioner: Optional[str] = None,
    mixed_precision: bool = False,
    force_dtype: str = "float64",
    refresh_precond_global: bool = False,
) -> tuple[QMCContext, QMCState]:
    """Build the context and initial state (the reference's setup cascade,
    SURVEY.md section 3.1, collapsed into one call).

    preconditioner: 'auto' (default — exact spectral below the N crossover,
    blocked-Chebyshev KPM above, see ops/preconditioner.py), 'spectral',
    'kpm', or None."""
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    plan = build_force_plan(elph, structure)
    efa = FourierAccelerator.build(elph, eta=eta)
    ctx = QMCContext(
        tbp=tbp,
        elph=elph,
        efa=efa,
        structure=structure,
        plan=plan,
        symmetric=symmetric,
        tol=tol,
        tol_force=float(np.sqrt(tol)) if tol_force is None else tol_force,
        maxiter=maxiter,
        mixed_precision=mixed_precision,
        force_dtype=force_dtype,
        refresh_precond_global=refresh_precond_global,
    )
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    x0 = jnp.asarray(elph.x)
    precond = None
    if use_preconditioner:
        kind = preconditioner or "auto"
        fdm = make_fdm(ctx, x0)
        precond = build_preconditioner(kind, fdm, sub)
    state = QMCState(x=x0, key=key, precond=precond)
    return ctx, state
