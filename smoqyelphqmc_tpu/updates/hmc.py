"""EFA-PFF-HMC update of the phonon fields.

Re-design of /root/reference/src/EFAPFFHMCUpdater.jl as one pure jitted function:
fresh pseudofermions are sampled at trajectory start, the bosonic harmonic part is
integrated analytically in phonon frequency space (ops/efa.py), the
fermionic + anharmonic + dispersive forces are kicked explicitly, and the
Metropolis decision selects between the proposed and original field with
`jnp.where` — no rollback bookkeeping, because (V, t, propagator factors) are pure
functions of x. Numerical failures (CG non-convergence / non-finite values)
surface as a converged=False flag that forces rejection, mirroring the
reference's try/catch-reject semantics (EFAPFFHMCUpdater.jl:168-187)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.bosonic import add_anharmonic_force, add_dispersive_force, bosonic_action
from ..ops.preconditioner import refresh_preconditioner
from ..ops.pff import fermionic_action, fermionic_action_and_force, sample_pseudofermion_fields
from ..utils.pytree import register_pytree_dataclass, static_field
from .context import QMCContext, QMCState, make_fdm


@register_pytree_dataclass
class HMCParams:
    """Trajectory hyperparameters (EFAPFFHMCUpdater ctor, EFAPFFHMCUpdater.jl:40-64)."""

    Nt: int = static_field(default=24)
    # dt is a pytree LEAF (not static) so the driver can feed a traced,
    # acceptance-tuned timestep through one compiled sweep program
    dt: float = 0.0  # 0 -> pi / (2 Nt)
    jitter: float = static_field(default=0.05)  # +-5% timestep noise (:125)
    # symplectic integrator for the non-harmonic force kicks. 'leapfrog' mirrors
    # the reference (EFAPFFHMCUpdater.jl:189-221); 'omelyan' is the 2nd-order
    # minimum-norm scheme (Omelyan/Mryglod/Folk 2003, lambda = 0.193...): two
    # force solves per step but a ~10x smaller error coefficient, so the same
    # acceptance holds at ~3x the timestep — net ~1.5x fewer solves per
    # trajectory at fixed length Nt*dt. The harmonic part is integrated exactly
    # in omega space either way (ops/efa.py), so the integrator error comes
    # only from the fermionic + anharmonic + dispersive kicks.
    integrator: str = static_field(default="leapfrog")
    # refresh the preconditioner at every leapfrog step (the reference refreshes
    # per solve) or only once per trajectory (cheaper when the refresh involves
    # an eigendecomposition; the tau-averaged propagator drifts slowly)
    refresh_precond_every_step: bool = static_field(default=False)
    # skip even the trajectory-start refresh and reuse the carried preconditioner
    # (driver-level cadence control: staleness affects only CG iteration count,
    # never the sampled distribution)
    refresh_precond_at_start: bool = static_field(default=True)
    # warm-start extrapolation order for the trajectory force solves: 2 =
    # linear chronological extrapolation of the previous two solutions, 3 =
    # quadratic through the previous three (leapfrog's uniform spacing only;
    # Omelyan always uses linear). Higher order cancels one more power of dt
    # in the warm-start residual at the cost of a larger amplification of the
    # tol-level solve noise; order 3 gave the fewest CG iterations per solve
    # at the headline config in an A/B of orders 2 / 3 / 4, so it is the
    # default.
    warm_order: int = static_field(default=3)

    def timestep(self):
        import math

        if isinstance(self.dt, (int, float)):
            return self.dt if self.dt > 0 else math.pi / (2 * self.Nt)
        return self.dt  # traced scalar (driver dt tuning); caller ensures > 0


class HMCStats(NamedTuple):
    accepted: jnp.ndarray  # bool
    delta_H: jnp.ndarray
    iters_avg: jnp.ndarray  # average CG iterations per solve
    converged: jnp.ndarray  # numerical-stability flag


def hmc_update(
    ctx: QMCContext,
    state: QMCState,
    params: HMCParams,
    recenter: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
) -> tuple[QMCState, HMCStats]:
    """One EFA-PFF-HMC trajectory (hmc_update!, EFAPFFHMCUpdater.jl:102-279)."""
    elph, efa = ctx.elph, ctx.efa
    # trace-time flag: a non-identity recenter acts in tau space, forcing a
    # re-transform of x after each drift (see omega-space trajectory below)
    has_recenter = recenter is not None
    recenter = recenter or (lambda x: x)
    Nt = params.Nt
    base_dt = params.timestep()

    key = state.key
    key, k_dt, k_phi, k_mom, k_acc, k_pre0 = jax.random.split(key, 6)

    dt = base_dt * (1.0 + (2.0 * jax.random.uniform(k_dt) - 1.0) * params.jitter)

    x0 = state.x
    fdm0 = make_fdm(ctx, x0)
    precond = state.precond
    if precond is not None and params.refresh_precond_at_start:
        precond = refresh_preconditioner(precond, fdm0, k_pre0)

    Phi, Sf0 = sample_pseudofermion_fields(k_phi, elph, fdm0, x0)
    Sb0 = bosonic_action(elph, x0)
    # the trajectory carries (x, p) in omega space: the exact drift is then an
    # elementwise rotation, and each leapfrog step pays only one inverse DFT
    # (x to tau for the force) + one forward DFT (the force kick) instead of
    # four full transforms per evolve()
    pw, K0 = efa.sample_momentum_omega(k_mom)
    H0 = Sf0 + Sb0 + K0

    # warm-start carry: consecutive trajectory solves share Phi and differ by
    # one drift of x, so each solve starts from an extrapolation of the
    # previous solutions (iteration counts drop several-fold; CG still converges
    # to tol, so the sampled distribution is untouched). Chronological
    # extrapolation psi + c (psi - psi2) with c = h_new / h_old cancels the
    # O(dt) drift of the solution along the trajectory (c = 1 for leapfrog's
    # uniform spacing; Omelyan alternates two spacings).
    warm_shape = (2, elph.Ltau, ctx.n_sites)
    # solution-history tuple for the warm-start extrapolation, newest first;
    # extra buffers ride the carry only at higher orders (a dead carry would
    # still cost scan copies). Omelyan's nonuniform kick spacing only supports
    # the linear form.
    n_hist = params.warm_order if params.integrator == "leapfrog" else 2
    n_hist = max(2, min(n_hist, 4))
    hist = tuple(
        jnp.zeros(warm_shape, dtype=jnp.dtype(ctx.force_dtype)) for _ in range(n_hist)
    )

    # force-path propagator tables in the force dtype: forces only shape the
    # proposal (endpoint actions below keep f64 tables)
    force_tab_dt = None if jnp.dtype(ctx.force_dtype) == jnp.float64 else ctx.force_dtype
    # when the force path is f32, the per-step DFT pair (omega -> tau for the
    # force field, tau -> omega for the kick) also runs in f32: both transforms
    # feed ONLY the tol~1e-5 force evaluation, while the (x, p) omega-space
    # carry, the drift rotations, and the endpoint actions stay exact f64 (the
    # final tau-space field is re-transformed in f64 once, after the scan).
    # With a tau-space recenter callback the f64 per-step transform is kept:
    # recentered x re-enters the exact carry through to_omega.
    use_f32_step = force_tab_dt is not None and not has_recenter

    # backward finite differences of the solution history, newest first
    _diffs = (
        lambda h: h[0] - h[1],
        lambda h: h[0] - 2.0 * h[1] + h[2],
        lambda h: h[0] - 3.0 * h[1] + 3.0 * h[2] - h[3],
    )

    def force_kick(x, pw, precond, hist, iters_sum, ok,
                   dt_kick, cs, k_pre, refresh):
        """Solve the fermionic force at x and kick p_omega by dt_kick. cs is
        the tuple of per-order extrapolation gates (order k's backward
        difference needs k+1 previous solutions — each gate opens one solve
        after the one below it)."""
        fdm = make_fdm(ctx, x, dtype=force_tab_dt)
        if precond is not None and refresh:
            precond = refresh_preconditioner(precond, fdm, k_pre)
        # chronological extrapolation through the previous len(hist) solutions
        # (uniform spacing): psi_warm = sum over valid backward differences
        psi_warm = hist[0]
        for k in range(len(hist) - 1):
            psi_warm = psi_warm + cs[k] * _diffs[k](hist)
        res = fermionic_action_and_force(
            Phi, elph, fdm, x, ctx.plan,
            precond=precond, tol=ctx.tol_force, maxiter=ctx.maxiter,
            mixed=ctx.mixed_precision, solve_dtype=ctx.force_dtype,
            warm_start=psi_warm,
        )
        hist = (res.psi_raw.astype(hist[0].dtype),) + hist[:-1]
        force = res.force
        force = add_anharmonic_force(force, elph, x)
        force = add_dispersive_force(force, elph, x)
        ok = ok & res.stats.converged & jnp.all(jnp.isfinite(force))
        kick = efa.kick_omega_f32 if use_f32_step else efa.kick_omega
        pw2 = kick(pw, force, dt_kick)
        return pw2, precond, hist, iters_sum + res.stats.iters, ok

    def drift(xw, pw, rot):
        """Exact harmonic rotation by a precomputed efa.rotation() table
        (the cos/sin planes are hoisted out of the scan) + the omega -> tau
        transform of x for the force evaluation."""
        xw, pw = efa.rotate_tabulated(xw, pw, rot)
        x = efa.to_tau_f32(*xw) if use_f32_step else efa.to_tau(*xw)
        if has_recenter:
            x = recenter(x)
            xw = efa.to_omega(x)
        return x, xw, pw

    # The preconditioner rides the scan carry ONLY when it is actually
    # refreshed inside the trajectory: carrying the (large) loop-invariant
    # preconditioner pytree through lax.scan materializes device copies of
    # every carried leaf per leapfrog step — XLA double-buffers each one
    # instead of recognizing the invariance. In the production path (refresh_precond_every_step=False)
    # the scan closes over it and the carry holds a dummy scalar.
    carry_precond = params.refresh_precond_every_step
    precond_closed = precond
    pre0 = precond if carry_precond else jnp.asarray(0, jnp.int32)

    def kick_with(x, pw, pre_c, hist, iters_sum, ok,
                  dt_kick, cs, k_pre, refresh=None):
        # refresh defaults to the params flag; omelyan kick B overrides it to
        # False so refresh_precond_every_step refreshes once per STEP (kick A),
        # not twice — matching the leapfrog path's one-refresh-per-solve-pair
        # cadence and keeping the refresh RNG stream per-step
        pre = pre_c if carry_precond else precond_closed
        pw, pre, hist, iters_sum, ok = force_kick(
            x, pw, pre, hist, iters_sum, ok,
            dt_kick, cs, k_pre,
            params.refresh_precond_every_step if refresh is None else refresh,
        )
        pre_c = pre if carry_precond else pre_c
        return pw, pre_c, hist, iters_sum, ok

    if params.integrator == "leapfrog":
        # D(dt/2) [K(dt) D(dt)]^{Nt-1} K(dt) D(dt/2): the scan runs the Nt-1
        # full-drift steps; the final kick + half drift are peeled out so no
        # step selects between rotation tables (the per-step
        # where(t == Nt-1, ...) plane selects showed up as ~ms-scale
        # select fusions in the device trace)
        rot_half = efa.rotation(dt / 2.0)
        rot_full = efa.rotation(dt)
        x, xw, pw = drift(efa.to_omega(x0), pw, rot_half)

        def step(carry, t):
            x, xw, pw, pre_c, hist, iters_sum, ok = carry
            # t = 0: zero guess (hist = 0); t = 1: previous solution; order-k
            # difference terms gate in once k+1 previous solutions exist
            cs = tuple(jnp.where(t >= k + 2, 1.0, 0.0) for k in range(len(hist) - 1))
            pw, pre_c, hist, iters_sum, ok = kick_with(
                x, pw, pre_c, hist, iters_sum, ok,
                dt, cs, jax.random.fold_in(k_pre0, t + 1),
            )
            x, xw, pw = drift(xw, pw, rot_full)
            return (x, xw, pw, pre_c, hist, iters_sum, ok), None

        (x, xw, pw, pre0, hist, iters_sum, ok), _ = lax.scan(
            step,
            (x, xw, pw, pre0, hist, jnp.asarray(0, jnp.int32), jnp.asarray(True)),
            jnp.arange(Nt - 1),
        )
        # final kick (solve index Nt-1) + closing half drift
        pw, pre0, hist, iters_sum, ok = kick_with(
            x, pw, pre0, hist, iters_sum, ok,
            dt,
            tuple(1.0 if Nt >= k + 3 else 0.0 for k in range(len(hist) - 1)),
            jax.random.fold_in(k_pre0, Nt),
        )
        x, xw, pw = drift(xw, pw, rot_half)
        n_solves = Nt + 1
    elif params.integrator == "omelyan":
        # 2nd-order minimum-norm: [D(l dt) K(dt/2) D((1-2l) dt) K(dt/2) D(l dt)]^Nt
        # with consecutive D(l dt) D(l dt) merged into D(2 l dt); the last
        # step is peeled out of the scan (closing drift rot_lam, no selects)
        lam = 0.1931833275037836
        rot_lam = efa.rotation(lam * dt)
        rot_2lam = efa.rotation(2.0 * lam * dt)
        rot_mid = efa.rotation((1.0 - 2.0 * lam) * dt)
        x, xw, pw = drift(efa.to_omega(x0), pw, rot_lam)
        # warm-start spacings alternate: before kick A of step t > 0 the field
        # drifted 2 l dt since kick B; before kick B it drifted (1 - 2 l) dt
        c_a = 2.0 * lam / (1.0 - 2.0 * lam)
        c_b = (1.0 - 2.0 * lam) / (2.0 * lam)

        def two_kicks(x, xw, pw, pre_c, hist, iters_sum, ok, t, ca, cb):
            # kick A (the 2t-th solve)
            pw, pre_c, hist, iters_sum, ok = kick_with(
                x, pw, pre_c, hist, iters_sum, ok,
                dt / 2.0, (ca,), jax.random.fold_in(k_pre0, t + 1),
            )
            x, xw, pw = drift(xw, pw, rot_mid)
            # kick B (the (2t+1)-th solve): never refresh here (see kick_with)
            pw, pre_c, hist, iters_sum, ok = kick_with(
                x, pw, pre_c, hist, iters_sum, ok,
                dt / 2.0, (cb,), jax.random.fold_in(k_pre0, -(t + 1)),
                refresh=False,
            )
            return x, xw, pw, pre_c, hist, iters_sum, ok

        def step(carry, t):
            x, xw, pw, pre_c, hist, iters_sum, ok = carry
            # gate extrapolation on solve index >= 2
            ca = jnp.where(2 * t >= 2, c_a, 0.0)
            cb = jnp.where(2 * t + 1 >= 2, c_b, 0.0)
            x, xw, pw, pre_c, hist, iters_sum, ok = two_kicks(
                x, xw, pw, pre_c, hist, iters_sum, ok, t, ca, cb
            )
            x, xw, pw = drift(xw, pw, rot_2lam)
            return (x, xw, pw, pre_c, hist, iters_sum, ok), None

        (x, xw, pw, pre0, hist, iters_sum, ok), _ = lax.scan(
            step,
            (x, xw, pw, pre0, hist, jnp.asarray(0, jnp.int32), jnp.asarray(True)),
            jnp.arange(Nt - 1),
        )
        x, xw, pw, pre0, hist, iters_sum, ok = two_kicks(
            x, xw, pw, pre0, hist, iters_sum, ok,
            jnp.asarray(Nt - 1),
            c_a if Nt >= 2 else 0.0,
            c_b if Nt >= 1 and 2 * Nt - 1 >= 2 else 0.0,
        )
        x, xw, pw = drift(xw, pw, rot_lam)
        n_solves = 2 * Nt + 1
    else:
        raise ValueError(
            f"HMCParams.integrator must be 'leapfrog' or 'omelyan', got {params.integrator!r}"
        )
    if carry_precond:
        precond = pre0

    if use_f32_step:
        # the per-step x was an f32 view for the force path only; the endpoint
        # field is re-transformed once from the exact f64 omega-space carry
        x = efa.to_tau(*xw)

    # final action (warm-started from the last force solve: same Phi, x one
    # half-drift away; the f64 endpoint solve still converges to ctx.tol)
    fdm1 = make_fdm(ctx, x)
    if precond is not None and params.refresh_precond_every_step:
        precond = refresh_preconditioner(precond, fdm1, jax.random.fold_in(k_pre0, Nt + 1))
    res1 = fermionic_action(
        Phi, elph, fdm1, x, precond=precond, tol=ctx.tol, maxiter=ctx.maxiter,
        mixed=ctx.mixed_precision, warm_start=hist[0].astype(jnp.float64),
    )
    ok = ok & res1.stats.converged & jnp.isfinite(res1.Sf)
    Sb1 = bosonic_action(elph, x)
    K1 = efa.kinetic_energy_omega(pw)
    H1 = res1.Sf + Sb1 + K1
    dH = H1 - H0
    iters_sum = iters_sum + res1.stats.iters

    P = jnp.where(ok, jnp.minimum(1.0, jnp.exp(-dH)), 0.0)
    accepted = jax.random.uniform(k_acc) < P
    x_new = jnp.where(accepted, x, x0)

    stats = HMCStats(
        accepted=accepted,
        delta_H=dH,
        iters_avg=iters_sum / n_solves,
        converged=ok,
    )
    return QMCState(x=x_new, key=key, precond=precond), stats

