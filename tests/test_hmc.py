"""HMC / EFA / global-update tests: exact harmonic statistics at alpha = 0,
conservation properties, and jit-compiled update smoke tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoqyelphqmc_tpu.ops.bosonic import bosonic_action, harmonic_curvature
from smoqyelphqmc_tpu.ops.efa import FourierAccelerator
from smoqyelphqmc_tpu.updates import (
    HMCParams,
    QMCState,
    hmc_update,
    initialize_qmc,
    radial_update,
    reflection_update,
    swap_update,
)

from _models import chain_model, honeycomb_model


def test_efa_conserves_harmonic_energy(rng):
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=2.0, alpha=0.0)
    efa = FourierAccelerator.build(elph)
    key = jax.random.PRNGKey(0)
    x = jnp.asarray(rng.standard_normal(elph.x.shape))
    p, K0 = efa.initialize_momentum(key)
    S0 = bosonic_action(elph, x)
    x1, p1 = efa.evolve(x, p, 0.7)
    K1 = efa.kinetic_energy(p1)
    S1 = bosonic_action(elph, x1)
    np.testing.assert_allclose(float(S0 + K0), float(S1 + K1), rtol=1e-10)
    # reversibility
    x2, p2 = efa.evolve(x1, -p1, 0.7)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-10)


def test_efa_rotation_tables_match_rotate_omega(rng):
    """rotation()/rotate_tabulated must reproduce rotate_omega exactly —
    the tables are the same formulas with the transcendentals hoisted."""
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=2.0, alpha=0.4)
    efa = FourierAccelerator.build(elph)
    shape = (elph.n_phonon, elph.Ltau)
    xw = (jnp.asarray(rng.standard_normal(shape)), jnp.asarray(rng.standard_normal(shape)))
    pw = (jnp.asarray(rng.standard_normal(shape)), jnp.asarray(rng.standard_normal(shape)))
    for t in (0.13, 0.7, np.pi / 2):
        ref_x, ref_p = efa.rotate_omega(xw, pw, t)
        tab_x, tab_p = efa.rotate_tabulated(xw, pw, efa.rotation(t))
        for r, s in ((ref_x, tab_x), (ref_p, tab_p)):
            np.testing.assert_allclose(np.asarray(r[0]), np.asarray(s[0]), atol=1e-13)
            np.testing.assert_allclose(np.asarray(r[1]), np.asarray(s[1]), atol=1e-13)


def test_efa_f32_step_transforms_track_f64(rng):
    """The per-step f32 DFT pair (to_tau_f32 / kick_omega_f32) must agree with
    the exact transforms to f32 precision — they feed only the tol~1e-5
    force path (updates/hmc.py use_f32_step)."""
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=2.0, alpha=0.4)
    efa = FourierAccelerator.build(elph)
    shape = (elph.n_phonon, elph.Ltau)
    x = jnp.asarray(rng.standard_normal(shape))
    xw = efa.to_omega(x)
    x32 = efa.to_tau_f32(*xw)
    assert x32.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(x32), np.asarray(x), rtol=0, atol=2e-5)
    force = jnp.asarray(rng.standard_normal(shape))
    pw = (jnp.asarray(rng.standard_normal(shape)), jnp.asarray(rng.standard_normal(shape)))
    k64 = efa.kick_omega(pw, force, 0.2)
    k32 = efa.kick_omega_f32(pw, force, 0.2)
    scale = float(jnp.max(jnp.abs(k64[0]))) + 1.0
    np.testing.assert_allclose(np.asarray(k32[0]), np.asarray(k64[0]), atol=3e-5 * scale)
    np.testing.assert_allclose(np.asarray(k32[1]), np.asarray(k64[1]), atol=3e-5 * scale)


def test_hmc_f32_step_trajectory_healthy():
    """End-to-end: an f32-force-path trajectory (the production driver
    configuration, which now also runs the per-step DFTs in f32) must stay
    numerically healthy — finite small dH, converged solves, f64 output."""
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=2.0, alpha=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=11, tol=1e-8, force_dtype="float32")
    params = HMCParams(Nt=8)
    new_state, stats = jax.jit(lambda s: hmc_update(ctx, s, params))(state)
    assert new_state.x.dtype == jnp.float64
    assert bool(stats.converged)
    assert np.isfinite(float(stats.delta_H))
    assert abs(float(stats.delta_H)) < 1.0


def test_efa_momentum_distribution(rng):
    """K should average d/2 per degree of freedom (equipartition)."""
    geo, tbm, tbp, _, elph = chain_model(L=4, beta=1.0)
    efa = FourierAccelerator.build(elph)
    keys = jax.random.split(jax.random.PRNGKey(1), 200)
    Ks = jax.vmap(lambda k: efa.initialize_momentum(k)[1])(keys)
    d = elph.n_phonon * elph.Ltau
    np.testing.assert_allclose(float(jnp.mean(Ks)), d / 2, rtol=0.15)


def test_hmc_free_phonon_statistics():
    """alpha = 0: phonons decouple, <x_l^2> = (1/Ltau) sum_k 1/Q_k exactly."""
    geo, tbm, tbp, _, elph = chain_model(L=2, beta=2.0, dtau=0.2, alpha=0.0)
    ctx, state = initialize_qmc(tbp, elph, seed=4, tol=1e-8, use_preconditioner=False)
    params = HMCParams(Nt=6)
    step = jax.jit(lambda s: hmc_update(ctx, s, params))

    n_warm, n_samp = 50, 400
    for _ in range(n_warm):
        state, stats = step(state)
    acc = 0.0
    x2 = 0.0
    for _ in range(n_samp):
        state, stats = step(state)
        acc += float(stats.accepted)
        x2 += float(jnp.mean(state.x**2))
    acc /= n_samp
    x2 /= n_samp
    Q = np.asarray(harmonic_curvature(elph))
    expected = float(np.mean(1.0 / Q))
    assert acc > 0.9, f"HMC acceptance too low at alpha=0: {acc}"
    np.testing.assert_allclose(x2, expected, rtol=0.15)


def test_hmc_interacting_runs_and_accepts():
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=1, tol=1e-8)
    params = HMCParams(Nt=8)
    step = jax.jit(lambda s: hmc_update(ctx, s, params))
    acc = 0
    for _ in range(10):
        state, stats = step(state)
        assert bool(stats.converged)
        acc += int(stats.accepted)
    assert acc >= 5, f"low acceptance: {acc}/10"
    assert np.all(np.isfinite(np.asarray(state.x)))


def test_global_updates_run():
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=2, tol=1e-8)
    refl = jax.jit(lambda s: reflection_update(ctx, s))
    swap = jax.jit(lambda s: swap_update(ctx, s))
    rad = jax.jit(lambda s: radial_update(ctx, s))
    for fn in (refl, swap, rad):
        for _ in range(3):
            state, stats = fn(state)
            assert bool(stats.converged)
            assert np.all(np.isfinite(np.asarray(state.x)))


def test_swap_exchanges_rows():
    """Accepted swaps permute trajectories; the multiset of row norms is invariant."""
    geo, tbm, tbp, _, elph = chain_model(L=4, beta=1.0, alpha=0.3)
    ctx, state = initialize_qmc(tbp, elph, seed=3, tol=1e-8)
    norms0 = sorted(np.linalg.norm(np.asarray(state.x), axis=1).round(10).tolist())
    step = jax.jit(lambda s: swap_update(ctx, s))
    for _ in range(5):
        state, stats = step(state)
    norms1 = sorted(np.linalg.norm(np.asarray(state.x), axis=1).round(10).tolist())
    np.testing.assert_allclose(norms0, norms1, atol=1e-9)


def test_radial_update_frozen_not_scaled():
    geo, tbm, tbp, _, elph = chain_model(L=4, beta=1.0, alpha=0.3, ssh=True)
    # add frozen mode scenario: bssh-like chain already uses a live mode; freeze manually
    frozen = elph.frozen_mask.copy()
    if not frozen.any():
        # emulate: treat as all live, this test then just checks scaling runs
        pass
    ctx, state = initialize_qmc(tbp, elph, seed=5, tol=1e-8)
    step = jax.jit(lambda s: radial_update(ctx, s, sigma=2.0))
    x0 = np.asarray(state.x)
    for _ in range(5):
        state, stats = step(state)
    assert np.all(np.isfinite(np.asarray(state.x)))


def test_omelyan_smaller_energy_error():
    """At the SAME timestep the Omelyan minimum-norm integrator must conserve
    H much better than leapfrog (its 2nd-order error coefficient is ~10x
    smaller), and both remain exact MC (converged flags set)."""
    geo, tbm, tbp, _, elph = chain_model(L=4, beta=2.0, dtau=0.1, alpha=0.6)
    ctx, state0 = initialize_qmc(tbp, elph, seed=11, tol=1e-10)

    def mean_abs_dH(integrator, n=6):
        params = HMCParams(Nt=6, jitter=0.0, integrator=integrator)
        step = jax.jit(lambda s: hmc_update(ctx, s, params))
        state, tot = state0, 0.0
        for _ in range(n):
            state, stats = step(state)
            assert bool(stats.converged)
            tot += abs(float(stats.delta_H))
        return tot / n

    lf = mean_abs_dH("leapfrog")
    om = mean_abs_dH("omelyan")
    assert om < 0.5 * lf, (om, lf)


def test_omelyan_accepts_with_third_the_steps():
    """Omelyan at Nt/3 (3x the timestep, ~2/3 the solves) should still accept
    at high rate where leapfrog needs the full Nt."""
    geo, tbm, tbp, _, elph = chain_model(L=4, beta=2.0, dtau=0.1, alpha=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=12, tol=1e-10)
    params = HMCParams(Nt=4, dt=np.pi / (2 * 12), jitter=0.0, integrator="omelyan")
    step = jax.jit(lambda s: hmc_update(ctx, s, params))
    acc = 0
    for _ in range(8):
        state, stats = step(state)
        assert bool(stats.converged)
        acc += int(stats.accepted)
    assert acc >= 6
