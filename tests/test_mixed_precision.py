"""Mixed-precision defect-correction CG: must reach the f64 solution at 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu.ops.cg import cg_solve, cg_solve_mixed
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral
from smoqyelphqmc_tpu.updates import HMCParams, hmc_update, initialize_qmc

import pytest

from _models import chain_model, honeycomb_model


def _fdm(**kw):
    geo, tbm, tbp, _, elph = honeycomb_model(**kw)
    fpi = build_path_integral(tbp, elph)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    return FermionDetMatrix.from_path_integral(fpi, st, symmetric=True)


def test_mixed_cg_matches_f64(rng):
    fdm = _fdm(L=2, beta=2.0, dtau=0.1, alpha=0.5)
    fdm32 = fdm.astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    x_ref, s_ref = cg_solve(fdm.mul_MtM, b, tol=1e-12, maxiter=4000)
    assert bool(s_ref.converged)
    pre = build_spectral(fdm, dtype="float32")
    x, stats = cg_solve_mixed(
        fdm.mul_MtM, fdm32.mul_MtM, b, precond=pre.as_operator(), tol=1e-10, maxiter=4000
    )
    assert bool(stats.converged)
    rel = float(jnp.max(jnp.abs(x - x_ref)) / jnp.max(jnp.abs(x_ref)))
    assert rel < 1e-8, rel
    assert float(jnp.max(stats.eps)) < 1e-10


def test_mixed_cg_unpreconditioned(rng):
    fdm = _fdm(L=2, beta=1.0, dtau=0.1, alpha=0.4)
    fdm32 = fdm.astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal((fdm.Ltau, fdm.n_sites)))
    x_ref, _ = cg_solve(fdm.mul_MtM, b, tol=1e-12, maxiter=4000)
    x, stats = cg_solve_mixed(fdm.mul_MtM, fdm32.mul_MtM, b, tol=1e-10, maxiter=4000)
    assert bool(stats.converged)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), rtol=1e-7, atol=1e-9)


def test_mixed_precision_hmc():
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.5)
    ctx, state = initialize_qmc(tbp, elph, seed=2, tol=1e-9, mixed_precision=True)
    step = jax.jit(lambda s: hmc_update(ctx, s, HMCParams(Nt=4)))
    acc = 0
    for _ in range(5):
        state, stats = step(state)
        assert bool(stats.converged)
        acc += int(stats.accepted)
    assert acc >= 2


@pytest.mark.parametrize(
    "model_fn,kw",
    [
        (honeycomb_model, dict(L=2, beta=1.0, dtau=0.1, alpha=0.6)),
        (chain_model, dict(L=6, beta=0.8, alpha=0.4)),
        (honeycomb_model, dict(L=2, beta=0.6, alpha=0.3, ph_sym=False)),
    ],
)
def test_f32_force_solve_matches_f64(model_fn, kw, rng):
    """solve_dtype='float32' forces agree with f64 to f32 resolution, for the
    chain, the honeycomb and the honeycomb without the particle-hole
    symmetric coupling form."""
    from smoqyelphqmc_tpu.ops.pff import (
        fermionic_action_and_force,
        sample_pseudofermion_fields,
    )
    from smoqyelphqmc_tpu.updates.context import initialize_qmc, make_fdm

    geo, tbm, tbp, _, elph = model_fn(**kw)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-10)
    fdm = make_fdm(ctx, state.x)
    Phi, _ = sample_pseudofermion_fields(jax.random.PRNGKey(1), elph, fdm, state.x)
    kw = dict(precond=state.precond, tol=1e-5, maxiter=3000)
    r64 = fermionic_action_and_force(Phi, elph, fdm, state.x, ctx.plan, **kw)
    r32 = fermionic_action_and_force(
        Phi, elph, fdm, state.x, ctx.plan, solve_dtype="float32", **kw
    )
    assert bool(r32.stats.converged)
    f64 = np.asarray(r64.force)
    f32 = np.asarray(r32.force)
    assert np.abs(f32 - f64).max() / np.abs(f64).max() < 1e-4
    assert f32.dtype == np.float64  # returned at full precision for the p update


def test_f32_force_hmc_acceptance():
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.5)
    from smoqyelphqmc_tpu.updates import HMCParams, hmc_update, initialize_qmc

    ctx, state = initialize_qmc(tbp, elph, seed=4, tol=1e-9, force_dtype="float32")
    step = jax.jit(lambda s: hmc_update(ctx, s, HMCParams(Nt=6)))
    acc = 0
    for _ in range(6):
        state, stats = step(state)
        assert bool(stats.converged)
        acc += int(stats.accepted)
    assert acc >= 3


def test_mixed_cg_warm_start(rng):
    """A warm start near the solution must (a) converge to the same f64 answer
    and (b) spend strictly fewer inner f32 iterations than the cold solve —
    the trajectory-endpoint action solve relies on this (updates/hmc.py)."""
    fdm = _fdm(L=2, beta=2.0, dtau=0.1, alpha=0.5)
    fdm32 = fdm.astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    pre = build_spectral(fdm, dtype="float32")
    x_cold, s_cold = cg_solve_mixed(
        fdm.mul_MtM, fdm32.mul_MtM, b, precond=pre.as_operator(), tol=1e-10, maxiter=4000
    )
    assert bool(s_cold.converged)
    # f32-accuracy warm start (what psi_prev provides along a trajectory)
    x0 = x_cold.astype(jnp.float32).astype(jnp.float64)
    x_warm, s_warm = cg_solve_mixed(
        fdm.mul_MtM, fdm32.mul_MtM, b, precond=pre.as_operator(), tol=1e-10, maxiter=4000,
        x0=x0,
    )
    assert bool(s_warm.converged)
    np.testing.assert_allclose(np.asarray(x_warm), np.asarray(x_cold), rtol=1e-7, atol=1e-10)
    assert int(s_warm.iters) < int(s_cold.iters), (int(s_warm.iters), int(s_cold.iters))


def test_mixed_cg_warm_start_already_converged(rng):
    """x0 already at the f64 solution: zero corrections, converged immediately."""
    fdm = _fdm(L=2, beta=1.0, dtau=0.1, alpha=0.4)
    fdm32 = fdm.astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal((fdm.Ltau, fdm.n_sites)))
    x_ref, _ = cg_solve(fdm.mul_MtM, b, tol=1e-13, maxiter=4000)
    x, stats = cg_solve_mixed(
        fdm.mul_MtM, fdm32.mul_MtM, b, tol=1e-9, maxiter=4000, x0=x_ref
    )
    assert bool(stats.converged)
    assert int(stats.iters) == 0
