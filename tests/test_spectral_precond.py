"""Spectral preconditioner: exactness against the dense averaged matrix and CG
acceleration parity with the KPM preconditioner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu.ops.cg import cg_solve
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix, dense_M
from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral, dense_spectral, spectral_apply

from _models import honeycomb_model


def _fdm(**kw):
    geo, tbm, tbp, _, elph = honeycomb_model(**kw)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    return FermionDetMatrix.from_path_integral(fpi, structure, symmetric=True)


def test_spectral_is_exact_inverse_of_averaged_system():
    fdm = _fdm(L=2, beta=1.0, dtau=0.2, alpha=0.5)
    pre = build_spectral(fdm, dtype="float64")
    # build Mbar: an fdm whose every slice uses the tau-averaged factors
    expV_bar, cosh_bar, sinh_bar = fdm.averaged_factors()
    from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_op

    Ltau = fdm.Ltau
    fdm_bar = FermionDetMatrix(
        exp_nV=jnp.broadcast_to(expV_bar[None], (Ltau, fdm.n_sites)),
        cb=build_checkerboard_op(
            fdm.structure,
            jnp.broadcast_to(cosh_bar[None], (Ltau, fdm.structure.n_hops)),
            jnp.broadcast_to(sinh_bar[None], (Ltau, fdm.structure.n_hops)),
        ),
        cosh_hop=jnp.broadcast_to(cosh_bar[None], (Ltau, fdm.structure.n_hops)),
        sinh_hop=jnp.broadcast_to(sinh_bar[None], (Ltau, fdm.structure.n_hops)),
        sinh_hop_im=None,
        symmetric=True,
        structure=fdm.structure,
        Ltau=Ltau,
        n_sites=fdm.n_sites,
    )
    Mbar = dense_M(fdm_bar)
    exact = np.linalg.inv(Mbar.T @ Mbar)
    approx = dense_spectral(pre)
    np.testing.assert_allclose(approx, exact, atol=1e-9)


def test_spectral_preconditioned_cg():
    fdm = _fdm(L=2, beta=2.0, dtau=0.1, alpha=0.4)
    pre = build_spectral(fdm)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    x0, s0 = cg_solve(fdm.mul_MtM, b, tol=1e-10, maxiter=3000)
    x1, s1 = cg_solve(fdm.mul_MtM, b, precond=pre.as_operator(), tol=1e-10, maxiter=3000)
    assert bool(s0.converged) and bool(s1.converged)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), rtol=1e-5, atol=1e-7)
    assert int(s1.iters) < int(s0.iters) // 3, (int(s1.iters), int(s0.iters))


def test_spectral_in_hmc_update():
    from smoqyelphqmc_tpu.updates import HMCParams, hmc_update, initialize_qmc

    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.5)
    ctx, state = initialize_qmc(tbp, elph, seed=1, tol=1e-8, preconditioner="spectral")
    step = jax.jit(lambda s: hmc_update(ctx, s, HMCParams(Nt=4)))
    for _ in range(3):
        state, stats = step(state)
        assert bool(stats.converged)


def test_asym_spectral_preconditioner():
    """Half-angle symmetrized spectral preconditioner accelerates the ASYM solve."""
    from smoqyelphqmc_tpu.ops.cg import cg_solve

    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=2.0, dtau=0.1, alpha=0.4)
    fpi = build_path_integral(tbp, elph)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, st, symmetric=False)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    x0, s0 = cg_solve(fdm.mul_MtM, b, tol=1e-10, maxiter=4000)
    pre = build_spectral(fdm)
    x1, s1 = cg_solve(fdm.mul_MtM, b, precond=pre.as_operator(), tol=1e-10, maxiter=4000)
    assert bool(s1.converged)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), rtol=1e-5, atol=1e-7)
    assert int(s1.iters) < int(s0.iters) // 3


def _solve_case(case):
    """(fdm, dense M^T M) for the symmetric and asymmetric honeycomb and the
    SSH chain (tau-dependent hoppings)."""
    from _models import chain_model

    if case == "ssh":
        geo, tbm, tbp, _, elph = chain_model(L=4, beta=1.0, dtau=0.1, alpha=0.3, ssh=True)
    else:
        geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=1.0, dtau=0.1, alpha=0.4)
    fpi = build_path_integral(tbp, elph)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, st, symmetric=case != "asym")
    M = dense_M(fdm)
    return fdm, M.T @ M


def _solution_bound(A, tol, dtype):
    """Relative solution error CG may leave: cond(A) times the residual
    tolerance plus the rounding of the operator in `dtype`."""
    return 2.0 * np.linalg.cond(A) * (tol + 10 * np.finfo(dtype).eps)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["sym", "asym", "ssh"])
def test_spectral_cg_matches_dense_solve(case, dtype, rng):
    """Spectral-preconditioned CG against numpy.linalg.solve of the dense
    M^T M, at the action-solve (f64) and force-solve (f32) precisions."""
    fdm, A = _solve_case(case)
    tol = 1e-10 if dtype == "float64" else 1e-5
    b = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    x_ref = np.linalg.solve(A, b.reshape(2, -1).T).T.reshape(b.shape)
    f = fdm.astype(dtype)
    pre = build_spectral(fdm)
    x, st = cg_solve(f.mul_MtM, jnp.asarray(b, dtype), precond=pre.as_operator(), tol=tol, maxiter=4000)
    assert bool(st.converged)
    err = np.linalg.norm(np.asarray(x, np.float64) - x_ref) / np.linalg.norm(x_ref)
    assert err <= _solution_bound(A, tol, dtype), (err, _solution_bound(A, tol, dtype))


def test_spectral_cg_warm_start_matches_dense_solve(rng):
    """A warm start near the solution converges to the same dense solution in
    fewer iterations than the cold solve."""
    fdm, A = _solve_case("sym")
    b = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    x_ref = np.linalg.solve(A, b.reshape(2, -1).T).T.reshape(b.shape)
    pre = build_spectral(fdm)
    x0 = jnp.asarray(x_ref + 1e-3 * rng.standard_normal(b.shape))
    _, cold = cg_solve(fdm.mul_MtM, jnp.asarray(b), precond=pre.as_operator(), tol=1e-10, maxiter=4000)
    x, warm = cg_solve(fdm.mul_MtM, jnp.asarray(b), precond=pre.as_operator(), tol=1e-10, maxiter=4000, x0=x0)
    assert bool(warm.converged)
    assert int(warm.iters) < int(cold.iters), (int(warm.iters), int(cold.iters))
    err = np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref)
    assert err <= _solution_bound(A, 1e-10, "float64")
