"""Complex hopping amplitudes: dense oracles and end-to-end sampling.

Complex t makes M a genuinely complex matrix; the framework carries complex
fields as a re/im channel pair at axis -3 and the checkerboard blocks become
Hermitian channel-mixing 2x2 rotations (ops/checkerboard.py). CG solves the
Hermitian PSD system M^dag M with joint-channel inner products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoqyelphqmc_tpu import (
    Bond,
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    Lattice,
    ModelGeometry,
    PhononMode,
    TightBindingModel,
    TightBindingParameters,
    UnitCell,
)
from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu.ops.cg import cg_solve
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix, dense_M
from smoqyelphqmc_tpu.updates import HMCParams, hmc_update, initialize_qmc


def complex_chain_model(L=4, t=1.0, phase=0.7, mu=0.1, Omega=1.0, alpha=0.5, beta=0.8, dtau=0.1, seed=0):
    """Chain with complex hopping t e^{i phase} (flux) + Holstein coupling."""
    uc = UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]])
    geo = ModelGeometry(uc, Lattice(L=[L]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    tbm = TightBindingModel(geo, [bond], [t * np.exp(1j * phase)], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], Omega))
    em.add_holstein_coupling(HolsteinCoupling(p, 0, [0], alpha, ph_sym_form=True))
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    return geo, tbm, tbp, em, elph


def _cplx_fdm(symmetric=True, **kw):
    geo, tbm, tbp, em, elph = complex_chain_model(**kw)
    fpi = build_path_integral(tbp, elph)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, st, symmetric=symmetric)
    assert fdm.complex_hops
    return fdm


def _apply_complex(fdm, fn, v):
    """Apply a channel-pair operator to a complex numpy vector."""
    vp = jnp.asarray(np.stack([v.real, v.imag]))  # (2, Ltau, N)
    out = np.asarray(fn(vp))
    return out[0] + 1j * out[1]


@pytest.mark.parametrize("symmetric", [True, False])
def test_complex_mul_M_against_dense(symmetric, rng):
    fdm = _cplx_fdm(symmetric=symmetric)
    Md = dense_M(fdm)
    assert np.abs(Md.imag).max() > 1e-3  # genuinely complex
    Ltau, N = fdm.Ltau, fdm.n_sites
    v = rng.standard_normal((Ltau, N)) + 1j * rng.standard_normal((Ltau, N))
    out = _apply_complex(fdm, fdm.mul_M, v)
    ref = (Md @ v.reshape(-1)).reshape(Ltau, N)
    np.testing.assert_allclose(out, ref, atol=1e-12)
    # mul_Mt implements the ADJOINT for complex hoppings
    out_d = _apply_complex(fdm, fdm.mul_Mt, v)
    ref_d = (Md.conj().T @ v.reshape(-1)).reshape(Ltau, N)
    np.testing.assert_allclose(out_d, ref_d, atol=1e-12)
    # M^dag M Hermitian PSD
    A = Md.conj().T @ Md
    np.testing.assert_allclose(A, A.conj().T, atol=1e-12)
    assert np.linalg.eigvalsh(A).min() > 0


def test_complex_cg_matches_dense_solve(rng):
    fdm = _cplx_fdm()
    Md = dense_M(fdm)
    A = Md.conj().T @ Md
    Ltau, N = fdm.Ltau, fdm.n_sites
    b = rng.standard_normal((Ltau, N)) + 1j * rng.standard_normal((Ltau, N))
    bp = jnp.asarray(np.stack([b.real, b.imag]))
    x, stats = cg_solve(fdm.mul_MtM, bp, tol=1e-12, maxiter=2000, sys_ndim=3)
    assert bool(stats.converged)
    got = np.asarray(x[0]) + 1j * np.asarray(x[1])
    ref = np.linalg.solve(A, b.reshape(-1)).reshape(Ltau, N)
    np.testing.assert_allclose(got, ref, atol=1e-8)


def test_complex_forces_finite_difference(rng):
    """Holstein forces with complex hoppings via central differences."""
    from smoqyelphqmc_tpu.ops.derivatives import build_force_plan
    from smoqyelphqmc_tpu.ops.pff import (
        fermionic_action,
        fermionic_action_and_force,
        sample_pseudofermion_fields,
    )

    geo, tbm, tbp, em, elph = complex_chain_model(beta=0.6)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    plan = build_force_plan(elph, st)

    def make_fdm(x):
        return FermionDetMatrix.from_path_integral(
            build_path_integral(tbp, elph, x), st, symmetric=True
        )

    x0 = jnp.asarray(elph.x)
    fdm0 = make_fdm(x0)
    Phi, _ = sample_pseudofermion_fields(jax.random.PRNGKey(3), elph, fdm0, x0)

    def S(x):
        return float(fermionic_action(Phi, elph, make_fdm(x), x, tol=1e-13, maxiter=4000).Sf)

    res = fermionic_action_and_force(Phi, elph, fdm0, x0, plan, tol=1e-13, maxiter=4000)
    assert bool(res.stats.converged)
    force = np.asarray(res.force)
    h = 1e-5
    x0n = np.asarray(x0)
    for (p, l) in [(0, 0), (2, 3)]:
        dx = np.zeros_like(x0n)
        dx[p, l] = h
        fd = (S(jnp.asarray(x0n + dx)) - S(jnp.asarray(x0n - dx))) / (2 * h)
        np.testing.assert_allclose(force[p, l], fd, rtol=2e-5, atol=1e-7)


def test_complex_spectral_preconditioner(rng):
    """Doubled-basis spectral preconditioner accelerates the complex solve."""
    fdm = _cplx_fdm(beta=2.0)
    from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral

    b = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    bp = jnp.asarray(b)
    x0, s0 = cg_solve(fdm.mul_MtM, bp, tol=1e-10, maxiter=4000, sys_ndim=3)
    pre = build_spectral(fdm)
    x1, s1 = cg_solve(
        fdm.mul_MtM, bp, precond=pre.as_operator(), tol=1e-10, maxiter=4000, sys_ndim=3
    )
    assert bool(s0.converged) and bool(s1.converged)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), rtol=1e-5, atol=1e-7)
    assert int(s1.iters) < int(s0.iters) // 3, (int(s1.iters), int(s0.iters))


@pytest.mark.parametrize("symmetric", [True, False])
def test_complex_kpm_preconditioner(symmetric, rng):
    """Doubled-basis blocked-KPM preconditioner accelerates the complex solve
    (closes the round-1 KPM-with-complex-hoppings gap)."""
    from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner

    fdm = _cplx_fdm(beta=2.0, symmetric=symmetric)
    pre = KPMPreconditioner.build(fdm, jax.random.PRNGKey(0))
    assert bool(pre.active), f"preconditioner inactive: bounds {pre.lo}, {pre.hi}"
    b = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    bp = jnp.asarray(b)
    x0, s0 = cg_solve(fdm.mul_MtM, bp, tol=1e-10, maxiter=4000, sys_ndim=3)
    x1, s1 = cg_solve(
        fdm.mul_MtM, bp, precond=pre.as_operator(), tol=1e-10, maxiter=4000, sys_ndim=3
    )
    assert bool(s0.converged) and bool(s1.converged)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), rtol=1e-5, atol=1e-7)
    assert int(s1.iters) < int(s0.iters), (int(s1.iters), int(s0.iters))


def test_complex_kpm_exact_for_static_field(rng):
    """With a tau-independent complex-hopping field (alpha=0, x=0), Bbar = B_l
    exactly, so the KPM expansion approximates [M^dag M]^{-1} itself."""
    from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner

    geo, tbm, tbp, em, elph = complex_chain_model(beta=2.0, alpha=0.0)
    elph = elph.replace(x=jnp.zeros_like(elph.x))
    fpi = build_path_integral(tbp, elph)
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, st, symmetric=True)
    assert fdm.complex_hops
    pre = KPMPreconditioner.build(fdm, jax.random.PRNGKey(1))
    assert bool(pre.active)
    b = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    bp = jnp.asarray(b)
    x0, s0 = cg_solve(fdm.mul_MtM, bp, tol=1e-8, maxiter=4000, sys_ndim=3)
    x1, s1 = cg_solve(
        fdm.mul_MtM, bp, precond=pre.as_operator(), tol=1e-8, maxiter=4000, sys_ndim=3
    )
    assert bool(s1.converged)
    assert int(s1.iters) <= max(8, int(s0.iters) // 4), (int(s1.iters), int(s0.iters))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), rtol=1e-4, atol=1e-6)


def test_complex_hmc_runs():
    geo, tbm, tbp, em, elph = complex_chain_model(beta=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=1, tol=1e-8)
    assert state.precond is not None  # complex spectral preconditioner active
    step = jax.jit(lambda s: hmc_update(ctx, s, HMCParams(Nt=4)))
    acc = 0
    for _ in range(5):
        state, stats = step(state)
        assert bool(stats.converged)
        acc += int(stats.accepted)
    assert acc >= 2
    assert np.all(np.isfinite(np.asarray(state.x)))


def test_complex_measurements_pass():
    """Full measurement pass with complex hoppings: complex hopping energies and
    complex-weighted current correlations."""
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec, make_measurements
    from smoqyelphqmc_tpu.measure.greens_estimator import (
        build_greens_estimator,
        update_greens_estimator,
    )
    from smoqyelphqmc_tpu.updates.context import make_fdm

    geo, tbm, tbp, em, elph = complex_chain_model(beta=0.6)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-8)
    fdm = make_fdm(ctx, state.x)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=4)
    est = update_greens_estimator(est, fdm, jax.random.PRNGKey(1), tol=1e-8, maxiter=3000).estimator
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", [(0, 0)])
    spec.add_correlation("current", [(tbm.bond_ids[0], tbm.bond_ids[0])])
    out = make_measurements(ctx, spec, est, state.x)
    # drop the DQMC-only globals the reference records as NaN
    nan_globals = {"sgndetGup", "sgndetGdn", "logdetGup", "logdetGdn",
                   "action_fermionic", "action_total"}
    out = {**out, "global": {k: v for k, v in out["global"].items() if k not in nan_globals}}
    flat, _ = jax.tree_util.tree_flatten(out)
    for leaf in flat:
        assert np.all(np.isfinite(np.asarray(leaf)))
    # dressed hopping amplitude keeps its imaginary part
    amp_im = float(out["local"]["hopping_amplitude"][1][0])
    assert abs(amp_im) > 1e-3


def complex_ssh_chain_model(L=4, t=1.0, mu=0.1, Omega=1.0, alpha=0.4 + 0.25j,
                            beta=0.6, dtau=0.1, seed=0, t_phase=0.0):
    """Chain with a COMPLEX SSH coupling constant (flux-threaded bond SSH):
    t(l) = t0 - alpha dx with alpha complex, so the hopping's imaginary part is
    phonon-field dependent."""
    from smoqyelphqmc_tpu import SSHCoupling

    uc = UnitCell(lattice_vecs=[[1.0]], basis_vecs=[[0.0]])
    geo = ModelGeometry(uc, Lattice(L=[L]))
    bond = Bond(orbitals=(0, 0), displacement=[1])
    geo.add_bond(bond)
    t0 = t * np.exp(1j * t_phase) if t_phase else t
    tbm = TightBindingModel(geo, [bond], [t0], [0.0], mu=mu)
    em = ElectronPhononModel(geo, tbm)
    p = em.add_phonon_mode(PhononMode([0.0], Omega))
    em.add_ssh_coupling(SSHCoupling(phonon_ids=(p, p), bond=bond, alpha_mean=alpha))
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    return geo, tbm, tbp, em, elph


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("t_phase", [0.0, 0.5])
def test_complex_ssh_forces_finite_difference(symmetric, t_phase, rng):
    """Complex SSH coupling constants: action derivative vs central differences
    (the last model-capability gap)."""
    from smoqyelphqmc_tpu.ops.derivatives import build_force_plan
    from smoqyelphqmc_tpu.ops.pff import (
        fermionic_action,
        fermionic_action_and_force,
        sample_pseudofermion_fields,
    )

    geo, tbm, tbp, em, elph = complex_ssh_chain_model(t_phase=t_phase)
    assert elph.ssh_alpha_im is not None
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    plan = build_force_plan(elph, st)

    def make_fdm(x):
        return FermionDetMatrix.from_path_integral(
            build_path_integral(tbp, elph, x), st, symmetric=symmetric
        )

    x0 = jnp.asarray(elph.x)
    fdm0 = make_fdm(x0)
    assert fdm0.complex_hops
    Phi, _ = sample_pseudofermion_fields(jax.random.PRNGKey(3), elph, fdm0, x0)

    def S(x):
        return float(fermionic_action(Phi, elph, make_fdm(x), x, tol=1e-13, maxiter=4000).Sf)

    res = fermionic_action_and_force(Phi, elph, fdm0, x0, plan, tol=1e-13, maxiter=4000)
    assert bool(res.stats.converged)
    force = np.asarray(res.force)
    h = 1e-5
    x0n = np.asarray(x0)
    for (p, l) in [(0, 0), (2, 3), (1, 5)]:
        dx = np.zeros_like(x0n)
        dx[p, l] = h
        fd = (S(jnp.asarray(x0n + dx)) - S(jnp.asarray(x0n - dx))) / (2 * h)
        np.testing.assert_allclose(force[p, l], fd, rtol=3e-5, atol=1e-7)


def test_complex_ssh_mul_M_against_dense(rng):
    """The complex-SSH-dressed M matches the dense block-bidiagonal construction."""
    geo, tbm, tbp, em, elph = complex_ssh_chain_model()
    st = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fpi = build_path_integral(tbp, elph)
    assert fpi.t_im is not None  # the SSH dressing created an imaginary part
    fdm = FermionDetMatrix.from_path_integral(fpi, st, symmetric=True)
    M = dense_M(fdm)
    v = rng.standard_normal((2, fdm.Ltau, fdm.n_sites))
    vc = (v[0] + 1j * v[1]).reshape(-1)
    out = fdm.mul_M(jnp.asarray(v))
    ref = (M @ vc).reshape(fdm.Ltau, fdm.n_sites)
    np.testing.assert_allclose(np.asarray(out[0]), ref.real, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out[1]), ref.imag, atol=1e-10)


def test_complex_ssh_hmc_and_measurements_run():
    geo, tbm, tbp, em, elph = complex_ssh_chain_model(beta=0.5)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-8, use_preconditioner=True)
    state, stats = jax.jit(lambda s: hmc_update(ctx, s, HMCParams(Nt=4)))(state)
    assert bool(stats.converged)
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec, make_measurements
    from smoqyelphqmc_tpu.measure.greens_estimator import (
        build_greens_estimator,
        update_greens_estimator,
    )
    from smoqyelphqmc_tpu.updates.context import make_fdm

    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=4)
    est = update_greens_estimator(
        est, make_fdm(ctx, state.x), jax.random.PRNGKey(5), tol=1e-8, maxiter=4000
    ).estimator
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0)])
    out = make_measurements(ctx, spec, est, state.x)
    assert np.isfinite(float(out["local"]["ssh_energy"][0][0]))
    assert np.isfinite(float(out["local"]["ssh_energy"][1][0]))
