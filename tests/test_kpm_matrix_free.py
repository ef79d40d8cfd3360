"""Matrix-free KPM: O(N)-per-order checkerboard Chebyshev apply + the
truncation-positivity guard and order-clip diagnostic.

The reference's KPM apply is matrix-free throughout
(/root/reference/src/KPMPreconditioner.jl:288-352); the repo's dense blocked
recurrence is the small-N latency optimization. These tests pin (a) exact
agreement of the two applies, (b) CG parity, (c) the self-deactivation on an
indefinite truncated fit (the reference's bounds guard extended to fit
positivity, KPMPreconditioner.jl:573-594), and (d) the clipped-order
diagnostic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu.ops.cg import cg_solve
from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix
from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner, kpm_apply, kpm_update

from _models import chain_model, honeycomb_model


def _fdm(model_fn, symmetric=True, **kw):
    geo, tbm, tbp, elph_model, elph = model_fn(**kw)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    return FermionDetMatrix.from_path_integral(fpi, structure, symmetric=symmetric)


@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_free_matches_dense_apply(symmetric, rng):
    fdm = _fdm(honeycomb_model, symmetric=symmetric, L=2, beta=2.0, alpha=0.4)
    key = jax.random.PRNGKey(0)
    dense = KPMPreconditioner.build(fdm, key, matrix_free=False)
    mf = KPMPreconditioner.build(fdm, key, matrix_free=True)
    assert bool(dense.active) and bool(mf.active)
    # identical bounds => identical coefficients; only the apply differs
    np.testing.assert_allclose(float(mf.lo), float(dense.lo), rtol=1e-10)
    np.testing.assert_allclose(float(mf.hi), float(dense.hi), rtol=1e-10)
    r = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    zd = np.asarray(kpm_apply(dense, r))
    zm = np.asarray(kpm_apply(mf, r))
    # both run in f32; agreement to f32 roundoff accumulated over ~C steps
    np.testing.assert_allclose(zm, zd, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_free_cg_parity(symmetric, rng):
    fdm = _fdm(honeycomb_model, symmetric=symmetric, L=2, beta=2.0, alpha=0.4)
    key = jax.random.PRNGKey(1)
    dense = KPMPreconditioner.build(fdm, key, matrix_free=False)
    mf = KPMPreconditioner.build(fdm, key, matrix_free=True)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    xd, sd = cg_solve(fdm.mul_MtM, b, precond=dense.as_operator(), tol=1e-10, maxiter=2000)
    xm, sm = cg_solve(fdm.mul_MtM, b, precond=mf.as_operator(), tol=1e-10, maxiter=2000)
    assert bool(sd.converged) and bool(sm.converged)
    np.testing.assert_allclose(np.asarray(xm), np.asarray(xd), rtol=1e-5, atol=1e-7)
    assert abs(int(sm.iters) - int(sd.iters)) <= 2, (int(sm.iters), int(sd.iters))


def test_matrix_free_update_is_jittable():
    fdm = _fdm(chain_model, L=4, beta=1.0)
    key = jax.random.PRNGKey(2)
    pre = KPMPreconditioner.build(fdm, key, matrix_free=True)
    pre2 = jax.jit(kpm_update)(pre, fdm, key)
    r = jnp.ones((2, fdm.Ltau, fdm.n_sites))
    z = jax.jit(kpm_apply)(pre2, r)
    assert np.all(np.isfinite(np.asarray(z)))


@pytest.mark.parametrize("matrix_free", [False, True])
def test_positivity_guard_deactivates_capped_fit(matrix_free, rng):
    """cap_max=32 at Ltau=240 makes the truncated 1/q fit non-positive at the
    lowest frequencies (documented DIVERGENCE in round 2, ops/kpm.py
    _static_plan). The guard must now self-deactivate instead — CG falls back
    to the unpreconditioned solve and still converges."""
    fdm = _fdm(chain_model, L=4, beta=24.0, dtau=0.1, alpha=0.4)
    assert fdm.Ltau == 240
    key = jax.random.PRNGKey(3)
    capped = KPMPreconditioner.build(fdm, key, cap_max=32, matrix_free=matrix_free)
    assert not bool(capped.active), "indefinite truncated fit must deactivate"
    uncapped = KPMPreconditioner.build(fdm, key, matrix_free=matrix_free)
    assert bool(uncapped.active), "the natural-order fit must stay active"
    b = jnp.asarray(rng.standard_normal((fdm.Ltau, fdm.n_sites)))
    # inactive preconditioner applies the identity: plain CG, converges
    x, st = cg_solve(fdm.mul_MtM, b, precond=capped.as_operator(), tol=1e-8, maxiter=4000)
    assert bool(st.converged)
    r = fdm.mul_MtM(x) - b
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b)) < 1e-6


def test_order_clip_diagnostic():
    """Runtime orders silently clipped at the build-time static caps must be
    counted (round-2 weak item: quality degraded with no diagnostic)."""
    fdm = _fdm(chain_model, L=4, beta=4.0, alpha=0.4)
    key = jax.random.PRNGKey(4)
    # generous build-time estimate: live orders fit, nothing clips
    roomy = KPMPreconditioner.build(fdm, key, cap_delta_eps=2.0)
    assert int(roomy.order_clip_count) == 0
    # tight build-time estimate: live Lanczos width exceeds it => clipping
    tight = KPMPreconditioner.build(fdm, key, cap_delta_eps=0.3)
    assert int(tight.order_clip_count) > 0


@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_free_vmapped_matches_per_walker(symmetric, rng):
    """Per-walker (vmapped) preconditioners: states.precond carries a leading
    walker axis in the per-walker refresh mode (parallel/walkers.py). The
    vmapped apply must equal applying each walker's own preconditioner."""
    fdm = _fdm(honeycomb_model, symmetric=symmetric, L=2, beta=2.0, alpha=0.4)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    pres = [KPMPreconditioner.build(fdm, k, matrix_free=True) for k in keys]
    pre_w = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
    r = jnp.asarray(rng.standard_normal((2, 2, fdm.Ltau, fdm.n_sites)))
    z_w = np.asarray(jax.vmap(kpm_apply)(pre_w, r))
    # f32 recurrence: batching may reorder sums, so roundoff over ~C steps
    for w in range(2):
        np.testing.assert_allclose(
            z_w[w], np.asarray(kpm_apply(pres[w], r[w])), rtol=2e-4, atol=2e-4
        )


# ----------------------------------------------------------------------
# Complex hoppings: matrix-free doubled-channel recurrence (the reference's
# apply is matrix-free for complex hoppings too, KPMPreconditioner.jl:417-550)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_free_complex_matches_dense_apply(symmetric, rng):
    from test_complex_hoppings import complex_chain_model

    geo, tbm, tbp, em, elph = complex_chain_model(beta=2.0)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=symmetric)
    assert fdm.complex_hops
    key = jax.random.PRNGKey(10)
    dense = KPMPreconditioner.build(fdm, key, matrix_free=False)
    mf = KPMPreconditioner.build(fdm, key, matrix_free=True)
    assert bool(dense.active) and bool(mf.active)
    np.testing.assert_allclose(float(mf.lo), float(dense.lo), rtol=1e-6)
    np.testing.assert_allclose(float(mf.hi), float(dense.hi), rtol=1e-6)
    r = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    zd = np.asarray(kpm_apply(dense, r))
    zm = np.asarray(kpm_apply(mf, r))
    np.testing.assert_allclose(zm, zd, rtol=5e-4, atol=5e-4)


def test_matrix_free_complex_batched(rng):
    """Leading batch axes (random vectors / walkers) broadcast through the
    complex-hopping recurrence: a batched apply equals the unbatched applies."""
    from test_complex_hoppings import complex_chain_model

    geo, tbm, tbp, em, elph = complex_chain_model(beta=2.0)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=True)
    mf = KPMPreconditioner.build(fdm, jax.random.PRNGKey(13), matrix_free=True)
    assert bool(mf.active)
    r = jnp.asarray(rng.standard_normal((3, 2, fdm.Ltau, fdm.n_sites)))
    z = np.asarray(kpm_apply(mf, r))
    for i in range(3):
        np.testing.assert_allclose(
            z[i], np.asarray(kpm_apply(mf, r[i])), rtol=2e-4, atol=2e-4
        )


@pytest.mark.parametrize("symmetric", [True, False])
def test_matrix_free_complex_cg_parity(symmetric, rng):
    from test_complex_hoppings import complex_chain_model

    geo, tbm, tbp, em, elph = complex_chain_model(beta=2.0)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=symmetric)
    key = jax.random.PRNGKey(11)
    dense = KPMPreconditioner.build(fdm, key, matrix_free=False)
    mf = KPMPreconditioner.build(fdm, key, matrix_free=True)
    b = jnp.asarray(rng.standard_normal((2, fdm.Ltau, fdm.n_sites)))
    xd, sd = cg_solve(fdm.mul_MtM, b, precond=dense.as_operator(), tol=1e-10,
                      maxiter=4000, sys_ndim=3)
    xm, sm = cg_solve(fdm.mul_MtM, b, precond=mf.as_operator(), tol=1e-10,
                      maxiter=4000, sys_ndim=3)
    assert bool(sd.converged) and bool(sm.converged)
    np.testing.assert_allclose(np.asarray(xm), np.asarray(xd), rtol=1e-5, atol=1e-7)
    assert abs(int(sm.iters) - int(sd.iters)) <= 2, (int(sm.iters), int(sd.iters))
