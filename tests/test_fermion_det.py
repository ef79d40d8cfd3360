"""Unit tests of the checkerboard kernels and the fermion determinant matrix
against dense-matrix oracles (the reference has no such tests; SURVEY.md section 4
calls for adding them)."""

import jax.numpy as jnp
import numpy as np
import pytest

from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
from smoqyelphqmc_tpu.ops.checkerboard import (
    CheckerboardOp,
    build_checkerboard_op,
    build_checkerboard_structure,
    dense_checkerboard_matrix,
    hop_factors,
)
from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix, dense_M

from _models import chain_model, honeycomb_model


def _random_fdm(model_fn, symmetric, seed=3, **kw):
    geo, tbm, tbp, elph_model, elph = model_fn(seed=seed, **kw)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=symmetric)
    return fdm, fpi


def test_checkerboard_colors_are_disjoint():
    geo, tbm, tbp, _, _ = honeycomb_model(L=3)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    nt = structure.neighbor_table
    for c, (start, stop) in enumerate(structure.color_slices):
        hops = structure.perm[start:stop]
        sites = np.concatenate([nt[0, hops], nt[1, hops]])
        assert len(sites) == len(set(sites.tolist())), f"color {c} reuses a site"
    # every hop appears exactly once
    assert sorted(structure.perm.tolist()) == list(range(nt.shape[1]))


@pytest.mark.parametrize("model_fn", [chain_model, honeycomb_model])
def test_checkerboard_inverse_transpose_dense(model_fn, rng):
    geo, tbm, tbp, _, elph = model_fn()
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fpi = build_path_integral(tbp, elph)
    cosh_hop, sinh_hop = hop_factors(fpi.t, fpi.dtau)
    op = build_checkerboard_op(structure, cosh_hop, sinh_hop)
    v = jnp.asarray(rng.standard_normal((2, fpi.Ltau, tbp.n_sites)))  # 2 = complex channels
    # inverse really inverts
    w = op.apply(op.apply(v), inverse=True)
    np.testing.assert_allclose(np.asarray(w), np.asarray(v), atol=1e-12)
    # transpose satisfies <u, A v> = <A^T u, v>
    u = jnp.asarray(rng.standard_normal(v.shape))
    lhs = float(jnp.vdot(u, op.apply(v)))
    rhs = float(jnp.vdot(op.apply(u, transpose=True), v))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    # dense oracle: product of 2x2 rotations applied hop by hop (slice 0)
    dense = dense_checkerboard_matrix(
        CheckerboardOp(C=op.C[:, 0], S=op.S[:, 0], S_im=None, partner=op.partner, n_colors=op.n_colors)
    )
    ref = np.eye(tbp.n_sites)
    nt = structure.neighbor_table
    ch = np.asarray(cosh_hop)[0]
    sh = np.asarray(sinh_hop)[0]
    for pos in structure.perm:  # color-sorted order
        h = int(pos)
        i, j = int(nt[0, h]), int(nt[1, h])
        rot = np.eye(tbp.n_sites)
        rot[i, i] = ch[h]
        rot[j, j] = ch[h]
        rot[i, j] = sh[h]
        rot[j, i] = sh[h]
        ref = rot @ ref
    np.testing.assert_allclose(dense, ref, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("model_fn", [chain_model, honeycomb_model])
def test_mul_M_against_dense(model_fn, symmetric, dtype, rng):
    """M, M^T and M^T M against the dense f64 oracle. The float32 case runs
    the f32 propagator tables of the force path (FermionDetMatrix.astype):
    its error is f32 rounding of O(10) terms, so 1e-5 of the largest entry."""
    fdm, fpi = _random_fdm(model_fn, symmetric)
    Ltau, N = fdm.Ltau, fdm.n_sites
    Mdense = dense_M(fdm)
    f = fdm.astype(dtype)
    v = rng.standard_normal((Ltau, N))
    vj = jnp.asarray(v, dtype=dtype)

    def close(out, ref, tol64):
        out = np.asarray(out, np.float64)
        if dtype == "float64":
            np.testing.assert_allclose(out, ref, atol=tol64)
        else:
            assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()

    close(f.mul_M(vj), (Mdense @ v.reshape(-1)).reshape(Ltau, N), 1e-12)
    close(f.mul_Mt(vj), (Mdense.T @ v.reshape(-1)).reshape(Ltau, N), 1e-12)
    close(f.mul_MtM(vj), (Mdense.T @ Mdense @ v.reshape(-1)).reshape(Ltau, N), 1e-11)


def test_mul_M_batched(rng):
    fdm, _ = _random_fdm(chain_model, True)
    Ltau, N = fdm.Ltau, fdm.n_sites
    v = rng.standard_normal((5, 2, Ltau, N))
    out = np.asarray(fdm.mul_MtM(jnp.asarray(v)))
    for b in range(5):
        for c in range(2):
            ref = np.asarray(fdm.mul_MtM(jnp.asarray(v[b, c])))
            np.testing.assert_allclose(out[b, c], ref, atol=1e-12)


def test_sym_MtM_is_symmetric_psd(rng):
    fdm, _ = _random_fdm(honeycomb_model, True)
    Mdense = dense_M(fdm)
    A = Mdense.T @ Mdense
    np.testing.assert_allclose(A, A.T, atol=1e-12)
    evals = np.linalg.eigvalsh(A)
    assert evals.min() > 0


def test_ssh_dressed_hoppings(rng):
    """SSH coupling modulates t and makes it time dependent."""
    geo, tbm, tbp, elph_model, elph = chain_model(ssh=True)
    fpi = build_path_integral(tbp, elph)
    t = np.asarray(fpi.t)
    assert t.shape == (elph.Ltau, tbp.n_hops)
    x = np.asarray(elph.x)
    # manual check hop 0: connects cells 0 -> 1, t_eff = t0 - alpha (x_1 - x_0)
    expected = 1.0 - 0.5 * (x[1] - x[0])
    np.testing.assert_allclose(t[:, 0], expected, atol=1e-12)
