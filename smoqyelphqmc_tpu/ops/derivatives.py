"""Fermion-matrix derivative forces: force[p, l] += nu * Re <u | dM/dx_{p,l} | v>.

Re-design of /root/reference/src/fermion_det_matrix_dervative.jl: the derivative of
the checkerboard-factorized M is never formed. Instead the algorithm walks the
checkerboard colors, incrementally transforming u' and v' with forward / inverse
color applications so the derivative of each factor is evaluated in the correct
basis. Per color, the SSH (hopping-derivative) contributions of all couplings in
that color are evaluated as one gather + elementwise + scatter-add; the Holstein
(potential-derivative) term is a single vectorized pass.

u, v carry a leading complex-channel axis (2, Ltau, N); with real couplings the
real part of <u|A|v> is the channel sum of elementwise products."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..models.electron_phonon import ElectronPhononParameters
from .checkerboard import CheckerboardStructure
from .fermion_det import FermionDetMatrix, _boundary_sign_first


@dataclasses.dataclass(frozen=True)
class ForcePlan:
    """Static grouping of SSH couplings by checkerboard color.

    For each color: index arrays (into the SSH coupling axis) of the couplings
    whose hop lives in that color, plus the site pair and phonon pair per coupling
    and finite-mass masks (frozen phonons take no force,
    fermion_det_matrix_dervative.jl:227-247)."""

    ssh_by_color: Tuple[np.ndarray, ...]  # coupling indices per color
    site_i: Tuple[np.ndarray, ...]
    site_j: Tuple[np.ndarray, ...]
    hop_idx: Tuple[np.ndarray, ...]  # hop column per coupling (complex-t force path)
    phonon_i: Tuple[np.ndarray, ...]
    phonon_f: Tuple[np.ndarray, ...]
    finite_i: Tuple[np.ndarray, ...]
    finite_f: Tuple[np.ndarray, ...]
    hol_finite: np.ndarray  # (n_holstein,) finite-mass mask


def build_force_plan(
    elph: ElectronPhononParameters, structure: CheckerboardStructure
) -> ForcePlan:
    n_colors = structure.n_colors
    color_of_hop = np.zeros(structure.n_hops, dtype=np.int64)
    for c, (start, stop) in enumerate(structure.color_slices):
        color_of_hop[structure.perm[start:stop]] = c
    frozen = elph.frozen_mask
    ssh_by_color, site_i, site_j, hop_idx = [], [], [], []
    phonon_i, phonon_f, finite_i, finite_f = [], [], [], []
    for c in range(n_colors):
        idx = np.where(color_of_hop[elph.ssh_to_hop] == c)[0] if elph.n_ssh else np.zeros(0, np.int64)
        ssh_by_color.append(idx.astype(np.int32))
        hops = elph.ssh_to_hop[idx]
        hop_idx.append(hops.astype(np.int32))
        site_i.append(structure.neighbor_table[0, hops].astype(np.int32))
        site_j.append(structure.neighbor_table[1, hops].astype(np.int32))
        p_i = elph.ssh_to_phonon[0, idx]
        p_f = elph.ssh_to_phonon[1, idx]
        phonon_i.append(p_i.astype(np.int32))
        phonon_f.append(p_f.astype(np.int32))
        finite_i.append((~frozen[p_i]).astype(np.float64))
        finite_f.append((~frozen[p_f]).astype(np.float64))
    hol_finite = (
        (~frozen[elph.hol_to_phonon]).astype(np.float64) if elph.n_holstein else np.zeros(0)
    )
    return ForcePlan(
        ssh_by_color=tuple(ssh_by_color),
        site_i=tuple(site_i),
        site_j=tuple(site_j),
        hop_idx=tuple(hop_idx),
        phonon_i=tuple(phonon_i),
        phonon_f=tuple(phonon_f),
        finite_i=tuple(finite_i),
        finite_f=tuple(finite_f),
        hol_finite=hol_finite,
    )


def _add_ssh_color_force(
    force: jnp.ndarray,
    nu: float,
    up: jnp.ndarray,
    vp: jnp.ndarray,
    fdm: FermionDetMatrix,
    elph: ElectronPhononParameters,
    x: jnp.ndarray,
    plan: ForcePlan,
    dtau_eff: float,
    color: int,
) -> jnp.ndarray:
    """SSH kinetic-derivative contribution of one checkerboard color
    (_mul_nuRe_dtau_dKc_dx!, fermion_det_matrix_dervative.jl:196-254).

    For REAL hoppings the inserted operator is exactly dE_c E_c^{-1}
    = dtau_eff * (dt/dx) * H0 (H0 = offdiag ones), the reference's recipe. For
    COMPLEX hoppings (complex static t and/or complex SSH coupling constants)
    dK_c no longer commutes with K_c inside a 2x2 hop block, so the exact block
    derivative is used instead: with t = |t| e^{i theta}, t_hat = t/|t|,
    c = cosh(dtau_eff |t|), s = sinh(dtau_eff |t|),

      dE E^{-1} = dtau_eff |t|' H + i theta' (s c G + s^2 Z),
      H = [[0, conj(t_hat)], [t_hat, 0]],  G = [[0, -conj(t_hat)], [t_hat, 0]],
      Z = diag(+1_i, -1_j),   |t|' = Re(conj(t_hat) dt/dx),
      theta' = Im(conj(t_hat) dt/dx) / |t|

    (the reference never needs this: its hoppings are real,
    checkerboard_matrix_multiply.jl). Validated by central differences."""
    idx = plan.ssh_by_color[color]
    if idx.size == 0:
        return force
    i = plan.site_i[color]
    j = plan.site_j[color]
    p = plan.phonon_i[color]
    pf = plan.phonon_f[color]
    idx_j = jnp.asarray(idx)
    dx = x[pf, :] - x[p, :]  # (n_c, Ltau)
    # g = -dt/dx = d(coupling polynomial)/d(dx), complex in general
    g_re = (
        elph.ssh_alpha[idx_j][:, None]
        + 2.0 * elph.ssh_alpha2[idx_j][:, None] * dx
        + 3.0 * elph.ssh_alpha3[idx_j][:, None] * dx**2
        + 4.0 * elph.ssh_alpha4[idx_j][:, None] * dx**3
    )  # (n_c, Ltau)

    if fdm.sinh_hop_im is None:
        # real fast path: dE E^{-1} = -dtau_eff g H0 exactly
        prod = jnp.sum(up[..., j] * vp[..., i] + up[..., i] * vp[..., j], axis=0)  # (Ltau, n_c)
        val = nu * dtau_eff * g_re * prod.T  # (n_c, Ltau)
    else:
        if elph.ssh_alpha_im is not None:
            g_im = (
                elph.ssh_alpha_im[idx_j][:, None]
                + 2.0 * elph.ssh_alpha2_im[idx_j][:, None] * dx
                + 3.0 * elph.ssh_alpha3_im[idx_j][:, None] * dx**2
                + 4.0 * elph.ssh_alpha4_im[idx_j][:, None] * dx**3
            )
        else:
            g_im = jnp.zeros_like(g_re)
        hops = jnp.asarray(plan.hop_idx[color])
        # factor data at this factorization's dtau_eff: s t_hat = sinh - i sinh_im
        sh_re = fdm.sinh_hop[:, hops].T  # (n_c, Ltau)
        sh_im = fdm.sinh_hop_im[:, hops].T
        c = fdm.cosh_hop[:, hops].T
        s = jnp.sqrt(sh_re**2 + sh_im**2)
        s_safe = jnp.where(s > 0, s, 1.0)
        a_re = sh_re / s_safe  # t_hat (1 when the hop amplitude vanishes)
        a_im = -sh_im / s_safe
        abs_t = jnp.arcsinh(s) / dtau_eff
        abs_t_safe = jnp.where(abs_t > 0, abs_t, 1.0)
        dabs = -(a_re * g_re + a_im * g_im)  # |t|' = Re(conj(t_hat) (-g))
        dtheta = -(a_re * g_im - a_im * g_re) / abs_t_safe  # theta'
        dtheta = jnp.where(abs_t > 0, dtheta, 0.0)

        u_re, u_im = up[0], up[1]
        v_re, v_im = vp[0], vp[1]

        def cprod(a, b):  # conj(u_a) v_b as (re, im) of shape (n_c, Ltau)
            re = (u_re[..., a] * v_re[..., b] + u_im[..., a] * v_im[..., b]).T
            im = (u_re[..., a] * v_im[..., b] - u_im[..., a] * v_re[..., b]).T
            return re, im

        Pji_re, Pji_im = cprod(j, i)
        Pij_re, Pij_im = cprod(i, j)
        Dii_re, Dii_im = cprod(i, i)
        Djj_re, Djj_im = cprod(j, j)

        # Re <u| dE E^{-1} |v> assembled from the three block terms
        term1 = dtau_eff * dabs * (
            a_re * (Pji_re + Pij_re) - a_im * (Pji_im - Pij_im)
        )
        term2 = -dtheta * s * c * (
            a_re * (Pji_im - Pij_im) + a_im * (Pji_re + Pij_re)
        )
        term3 = -dtheta * s**2 * (Dii_im - Djj_im)
        val = -nu * (term1 + term2 + term3)
    force = force.at[p].add(-val * jnp.asarray(plan.finite_i[color], dtype=val.dtype)[:, None])
    force = force.at[pf].add(val * jnp.asarray(plan.finite_f[color], dtype=val.dtype)[:, None])
    return force


def _add_holstein_V_force(
    force: jnp.ndarray,
    nu: float,
    up: jnp.ndarray,
    vp: jnp.ndarray,
    elph: ElectronPhononParameters,
    x: jnp.ndarray,
    plan: ForcePlan,
) -> jnp.ndarray:
    """Holstein potential-derivative contribution
    (_mul_nuRe_dtau_dV_dx!, fermion_det_matrix_dervative.jl:258-290)."""
    if elph.n_holstein == 0:
        return force
    sites = elph.hol_to_site
    phonons = elph.hol_to_phonon
    xp = x[phonons, :]  # (n_hol, Ltau)
    dV = elph.dtau * (
        elph.hol_alpha[:, None]
        + 2.0 * elph.hol_alpha2[:, None] * xp
        + 3.0 * elph.hol_alpha3[:, None] * xp**2
        + 4.0 * elph.hol_alpha4[:, None] * xp**3
    )
    prod = jnp.sum(up[..., sites] * vp[..., sites], axis=0)  # (Ltau, n_hol)
    val = nu * dV * prod.T * jnp.asarray(plan.hol_finite, dtype=prod.dtype)[:, None]
    return force.at[phonons].add(val)


def add_M_derivative_force(
    force: jnp.ndarray,
    nu: float,
    u: jnp.ndarray,
    v: jnp.ndarray,
    fdm: FermionDetMatrix,
    elph: ElectronPhononParameters,
    x: jnp.ndarray,
    plan: ForcePlan,
) -> jnp.ndarray:
    """force += nu * Re <u | dM/dx | v>  (mul_nuRe_dMdx!,
    fermion_det_matrix_dervative.jl:2-114 sym / :117-191 asym).

    u, v: (2, Ltau, N) channel pairs; force: (n_phonon, Ltau).
    """
    cb = fdm.cb
    n_colors = cb.n_colors
    dtau = elph.dtau

    # v' = B_l (+-v[l-1]): the tau-shifted, sign-fixed column the derivative acts on
    vp = jnp.roll(v, 1, axis=-2) * _boundary_sign_first(fdm.Ltau).astype(v.dtype)
    vp = fdm.apply_B(vp)
    up = u

    if fdm.symmetric:
        # term 1: d(exp(-dtau K/2)) on the left factor — walk colors in reverse
        if elph.n_ssh > 0:
            for color in reversed(range(n_colors)):
                force = _add_ssh_color_force(force, -nu, up, vp, fdm, elph, x, plan, dtau / 2, color)
                up = cb.apply_color(up, color)
                vp = cb.apply_color(vp, color, inverse=True)
        else:
            # pair <u| CB dD CB^dag |w>: u-side takes CB^dag (reversed colors),
            # v-side peels the LEFT factor CB, i.e. the plain inverse. (The
            # reference peels with the transposed inverse here,
            # fermion_det_matrix_dervative.jl:70-74, which differs at
            # O([K_c, K_c']) for non-commuting colors; verified exact by
            # finite differences and a direct derivative bracket.)
            up = cb.apply(up, transpose=True)
            vp = cb.apply(vp, inverse=True)
        # term 2: d(exp(-dtau V)) in the middle
        if elph.n_holstein > 0:
            force = _add_holstein_V_force(force, -nu, up, vp, elph, x, plan)
        up = up * fdm.exp_nV
        vp = vp / fdm.exp_nV
        # term 3: d(exp(-dtau K/2)^T) on the right factor — walk colors forward
        if elph.n_ssh > 0:
            for color in range(n_colors):
                force = _add_ssh_color_force(force, -nu, up, vp, fdm, elph, x, plan, dtau / 2, color)
                up = cb.apply_color(up, color)
                vp = cb.apply_color(vp, color, inverse=True)
    else:
        # asym B = exp(-dtau V) CB: potential term first, then kinetic walk
        if elph.n_holstein > 0:
            force = _add_holstein_V_force(force, -nu, up, vp, elph, x, plan)
        if elph.n_ssh > 0:
            up = up * fdm.exp_nV
            vp = vp / fdm.exp_nV
            for color in reversed(range(n_colors)):
                force = _add_ssh_color_force(force, -nu, up, vp, fdm, elph, x, plan, dtau, color)
                up = cb.apply_color(up, color)
                vp = cb.apply_color(vp, color, inverse=True)
    return force
