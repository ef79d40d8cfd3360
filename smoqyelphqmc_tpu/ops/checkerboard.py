"""Checkerboard propagator application as gather + elementwise kernels.

Accelerator re-design of the reference's sequential in-place 2x2 hop rotations
(/root/reference/src/checkerboard_matrix_multiply.jl:26-72): each checkerboard color
touches disjoint site pairs, so one color application is

    u <- C_c (.) u + S_c (.) u[..., partner_c]

with per-site coefficient planes C_c, S_c of shape (Ltau, N) (or (N,) for a
time-averaged single-slice propagator) and a static site-permutation gather
`partner_c`. No scatter appears in the hot path; the tau and site axes are fully
vectorized, and arbitrary leading batch axes (complex channel, random vectors, walkers) broadcast for free.

dtype note: the framework carries complex space-time fields as a leading real/imag channel axis. For real
hopping amplitudes (every model family in the reference) each 2x2 hop block
[[cosh, s], [s, cosh]] (s = sign(t) sinh(dtau |t|)) is REAL symmetric with unit
determinant, so:
  - the checkerboard product is a real matrix and channels never mix;
  - its transpose is the same colors applied in reverse order (the reference's
    `transposed=true` path, checkerboard_matrix_multiply.jl:44-47);
  - the inverse negates S and reverses the color order
    (checkerboard_matrix_multiply.jl:117-141).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..lattice import checkerboard_decomposition
from ..utils.pytree import register_pytree_dataclass, static_field


@dataclasses.dataclass(frozen=True)
class CheckerboardStructure:
    """Static gather structure of a checkerboard decomposition (host-side).

    Attributes:
      neighbor_table: (2, n_hops) site pairs in ORIGINAL hop order.
      perm: (n_hops,) original hop index of each color-sorted position.
      color_slices: (start, stop) ranges into the color-sorted order.
      site_hop: (n_colors, n_sites) original hop index covering each site in each
        color (0 where uncovered, masked by site_side == 0).
      site_side: (n_colors, n_sites) +1 if the site is the initial member of its
        hop pair, -1 if final, 0 if uncovered by this color.
      partner: (n_colors, n_sites) the other site of the pair (identity if uncovered).
    """

    neighbor_table: np.ndarray
    perm: np.ndarray
    color_slices: Tuple[Tuple[int, int], ...]
    site_hop: np.ndarray
    site_side: np.ndarray
    partner: np.ndarray

    @property
    def n_colors(self) -> int:
        return len(self.color_slices)

    @property
    def n_sites(self) -> int:
        return self.partner.shape[1]

    @property
    def n_hops(self) -> int:
        return self.neighbor_table.shape[1]


def build_checkerboard_structure(neighbor_table: np.ndarray, n_sites: int) -> CheckerboardStructure:
    """Color the hopping graph and precompute per-color gather maps."""
    neighbor_table = np.asarray(neighbor_table, dtype=np.int32)
    perm, colors = checkerboard_decomposition(neighbor_table)
    n_colors = len(colors)
    site_hop = np.zeros((max(n_colors, 1), n_sites), dtype=np.int32)
    site_side = np.zeros((max(n_colors, 1), n_sites), dtype=np.int8)
    partner = np.tile(np.arange(n_sites, dtype=np.int32), (max(n_colors, 1), 1))
    color_slices: List[Tuple[int, int]] = []
    for c, members in enumerate(colors):
        color_slices.append((int(members[0]), int(members[-1]) + 1) if len(members) else (0, 0))
        for pos in members:
            h = int(perm[pos])  # original hop index
            i, j = int(neighbor_table[0, h]), int(neighbor_table[1, h])
            site_hop[c, i] = h
            site_hop[c, j] = h
            site_side[c, i] = 1
            site_side[c, j] = -1
            partner[c, i] = j
            partner[c, j] = i
    if n_colors == 0:
        color_slices = []
        site_hop = site_hop[:0]
        site_side = site_side[:0]
        partner = partner[:0]
    return CheckerboardStructure(
        neighbor_table=neighbor_table,
        perm=np.asarray(perm, dtype=np.int32),
        color_slices=tuple(color_slices),
        site_hop=site_hop,
        site_side=site_side,
        partner=partner,
    )


@register_pytree_dataclass
class CheckerboardOp:
    """Per-color coefficient planes + static gather maps, ready to apply.

    C, S have shape (n_colors, *time_dims, n_sites): time_dims = (Ltau,) for the
    full space-time operator or () for a single-slice (time-averaged) propagator.

    Complex hoppings: S_im is None for real amplitudes (the fast path — every
    channel/batch axis broadcasts untouched). With complex t the 2x2 hop block
    [[c, s], [conj(s), c]] is HERMITIAN, so the operator mixes the re/im channel
    pair, which must then sit at axis -3 of u, i.e. u is (..., 2, time, n_sites):

      u'_re = C u_re + S_re u_re[p] - (+-)S_im u_im[p]
      u'_im = C u_im + S_re u_im[p] + (+-)S_im u_re[p]

    with the site-dependent sign of S_im already encoding conj(s) on the second
    pair member. Transpose (reversed colors) then realizes the ADJOINT, exactly
    the reference's `transposed=true` semantics for Hermitian blocks
    (checkerboard_matrix_multiply.jl:44-47)."""

    C: jnp.ndarray
    S: jnp.ndarray
    S_im: Optional[jnp.ndarray]  # None for real hoppings
    partner: np.ndarray = static_field()  # (n_colors, n_sites)
    n_colors: int = static_field()

    def apply(self, u: jnp.ndarray, transpose: bool = False, inverse: bool = False) -> jnp.ndarray:
        """Apply the full checkerboard product (or its transpose / inverse) to u.

        u has shape (..., n_sites) [single-slice factors] or (..., Ltau, n_sites);
        coefficients broadcast against leading batch dimensions. For complex
        hoppings u must carry the re/im channel pair at axis -3; transpose=True
        applies the adjoint.
        """
        order = range(self.n_colors)
        # transpose and inverse each reverse the factor order: every hop block
        # (and its inverse) is Hermitian, so reversing the color order realizes
        # the adjoint with no per-block change; applying both cancels it.
        if transpose != inverse:
            order = reversed(order)
        for c in order:
            u = self.apply_color(u, c, inverse=inverse)
        return u

    def apply_color(self, u: jnp.ndarray, c: int, inverse: bool = False) -> jnp.ndarray:
        """u <- C_c u + (-)S_c u[partner_c] for a single color."""
        Cc = self.C[c]
        Sc = -self.S[c] if inverse else self.S[c]
        up = jnp.take(u, jnp.asarray(self.partner[c]), axis=-1)
        if self.S_im is None:
            return Cc * u + Sc * up
        Sc_im = -self.S_im[c] if inverse else self.S_im[c]
        up_re = up[..., 0, :, :]
        up_im = up[..., 1, :, :]
        out_re = Cc * u[..., 0, :, :] + Sc * up_re - Sc_im * up_im
        out_im = Cc * u[..., 1, :, :] + Sc * up_im + Sc_im * up_re
        return jnp.stack([out_re, out_im], axis=-3)


def build_checkerboard_op(
    structure: CheckerboardStructure,
    cosh_hop: jnp.ndarray,
    sinh_hop: jnp.ndarray,
    sinh_hop_im: Optional[jnp.ndarray] = None,
) -> CheckerboardOp:
    """Expand per-hop (.., n_hops) cosh/sinh factors into per-color site planes.

    cosh_hop/sinh_hop index hops in ORIGINAL order along their last axis; leading
    axes (e.g. Ltau) are carried through. sinh encodes s = sign(conj t) sinh(dtau |t|);
    for real t both pair members share it (real symmetric 2x2 block), for complex
    t the second member takes conj(s), encoded as a sign flip of the S_im plane.
    """
    n_colors = structure.n_colors
    n_sites = structure.n_sites
    lead = cosh_hop.shape[:-1]
    if n_colors == 0:
        C = jnp.ones((0,) + lead + (n_sites,))
        S = jnp.zeros((0,) + lead + (n_sites,))
        return CheckerboardOp(C=C, S=S, S_im=None, partner=structure.partner, n_colors=0)

    site_hop = jnp.asarray(structure.site_hop)  # (n_colors, n_sites)
    covered = structure.site_side != 0  # static bool (n_colors, n_sites)
    # gather per-site factors: result (n_colors, *lead, n_sites)
    cosh_site = jnp.moveaxis(cosh_hop[..., site_hop], -2, 0)
    sinh_site = jnp.moveaxis(sinh_hop[..., site_hop], -2, 0)
    bshape = (n_colors,) + (1,) * len(lead) + (n_sites,)
    covered_b = jnp.asarray(covered).reshape(bshape)
    C = jnp.where(covered_b, cosh_site, 1.0)
    S = jnp.where(covered_b, sinh_site, 0.0)
    S_im = None
    if sinh_hop_im is not None:
        sinh_im_site = jnp.moveaxis(sinh_hop_im[..., site_hop], -2, 0)
        # +s_im on the initial pair member, -s_im (conjugate) on the final one
        side_b = jnp.asarray(structure.site_side.astype(np.float64)).reshape(bshape)
        S_im = jnp.where(covered_b, sinh_im_site * side_b, 0.0)
    return CheckerboardOp(C=C, S=S, S_im=S_im, partner=structure.partner, n_colors=n_colors)


def hop_factors(t: jnp.ndarray, dtau_eff: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-hop (cosh, sinh) factors from REAL hopping amplitudes t (.., n_hops).

    cosh = cosh(dtau_eff * |t|), sinh = sign(t) sinh(dtau_eff * |t|) = sinh(dtau_eff * t)
    (matching /root/reference/src/FermionDetMatrix.jl:227-232 for real t).
    """
    return jnp.cosh(dtau_eff * t), jnp.sinh(dtau_eff * t)


def hop_factors_complex(
    t_re: jnp.ndarray, t_im: jnp.ndarray, dtau_eff: float
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(cosh, sinh_re, sinh_im) for COMPLEX hoppings t = t_re + i t_im:
    s = sign(conj t) sinh(dtau_eff |t|) (FermionDetMatrix.jl:227-232)."""
    abs_t = jnp.sqrt(t_re**2 + t_im**2)
    safe = jnp.where(abs_t > 0, abs_t, 1.0)
    sh = jnp.sinh(dtau_eff * abs_t)
    return (
        jnp.cosh(dtau_eff * abs_t),
        jnp.where(abs_t > 0, t_re / safe, 0.0) * sh,
        jnp.where(abs_t > 0, -t_im / safe, 0.0) * sh,
    )


def dense_checkerboard_matrix(op: CheckerboardOp) -> np.ndarray:
    """Dense (n_sites, n_sites) matrix of a single-slice checkerboard product
    (testing oracle; feed per-slice factors)."""
    n_sites = op.partner.shape[1] if op.n_colors else op.C.shape[-1]
    eye = jnp.eye(n_sites)
    return np.asarray(op.apply(eye)).T
