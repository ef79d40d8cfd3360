"""Matrix-free fermion determinant matrix M and its products.

Re-design of /root/reference/src/FermionDetMatrix.jl: M is the block-bidiagonal
space-time matrix (I on the diagonal, -B_l on the subdiagonal, +B_0 in the corner,
antiperiodic boundary) applied to (..., Ltau, N) fields. Two propagator
factorizations:

  symmetric  B_l = CB e^{-dtau V_l} CB^T, CB ~ e^{-dtau K_l / 2}   (symmetric PSD)
  asymmetric B_l = e^{-dtau V_l} CB,      CB ~ e^{-dtau K_l}

with CB the checkerboard approximation (ops/checkerboard.py). For real hoppings
(every reference model family) M is a REAL matrix, so complex pseudofermion fields
ride a leading channel axis of size 2 and all products broadcast over it — no complex dtypes
are needed in this hot path. Arbitrary
further leading batch dimensions (random vectors, walkers) broadcast the same way,
replacing the reference's sequential per-vector loops with one batched application.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..models.fermion_path_integral import FermionPathIntegral
from ..utils.pytree import register_pytree_dataclass, static_field
from .checkerboard import (
    CheckerboardOp,
    CheckerboardStructure,
    build_checkerboard_op,
    build_checkerboard_structure,
    hop_factors,
    hop_factors_complex,
)


@register_pytree_dataclass
class FermionDetMatrix:
    """Matrix-free representation of M (and M^T M) for the current field.

    Leaves:
      exp_nV: (Ltau, N) exp(-dtau V_l) diagonal factors.
      cb: checkerboard factors at dtau_eff = dtau/2 (sym) or dtau (asym).
      cosh_hop / sinh_hop: (Ltau, n_hops) per-hop factors in original hop order
        (retained for the KPM averaged propagator and the force color-walk).
    """

    exp_nV: jnp.ndarray
    cb: CheckerboardOp
    cosh_hop: jnp.ndarray
    sinh_hop: jnp.ndarray
    sinh_hop_im: "jnp.ndarray | None"  # complex hoppings only
    symmetric: bool = static_field()
    structure: CheckerboardStructure = static_field()
    Ltau: int = static_field()
    n_sites: int = static_field()

    # ------------------------------------------------------------------
    @staticmethod
    def from_path_integral(
        fpi: FermionPathIntegral,
        structure: CheckerboardStructure,
        symmetric: bool = True,
    ) -> "FermionDetMatrix":
        """Exponentiate the path integral into propagator factors
        (re-design of update! at /root/reference/src/FermionDetMatrix.jl:208-236)."""
        dtau = fpi.dtau
        dtau_eff = dtau / 2 if symmetric else dtau
        if fpi.t_im is None:
            cosh_hop, sinh_hop = hop_factors(fpi.t, dtau_eff)
            sinh_hop_im = None
        else:
            cosh_hop, sinh_hop, sinh_hop_im = hop_factors_complex(fpi.t, fpi.t_im, dtau_eff)
        cb = build_checkerboard_op(structure, cosh_hop, sinh_hop, sinh_hop_im)
        exp_nV = jnp.exp(-dtau * fpi.V)
        return FermionDetMatrix(
            exp_nV=exp_nV,
            cb=cb,
            cosh_hop=cosh_hop,
            sinh_hop=sinh_hop,
            sinh_hop_im=sinh_hop_im,
            symmetric=symmetric,
            structure=structure,
            Ltau=fpi.Ltau,
            n_sites=fpi.n_sites,
        )

    # ------------------------------------------------------------------
    def apply_B(self, u: jnp.ndarray) -> jnp.ndarray:
        """u <- B u slice-wise (no time shift)."""
        if self.symmetric:
            u = self.cb.apply(u, transpose=True)
            u = self.exp_nV * u
            u = self.cb.apply(u, transpose=False)
        else:
            u = self.cb.apply(u, transpose=False)
            u = self.exp_nV * u
        return u

    def apply_Bt(self, u: jnp.ndarray) -> jnp.ndarray:
        """u <- B^T u slice-wise (sym B is symmetric)."""
        if self.symmetric:
            return self.apply_B(u)
        u = self.exp_nV * u
        u = self.cb.apply(u, transpose=True)
        return u

    # ------------------------------------------------------------------
    def mul_M(self, v: jnp.ndarray) -> jnp.ndarray:
        """v' = M v  (/root/reference/src/FermionDetMatrix.jl:385-466).

        v'[l] = v[l] - B_l v[l-1] for l >= 1;  v'[0] = v[0] + B_0 v[Ltau-1].
        """
        u = jnp.roll(v, 1, axis=-2)  # u[l] = v[l-1] (antiperiodic wrap handled by sign)
        u = self.apply_B(u)
        sgn = _boundary_sign_first(self.Ltau).astype(v.dtype)
        return v + sgn * u

    def mul_Mt(self, v: jnp.ndarray) -> jnp.ndarray:
        """v' = M^T v  (/root/reference/src/FermionDetMatrix.jl:484-563).

        v'[l] = v[l] - B_{l+1}^T v[l+1] for l < Ltau-1;
        v'[Ltau-1] = v[Ltau-1] + B_0^T v[0].
        """
        w = self.apply_Bt(v)
        w = jnp.roll(w, -1, axis=-2)  # w[l] = (B^T v)[l+1], wraps to row 0 at the end
        sgn = _boundary_sign_last(self.Ltau).astype(v.dtype)
        return v + sgn * w

    def mul_MtM(self, v: jnp.ndarray) -> jnp.ndarray:
        return self.mul_Mt(self.mul_M(v))

    def mul_MMt(self, v: jnp.ndarray) -> jnp.ndarray:
        return self.mul_M(self.mul_Mt(v))

    # ------------------------------------------------------------------
    @property
    def complex_hops(self) -> bool:
        """True when M is complex (re/im channel axis must sit at axis -3)."""
        return self.cb.S_im is not None

    def astype(self, dtype) -> "FermionDetMatrix":
        """Cast the propagator factors (for the f32 inner solves of
        mixed-precision CG — ops/cg.py:cg_solve_mixed)."""
        dt = jnp.dtype(dtype)
        return FermionDetMatrix(
            exp_nV=self.exp_nV.astype(dt),
            cb=CheckerboardOp(
                C=self.cb.C.astype(dt),
                S=self.cb.S.astype(dt),
                S_im=None if self.cb.S_im is None else self.cb.S_im.astype(dt),
                partner=self.cb.partner,
                n_colors=self.cb.n_colors,
            ),
            cosh_hop=self.cosh_hop.astype(dt),
            sinh_hop=self.sinh_hop.astype(dt),
            sinh_hop_im=None if self.sinh_hop_im is None else self.sinh_hop_im.astype(dt),
            symmetric=self.symmetric,
            structure=self.structure,
            Ltau=self.Ltau,
            n_sites=self.n_sites,
        )

    @property
    def dim(self) -> int:
        return self.Ltau * self.n_sites

    def averaged_factors(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """tau-averaged (exp_nV, cosh_hop, sinh_hop), each (N,)/(n_hops,) — the
        Bbar ingredients of the KPM preconditioner
        (/root/reference/src/KPMPreconditioner.jl:604-621)."""
        return (
            jnp.mean(self.exp_nV, axis=0),
            jnp.mean(self.cosh_hop, axis=0),
            jnp.mean(self.sinh_hop, axis=0),
        )


def _boundary_sign_first(Ltau: int) -> jnp.ndarray:
    """(Ltau, 1) column: +1 in row 0 (antiperiodic corner), -1 elsewhere."""
    s = np.full((Ltau, 1), -1.0)
    s[0, 0] = 1.0
    return jnp.asarray(s)


def _boundary_sign_last(Ltau: int) -> jnp.ndarray:
    """(Ltau, 1) column: +1 in row Ltau-1, -1 elsewhere."""
    s = np.full((Ltau, 1), -1.0)
    s[Ltau - 1, 0] = 1.0
    return jnp.asarray(s)


def make_structure(neighbor_table: np.ndarray, n_sites: int) -> CheckerboardStructure:
    return build_checkerboard_structure(neighbor_table, n_sites)


def solve_MtM(
    fdm: FermionDetMatrix,
    rhs: jnp.ndarray,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    mixed: bool = False,
    x0=None,
):
    """[M^T M]^{-1} rhs via batched (optionally mixed-precision) preconditioned CG.

    x0 warm-starts the Krylov iteration — along an HMC trajectory consecutive
    solves share Phi and differ by one leapfrog drift of x, so the previous
    solution is an excellent initial guess (iteration counts drop several-fold;
    statistically free since CG still converges to tol)."""
    from .cg import cg_solve, cg_solve_mixed

    # an f32 right-hand side IS the low-precision system: defect correction
    # would add nothing (the f32 solve already meets any tol >= f32 resolution)
    mixed = mixed and rhs.dtype == jnp.float64
    # an f32 rhs against f64 propagator tables would promote the matvec back
    # to f64 and break the while-loop carry dtypes — the f32 request wins
    if rhs.dtype == jnp.float32 and not mixed and fdm.exp_nV.dtype != jnp.float32:
        fdm = fdm.astype(jnp.float32)
    pre_op = precond.as_operator() if precond is not None else None
    # complex M mixes the re/im channel pair at axis -3: the CG inner products
    # must then reduce over (channel, Ltau, N) jointly
    sys_ndim = 3 if fdm.complex_hops else 2
    if mixed:
        fdm32 = fdm.astype(jnp.float32)
        return cg_solve_mixed(
            fdm.mul_MtM, fdm32.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter,
            sys_ndim=sys_ndim, x0=x0,
        )
    return cg_solve(
        fdm.mul_MtM, rhs, precond=pre_op, tol=tol, maxiter=maxiter, sys_ndim=sys_ndim, x0=x0
    )


# ----------------------------------------------------------------------
# Dense oracles (testing only)
# ----------------------------------------------------------------------


def dense_B(fdm: FermionDetMatrix, l: int) -> np.ndarray:
    """Dense (N, N) propagator B_l (testing oracle)."""
    n = fdm.n_sites
    eye = jnp.eye(n)
    has_im = fdm.cb.S_im is not None
    sub = FermionDetMatrix(
        exp_nV=fdm.exp_nV[l],
        cb=CheckerboardOp(
            C=fdm.cb.C[:, l] if fdm.cb.n_colors else fdm.cb.C,
            S=fdm.cb.S[:, l] if fdm.cb.n_colors else fdm.cb.S,
            S_im=(fdm.cb.S_im[:, l] if fdm.cb.n_colors else fdm.cb.S_im) if has_im else None,
            partner=fdm.cb.partner,
            n_colors=fdm.cb.n_colors,
        ),
        cosh_hop=fdm.cosh_hop[l],
        sinh_hop=fdm.sinh_hop[l],
        sinh_hop_im=fdm.sinh_hop_im[l] if has_im else None,
        symmetric=fdm.symmetric,
        structure=fdm.structure,
        Ltau=1,
        n_sites=n,
    )
    if not has_im:
        cols = sub.apply_B(eye)  # row k = B e_k
        return np.asarray(cols).T
    # complex: feed channel-paired basis vectors (..., 2, 1, N)
    basis = jnp.stack([eye, jnp.zeros_like(eye)], axis=1)[:, :, None, :]  # (N, 2, 1, N)
    out = sub.apply_B(basis)  # (N, 2, 1, N)
    cols = np.asarray(out[:, 0, 0, :]) + 1j * np.asarray(out[:, 1, 0, :])
    return cols.T


def dense_M(fdm: FermionDetMatrix) -> np.ndarray:
    """Dense (Ltau N, Ltau N) fermion determinant matrix (testing oracle)."""
    Ltau, n = fdm.Ltau, fdm.n_sites
    dim = Ltau * n
    M = np.eye(dim, dtype=np.complex128 if fdm.complex_hops else np.float64)
    for l in range(Ltau):
        B = dense_B(fdm, l)
        row = l
        col = (l - 1) % Ltau
        sign = 1.0 if l == 0 else -1.0
        M[row * n : (row + 1) * n, col * n : (col + 1) * n] += sign * B
    return M
