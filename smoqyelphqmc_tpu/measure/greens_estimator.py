"""Stochastic Green's-function estimator and FFT contraction engine.

Re-design of /root/reference/src/Measurements/GreensEstimator.jl. The estimator
holds Nrv unit-phase complex random vectors R and GR = M^{-1} R, obtained from ONE
batched CG solve of [M^T M] x = M^T R over all (vector, channel) systems — the
batched replacement for the reference's sequential per-vector solves
(GreensEstimator.jl:154-168).

Estimators (complex fields are (re, im) array pairs; no complex dtypes):

- single-particle G(r, tau) via FFT cross-correlation of GR with conj(R) using the
  aperiodic sign-extension along tau (GreensEstimator.jl:656-671) and the
  boundary fix G(r, beta) = delta(r) - G(r, 0) (:221-227);
- four-fermion contractions G.G from pairs of independent random vectors in three
  topologies (GdG d0.Gd0 / Gdd.G00 / G0d.Gd0, :241-606) with orbital 4-tuples,
  four static unit-cell displacements, optional hopping-amplitude weight fields
  with conjugation flags, and tau = 0 / beta delta-function boundary corrections;
- translational averaging S[r] += (1/Nvol) sum_i a[i+r] b[i] as multi-axis DFT
  matmuls (ops/fourier.py, at Precision.HIGHEST), batched over all
  random-vector pairs at once.

All correlation outputs have shape (Ltau + 1, *L) — displacement tau = 0..beta —
as (re, im) pairs; accumulation into named containers happens one level up.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fermion_det import FermionDetMatrix
from ..ops.fourier import FactoredDFT, PackedDFT
from ..utils.pytree import register_pytree_dataclass, static_field

Pair = Tuple[jnp.ndarray, jnp.ndarray]

# transform-size thresholds: dense packed matmuls up to these sizes, the
# asymptotically-cheaper factored / per-axis forms beyond (see PackedDFT)
_PACKED_TAU_MAX = 1024
_JOINT_SPACE_MAX_CELLS = 512


def _cmul(ar, ai, br, bi) -> Pair:
    return ar * br - ai * bi, ar * bi + ai * br


def _cached(cache: Optional[dict], key, fn):
    """Trace-time transform cache: repeated contraction terms across correlation
    kinds (spin_z == density exchange term, composite re-measurements, ...) share
    ONE transformed field instead of relying on XLA CSE. key=None bypasses."""
    if cache is None or key is None:
        return fn()
    if key not in cache:
        cache[key] = fn()
    return cache[key]


@register_pytree_dataclass
class GreensEstimator:
    """R, GR = M^{-1} R and the DFT operators for translational averaging."""

    R: jnp.ndarray  # (Nrv, 2, Ltau, N) random vectors (channel axis = re/im)
    GR: jnp.ndarray  # (Nrv, 2, Ltau, N)
    tau2_fwd: object  # length-2Ltau transforms (single-G aperiodic doubling)
    tau2_inv: object
    tau_fwd: object  # length-Ltau transforms (pair contractions)
    tau_inv: object
    space_fwd: object  # joint PackedDFT over flattened cells, or per-axis tuple
    space_inv: object
    Nrv: int = static_field()
    Ltau: int = static_field()
    n_orb: int = static_field()
    L: Tuple[int, ...] = static_field()
    joint_space: bool = static_field(default=True)
    # dtype of the contraction engine: float32 rounding (~1e-7) is far below the
    # 1/sqrt(Nrv...) statistical noise of the estimators, so the FFT/product
    # arithmetic can run in f32 while the CG solves stay f64
    dtype: str = static_field(default="float64")

    # ------------------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return int(np.prod(self.L))

    @property
    def n_sites(self) -> int:
        return self.n_cells * self.n_orb

    @property
    def D(self) -> int:
        return len(self.L)

    def shaped(self, arr: jnp.ndarray) -> jnp.ndarray:
        """(.., Ltau, N) -> (.., Ltau, *L, n_orb)."""
        return arr.reshape(arr.shape[:-1] + self.L + (self.n_orb,))

    def orbital_fields(self, orb: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(GR_re, GR_im, Rc_re, Rc_im) for one orbital, each (Nrv, Ltau, *L);
        Rc = conj(R)."""
        GR = self.shaped(self.GR)[..., orb]
        R = self.shaped(self.R)[..., orb]
        return GR[:, 0], GR[:, 1], R[:, 0], -R[:, 1]

    # ------------------------------------------------------------------
    def xt(self, ar, ai, inverse: bool, doubled: bool = False) -> Pair:
        """Multi-axis DFT over the trailing (tau, *L) axes of ar/ai. The
        forward (analysis of the shifted factor) uses the plain DFT kernel; the
        inverse kernel (with its 1/Nvol norm) serves both the analysis of the
        un-shifted factor and the final synthesis — the cross-correlation
        identity S = IDFT(DFT(a) . IDFT(b)) (_translational_average!,
        GreensEstimator.jl:677-708)."""
        if doubled:
            tau_dft = self.tau2_inv if inverse else self.tau2_fwd
        else:
            tau_dft = self.tau_inv if inverse else self.tau_fwd
        ndim = ar.ndim
        tau_axis = ndim - 1 - self.D
        ar, ai = tau_dft.apply(ar, ai, axis=tau_axis)
        sp = self.space_inv if inverse else self.space_fwd
        if self.joint_space:
            lead = ar.shape[: tau_axis + 1]
            ar, ai = sp.apply(ar.reshape(lead + (-1,)), ai.reshape(lead + (-1,)), axis=-1)
            ar = ar.reshape(lead + self.L)
            ai = ai.reshape(lead + self.L)
        else:
            for d in range(self.D):
                ar, ai = sp[d].apply(ar, ai, axis=tau_axis + 1 + d)
        return ar, ai

    def xcorr_accumulate(self, ar, ai, br, bi, doubled: bool) -> Pair:
        """S[r] = (1/Nvol) sum_i a[i+r] b[i] over (tau, *L) for batched a, b;
        sums the leading batch axes."""
        fr, fi = self.xt(ar, ai, inverse=False, doubled=doubled)
        hr, hi = self.xt(br, bi, inverse=True, doubled=doubled)
        pr, pi = _cmul(fr, fi, hr, hi)
        # sum over every leading axis before the final inverse transform
        extra = pr.ndim - (1 + self.D)
        if extra > 0:
            pr = jnp.sum(pr, axis=tuple(range(extra)))
            pi = jnp.sum(pi, axis=tuple(range(extra)))
        return self.xt(pr, pi, inverse=True, doubled=doubled)


class EstimatorUpdate(NamedTuple):
    estimator: GreensEstimator
    iters: jnp.ndarray
    converged: jnp.ndarray


def _tau_dft(n: int, inverse: bool, dtype: str):
    norm = 1.0 / n if inverse else 1.0
    if n <= _PACKED_TAU_MAX:
        return PackedDFT.build(n, inverse=inverse, norm=norm, dtype=dtype)
    return FactoredDFT.build(n, inverse=inverse, norm=norm, dtype=dtype)


def build_greens_estimator(
    Ltau: int, n_orb: int, L: Sequence[int], Nrv: int = 10, dtype: str = "float64"
) -> GreensEstimator:
    L = tuple(int(x) for x in L)
    n_cells = int(np.prod(L))
    n_sites = n_cells * n_orb
    dt = jnp.dtype(dtype)
    zeros = jnp.zeros((Nrv, 2, Ltau, n_sites), dtype=dt)
    joint = n_cells <= _JOINT_SPACE_MAX_CELLS
    if joint:
        space_fwd = PackedDFT.build_joint(L, dtype=dtype)
        space_inv = PackedDFT.build_joint(L, inverse=True, dtype=dtype)
    else:
        space_fwd = tuple(PackedDFT.build(l, dtype=dtype) for l in L)
        space_inv = tuple(
            PackedDFT.build(l, inverse=True, norm=1.0 / l, dtype=dtype) for l in L
        )
    return GreensEstimator(
        R=zeros,
        GR=zeros,
        tau2_fwd=_tau_dft(2 * Ltau, False, dtype),
        tau2_inv=_tau_dft(2 * Ltau, True, dtype),
        tau_fwd=_tau_dft(Ltau, False, dtype),
        tau_inv=_tau_dft(Ltau, True, dtype),
        space_fwd=space_fwd,
        space_inv=space_inv,
        Nrv=Nrv,
        Ltau=Ltau,
        n_orb=n_orb,
        L=L,
        joint_space=joint,
        dtype=dtype,
    )


def update_greens_estimator(
    est: GreensEstimator,
    fdm: FermionDetMatrix,
    key,
    precond=None,
    tol: float = 1e-10,
    maxiter: int = 10_000,
    mixed: bool = False,
    solve_dtype: "str | None" = None,
) -> EstimatorUpdate:
    """Draw fresh unit-phase random vectors and solve GR = M^{-1} R in one
    batched CG (update_greens_estimator!, GreensEstimator.jl:125-175).

    solve_dtype='float32' runs the Nrv solves in f32. The solve residual enters measurements only as a BIAS of
    relative size ~tol — at the clamped 2e-5 this sits 3-4 orders below the
    stochastic estimator noise (~1/sqrt(Nrv)) and below the f32 rounding of the
    stored GR fields (est.dtype is float32 in the production driver), while the
    Markov chain's exactness never involves these solves at all. f64 solves
    exist for validation (solve_dtype=None with float64 inputs)."""
    from ..ops.fermion_det import solve_MtM

    theta = jax.random.uniform(key, (est.Nrv, est.Ltau, fdm.n_sites), maxval=2.0 * np.pi)
    R = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=1)  # (Nrv, 2, Ltau, N)
    if solve_dtype is not None and jnp.dtype(solve_dtype) == jnp.float32:
        fdm = fdm.astype(jnp.float32)
        R_s = R.astype(jnp.float32)
        tol = max(tol, 2e-5)  # f32 resolution floor
        mixed = False
    else:
        R_s = R
    MtR = fdm.mul_Mt(R_s)
    GR, stats = solve_MtM(fdm, MtR, precond=precond, tol=tol, maxiter=maxiter, mixed=mixed)
    dt = jnp.dtype(est.dtype)
    est = est.replace(R=R.astype(dt), GR=GR.astype(dt))
    return EstimatorUpdate(estimator=est, iters=stats.iters, converged=stats.converged)


# ----------------------------------------------------------------------
# Single-particle Green's function
# ----------------------------------------------------------------------


def measure_G(est: GreensEstimator, orbitals: Tuple[int, int], cache: Optional[dict] = None) -> Pair:
    """G_ab(r, tau) for tau = 0..beta, shape (Ltau+1, *L)
    (measure_GD0!, GreensEstimator.jl:179-233)."""
    a, b = orbitals

    def mkF():
        GAr, GAi = est.orbital_fields(a)[:2]
        # aperiodic sign extension along tau
        Ar = jnp.concatenate([GAr, -GAr], axis=1)
        Ai = jnp.concatenate([GAi, -GAi], axis=1)
        return est.xt(Ar, Ai, inverse=False, doubled=True)

    def mkH():
        RBr, RBi = est.orbital_fields(b)[2:]
        Br = jnp.concatenate([RBr, -RBr], axis=1)
        Bi = jnp.concatenate([RBi, -RBi], axis=1)
        return est.xt(Br, Bi, inverse=True, doubled=True)

    Fr, Fi = _cached(cache, ("G2", "G", a), mkF)
    Hr, Hi = _cached(cache, ("G2", "R", b), mkH)
    pr, pi = _cmul(Fr, Fi, Hr, Hi)
    pr = jnp.sum(pr, axis=0)
    pi = jnp.sum(pi, axis=0)
    Sr, Si = est.xt(pr, pi, inverse=True, doubled=True)
    Sr = Sr / est.Nrv
    Si = Si / est.Nrv
    Gr = Sr[: est.Ltau]
    Gi = Si[: est.Ltau]
    # boundary: G(r, beta) = delta_ab delta(r) - G(r, 0)
    Gb_r = -Sr[0]
    Gb_i = -Si[0]
    if a == b:
        Gb_r = Gb_r.at[(0,) * est.D].add(1.0)
    return (
        jnp.concatenate([Gr, Gb_r[None]], axis=0),
        jnp.concatenate([Gi, Gb_i[None]], axis=0),
    )


# ----------------------------------------------------------------------
# Pairwise four-fermion contractions
# ----------------------------------------------------------------------


def _pair_indices(Nrv: int) -> Tuple[np.ndarray, np.ndarray]:
    n, m = np.triu_indices(Nrv, k=1)
    return n.astype(np.int32), m.astype(np.int32)


def _roll_cells(est: GreensEstimator, arr: jnp.ndarray, r: Sequence[int], sign: int) -> jnp.ndarray:
    """Roll the trailing D cell axes by sign*r (arr trailing dims = (*L,) or (tau, *L))."""
    r = tuple(int(v) for v in r)
    if all(v == 0 for v in r):
        return arr
    axes = tuple(range(arr.ndim - est.D, arr.ndim))
    return jnp.roll(arr, tuple(sign * v for v in r), axes)


def _apply_weight(est, pr, pi, t_field, conj_t, shift=None):
    """Multiply a (.., Ltau, *L) pair by a hopping-weight field (Ltau, *L) pair."""
    if t_field is None:
        return pr, pi
    tr, ti = t_field
    if shift is not None:
        tr = _roll_cells(est, tr, shift, +1)
        ti = None if ti is None else _roll_cells(est, ti, shift, +1)
    if ti is None:
        return pr * tr, pi * tr
    if conj_t:
        ti = -ti
    return _cmul(pr, pi, tr, ti)


def _four_point(
    est: GreensEstimator,
    fields: Tuple,  # ((X1, X2), (Y1, Y2)): delta-side and zero-side factor pairs
    tD: Optional[Pair],
    t0: Optional[Pair],
    conj_tD: bool,
    conj_t0: bool,
    cache: Optional[dict] = None,
    keyP=None,
    keyQ=None,
) -> Pair:
    """sum over ordered random-vector pairs (n, m), n -> first slot, m -> second:
    xcorr( tD (.) X1_n (.) X2_m ,  t0 (.) Y1_n (.) Y2_m ) / Npairs. The two
    per-pair-field transforms (the engine's dominant cost) are cached by the
    semantic keys keyP/keyQ; weighted sides bypass the cache."""
    (X1r, X1i, X2r, X2i), (Y1r, Y1i, Y2r, Y2i) = fields
    pn, pm = _pair_indices(est.Nrv)
    pn = jnp.asarray(pn)
    pm = jnp.asarray(pm)

    def mkP():
        Pr, Pi = _cmul(X1r[pn], X1i[pn], X2r[pm], X2i[pm])  # (Npairs, Ltau, *L)
        Pr, Pi = _apply_weight(est, Pr, Pi, tD, conj_tD)
        return est.xt(Pr, Pi, inverse=False)

    def mkQ():
        Qr, Qi = _cmul(Y1r[pn], Y1i[pn], Y2r[pm], Y2i[pm])
        Qr, Qi = _apply_weight(est, Qr, Qi, t0, conj_t0)
        return est.xt(Qr, Qi, inverse=True)

    Fr, Fi = _cached(cache, keyP if tD is None else None, mkP)
    Hr, Hi = _cached(cache, keyQ if t0 is None else None, mkQ)
    pr, pi = _cmul(Fr, Fi, Hr, Hi)
    pr = jnp.sum(pr, axis=0)
    pi = jnp.sum(pi, axis=0)
    Sr, Si = est.xt(pr, pi, inverse=True)
    npairs = pn.shape[0]
    return Sr / npairs, Si / npairs


def _extend_beta(est: GreensEstimator, Sr: jnp.ndarray, Si: jnp.ndarray) -> Pair:
    """(Ltau, *L) -> (Ltau+1, *L) with the beta row equal to the tau = 0 row
    (periodic product of two antiperiodic factors)."""
    return (
        jnp.concatenate([Sr, Sr[0][None]], axis=0),
        jnp.concatenate([Si, Si[0][None]], axis=0),
    )


def _site_sum_correction(
    est: GreensEstimator,
    GXr, GXi, RYr, RYi,
    shift: Sequence[int],
    tD: Optional[Pair],
    t0: Optional[Pair],
    conj_tD: bool,
    conj_t0: bool,
    t_shift: Sequence[int],
) -> Pair:
    """(1/(Nrv Nvol)) sum_rv sum_i [t-weights] GX[i + shift] RY[i] — the building
    block of the tau = 0 / beta delta-corrections (GreensEstimator.jl:308-382)."""
    GXr_s = _roll_cells(est, GXr, shift, +1)
    GXi_s = _roll_cells(est, GXi, shift, +1)
    pr, pi = _cmul(GXr_s, GXi_s, RYr, RYi)  # (Nrv, Ltau, *L)
    if tD is not None or t0 is not None:
        if tD is not None:
            wr_, wi_ = tD
            wr_ = _roll_cells(est, wr_, t_shift, +1)
            if wi_ is not None:
                wi_ = _roll_cells(est, wi_, t_shift, +1)
                if conj_tD:
                    wi_ = -wi_
                pr, pi = _cmul(pr, pi, wr_, wi_)
            else:
                pr, pi = pr * wr_, pi * wr_
        if t0 is not None:
            tr_, ti_ = t0
            if ti_ is not None:
                if conj_t0:
                    ti_ = -ti_
                pr, pi = _cmul(pr, pi, tr_, ti_)
            else:
                pr, pi = pr * tr_, pi * tr_
    nvol = est.Ltau * est.n_cells
    return jnp.sum(pr) / (est.Nrv * nvol), jnp.sum(pi) / (est.Nrv * nvol)


def _delta_cell(est: GreensEstimator, r: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(v) % l for v, l in zip(r, est.L))


def measure_GD0_GD0(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Pair] = None,
    t0: Optional[Pair] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> Pair:
    """G(D,0).G(D,0) contraction with its two tau = beta boundary corrections and
    the double-delta term (measure_GD0_GD0!, GreensEstimator.jl:241-388)."""
    a, b, c, d = orbitals
    GAr, GAi, _, _ = est.orbital_fields(a)
    _, _, RBr, RBi = est.orbital_fields(b)
    GCr, GCi, _, _ = est.orbital_fields(c)
    _, _, RDr, RDi = est.orbital_fields(d)
    D = est.D

    sh = lambda arr, r: _roll_cells(est, arr, r, -1)  # view at i + r
    fields = (
        (sh(GAr, r1), sh(GAi, r1), sh(GCr, r3), sh(GCi, r3)),
        (sh(RBr, r2), sh(RBi, r2), sh(RDr, r4), sh(RDi, r4)),
    )
    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))
    Sr, Si = _four_point(
        est, fields, tD, t0, conj_tD, conj_t0, cache,
        keyP=("GD0P", "G", a, r1t, "G", c, r3t),
        keyQ=("GD0Q", "R", b, r2t, "R", d, r4t),
    )
    Cr, Ci = _extend_beta(est, Sr, Si)

    # tau = beta corrections
    if a == b:
        shift = tuple(r1[k] - r2[k] - r3[k] + r4[k] for k in range(D))
        vr, vi = _site_sum_correction(
            est, GCr, GCi, RDr, RDi, shift, tD, t0, conj_tD, conj_t0,
            t_shift=tuple(r1[k] - r2[k] for k in range(D)),
        )
        cell = _delta_cell(est, tuple(r2[k] - r1[k] for k in range(D)))
        Cr = Cr.at[(est.Ltau,) + cell].add(-vr)
        Ci = Ci.at[(est.Ltau,) + cell].add(-vi)
    if c == d:
        shift = tuple(-r1[k] + r2[k] + r3[k] - r4[k] for k in range(D))
        vr, vi = _site_sum_correction(
            est, GAr, GAi, RBr, RBi, shift, tD, t0, conj_tD, conj_t0,
            t_shift=tuple(r3[k] - r4[k] for k in range(D)),
        )
        cell = _delta_cell(est, tuple(r4[k] - r3[k] for k in range(D)))
        Cr = Cr.at[(est.Ltau,) + cell].add(-vr)
        Ci = Ci.at[(est.Ltau,) + cell].add(-vi)
    if (
        a == b
        and c == d
        and all((r2[k] - r1[k]) % est.L[k] == (r4[k] - r3[k]) % est.L[k] for k in range(D))
    ):
        cell = _delta_cell(est, tuple(r2[k] - r1[k] for k in range(D)))
        if tD is None and t0 is None:
            Cr = Cr.at[(est.Ltau,) + cell].add(1.0)
        else:
            # mean of the weight product over the lattice
            wr = jnp.ones((est.Ltau,) + est.L)
            wi = jnp.zeros((est.Ltau,) + est.L)
            wr, wi = _apply_weight(
                est, wr, wi, tD, conj_tD, shift=tuple(r1[k] - r2[k] for k in range(D))
            )
            wr, wi = _apply_weight(est, wr, wi, t0, conj_t0)
            nvol = est.Ltau * est.n_cells
            Cr = Cr.at[(est.Ltau,) + cell].add(jnp.sum(wr) / nvol)
            Ci = Ci.at[(est.Ltau,) + cell].add(jnp.sum(wi) / nvol)
    return coef * Cr, coef * Ci


def measure_GDD_G00(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Pair] = None,
    t0: Optional[Pair] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> Pair:
    """G(D,D).G(0,0) contraction (measure_GDD_G00!, GreensEstimator.jl:396-467) —
    equal-time factors at both ends, no boundary corrections.

    The delta-side product depends only on vector n and the zero-side only on m,
    so the pair sum FACTORIZES: averaging over ALL ordered pairs n != m (an
    equally unbiased estimator with 2x the reference's binomial(Nrv,2) pairs),

        sum_{n != m} F(P_n) G(Q_m) = (sum_n F(P_n)) (sum_m G(Q_m))
                                     - sum_n F(P_n) G(Q_n),

    which needs 2*Nrv field transforms instead of 2*binomial(Nrv,2)."""
    a, b, c, d = orbitals
    GAr, GAi, _, _ = est.orbital_fields(a)
    _, _, RBr, RBi = est.orbital_fields(b)
    GCr, GCi, _, _ = est.orbital_fields(c)
    _, _, RDr, RDi = est.orbital_fields(d)
    sh = lambda arr, r: _roll_cells(est, arr, r, -1)
    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))

    def mkF():
        Pr, Pi = _cmul(sh(GAr, r1), sh(GAi, r1), sh(RBr, r2), sh(RBi, r2))
        Pr, Pi = _apply_weight(est, Pr, Pi, tD, conj_tD)
        return est.xt(Pr, Pi, inverse=False)  # (Nrv, Ltau, *L)

    def mkH():
        Qr, Qi = _cmul(sh(GCr, r3), sh(GCi, r3), sh(RDr, r4), sh(RDi, r4))
        Qr, Qi = _apply_weight(est, Qr, Qi, t0, conj_t0)
        return est.xt(Qr, Qi, inverse=True)

    Fr, Fi = _cached(cache, ("GDDP", "G", a, r1t, "R", b, r2t) if tD is None else None, mkF)
    Hr, Hi = _cached(cache, ("GDDQ", "G", c, r3t, "R", d, r4t) if t0 is None else None, mkH)
    tot_r, tot_i = _cmul(Fr.sum(0), Fi.sum(0), Hr.sum(0), Hi.sum(0))
    diag_r, diag_i = _cmul(Fr, Fi, Hr, Hi)
    pr = tot_r - diag_r.sum(0)
    pi = tot_i - diag_i.sum(0)
    Sr, Si = est.xt(pr, pi, inverse=True)
    npairs = est.Nrv * (est.Nrv - 1)
    Cr, Ci = _extend_beta(est, Sr / npairs, Si / npairs)
    return coef * Cr, coef * Ci


def measure_G0D_GD0(
    est: GreensEstimator,
    orbitals: Tuple[int, int, int, int],
    r1, r2, r3, r4,
    coef: float,
    tD: Optional[Pair] = None,
    t0: Optional[Pair] = None,
    conj_tD: bool = False,
    conj_t0: bool = False,
    cache: Optional[dict] = None,
) -> Pair:
    """G(0,D).G(D,0) contraction with tau = 0 and tau = beta delta-corrections
    (measure_G0D_GD0!, GreensEstimator.jl:475-606)."""
    a, b, c, d = orbitals
    GAr, GAi, _, _ = est.orbital_fields(a)
    _, _, RBr, RBi = est.orbital_fields(b)
    GCr, GCi, _, _ = est.orbital_fields(c)
    _, _, RDr, RDi = est.orbital_fields(d)
    D = est.D
    sh = lambda arr, r: _roll_cells(est, arr, r, -1)
    # delta side: (Rt_b_r2)_n (.) (GR_c_r3)_m ; zero side: (GR_a_r1)_n (.) (Rt_d_r4)_m
    fields = (
        (sh(RBr, r2), sh(RBi, r2), sh(GCr, r3), sh(GCi, r3)),
        (sh(GAr, r1), sh(GAi, r1), sh(RDr, r4), sh(RDi, r4)),
    )
    r1t, r2t, r3t, r4t = (tuple(int(v) for v in r) for r in (r1, r2, r3, r4))
    Sr, Si = _four_point(
        est, fields, tD, t0, conj_tD, conj_t0, cache,
        keyP=("G0DP", "R", b, r2t, "G", c, r3t),
        keyQ=("G0DQ", "G", a, r1t, "R", d, r4t),
    )
    Cr, Ci = _extend_beta(est, Sr, Si)

    shift = tuple(-r1[k] + r2[k] - r3[k] + r4[k] for k in range(D))
    if a == b:
        vr, vi = _site_sum_correction(
            est, GCr, GCi, RDr, RDi, shift, tD, t0, conj_tD, conj_t0,
            t_shift=tuple(-r1[k] + r2[k] for k in range(D)),
        )
        cell = _delta_cell(est, tuple(r1[k] - r2[k] for k in range(D)))
        Cr = Cr.at[(0,) + cell].add(-vr)
        Ci = Ci.at[(0,) + cell].add(-vi)
    if c == d:
        vr, vi = _site_sum_correction(
            est, GAr, GAi, RBr, RBi, shift, tD, t0, conj_tD, conj_t0,
            t_shift=tuple(-r4[k] + r3[k] for k in range(D)),
        )
        cell = _delta_cell(est, tuple(r4[k] - r3[k] for k in range(D)))
        Cr = Cr.at[(est.Ltau,) + cell].add(-vr)
        Ci = Ci.at[(est.Ltau,) + cell].add(-vi)
    return coef * Cr, coef * Ci
