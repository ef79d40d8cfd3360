"""KPM (Chebyshev) preconditioner for the M^T M conjugate-gradient solves.

Re-design of /root/reference/src/KPMPreconditioner.jl for accelerator execution. The
preconditioner is P^{-1} = [Mbar^T Mbar]^{-1} where Mbar replaces every propagator
by the tau-averaged Bbar; in the antiperiodic frequency basis (ops/fourier.py)
Mbar is block diagonal and the per-frequency inverse is a scalar function of Bbar:

  symmetric:  f(b; phi) = 1 / (b^2 - 2 b cos(phi) + 1)          (real coefficients)
  asymmetric: g(b; phi) = 1 / (1 - e^{-i phi} b), applied twice  (complex coefficients)

with phi_w = 2 pi (w + 1/2) / Ltau. Eigenvalue bounds of Bbar come from a
fixed-step Lanczos iteration; the preconditioner self-deactivates when the
buffered bounds leave (0,1) u (1,2) (KPMPreconditioner.jl:573-594).

Accelerator mapping (the load-bearing design choices):

- The reference expands each frequency separately with a per-frequency order
  n_w ~ (eps_max - eps_min)(a1/phi + a2) (KPMPreconditioner.jl:711). Here ONE
  Chebyshev recurrence runs over the whole (Ltau, N) frequency block — Bbar is
  the same operator for every frequency — with runtime orders (from live Lanczos
  bounds) zeroing coefficients beyond each frequency's n_w, preserving the
  reference's adaptive truncation without dynamic shapes.
- The recurrence is BLOCKED to cut sequential latency sqrt(C)-fold: Bbar is
  densified once per refresh (N x N — trivially affordable next to the O(N^3)
  alternatives), the stride matrix T_s(Bbar') is built by an s-step dense matrix
  recurrence at refresh time, and the apply advances s Chebyshev orders per
  dense (s*Ltau, N) x (N, N) matmul via T_{m+s} = 2 T_s T_m - T_{m-s}. Depth
  falls from C sequential checkerboard sweeps to ~2 sqrt(C) dense matmuls.
- The whole apply runs in float32 by default, with matmuls at the backend's
  default precision (TF32 on a GPU): a preconditioner is a fixed SPD map, so
  its precision never affects the CG solution, only the iteration count.
- Chebyshev coefficients are computed on device as small cosine-transform matmuls
  every update (cheap), instead of the reference's drift-gated host recompute.
- Everything is real arithmetic: complex frequency-space vectors are (re, im)
  pairs; for the symmetric propagator the coefficients are real so the two
  channels never mix.
- COMPLEX hoppings: Bbar is a complex (Hermitian for the symmetric
  factorization) operator on the (re, im)-channel site vectors; the blocked
  recurrence runs in the real doubled basis E = [[B_re, -B_im], [B_im, B_re]]
  (2N x 2N dense, same embedding as ops/spectral_precond.py), and complex
  frequency coefficients act through the i-rotation rot([a, b]) = [-b, a] of
  the doubled site axis. Spectrum of E = spectrum of Bbar (doubled), so the
  Lanczos bounds, activation test and per-frequency orders are unchanged.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.pytree import register_pytree_dataclass, static_field
from .checkerboard import CheckerboardOp, build_checkerboard_op
from .fermion_det import FermionDetMatrix
from .fourier import TauFourier


# ----------------------------------------------------------------------
# Bbar: tau-averaged single-slice propagator
# ----------------------------------------------------------------------


@register_pytree_dataclass
class AveragedPropagator:
    """Bbar built from tau-averaged checkerboard + diagonal factors
    (/root/reference/src/KPMPreconditioner.jl:604-621)."""

    cb: CheckerboardOp  # single-slice factors (N,)
    expV: jnp.ndarray  # (N,)
    symmetric: bool = static_field()

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        if self.symmetric:
            u = self.cb.apply(u, transpose=True)
            u = self.expV * u
            u = self.cb.apply(u)
        else:
            u = self.cb.apply(u)
            u = self.expV * u
        return u

    def apply_T(self, u: jnp.ndarray) -> jnp.ndarray:
        if self.symmetric:
            return self.apply(u)
        u = self.expV * u
        u = self.cb.apply(u, transpose=True)
        return u


def averaged_propagator(fdm: FermionDetMatrix) -> AveragedPropagator:
    expV_bar, cosh_bar, sinh_bar = fdm.averaged_factors()
    sinh_bar_im = None if fdm.sinh_hop_im is None else jnp.mean(fdm.sinh_hop_im, axis=0)
    cb = build_checkerboard_op(fdm.structure, cosh_bar, sinh_bar, sinh_bar_im)
    return AveragedPropagator(cb=cb, expV=expV_bar, symmetric=fdm.symmetric)


# ----------------------------------------------------------------------
# Lanczos eigenvalue bounds (fixed-step, device-side)
# ----------------------------------------------------------------------


def lanczos_bounds(apply_A, n_sites: int, key, n_steps: int = 20) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(eig_min, eig_max) of a symmetric operator via n_steps Lanczos + dense
    tridiagonal eigensolve (SmoQyKPMCore lanczos! as used at
    /root/reference/src/KPMPreconditioner.jl:625-658)."""
    v = jax.random.normal(key, (n_sites,))
    v = v / jnp.linalg.norm(v)

    def step(carry, _):
        v_prev, v_cur, beta_prev = carry
        w = apply_A(v_cur) - beta_prev * v_prev
        alpha = jnp.dot(w, v_cur)
        w = w - alpha * v_cur
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.where(beta > 1e-300, beta, 1.0)
        return (v_cur, v_next, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = lax.scan(step, (jnp.zeros(n_sites), v, jnp.asarray(0.0)), None, length=n_steps)
    T = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    evals = jnp.linalg.eigvalsh(T)
    return evals[0], evals[-1]


# ----------------------------------------------------------------------
# Static frequency bucketing plan
# ----------------------------------------------------------------------

# Auto-crossover to the matrix-free checkerboard recurrence: below this the
# dense blocked-stride apply's shorter sequential depth wins; above it the
# dense N^2-per-stride matmuls and the N^2 refresh densification stop scaling
# while the checkerboard recurrence stays O(n_colors N) per order. Not yet
# tuned on the H100.
_MATRIX_FREE_MIN_SITES = 1024


def _static_plan(Ltau: int, a1_eff: float, a2: float, cap_delta_eps: float, cap_max=None):
    """Static per-frequency order caps + ONE flat recurrence segment.

    One recurrence per frequency tier would be many small sequential steps,
    so the plan runs a single blocked Chebyshev
    recurrence over the whole (Ltau, N) frequency block padded up to a
    (block_size x n_blocks) grid (coefficients are zero beyond each frequency's
    own order, so higher frequencies simply stop contributing).

    cap_max=None (default) keeps the natural per-frequency orders — the
    reference's unbounded growth at the lowest Matsubara frequencies
    (KPMPreconditioner.jl:711). An explicit cap bounds sequential work but is
    a correctness risk, not just a quality knob: truncating the Chebyshev fit
    of 1/q too early makes the polynomial non-positive on the spectrum and the
    preconditioner indefinite — measured at the headline config (Ltau = 240),
    cap 64 converges in 46 iterations while cap 32 DIVERGES outright. The
    sufficient order scales ~ a1_eff * Ltau / (2 pi), so a static cap that
    works at one beta silently breaks at a larger one."""
    w = np.arange(Ltau)
    phi = 2.0 * np.pi * (w + 0.5) / Ltau
    phi_eff = np.minimum(phi, 2.0 * np.pi - phi)
    caps = np.maximum(1, np.floor(cap_delta_eps * (a1_eff / phi_eff + a2)).astype(np.int64))
    if cap_max is not None:
        caps = np.minimum(caps, cap_max)
    perm = np.arange(Ltau, dtype=np.int32)
    C = int(max(caps.max(), 1))
    block_size = max(1, int(np.ceil(np.sqrt(C))))
    n_blocks = int(np.ceil(C / block_size))
    C_pad = block_size * n_blocks
    buckets = ((0, Ltau, C_pad),)
    return phi, perm, perm.copy(), caps, buckets, block_size, n_blocks


def _cheb_nodes_and_cosmat(C: int):
    """Chebyshev nodes x_j and the coefficient cosine matrix for a C-term fit."""
    j = np.arange(C)
    theta = np.pi * (j + 0.5) / C
    nodes = np.cos(theta)  # (C,)
    k = np.arange(C)[:, None]
    cosmat = np.cos(k * theta[None, :]) * (2.0 / C)
    cosmat[0, :] *= 0.5
    return nodes, cosmat  # coefs[k] = sum_j cosmat[k, j] f(m_j)


_FIT_GRID = 257  # static evaluation grid for the truncation-positivity guard


def _fit_eval_mat(C: int, G: int = _FIT_GRID) -> np.ndarray:
    """(C, G) matrix evaluating a C-term Chebyshev series on a dense grid of G
    angles: p(cos theta_g) = sum_k c_k cos(k theta_g). The C fit NODES are exact
    interpolation points (p(x_j) = f(x_j) > 0 there by construction), so
    non-positivity of a too-short fit only shows BETWEEN nodes — hence a grid
    finer than any fit order in use."""
    theta = np.pi * (np.arange(G) + 0.5) / G
    return np.cos(np.arange(C)[:, None] * theta[None, :])


# ----------------------------------------------------------------------
# Preconditioner state
# ----------------------------------------------------------------------


@register_pytree_dataclass
class KPMPreconditioner:
    """Runtime state + static plan of the KPM preconditioner.

    Leaves: Bbar, buffered bounds, activation flag, per-bucket coefficient planes
    (tuple of (n_freq_bucket, C_bucket) arrays; an (re, im) pair per bucket for the
    asymmetric propagator, im all-zero for the symmetric one).
    """

    bbar: AveragedPropagator
    lo: jnp.ndarray  # buffered lower bound
    hi: jnp.ndarray  # buffered upper bound
    active: jnp.ndarray  # bool scalar
    coefs_re: Tuple[jnp.ndarray, ...]
    coefs_im: Tuple[jnp.ndarray, ...]
    fft: TauFourier
    BpT: jnp.ndarray  # (N, N) dense transposed scaled propagator Bbar' = (Bbar - c)/h
    TsT: jnp.ndarray  # (N, N) dense transposed stride matrix T_s(Bbar')
    order_clip_count: jnp.ndarray  # i32: frequencies whose live order hit the static cap
    symmetric: bool = static_field()
    Ltau: int = static_field()
    n_sites: int = static_field()
    a1: float = static_field()
    a2: float = static_field()
    rbuf: float = static_field()
    n_lanczos: int = static_field()
    phi: np.ndarray = static_field()  # (Ltau,)
    perm: np.ndarray = static_field()
    inv_perm: np.ndarray = static_field()
    caps: np.ndarray = static_field()
    buckets: Tuple[Tuple[int, int, int], ...] = static_field()
    block_size: int = static_field(default=8)
    n_blocks: int = static_field(default=8)
    dtype: str = static_field(default="float32")
    complex_pair: bool = static_field(default=False)
    # matrix-free apply: the Chebyshev recurrence steps through Bbar via the
    # averaged CHECKERBOARD (O(n_colors N) per order) instead of the dense
    # (N, N) stride matmuls — the large-N scaling mode (the reference's apply
    # is matrix-free throughout, KPMPreconditioner.jl:288-352). Auto-selected
    # by KPMPreconditioner.build above _MATRIX_FREE_MIN_SITES.
    matrix_free: bool = static_field(default=False)

    # ------------------------------------------------------------------
    @staticmethod
    def build(
        fdm: FermionDetMatrix,
        key,
        rbuf: float = 0.10,
        n_lanczos: int = 20,
        a1: float = 1.0,
        a2: float = 1.0,
        cap_delta_eps: float = 1.0,
        cap_max=None,
        dtype: str = "float32",
        matrix_free=None,
    ) -> "KPMPreconditioner":
        """Construct and immediately update (mirrors KPMPreconditioner ctor,
        /root/reference/src/KPMPreconditioner.jl:198-284; a1 doubles for the
        symmetric propagator as in :263).

        matrix_free=None auto-selects: the dense blocked recurrence below
        _MATRIX_FREE_MIN_SITES (shortest sequential depth at small N), the
        O(N)-per-order checkerboard recurrence above it (complex hoppings
        always take the dense doubled-basis path). SMOQY_KPM_MATRIX_FREE=0/1
        force-overrides."""
        import os

        Ltau, N = fdm.Ltau, fdm.n_sites
        Ndim = 2 * N if fdm.complex_hops else N  # doubled basis for complex hops
        if matrix_free is None:
            env = os.environ.get("SMOQY_KPM_MATRIX_FREE")
            if env is not None:
                matrix_free = env == "1"
            else:
                matrix_free = N > _MATRIX_FREE_MIN_SITES
        matrix_free = bool(matrix_free)
        a1_eff = (2.0 * a1) if fdm.symmetric else a1
        phi, perm, inv_perm, caps, buckets, block_size, n_blocks = _static_plan(
            Ltau, a1_eff, a2, cap_delta_eps, cap_max
        )
        dt = jnp.dtype(dtype)
        coefs_re = tuple(jnp.zeros((stop - start, C), dt) for (start, stop, C) in buckets)
        coefs_im = tuple(jnp.zeros((stop - start, C), dt) for (start, stop, C) in buckets)
        # matrix-free mode never touches the dense stride matrices; keep (1, 1)
        # placeholders so the pytree structure (and checkpoints) stay uniform
        dense_dim = 1 if matrix_free else Ndim
        pre = KPMPreconditioner(
            bbar=averaged_propagator(fdm),
            lo=jnp.asarray(0.0),
            hi=jnp.asarray(0.0),
            active=jnp.asarray(False),
            coefs_re=coefs_re,
            coefs_im=coefs_im,
            fft=TauFourier.build(Ltau, dtype=dtype),
            BpT=jnp.zeros((dense_dim, dense_dim), dt),
            TsT=jnp.zeros((dense_dim, dense_dim), dt),
            order_clip_count=jnp.asarray(0, jnp.int32),
            symmetric=fdm.symmetric,
            Ltau=Ltau,
            n_sites=N,
            a1=a1_eff,
            a2=a2,
            rbuf=rbuf,
            n_lanczos=n_lanczos,
            phi=phi,
            perm=perm,
            inv_perm=inv_perm,
            caps=caps,
            buckets=buckets,
            block_size=block_size,
            n_blocks=n_blocks,
            dtype=dtype,
            complex_pair=fdm.complex_hops,
            matrix_free=matrix_free,
        )
        return kpm_update(pre, fdm, key)

    # ------------------------------------------------------------------
    def as_operator(self):
        """Return z = P^{-1} r callable for cg_solve."""
        return lambda r: kpm_apply(self, r)


# ----------------------------------------------------------------------
# Update: refresh Bbar, bounds, activation, coefficients
# ----------------------------------------------------------------------


def kpm_update(pre: KPMPreconditioner, fdm: FermionDetMatrix, key) -> KPMPreconditioner:
    """Pure update of the preconditioner state for the current fermion matrix
    (update_preconditioner!, /root/reference/src/KPMPreconditioner.jl:554-597)."""
    bbar = averaged_propagator(fdm)
    N = pre.n_sites
    BbarT = None
    if pre.matrix_free:
        # O(N) refresh: Lanczos steps apply Bbar through the checkerboard —
        # no densification anywhere (the reference's matrix-free update,
        # KPMPreconditioner.jl:625-658). Complex hoppings run Lanczos on the
        # doubled real embedding (spectrum of E = spectrum of Bbar, doubled):
        # the vector halves are the (re, im) channel pair the checkerboard
        # mixes at axis -3.
        if pre.complex_pair:
            def apply_B(w):
                return bbar.apply(w.reshape(2, 1, N)).reshape(-1)

            def apply_Bt(w):
                return bbar.apply_T(w.reshape(2, 1, N)).reshape(-1)

            dim_l = 2 * N
        else:
            apply_B, apply_Bt = bbar.apply, bbar.apply_T
            dim_l = N
        if pre.symmetric:
            lo_raw, hi_raw = lanczos_bounds(apply_B, dim_l, key, pre.n_lanczos)
        else:
            apply_BtB = lambda v: apply_Bt(apply_B(v))
            lo2, hi2 = lanczos_bounds(apply_BtB, dim_l, key, pre.n_lanczos)
            lo_raw = jnp.sqrt(jnp.maximum(lo2, 0.0))
            hi_raw = jnp.sqrt(jnp.maximum(hi2, 0.0))
    else:
        # densify Bbar^T once per refresh (f64). Row-form convention: row k of
        # the stored matrix is Bbar e_k, so u @ BbarT applies Bbar to
        # row-vectors u. For complex hoppings the doubled real embedding
        # E = [[Br, -Bi], [Bi, Br]] is built from channel-paired basis vectors
        # (cf. ops/spectral_precond.py).
        if pre.complex_pair:
            eyeN = jnp.eye(N)
            zeroN = jnp.zeros_like(eyeN)
            basis = jnp.concatenate(
                [
                    jnp.stack([eyeN, zeroN], axis=1),  # real unit site vectors
                    jnp.stack([zeroN, eyeN], axis=1),  # imaginary unit site vectors
                ]
            )[:, :, None, :]  # (2N, 2, 1, N)
            out = bbar.apply(basis)  # row k = Bbar e_k as a channel pair
            BbarT = jnp.concatenate([out[:, 0, 0, :], out[:, 1, 0, :]], axis=-1)  # (2N, 2N)
        else:
            eyeN = jnp.eye(N)
            BbarT = bbar.apply(eyeN)
        dim = BbarT.shape[0]
        if pre.symmetric:
            # symmetric factorization: Bbar (and its embedding E) is symmetric
            lo_raw, hi_raw = lanczos_bounds(lambda v: v @ BbarT, dim, key, pre.n_lanczos)
        else:
            apply_BtB = lambda v: (v @ BbarT) @ BbarT.T
            lo2, hi2 = lanczos_bounds(apply_BtB, dim, key, pre.n_lanczos)
            lo_raw = jnp.sqrt(jnp.maximum(lo2, 0.0))
            hi_raw = jnp.sqrt(jnp.maximum(hi2, 0.0))
    lo = (1.0 - pre.rbuf) * lo_raw
    hi = (1.0 + pre.rbuf) * hi_raw
    active = (lo > 0.0) & (lo < 1.0) & (hi > 1.0) & (hi < 2.0)
    # safe bounds keep coefficient math finite when inactive
    lo_s = jnp.where(active, lo, 0.5)
    hi_s = jnp.where(active, hi, 1.5)

    # runtime per-frequency orders, clipped to the static caps
    width = hi_s - lo_s
    phi_eff = np.minimum(pre.phi, 2 * np.pi - pre.phi)
    orders_raw = jnp.maximum(
        1,
        jnp.floor(width * (pre.a1 / jnp.asarray(phi_eff) + pre.a2)).astype(jnp.int32),
    )
    caps_arr = jnp.asarray(pre.caps.astype(np.int32))
    orders = jnp.minimum(orders_raw, caps_arr)
    # diagnostic for silent quality loss: how many frequencies wanted a HIGHER
    # order than the build-time static cap allows (live Lanczos bounds wider
    # than the build-time cap_delta_eps estimate, or an explicit cap_max)
    order_clip_count = jnp.sum((orders_raw > caps_arr).astype(jnp.int32))
    orders_sorted = orders[pre.perm]
    phi_sorted = jnp.asarray(pre.phi)[pre.perm]

    center = (hi_s + lo_s) / 2.0
    half = (hi_s - lo_s) / 2.0
    half_safe = jnp.maximum(half, 1e-12)

    coefs_re = []
    coefs_im = []
    for (start, stop, C) in pre.buckets:
        nodes, cosmat = _cheb_nodes_and_cosmat(C)
        m = center + half * jnp.asarray(nodes)  # (C,) sample points in [lo, hi]
        phi_b = phi_sorted[start:stop][:, None]  # (F, 1)
        if pre.symmetric:
            f = 1.0 / (m[None, :] ** 2 - 2.0 * m[None, :] * jnp.cos(phi_b) + 1.0)  # (F, C)
            cre = f @ jnp.asarray(cosmat).T
            cim = jnp.zeros_like(cre)
        else:
            # g = 1 / (1 - e^{-i phi} m) = (1 - m cos phi - i m sin phi)^{-1}... compute via
            # real/imag parts: denom = (1 - m cos)^2 + (m sin)^2
            mc = m[None, :] * jnp.cos(phi_b)
            ms = m[None, :] * jnp.sin(phi_b)
            denom = (1.0 - mc) ** 2 + ms**2
            f_re = (1.0 - mc) / denom
            f_im = -ms / denom
            cre = f_re @ jnp.asarray(cosmat).T
            cim = f_im @ jnp.asarray(cosmat).T
        # zero out terms beyond the runtime order
        kidx = jnp.arange(C)[None, :]
        mask = kidx < orders_sorted[start:stop][:, None]
        dt = jnp.dtype(pre.dtype)
        coefs_re.append(jnp.where(mask, cre, 0.0).astype(dt))
        coefs_im.append(jnp.where(mask, cim, 0.0).astype(dt))

    # Truncation-positivity guard (the missing half of the reference's
    # self-deactivation, KPMPreconditioner.jl:573-594): for the SYMMETRIC
    # factorization the applied polynomial must be positive on the whole
    # spectrum interval or P^-1 is indefinite and CG diverges (measured:
    # cap_max=32 at Ltau=240 diverges outright, _static_plan docstring).
    # Evaluate every frequency's MASKED fit on a dense static grid and
    # deactivate on any non-positive value. The asymmetric factorization is
    # exempt: its two conjugate passes multiply each eigencomponent by
    # |p(lambda)|^2 >= 0, so truncation can degrade but never flip the sign.
    if pre.symmetric:
        fit_min = jnp.inf
        for (start, stop, C), cre_m in zip(pre.buckets, coefs_re):
            eval_mat = jnp.asarray(_fit_eval_mat(C), dtype=cre_m.dtype)
            fit_min = jnp.minimum(fit_min, jnp.min(cre_m @ eval_mat))
        active = active & (fit_min > 0.0)

    if pre.matrix_free:
        BpT_out, TsT_out = pre.BpT, pre.TsT  # (1, 1) placeholders, never read
    else:
        # scaled propagator + stride matrix for the blocked recurrence (dense
        # BbarT computed above)
        dt = jnp.dtype(pre.dtype)
        BpT = ((BbarT - center * jnp.eye(dim)) / half_safe).astype(dt)
        s = pre.block_size
        # TsT = T_s(Bbar')^T by the dense Chebyshev matrix recurrence (s-1
        # matmuls, once per refresh)
        if s == 1:
            TsT = BpT
        else:
            m_prev, m_cur = jnp.eye(dim, dtype=dt), BpT
            for _ in range(s - 1):
                m_prev, m_cur = m_cur, 2.0 * (BpT @ m_cur) - m_prev
            TsT = m_cur
        BpT_out, TsT_out = BpT, TsT

    return pre.replace(
        bbar=bbar,
        lo=lo_s,
        hi=hi_s,
        active=active,
        coefs_re=tuple(coefs_re),
        coefs_im=tuple(coefs_im),
        BpT=BpT_out,
        TsT=TsT_out,
        order_clip_count=order_clip_count,
    )


# ----------------------------------------------------------------------
# Apply: z = P^{-1} r
# ----------------------------------------------------------------------


def _block_cheb(pre: "KPMPreconditioner", u_re, u_im, cre, cim):
    """y = sum_k c_k T_k(B') u for complex coefficient planes c (F, C_pad) and a
    complex frequency-space pair u (..., F, N), via the blocked recurrence

        Block_b = [T_{bs+j} u]_{j<s},   Block_{b+1} = 2 Block_b @ TsT - Block_{b-1}

    (T_{m+s} = 2 T_s T_m - T_{m-s}). B' is real, so the re/im channels share the
    recurrence; every step is one dense matmul instead of a checkerboard sweep.
    The matmuls run at the backend's default precision on purpose: the
    preconditioner shapes only the CG iteration count, never the solution."""
    s, nb = pre.block_size, pre.n_blocks
    BpT, TsT = pre.BpT, pre.TsT
    F = cre.shape[0]

    # coefficient planes regrouped per block: (nb, s, F)
    cre_b = cre.T.reshape(nb, s, F)
    cim_b = cim.T.reshape(nb, s, F)

    def acc(y_re, y_im, B_re, B_im, cb_re, cb_im):
        # y += sum_j c[j, f] * Block[j, ..., f, :]  (complex)
        y_re = y_re + jnp.einsum("jf,j...fn->...fn", cb_re, B_re) - jnp.einsum(
            "jf,j...fn->...fn", cb_im, B_im
        )
        y_im = y_im + jnp.einsum("jf,j...fn->...fn", cb_re, B_im) + jnp.einsum(
            "jf,j...fn->...fn", cb_im, B_re
        )
        return y_re, y_im

    # block 0: T_0 u .. T_{s-1} u (s-1 sequential matmuls)
    ts_re, ts_im = [u_re], [u_im]
    if s > 1:
        ts_re.append(u_re @ BpT)
        ts_im.append(u_im @ BpT)
        for _ in range(s - 2):
            ts_re.append(2.0 * (ts_re[-1] @ BpT) - ts_re[-2])
            ts_im.append(2.0 * (ts_im[-1] @ BpT) - ts_im[-2])
    B0_re = jnp.stack(ts_re)
    B0_im = jnp.stack(ts_im)
    y_re = jnp.zeros_like(u_re)
    y_im = jnp.zeros_like(u_im)
    y_re, y_im = acc(y_re, y_im, B0_re, B0_im, cre_b[0], cim_b[0])
    if nb == 1:
        return y_re, y_im

    # block -1 is [T_{s-j} u]_{j<s} = (T_s u, then block 0 reversed from index s-1..1)
    Bm1_re = jnp.concatenate([(u_re @ TsT)[None], B0_re[1:][::-1]], axis=0)
    Bm1_im = jnp.concatenate([(u_im @ TsT)[None], B0_im[1:][::-1]], axis=0)

    def body(b, carry):
        Bp_re, Bp_im, Bc_re, Bc_im, y_re, y_im = carry
        Bn_re = 2.0 * (Bc_re @ TsT) - Bp_re
        Bn_im = 2.0 * (Bc_im @ TsT) - Bp_im
        cb_re = lax.dynamic_slice_in_dim(cre_b, b, 1, axis=0)[0]
        cb_im = lax.dynamic_slice_in_dim(cim_b, b, 1, axis=0)[0]
        y_re, y_im = acc(y_re, y_im, Bn_re, Bn_im, cb_re, cb_im)
        return (Bc_re, Bc_im, Bn_re, Bn_im, y_re, y_im)

    carry = (Bm1_re, Bm1_im, B0_re, B0_im, y_re, y_im)
    carry = lax.fori_loop(1, nb, body, carry)
    return carry[4], carry[5]


def _rot_i(pre: "KPMPreconditioner", w: jnp.ndarray) -> jnp.ndarray:
    """Multiply by i in the doubled (re, im)-site basis: [a, b] -> [-b, a]."""
    N = pre.n_sites
    return jnp.concatenate([-w[..., N:], w[..., :N]], axis=-1)


def _block_cheb_pair(pre: "KPMPreconditioner", w, cre, cim):
    """y = sum_k c_k T_k(E') w in the doubled real site basis (complex
    hoppings): w is (..., F, 2N) holding the (re, im) halves of the complex
    frequency-space vector, E' the scaled 2N x 2N embedding, and the complex
    frequency coefficient c_k acts as cre + cim * rot_i. One recurrence over
    the single doubled channel — same matmul volume as the real case's two
    N-channels."""
    s, nb = pre.block_size, pre.n_blocks
    BpT, TsT = pre.BpT, pre.TsT
    F = cre.shape[0]

    cre_b = cre.T.reshape(nb, s, F)
    cim_b = cim.T.reshape(nb, s, F)
    use_im = not pre.symmetric  # symmetric coefficients are real

    def acc(y, B, cb_re, cb_im):
        y = y + jnp.einsum("jf,j...fn->...fn", cb_re, B)
        if use_im:
            y = y + _rot_i(pre, jnp.einsum("jf,j...fn->...fn", cb_im, B))
        return y

    ts = [w]
    if s > 1:
        ts.append(w @ BpT)
        for _ in range(s - 2):
            ts.append(2.0 * (ts[-1] @ BpT) - ts[-2])
    B0 = jnp.stack(ts)
    y = jnp.zeros_like(w)
    y = acc(y, B0, cre_b[0], cim_b[0])
    if nb == 1:
        return y

    Bm1 = jnp.concatenate([(w @ TsT)[None], B0[1:][::-1]], axis=0)

    def body(b, carry):
        Bp, Bc, y = carry
        Bn = 2.0 * (Bc @ TsT) - Bp
        cb_re = lax.dynamic_slice_in_dim(cre_b, b, 1, axis=0)[0]
        cb_im = lax.dynamic_slice_in_dim(cim_b, b, 1, axis=0)[0]
        y = acc(y, Bn, cb_re, cb_im)
        return (Bc, Bn, y)

    _, _, y = lax.fori_loop(1, nb, body, (Bm1, B0, y))
    return y


def _mf_cheb(pre: "KPMPreconditioner", u_re, u_im, cre, cim, bbar32=None):
    """Matrix-free y = sum_k c_k T_k(Bbar') u: the plain three-term recurrence
    T_{k+1} = 2 Bbar' T_k - T_{k-1} with Bbar applied through the tau-averaged
    CHECKERBOARD — O(n_colors N) per order per frequency plane, no dense
    matrices anywhere (the reference's apply structure,
    KPMPreconditioner.jl:288-352). Sequential depth is the full static order
    cap C (coefficients are zero beyond each frequency's live order, so higher
    frequencies simply stop contributing); the per-step work is a handful of
    gather+elementwise ops over the whole (2, ..., F, N) block."""
    dt = u_re.dtype
    bbar = bbar32 if bbar32 is not None else pre.bbar
    center = ((pre.hi + pre.lo) * 0.5).astype(dt)
    inv_half = (1.0 / jnp.maximum((pre.hi - pre.lo) * 0.5, 1e-12)).astype(dt)

    def applyBp(t):
        return (bbar.apply(t) - center * t) * inv_half

    C = cre.shape[1]
    t0 = jnp.stack([u_re, u_im])  # channel-stacked recurrence state
    c0 = cre[:, 0][:, None]
    y = c0 * t0
    if cim is not None:
        ci0 = cim[:, 0][:, None]
        y = y + ci0 * jnp.stack([-t0[1], t0[0]])  # + i c_im * t
    if C == 1:
        return y[0], y[1]
    t1 = applyBp(t0)
    # scanned coefficient columns k = 1 .. C-1 (im plane only when it exists:
    # symmetric coefficients are real and skip the i-rotation entirely)
    if cim is None:
        cs = cre.T[1:, None]  # (C-1, 1, F)
    else:
        cs = jnp.stack([cre.T, cim.T], axis=1)[1:]  # (C-1, 2, F)

    def step(carry, ck):
        t_prev, t_cur, y = carry
        y = y + ck[0][:, None] * t_cur
        if cim is not None:
            y = y + ck[1][:, None] * jnp.stack([-t_cur[1], t_cur[0]])
        t_next = 2.0 * applyBp(t_cur) - t_prev
        return (t_cur, t_next, y), None

    (_, _, y), _ = lax.scan(step, (t0, t1, y), cs)
    return y[0], y[1]


def _mf_cheb_pair(pre: "KPMPreconditioner", w, cre, cim, bbar32=None):
    """Matrix-free y = sum_k c_k T_k(Bbar') w for COMPLEX hoppings: w is
    (..., 2, F, N) carrying the (re, im) channel pair the checkerboard mixes
    at axis -3 (ops/checkerboard.py complex branch), and the complex frequency
    coefficient acts through the i-rotation of the SAME pair — with complex
    hoppings the field's complex structure and the operator's coincide, so one
    rotation serves both (dense analogue: _block_cheb_pair). Same O(n_colors N)
    per order recurrence as _mf_cheb."""
    dt = w.dtype
    bbar = bbar32 if bbar32 is not None else pre.bbar
    center = ((pre.hi + pre.lo) * 0.5).astype(dt)
    inv_half = (1.0 / jnp.maximum((pre.hi - pre.lo) * 0.5, 1e-12)).astype(dt)

    def applyBp(t):
        return (bbar.apply(t) - center * t) * inv_half

    def rot_i(t):
        return jnp.stack([-t[..., 1, :, :], t[..., 0, :, :]], axis=-3)

    use_im = not pre.symmetric  # symmetric coefficients are real
    C = cre.shape[1]
    y = cre[:, 0][:, None] * w
    if use_im:
        y = y + cim[:, 0][:, None] * rot_i(w)
    if C == 1:
        return y
    t1 = applyBp(w)
    if use_im:
        cs = jnp.stack([cre.T, cim.T], axis=1)[1:]  # (C-1, 2, F)
    else:
        cs = cre.T[1:, None]  # (C-1, 1, F)

    def step(carry, ck):
        t_prev, t_cur, y = carry
        y = y + ck[0][:, None] * t_cur
        if use_im:
            y = y + ck[1][:, None] * rot_i(t_cur)
        t_next = 2.0 * applyBp(t_cur) - t_prev
        return (t_cur, t_next, y), None

    (_, _, y), _ = lax.scan(step, (w, t1, y), cs)
    return y


def kpm_apply(pre: KPMPreconditioner, r: jnp.ndarray) -> jnp.ndarray:
    """z = P^{-1} r for real r (..., Ltau, N); channels/batches broadcast.

    Pipeline: tau-FFT -> blocked Chebyshev in dense Bbar' -> inverse FFT -> real
    part (ldiv!, /root/reference/src/KPMPreconditioner.jl:288-352). Runs in
    pre.dtype (f32 default); the caller's dtype is restored on return.
    """
    in_dtype = r.dtype
    dt = jnp.dtype(pre.dtype)
    r = r.astype(dt)

    if pre.matrix_free:
        # cast the checkerboard/diagonal factors once per call (jit dedups);
        # the whole recurrence then runs in pre.dtype like the dense path
        bbar32 = jax.tree_util.tree_map(lambda a: a.astype(dt), pre.bbar)

        def transform(r):
            cre, cim = pre.coefs_re[0], pre.coefs_im[0]
            if pre.complex_pair:
                # channel pair (..., 2, Ltau, N): complex tau-FFT of the
                # complex field, then the channel-mixing checkerboard
                # recurrence on (..., 2, F, N) pairs
                ure, uim = pre.fft.forward(r[..., 0, :, :], r[..., 1, :, :])
                w = jnp.stack([ure, uim], axis=-3)
                if pre.symmetric:
                    w = _mf_cheb_pair(pre, w, cre, cim, bbar32)
                else:
                    w = _mf_cheb_pair(pre, w, cre, -cim, bbar32)
                    w = _mf_cheb_pair(pre, w, cre, cim, bbar32)
                zre, zim = pre.fft.inverse(w[..., 0, :, :], w[..., 1, :, :])
                return jnp.stack([zre, zim], axis=-3)
            ure, uim = pre.fft.forward(r)
            if pre.symmetric:
                yre, yim = _mf_cheb(pre, ure, uim, cre, None, bbar32)
            else:
                # two passes: conj(coefs) then coefs (KPMPreconditioner.jl:455-459)
                yre, yim = _mf_cheb(pre, ure, uim, cre, -cim, bbar32)
                yre, yim = _mf_cheb(pre, yre, yim, cre, cim, bbar32)
            zre, _ = pre.fft.inverse(yre, yim)
            return zre

        return lax.cond(pre.active, transform, lambda r: r, r).astype(in_dtype)

    def transform(r):
        cre, cim = pre.coefs_re[0], pre.coefs_im[0]
        if pre.complex_pair:
            # channel pair (..., 2, Ltau, N): complex tau-FFT of the complex
            # field, then the doubled-basis recurrence on (..., F, 2N)
            N = pre.n_sites
            ure, uim = pre.fft.forward(r[..., 0, :, :], r[..., 1, :, :])
            w = jnp.concatenate([ure, uim], axis=-1)
            if pre.symmetric:
                w = _block_cheb_pair(pre, w, cre, cim)
            else:
                w = _block_cheb_pair(pre, w, cre, -cim)
                w = _block_cheb_pair(pre, w, cre, cim)
            zre, zim = pre.fft.inverse(w[..., :N], w[..., N:])
            return jnp.stack([zre, zim], axis=-3)
        ure, uim = pre.fft.forward(r)
        if pre.symmetric:
            yre, yim = _block_cheb(pre, ure, uim, cre, cim)
        else:
            # two passes: conj(coefs) then coefs (KPMPreconditioner.jl:455-459)
            yre, yim = _block_cheb(pre, ure, uim, cre, -cim)
            yre, yim = _block_cheb(pre, yre, yim, cre, cim)
        zre, _ = pre.fft.inverse(yre, yim)
        return zre

    return lax.cond(pre.active, transform, lambda r: r, r).astype(in_dtype)


def dense_preconditioner(pre: KPMPreconditioner) -> np.ndarray:
    """Dense (Ltau N, Ltau N) matrix of P^{-1} (testing oracle; real hoppings —
    complex-hopping quality is asserted through CG iteration counts instead)."""
    if pre.complex_pair:
        raise NotImplementedError("dense oracle only provided for real hoppings")
    dim = pre.Ltau * pre.n_sites
    eye = np.eye(dim).reshape(dim, pre.Ltau, pre.n_sites)
    cols = jax.vmap(lambda e: kpm_apply(pre, e))(jnp.asarray(eye))
    return np.asarray(cols).reshape(dim, dim).T
