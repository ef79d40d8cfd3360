"""Imaginary-time (antiperiodic) Fourier transform as dense matmuls.

Re-design of /root/reference/src/FourierTransformer.jl: the unitary change of basis
tau -> omega_n for antiperiodic fermionic boundary conditions,

    u[w] = (1/sqrt(Ltau)) sum_l exp(-i (2 pi w + pi) l / Ltau) v[l],

which maps the antiperiodic one-slice shift operator to diag(exp(-i phi_w)) with
phi_w = 2 pi (w + 1/2) / Ltau. The transform is applied as dense DFT *matmuls*
with precomputed real and imaginary matrices — (Ltau, Ltau) @ (Ltau, N)
contractions that batch over leading axes, with no complex dtype and no FFT
call. Complex fields are (re, im) array pairs.

Every matmul here asks for Precision.HIGHEST: the transforms feed forces and
observables, and at the backend's default an f32 matmul may run in TF32 on a
GPU, which keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.pytree import register_pytree_dataclass, static_field

_einsum = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)
_matmul = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)


def dft_matrices(n: int, sign: float = -1.0, phase_shift: float = 0.0, norm: float = 1.0):
    """Real/imag parts of W[k, l] = norm * exp(sign * i * (2 pi k + phase_shift) l / n)."""
    k = np.arange(n)[:, None]
    l = np.arange(n)[None, :]
    ang = sign * (2.0 * np.pi * k + phase_shift) * l / n
    return norm * np.cos(ang), norm * np.sin(ang)


@register_pytree_dataclass
class TauFourier:
    """Unitary antiperiodic tau -> omega transform (and inverse), Cooley-Tukey
    factored: u[w] = (1/sqrt(L)) sum_l e^{-i(2 pi w + pi) l / L} v[l]. The inverse
    is a factored inverse DFT followed by the output phase e^{+i pi l / L}."""

    fwd: "FactoredDFT"
    inv: "FactoredDFT"
    phase_re: jnp.ndarray  # (Ltau, 1) e^{+i pi l / Ltau}
    phase_im: jnp.ndarray
    Ltau: int = static_field()

    @staticmethod
    def build(Ltau: int, dtype: str = "float64") -> "TauFourier":
        dt = jnp.dtype(dtype)
        l = np.arange(Ltau)
        ph = np.pi * l / Ltau
        return TauFourier(
            fwd=FactoredDFT.build(
                Ltau, inverse=False, phase_shift=np.pi, norm=1.0 / np.sqrt(Ltau), dtype=dtype
            ),
            inv=FactoredDFT.build(Ltau, inverse=True, norm=1.0 / np.sqrt(Ltau), dtype=dtype),
            phase_re=jnp.asarray(np.cos(ph)[:, None], dtype=dt),
            phase_im=jnp.asarray(np.sin(ph)[:, None], dtype=dt),
            Ltau=Ltau,
        )

    def forward(
        self, vre: jnp.ndarray, vim: Optional[jnp.ndarray] = None
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(..., Ltau, N) pair -> frequency-space pair along axis -2."""
        return self.fwd.apply(vre, vim, axis=-2)

    def inverse(self, ure: jnp.ndarray, uim: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Frequency-space pair -> (..., Ltau, N) pair (unitary inverse)."""
        wre, wim = self.inv.apply(ure, uim, axis=-2)
        vre = wre * self.phase_re - wim * self.phase_im
        vim = wre * self.phase_im + wim * self.phase_re
        return vre, vim


def _best_split(n: int) -> Tuple[int, int]:
    """Factor n = n1 * n2 with n1, n2 as balanced as possible (n1 <= n2)."""
    best = (1, n)
    for n1 in range(2, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


@register_pytree_dataclass
class FactoredDFT:
    """Cooley-Tukey two-stage DFT along one axis as matmul pairs.

    For n = n1 * n2 the length-n DFT becomes a (n1 x n1) matmul over the
    decimated axis, a twiddle multiply, and a (n2 x n2) matmul — n (n1 + n2)
    MACs instead of n^2, while every stage stays a dense matmul. Falls back to the
    dense matrix when n is prime (n1 == 1).

    X[k1 + n1 k2] = sum_b W2[k2, b] T[k1, b] sum_a W1[k1, a] x[a n2 + b],
    W1 = exp(s 2 pi i k1 a / n1), T = exp(s 2 pi i k1 b / n),
    W2 = exp(s 2 pi i k2 b / n2); an extra per-l input phase exp(s phi l / n)
    (the antiperiodic tau phase) folds into W1 (a-part) and T (b-part)."""

    W1re: jnp.ndarray  # (n1, n1)
    W1im: jnp.ndarray
    Tre: jnp.ndarray  # (n1, n2) twiddles
    Tim: jnp.ndarray
    W2re: jnp.ndarray  # (n2, n2)
    W2im: jnp.ndarray
    n: int = static_field()
    n1: int = static_field()
    n2: int = static_field()

    @staticmethod
    def build(
        n: int,
        inverse: bool = False,
        phase_shift: float = 0.0,
        norm: float = 1.0,
        dtype: str = "float64",
    ) -> "FactoredDFT":
        n1, n2 = _best_split(n)
        s = 1.0 if inverse else -1.0
        a = np.arange(n1)
        b = np.arange(n2)
        k1 = a[:, None]
        k2 = b[:, None]
        # stage 1 over a (l = a n2 + b): includes the extra phase on the a part
        ang1 = s * (2.0 * np.pi * k1 * a[None, :] / n1 + phase_shift * (a[None, :] * n2) / n)
        # twiddle: k1 x b, includes the extra phase on the b part
        angT = s * (2.0 * np.pi * a[:, None] * b[None, :] / n + phase_shift * b[None, :] / n)
        ang2 = s * 2.0 * np.pi * k2 * b[None, :] / n2
        dt = jnp.dtype(dtype)
        return FactoredDFT(
            W1re=jnp.asarray(norm * np.cos(ang1), dtype=dt),
            W1im=jnp.asarray(norm * np.sin(ang1), dtype=dt),
            Tre=jnp.asarray(np.cos(angT), dtype=dt),
            Tim=jnp.asarray(np.sin(angT), dtype=dt),
            W2re=jnp.asarray(np.cos(ang2), dtype=dt),
            W2im=jnp.asarray(np.sin(ang2), dtype=dt),
            n=n,
            n1=n1,
            n2=n2,
        )

    def apply(
        self, vre: jnp.ndarray, vim: Optional[jnp.ndarray], axis: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        n1, n2 = self.n1, self.n2
        vre = jnp.moveaxis(vre, axis, -1)
        vim_m = None if vim is None else jnp.moveaxis(vim, axis, -1)
        lead = vre.shape[:-1]
        vre = vre.reshape(lead + (n1, n2))
        vim_m = None if vim_m is None else vim_m.reshape(lead + (n1, n2))
        # stage 1: contract the a axis (-2)
        yre = _einsum("ka,...ab->...kb", self.W1re, vre)
        yim = _einsum("ka,...ab->...kb", self.W1im, vre)
        if vim_m is not None:
            yre = yre - _einsum("ka,...ab->...kb", self.W1im, vim_m)
            yim = yim + _einsum("ka,...ab->...kb", self.W1re, vim_m)
        # twiddle (elementwise complex over (k1, b))
        zre = yre * self.Tre - yim * self.Tim
        zim = yre * self.Tim + yim * self.Tre
        # stage 2: contract the b axis (-1); output index k2
        xre = _einsum("cb,...kb->...kc", self.W2re, zre) - _einsum(
            "cb,...kb->...kc", self.W2im, zim
        )
        xim = _einsum("cb,...kb->...kc", self.W2re, zim) + _einsum(
            "cb,...kb->...kc", self.W2im, zre
        )
        # X[k1 + n1 k2]: order axes (k2, k1) then flatten
        xre = jnp.swapaxes(xre, -1, -2).reshape(lead + (self.n,))
        xim = jnp.swapaxes(xim, -1, -2).reshape(lead + (self.n,))
        return jnp.moveaxis(xre, -1, axis), jnp.moveaxis(xim, -1, axis)


@register_pytree_dataclass
class PackedDFT:
    """Complex DFT along one axis as ONE real matmul in the packed [re | im]
    basis — the formulation of the contraction-engine transforms.

    A complex matvec y = W v splits into 4 real matmuls when (re, im) are
    separate planes; packing the planes along the contracted axis turns it into
    a single real matmul with the (2n, 2n) block matrix

        [yr | yi] = [vr | vi] @ [[Wre^T, Wim^T], [-Wim^T, Wre^T]]

    with IDENTICAL FLOPs but a contraction dimension of 2n instead of n1/n2-
    sized factored stages (2n = 480 for the tau axis, 2*Ncells = 288 for the
    joint space transform at the measurement engine's sizes), so the DFTs run
    as a few large matmuls instead of many 12-16-wide contractions.
    Real input (vim is None) uses only the top half of the packed matrix.

    `matrices` lets the caller supply an arbitrary complex kernel (e.g. the
    Kronecker product of the per-axis space DFTs — see build_joint)."""

    Wp: jnp.ndarray  # (2n, 2n) packed matrix (transposed layout, right-multiply)
    n: int = static_field()

    @staticmethod
    def build(
        n: int,
        inverse: bool = False,
        norm: float = 1.0,
        dtype: str = "float64",
        matrices: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> "PackedDFT":
        if matrices is None:
            sign = 1.0 if inverse else -1.0
            wre, wim = dft_matrices(n, sign=sign, norm=norm)
        else:
            wre, wim = matrices
            n = wre.shape[0]
        top = np.concatenate([wre.T, wim.T], axis=1)  # (n, 2n)
        bot = np.concatenate([-wim.T, wre.T], axis=1)
        dt = jnp.dtype(dtype)
        return PackedDFT(Wp=jnp.asarray(np.concatenate([top, bot], axis=0), dtype=dt), n=n)

    @staticmethod
    def build_joint(
        Ls: Tuple[int, ...], inverse: bool = False, dtype: str = "float64"
    ) -> "PackedDFT":
        """Kronecker product of per-axis DFTs: one packed matmul transforming
        all D flattened cell axes at once (contraction dim 2*prod(Ls))."""
        sign = 1.0 if inverse else -1.0
        W = np.ones((1, 1), dtype=complex)
        for l in Ls:
            wre, wim = dft_matrices(l, sign=sign, norm=(1.0 / l if inverse else 1.0))
            W = np.kron(W, wre + 1j * wim)
        return PackedDFT.build(W.shape[0], dtype=dtype, matrices=(W.real, W.imag))

    def apply(
        self, vre: jnp.ndarray, vim: Optional[jnp.ndarray], axis: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        n = self.n
        vre_m = jnp.moveaxis(vre, axis, -1)
        if vim is None:
            out = _matmul(vre_m, self.Wp[:n])
        else:
            vim_m = jnp.moveaxis(vim, axis, -1)
            out = _matmul(jnp.concatenate([vre_m, vim_m], axis=-1), self.Wp)
        ure, uim = out[..., :n], out[..., n:]
        return jnp.moveaxis(ure, -1, axis), jnp.moveaxis(uim, -1, axis)


@register_pytree_dataclass
class AxisDFT:
    """Plain (periodic) DFT along one axis as a matmul pair — building block for
    space-time correlation FFTs and structure factors (no complex dtype needed)."""

    Wre: jnp.ndarray  # (n, n)
    Wim: jnp.ndarray
    n: int = static_field()
    inverse_norm: bool = static_field()

    @staticmethod
    def build(n: int, inverse: bool = False, dtype: str = "float64") -> "AxisDFT":
        sign = 1.0 if inverse else -1.0
        norm = 1.0 / n if inverse else 1.0
        wre, wim = dft_matrices(n, sign=sign, norm=norm)
        dt = jnp.dtype(dtype)
        return AxisDFT(
            Wre=jnp.asarray(wre, dtype=dt), Wim=jnp.asarray(wim, dtype=dt), n=n, inverse_norm=inverse
        )

    def apply(
        self, vre: jnp.ndarray, vim: Optional[jnp.ndarray], axis: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        vre_m = jnp.moveaxis(vre, axis, -1)
        ure = _matmul(vre_m, self.Wre.T)
        uim = _matmul(vre_m, self.Wim.T)
        if vim is not None:
            vim_m = jnp.moveaxis(vim, axis, -1)
            ure = ure - _matmul(vim_m, self.Wim.T)
            uim = uim + _matmul(vim_m, self.Wre.T)
        return jnp.moveaxis(ure, -1, axis), jnp.moveaxis(uim, -1, axis)
