"""Exact Fourier accelerator: analytic harmonic evolution of the phonon field.

Re-design of SmoQyDQMC's ExactFourierAccelerator as consumed by the reference HMC
updater (SURVEY.md section 2b; /root/reference/src/EFAPFFHMCUpdater.jl:61,142,150,244).

In the (periodic, bosonic) tau-Fourier basis the harmonic part of the bosonic
action is diagonal, S_harm = (1/2) sum_k Q_k |x_k|^2 (ops/bosonic.py). HMC momenta
are given per-mode fictitious masses

    m_k = M ( (4/dtau) sin^2(pi k/Ltau) + dtau (Omega^2 + eta^2) ),

so that for eta = 0 every mode oscillates at unit frequency omega_k =
sqrt(Q_k/m_k) = 1 — the "normalize all bare phonon frequencies to unity" property
the reference tutorials rely on when choosing the trajectory length pi/2. The
drift step rotates (x_k, p_k) analytically by omega_k * t, conserving the
harmonic energy exactly; the fermionic/anharmonic/dispersive forces are kicked
explicitly by the updater.

No complex dtypes: the tau-axis DFT is a matmul pair (ops/fourier.py), masses are
symmetric under k -> Ltau - k so reality is preserved. Frozen modes (infinite
mass) have 1/m = 0: zero momentum, zero motion, zero kinetic energy."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.electron_phonon import ElectronPhononParameters
from ..utils.pytree import register_pytree_dataclass, static_field
from .bosonic import harmonic_curvature
from .fourier import AxisDFT


@register_pytree_dataclass
class FourierAccelerator:
    """Per-(mode, frequency) fictitious masses + curvatures and the tau DFT pair."""

    Q: jnp.ndarray  # (n_phonon, Ltau) harmonic curvature (0 for frozen modes)
    m: jnp.ndarray  # (n_phonon, Ltau) fictitious mass (0 for frozen modes)
    fwd: AxisDFT
    inv: AxisDFT
    # f32 copies of the DFT pair for the per-leapfrog-step force path: the
    # force is only tol~1e-5 accurate anyway — the exact f64 (x, p)
    # omega-space carry and the endpoint actions are untouched (updates/hmc.py)
    fwd32: AxisDFT
    inv32: AxisDFT
    Ltau: int = static_field()

    @staticmethod
    def build(elph: ElectronPhononParameters, eta: float = 0.0) -> "FourierAccelerator":
        Ltau = elph.Ltau
        Q = harmonic_curvature(elph)
        k = np.arange(Ltau)
        sin2 = jnp.asarray(np.sin(np.pi * k / Ltau) ** 2)
        live = jnp.asarray(~elph.frozen_mask)
        mass = jnp.where(live, elph.mass, 0.0)
        m = mass[:, None] * (
            4.0 / elph.dtau * sin2[None, :] + elph.dtau * (elph.Omega[:, None] ** 2 + eta**2)
        )
        return FourierAccelerator(
            Q=Q, m=m, fwd=AxisDFT.build(Ltau), inv=AxisDFT.build(Ltau, inverse=True),
            fwd32=AxisDFT.build(Ltau, dtype="float32"),
            inv32=AxisDFT.build(Ltau, inverse=True, dtype="float32"),
            Ltau=Ltau,
        )

    # ------------------------------------------------------------------
    def initialize_momentum(self, key) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Sample p with density prop exp(-(1/2) sum_k |p_k|^2 / m_k); returns
        (p, kinetic_energy). Implemented as p = F^{-1} sqrt(m) F xi with real
        white noise xi, which preserves reality because m is k-symmetric."""
        n_ph = self.m.shape[0]
        xi = jax.random.normal(key, (n_ph, self.Ltau))
        # unitary-normalized transform: use fwd then scale by 1/sqrt(L) etc.; the
        # normalization cancels in F^{-1} diag F, so use plain fft/ifft pair.
        xr, xi_im = self.fwd.apply(xi, None, axis=1)
        s = jnp.sqrt(self.m)
        pr, pi = self.inv.apply(s * xr, s * xi_im, axis=1)
        p = pr  # imaginary part is zero by symmetry
        return p, self.kinetic_energy(p)

    def kinetic_energy(self, p: jnp.ndarray) -> jnp.ndarray:
        """K = (1/2) sum_k |p_k|^2 / m_k with the unitary-FFT convention."""
        pr, pi = self.fwd.apply(p, None, axis=1)
        inv_m = jnp.where(self.m > 0, 1.0 / jnp.where(self.m > 0, self.m, 1.0), 0.0)
        return 0.5 * jnp.sum((pr**2 + pi**2) * inv_m) / self.Ltau

    # ------------------------------------------------------------------
    # omega-space representation: the HMC trajectory carries (x, p) as DFT
    # pairs in the (unnormalized) fwd convention, so the exact drift is a pure
    # elementwise rotation and each leapfrog step costs only ONE inverse DFT
    # (x to tau-space for the force) plus ONE forward DFT (the force kick)
    # instead of round-tripping both x and p every drift.
    # ------------------------------------------------------------------
    def to_omega(self, v: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """tau -> omega (fwd-DFT convention): (re, im) pair."""
        return self.fwd.apply(v, None, axis=1)

    def to_tau(self, vr: jnp.ndarray, vi: jnp.ndarray) -> jnp.ndarray:
        """omega -> tau; the imaginary part vanishes by the k -> Ltau-k symmetry
        of every operation performed in omega space."""
        return self.inv.apply(vr, vi, axis=1)[0]

    def to_tau_f32(self, vr: jnp.ndarray, vi: jnp.ndarray) -> jnp.ndarray:
        """omega -> tau through the f32 DFT pair — for the per-step force path
        only (the force solve runs at tol ~1e-5 in f32; a ~1e-7 relative error
        in its input field is invisible there)."""
        return self.inv32.apply(
            vr.astype(jnp.float32), vi.astype(jnp.float32), axis=1
        )[0]

    def rotate_omega(self, xw, pw, t):
        """Exact harmonic rotation of omega-space (x, p) by time t — elementwise."""
        xr, xi = xw
        pr, pi = pw
        m = self.m
        Q = self.Q
        live = m > 0
        inv_m = jnp.where(live, 1.0 / jnp.where(live, m, 1.0), 0.0)
        omega = jnp.sqrt(jnp.where(live, Q * inv_m, 0.0))
        osc = omega > 0
        c = jnp.cos(omega * t)
        s = jnp.sin(omega * t)
        # oscillator: x' = x c + p s/(m w); p' = p c - x m w s
        inv_mw = jnp.where(osc, 1.0 / jnp.where(osc, m * omega, 1.0), 0.0)
        xr_new = jnp.where(osc, xr * c + pr * s * inv_mw, xr + t * pr * inv_m)
        xi_new = jnp.where(osc, xi * c + pi * s * inv_mw, xi + t * pi * inv_m)
        pr_new = jnp.where(osc, pr * c - xr * m * omega * s, pr)
        pi_new = jnp.where(osc, pi * c - xi * m * omega * s, pi)
        return (xr_new, xi_new), (pr_new, pi_new)

    def kick_omega(self, pw, force: jnp.ndarray, dt):
        """p <- p - dt * force, applied in omega space (the DFT is linear, so
        this is exactly the tau-space kick transformed)."""
        fr, fi = self.fwd.apply(force, None, axis=1)
        return (pw[0] - dt * fr, pw[1] - dt * fi)

    def kick_omega_f32(self, pw, force: jnp.ndarray, dt):
        """kick_omega with the force DFT in f32 (force-path companion of
        to_tau_f32): the force itself carries a ~tol=1e-5 solve error, so the
        f32 transform adds nothing measurable, while the f64 momentum carry
        stays exact (the kick accumulates into f64 pw)."""
        fr, fi = self.fwd32.apply(force.astype(jnp.float32), None, axis=1)
        return (pw[0] - dt * fr, pw[1] - dt * fi)

    # ------------------------------------------------------------------
    def rotation(self, t):
        """Precompute the exact harmonic drift of duration t as three
        elementwise planes (c, a, g) with

            x' = c * x + a * p,      p' = c * p - g * x,

        covering all three mode classes in one mask-free multiply-add form:
        oscillators (c = cos(w t), a = sin(w t)/(m w), g = m w sin(w t)),
        zero-frequency live modes (c = 1, a = t/m, g = 0) and frozen modes
        (c = 1, a = 0, g = 0). Hoisting this out of the leapfrog scan replaces
        Nt f64 cos/sin plane evaluations per trajectory with
        one per distinct drift duration (updates/hmc.py)."""
        m, Q = self.m, self.Q
        live = m > 0
        inv_m = jnp.where(live, 1.0 / jnp.where(live, m, 1.0), 0.0)
        omega = jnp.sqrt(jnp.where(live, Q * inv_m, 0.0))
        osc = omega > 0
        cos_wt = jnp.cos(omega * t)
        sin_wt = jnp.sin(omega * t)
        inv_mw = jnp.where(osc, 1.0 / jnp.where(osc, m * omega, 1.0), 0.0)
        c = jnp.where(osc, cos_wt, 1.0)
        a = jnp.where(osc, sin_wt * inv_mw, t * inv_m)
        g = jnp.where(osc, m * omega * sin_wt, 0.0)
        return (c, a, g)

    @staticmethod
    def rotate_tabulated(xw, pw, rot):
        """Apply a rotation() table: 6 fused multiply-adds, no transcendentals."""
        c, a, g = rot
        xr, xi = xw
        pr, pi = pw
        return (xr * c + pr * a, xi * c + pi * a), (pr * c - xr * g, pi * c - xi * g)

    def sample_momentum_omega(self, key) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
        """Sample p_omega = sqrt(m) F xi (identically distributed to
        F(initialize_momentum): F F^{-1} sqrt(m) F xi = sqrt(m) F xi) and its
        kinetic energy — no inverse transform needed."""
        n_ph = self.m.shape[0]
        xi = jax.random.normal(key, (n_ph, self.Ltau))
        xr, xi_im = self.fwd.apply(xi, None, axis=1)
        s = jnp.sqrt(self.m)
        pw = (s * xr, s * xi_im)
        return pw, self.kinetic_energy_omega(pw)

    def kinetic_energy_omega(self, pw) -> jnp.ndarray:
        """K = (1/2) sum_k |p_k|^2 / m_k in the unnormalized-fwd convention."""
        pr, pi = pw
        inv_m = jnp.where(self.m > 0, 1.0 / jnp.where(self.m > 0, self.m, 1.0), 0.0)
        return 0.5 * jnp.sum((pr**2 + pi**2) * inv_m) / self.Ltau

    # ------------------------------------------------------------------
    def evolve(self, x: jnp.ndarray, p: jnp.ndarray, t) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Exact harmonic rotation of (x, p) by time t (evolve_eom!)."""
        xw, pw = self.rotate_omega(self.to_omega(x), self.to_omega(p), t)
        return self.to_tau(*xw), self.to_tau(*pw)
