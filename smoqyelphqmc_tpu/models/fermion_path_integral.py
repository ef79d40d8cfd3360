"""Fermion path integral: V(tau, site) and t(tau, hop) as a pure function of x.

Re-design of SmoQyDQMC's FermionPathIntegral (SURVEY.md section 2b,
/root/reference/src/FermionDetMatrix.jl:72): instead of incrementally adding /
subtracting phonon contributions with update!(fpi, params, x, +-1)
(/root/reference/src/reflection_update.jl:81-96), the time-dependent potential and
hopping matrices are *rebuilt from scratch* from the static tight-binding data and
the current phonon field. The rebuild is O(Ltau * (N + n_hops)) elementwise work —
negligible next to one CG solve — and removes all mutation/rollback logic: rejection
just keeps the old x.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import register_pytree_dataclass, static_field
from .electron_phonon import ElectronPhononParameters
from .tight_binding import TightBindingParameters


@register_pytree_dataclass
class FermionPathIntegral:
    """Time-dependent single-particle matrices in compact form.

    V: (Ltau, n_sites) on-site energies (includes eps - mu and Holstein terms).
    t: (Ltau, n_hops) hopping amplitudes (includes SSH dressing); complex
    hoppings carry their imaginary part in t_im (None for real models — SSH
    couplings modulate only the real part, so t_im is static in x).
    """

    V: jnp.ndarray
    t: jnp.ndarray
    t_im: "jnp.ndarray | None"
    dtau: float = static_field()
    Ltau: int = static_field()
    n_sites: int = static_field()


def holstein_potential(elph: ElectronPhononParameters, x: jnp.ndarray) -> jnp.ndarray:
    """(Ltau, n_sites) Holstein contribution  sum_c alpha_k x_p^k  scattered to sites."""
    Ltau = elph.Ltau
    if elph.n_holstein == 0:
        return jnp.zeros((Ltau, 0))
    xp = x[elph.hol_to_phonon, :]  # (n_hol, Ltau)
    vals = (
        elph.hol_alpha[:, None] * xp
        + elph.hol_alpha2[:, None] * xp**2
        + elph.hol_alpha3[:, None] * xp**3
        + elph.hol_alpha4[:, None] * xp**4
    )
    return vals  # caller scatters


def ssh_hopping_shift(elph: ElectronPhononParameters, x: jnp.ndarray):
    """(n_ssh, Ltau) SSH contribution  sum_k alpha_k (x_f - x_i)^k  per coupling,
    as an (re, im-or-None) pair (complex coupling constants supported)."""
    dx = x[elph.ssh_to_phonon[1], :] - x[elph.ssh_to_phonon[0], :]  # (n_ssh, Ltau)
    re = (
        elph.ssh_alpha[:, None] * dx
        + elph.ssh_alpha2[:, None] * dx**2
        + elph.ssh_alpha3[:, None] * dx**3
        + elph.ssh_alpha4[:, None] * dx**4
    )
    if elph.ssh_alpha_im is None:
        return re, None
    im = (
        elph.ssh_alpha_im[:, None] * dx
        + elph.ssh_alpha2_im[:, None] * dx**2
        + elph.ssh_alpha3_im[:, None] * dx**3
        + elph.ssh_alpha4_im[:, None] * dx**4
    )
    return re, im


def build_path_integral(
    tbp: TightBindingParameters,
    elph: ElectronPhononParameters,
    x: jnp.ndarray | None = None,
) -> FermionPathIntegral:
    """Build (V, t) from tight-binding data + phonon field x (default elph.x).

    V[l, i] = eps_i - mu + sum_{holstein c -> i} sum_k alpha_k,c x_{p_c, l}^k
    t[l, h] = t0_h - sum_{ssh c -> h} sum_k alpha_k,c (x_{p'_c,l} - x_{p_c,l})^k
      (effective hopping t_eff = t - alpha dx; /root/reference/examples/bssh_chain.jl:177).
    """
    if x is None:
        x = elph.x
    Ltau = elph.Ltau
    n_sites = tbp.n_sites

    V = jnp.broadcast_to((tbp.eps - tbp.mu)[None, :], (Ltau, n_sites))
    if elph.n_holstein > 0:
        vals = holstein_potential(elph, x)  # (n_hol, Ltau)
        V_sc = jnp.zeros((n_sites, Ltau)).at[elph.hol_to_site].add(vals)
        V = V + V_sc.T

    t = jnp.broadcast_to(tbp.t0[None, :], (Ltau, tbp.n_hops))
    t_im = None
    if tbp.t0_im is not None:
        t_im = jnp.broadcast_to(tbp.t0_im[None, :], (Ltau, tbp.n_hops))
    if elph.n_ssh > 0:
        shift_re, shift_im = ssh_hopping_shift(elph, x)  # (n_ssh, Ltau) pair
        t_sc = jnp.zeros((tbp.n_hops, Ltau), dtype=shift_re.dtype).at[elph.ssh_to_hop].add(shift_re)
        t = t - t_sc.T
        if shift_im is not None:
            t_sc_im = (
                jnp.zeros((tbp.n_hops, Ltau), dtype=shift_im.dtype)
                .at[elph.ssh_to_hop]
                .add(shift_im)
            )
            if t_im is None:
                t_im = jnp.zeros((Ltau, tbp.n_hops))
            t_im = t_im - t_sc_im.T

    return FermionPathIntegral(
        V=V, t=t, t_im=t_im, dtau=elph.dtau, Ltau=Ltau, n_sites=n_sites,
    )
