"""Measurement specification, jitted orchestrator, and host-side accumulation.

Re-design of SmoQyDQMC's measurement containers + the reference's
make_measurements! dispatcher (/root/reference/src/Measurements/make_measurements.jl):

- `MeasurementSpec` (static, host) declares which correlations to measure —
  the analogue of initialize_measurement_container +
  initialize_(composite_)correlation_measurements!
  (/root/reference/tutorials/holstein_honeycomb.jl:318-430);
- `make_measurements` is ONE jitted function of (ctx, est, x) returning a flat
  pytree of results: global scalars, local per-type vectors, and correlation
  arrays of shape (n_pairs, Ltau+1, *L) as (re, im) pairs;
- `MeasurementAccumulator` (host, NumPy) bin-averages results and hands finished
  bins to the IO layer.

Correlation kinds and their id semantics (mirroring make_measurements.jl:166-394):
  greens, density, density_upup, density_updn, spin_z, spin_x: orbital-id pairs
  pair, bond, bond_upup, bond_updn: bond-id pairs
  current, current_upup, current_updn: hopping (t-bond) id pairs
  phonon_greens: phonon-mode-id pairs (pure boson, measured from x directly)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..lattice import ModelGeometry
from ..models.fermion_path_integral import build_path_integral
from ..updates.context import QMCContext
from .correlations import (
    measure_bond_correlation,
    measure_current_correlation,
    measure_density_correlation,
    measure_greens_correlation,
    measure_pair_correlation,
    measure_spin_z_correlation,
)
from .greens_estimator import GreensEstimator
from .local_measurements import (
    measure_bare_hopping_energy,
    measure_dispersion_energy,
    measure_holstein_energy,
    measure_hopping_amplitude,
    measure_hopping_energy,
    measure_hopping_inversion,
    measure_onsite_energy,
    measure_phonon_kinetic_energy,
    measure_phonon_position_moment,
    measure_phonon_potential_energy,
    measure_ssh_energy,
)
from .scalar import measure_double_occ, measure_n, measure_Nsqrd

ORBITAL_KINDS = (
    "greens", "greens_up", "greens_dn",
    "density", "density_upup", "density_updn", "density_dndn", "density_dnup",
    "spin_z", "spin_x",
)
BOND_KINDS = ("pair", "bond", "bond_upup", "bond_updn", "bond_dndn", "bond_dnup")
CURRENT_KINDS = ("current", "current_upup", "current_updn", "current_dndn", "current_dnup")
PHONON_KINDS = ("phonon_greens",)
ALL_KINDS = ORBITAL_KINDS + BOND_KINDS + CURRENT_KINDS + PHONON_KINDS

# spin-resolved channel per kind suffix; for spin-symmetric models dn-dn is the
# same contraction as up-up and dn-up the same as up-dn (the reference dispatches
# both names to one branch, make_measurements.jl:209-218,256-270,298-329)
_SPIN_CHANNEL = {
    "upup": (0, 0), "updn": (0, 1), "dndn": (1, 1), "dnup": (1, 0),
}


def _spin_channel(kind: str):
    """(spin_resolved tuple or None) for a correlation-kind name."""
    suffix = kind.rsplit("_", 1)[-1]
    return _SPIN_CHANNEL.get(suffix)


@dataclasses.dataclass(frozen=True)
class CorrelationRequest:
    kind: str
    id_pairs: Tuple[Tuple[int, int], ...]
    time_displaced: bool = False
    integrated: bool = False


@dataclasses.dataclass(frozen=True)
class CompositeRequest:
    name: str
    kind: str
    id_pairs: Tuple[Tuple[int, int], ...]
    coefficients: Tuple[complex, ...]  # one per id pair
    time_displaced: bool = False
    integrated: bool = False
    # per-PAIR displacement difference d_i - d_j (from the generating `ids` form);
    # folded into momentum-space phases at postprocessing (structure factors).
    pair_displacements: Optional[Tuple[Tuple[float, ...], ...]] = None


@dataclasses.dataclass
class MeasurementSpec:
    geometry: ModelGeometry
    correlations: Dict[str, CorrelationRequest] = dataclasses.field(default_factory=dict)
    composites: Dict[str, CompositeRequest] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    def add_correlation(
        self,
        correlation: str,
        pairs: Sequence[Tuple[int, int]],
        time_displaced: bool = False,
        integrated: bool = False,
    ) -> None:
        """initialize_correlation_measurements! equivalent."""
        assert correlation in ALL_KINDS, f"unknown correlation kind {correlation}"
        prev = self.correlations.get(correlation)
        all_pairs = tuple(prev.id_pairs) + tuple((int(a), int(b)) for a, b in pairs) if prev else tuple(
            (int(a), int(b)) for a, b in pairs
        )
        self.correlations[correlation] = CorrelationRequest(
            kind=correlation,
            id_pairs=tuple(dict.fromkeys(all_pairs)),
            time_displaced=time_displaced or (prev.time_displaced if prev else False),
            integrated=integrated or (prev.integrated if prev else False),
        )

    def add_composite_correlation(
        self,
        name: str,
        correlation: str,
        coefficients: Sequence[complex],
        ids: Optional[Sequence[int]] = None,
        id_pairs: Optional[Sequence[Tuple[int, int]]] = None,
        displacement_vecs: Optional[Sequence[Sequence[float]]] = None,
        time_displaced: bool = False,
        integrated: bool = False,
    ) -> None:
        """initialize_composite_correlation_measurement! equivalent: with `ids`,
        all pairs (i, j) get coefficient c_i * conj(c_j); with `id_pairs`, the
        given pairs get the given coefficients directly."""
        assert correlation in ALL_KINDS
        pair_disps = None
        if ids is not None:
            pairs = []
            coefs = []
            disps = []
            for ki, (i, ci) in enumerate(zip(ids, coefficients)):
                for kj, (j, cj) in enumerate(zip(ids, coefficients)):
                    pairs.append((int(i), int(j)))
                    coefs.append(complex(ci) * np.conj(complex(cj)))
                    if displacement_vecs is not None:
                        di = np.asarray(displacement_vecs[ki], dtype=float)
                        dj = np.asarray(displacement_vecs[kj], dtype=float)
                        disps.append(tuple(di - dj))
            id_pairs = tuple(pairs)
            coefficients = tuple(coefs)
            pair_disps = tuple(disps) if disps else None
        else:
            assert id_pairs is not None
            id_pairs = tuple((int(a), int(b)) for a, b in id_pairs)
            coefficients = tuple(complex(c) for c in coefficients)
        self.composites[name] = CompositeRequest(
            name=name,
            kind=correlation,
            id_pairs=id_pairs,
            coefficients=coefficients,
            time_displaced=time_displaced,
            integrated=integrated,
            pair_displacements=pair_disps,
        )


# ----------------------------------------------------------------------
# Jitted measurement pass
# ----------------------------------------------------------------------


def _bond_t_field(est: GreensEstimator, ctx: QMCContext, fpi, bond_id: int):
    """Hopping field t(l, cell) of one t-bond as an (re, None) pair (Ltau, *L)."""
    # bond_id indexes ctx.tbp.bond_ids; find its position
    if bond_id not in ctx.tbp.bond_ids:
        raise ValueError(
            f"current correlation requested for bond id {bond_id}, which is not a "
            f"hopping (t) bond of the tight-binding model (t-bond ids: {ctx.tbp.bond_ids})"
        )
    pos = ctx.tbp.bond_ids.index(bond_id)
    start, stop = ctx.tbp.bond_slices[pos]
    t = fpi.t[:, start:stop].reshape((est.Ltau,) + est.L)
    t_im = None
    if fpi.t_im is not None:
        t_im = fpi.t_im[:, start:stop].reshape((est.Ltau,) + est.L)
    return (t, t_im)


def _measure_one_correlation(
    ctx: QMCContext,
    spec: MeasurementSpec,
    est: GreensEstimator,
    x: jnp.ndarray,
    fpi,
    req: CorrelationRequest,
    cache=None,
):
    """(n_pairs, Ltau+1, *L) pair for one correlation kind. `cache` is the
    pass-wide trace-time transform cache shared across ALL kinds and composites
    (spin_z reuses density's exchange transforms, composites reuse the direct
    measurements', ...)."""
    shape = (est.Ltau + 1,) + est.L
    outs_re, outs_im = [], []
    geo = spec.geometry
    for (ia, ib) in req.id_pairs:
        C = (jnp.zeros(shape), jnp.zeros(shape))
        if req.kind in ("greens", "greens_up", "greens_dn"):
            C = measure_greens_correlation(C, est, ia, ib, cache=cache)
        elif req.kind.startswith("density"):
            C = measure_density_correlation(
                C, est, ia, ib, spin_resolved=_spin_channel(req.kind), cache=cache
            )
        elif req.kind == "spin_z" or req.kind == "spin_x":
            C = measure_spin_z_correlation(C, est, ia, ib, cache=cache)
        elif req.kind == "pair":
            C = measure_pair_correlation(C, est, geo.bond(ia), geo.bond(ib), cache=cache)
        elif req.kind.startswith("bond"):
            C = measure_bond_correlation(
                C, est, geo.bond(ia), geo.bond(ib), spin_resolved=_spin_channel(req.kind),
                cache=cache,
            )
        elif req.kind in CURRENT_KINDS:
            t1 = _bond_t_field(est, ctx, fpi, ia)
            t2 = _bond_t_field(est, ctx, fpi, ib)
            C = measure_current_correlation(
                C, est, geo.bond(ia), geo.bond(ib), t1, t2,
                spin_resolved=_spin_channel(req.kind),
            )
        elif req.kind == "phonon_greens":
            C = _phonon_greens(C, ctx, est, x, ia, ib)
        else:  # pragma: no cover
            raise ValueError(req.kind)
        outs_re.append(C[0])
        outs_im.append(C[1])
    return jnp.stack(outs_re), jnp.stack(outs_im)


def _phonon_greens(C, ctx: QMCContext, est: GreensEstimator, x: jnp.ndarray, pa: int, pb: int):
    """Pure-boson displacement correlation <x_a(i+r, tau) x_b(i, 0)> with periodic
    tau (delegated to SmoQyDQMC in the reference, make_measurements.jl:717-768)."""
    elph = ctx.elph
    nc = elph.n_cells
    # contraction-engine dtype (f32 in production): the f64 phonon field would
    # otherwise promote the whole FFT chain to f64 for a rounding level 5
    # orders below the statistical noise
    dt = est.R.dtype
    xa = x[pa * nc : (pa + 1) * nc, :].T.reshape((elph.Ltau,) + est.L).astype(dt)
    xb = x[pb * nc : (pb + 1) * nc, :].T.reshape((elph.Ltau,) + est.L).astype(dt)
    za = jnp.zeros_like(xa)
    Sr, Si = est.xcorr_accumulate(xa, za, xb, za, doubled=False)
    Cr = jnp.concatenate([Sr, Sr[0][None]], axis=0)
    Ci = jnp.concatenate([Si, Si[0][None]], axis=0)
    return C[0] + Cr, C[1] + Ci


def make_measurements(
    ctx: QMCContext,
    spec: MeasurementSpec,
    est: GreensEstimator,
    x: jnp.ndarray,
):
    """One full measurement pass (make_measurements!, make_measurements.jl:19-90).
    The Green's estimator must already reflect the current x (the driver calls
    update_greens_estimator first and records its CG iteration count)."""
    from ..ops.bosonic import bosonic_action

    elph = ctx.elph
    tbp = ctx.tbp
    fpi = build_path_integral(tbp, elph, x)

    out: Dict[str, object] = {}

    # ---- global measurements (make_measurements.jl:93-117) ----
    n_re, n_im = measure_n(est)
    Nsq_re, Nsq_im = measure_Nsqrd(est)
    docc_re, docc_im = measure_double_occ(est)
    nan = jnp.asarray(jnp.nan)
    zero = jnp.asarray(0.0)
    glob = {
        "sgn": (jnp.asarray(1.0), zero),
        # DQMC-only entries the PFF formulation never computes; the reference
        # records them as NaN (make_measurements.jl:101-107)
        "sgndetGup": (nan, zero),
        "sgndetGdn": (nan, zero),
        "logdetGup": (nan, zero),
        "logdetGdn": (nan, zero),
        "action_fermionic": (nan, zero),
        "action_total": (nan, zero),
        "density": (2.0 * n_re, 2.0 * n_im),
        "density_up": (n_re, n_im),
        "density_dn": (n_re, n_im),
        "double_occ": (docc_re, docc_im),
        "Nsqrd": (Nsq_re, Nsq_im),
        "chemical_potential": (tbp.mu, zero),
        "action_bosonic": (bosonic_action(elph, x), zero),
    }
    out["global"] = glob

    # ---- local measurements (make_measurements.jl:121-163) ----
    local: Dict[str, object] = {}
    n_orb = spec.geometry.n_orbitals
    ons = [measure_onsite_energy(est, tbp, o) for o in range(n_orb)]
    local["onsite_energy_up"] = (jnp.stack([o[0] for o in ons]), jnp.stack([o[1] for o in ons]))
    local["onsite_energy_dn"] = local["onsite_energy_up"]
    local["onsite_energy"] = (2 * local["onsite_energy_up"][0], 2 * local["onsite_energy_up"][1])

    nbond = tbp.n_bond_types
    if nbond:
        bare = [measure_bare_hopping_energy(est, tbp, h) for h in range(nbond)]
        dressed = [measure_hopping_energy(est, tbp, fpi, h) for h in range(nbond)]
        amp = [measure_hopping_amplitude(tbp, fpi, h) for h in range(nbond)]
        inv = [measure_hopping_inversion(tbp, fpi, h) for h in range(nbond)]
        for name, vals in [
            ("bare_hopping_energy", bare),
            ("hopping_energy", dressed),
            ("hopping_amplitude", amp),
            ("hopping_inversion", inv),
        ]:
            re = jnp.stack([v[0] for v in vals])
            im = jnp.stack([v[1] for v in vals])
            local[name + "_up"] = (re, im)
            local[name + "_dn"] = (re, im)
            local[name] = (re, im) if name in ("hopping_amplitude", "hopping_inversion") else (2 * re, 2 * im)

    if elph.nphonon:
        local["phonon_kin_energy"] = (
            jnp.stack([measure_phonon_kinetic_energy(elph, x, p) for p in range(elph.nphonon)]),
            jnp.zeros(elph.nphonon),
        )
        local["phonon_pot_energy"] = (
            jnp.stack([measure_phonon_potential_energy(elph, x, p) for p in range(elph.nphonon)]),
            jnp.zeros(elph.nphonon),
        )
        for mom, name in [(1, "X"), (2, "X2"), (3, "X3"), (4, "X4")]:
            local[name] = (
                jnp.stack([measure_phonon_position_moment(elph, x, p, mom) for p in range(elph.nphonon)]),
                jnp.zeros(elph.nphonon),
            )
    if elph.nholstein:
        hol = [measure_holstein_energy(est, elph, x, h) for h in range(elph.nholstein)]
        re = jnp.stack([v[0] for v in hol])
        im = jnp.stack([v[1] for v in hol])
        local["holstein_energy_up"] = (re, im)
        local["holstein_energy_dn"] = (re, im)
        local["holstein_energy"] = (2 * re, 2 * im)
    if elph.nssh:
        ssh = [measure_ssh_energy(est, elph, tbp, x, s) for s in range(elph.nssh)]
        re = jnp.stack([v[0] for v in ssh])
        im = jnp.stack([v[1] for v in ssh])
        local["ssh_energy_up"] = (re, im)
        local["ssh_energy_dn"] = (re, im)
        local["ssh_energy"] = (2 * re, 2 * im)
    if elph.ndispersion:
        local["dispersion_energy"] = (
            jnp.stack([measure_dispersion_energy(elph, x, d) for d in range(elph.ndispersion)]),
            jnp.zeros(elph.ndispersion),
        )
    out["local"] = local

    # ---- correlation measurements (make_measurements.jl:166-394) ----
    cache: Dict = {}  # pass-wide transform cache (trace-time dedup)
    corr: Dict[str, object] = {}
    for name, req in spec.correlations.items():
        corr[name] = _measure_one_correlation(ctx, spec, est, x, fpi, req, cache=cache)
    out["correlations"] = corr

    # ---- composite correlations (make_measurements.jl:398-713) ----
    # stored PER PAIR so postprocessing can fold coefficients (r-space) and
    # coefficient x displacement phases (structure factors) exactly
    comp: Dict[str, object] = {}
    for name, creq in spec.composites.items():
        base = CorrelationRequest(kind=creq.kind, id_pairs=creq.id_pairs)
        comp[name] = _measure_one_correlation(ctx, spec, est, x, fpi, base, cache=cache)
    out["composite"] = comp
    return out


def compose_composite(coefficients, stack: np.ndarray, pairs_axis: int) -> np.ndarray:
    """sum_k c_k stack[..., k, ...] along pairs_axis (complex coefficients)."""
    coefs = np.asarray(coefficients)
    moved = np.moveaxis(stack, pairs_axis, -1)
    return moved @ coefs


# ----------------------------------------------------------------------
# Host-side bin accumulation
# ----------------------------------------------------------------------


class MeasurementAccumulator:
    """Accumulates jitted measurement pytrees into bin averages (the role of
    SmoQyDQMC's container dicts + write_measurements! bin logic).

    Accumulation stays ON DEVICE (lazy jax adds): forcing the measurement tree
    to host every sweep would serialize the driver loop on device->host
    transfers. Host conversion happens once
    per bin in finalize_bin (and at checkpoint time via np.asarray)."""

    # class-level jitted helpers (shared across instances; retraced per tree
    # structure): ONE dispatched call per accumulate instead of one eager op per
    # tree leaf
    _jit_add = None
    _jit_add_slice = None

    def __init__(self, spec: MeasurementSpec):
        self.spec = spec
        self.count = 0
        self.sums: Optional[dict] = None
        if MeasurementAccumulator._jit_add is None:
            import jax

            MeasurementAccumulator._jit_add = jax.jit(
                lambda s, h: jax.tree_util.tree_map(jnp.add, s, h)
            )
            MeasurementAccumulator._jit_add_slice = jax.jit(
                lambda s, h, w: jax.tree_util.tree_map(
                    lambda a, b: a + jax.lax.dynamic_index_in_dim(b, w, 0, keepdims=False),
                    s,
                    h,
                )
            )

    def accumulate(self, result) -> None:
        if self.sums is None:
            self.sums = result
        else:
            self.sums = MeasurementAccumulator._jit_add(self.sums, result)
        self.count += 1

    def accumulate_walker(self, result, w: int) -> None:
        """Accumulate walker w's slice of a leading-walker-axis result tree."""
        import jax

        if self.sums is None:
            self.sums = jax.tree_util.tree_map(lambda b: b[w], result)
        else:
            self.sums = MeasurementAccumulator._jit_add_slice(self.sums, result, w)
        self.count += 1

    def finalize_bin(self):
        """Return the bin-averaged pytree (NumPy, host) and reset."""
        import jax

        assert self.count > 0, "empty bin"
        avg = jax.tree_util.tree_map(lambda s: np.asarray(s) / self.count, self.sums)
        self.sums = None
        self.count = 0
        return avg
