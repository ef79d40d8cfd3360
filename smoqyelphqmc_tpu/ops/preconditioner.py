"""Uniform preconditioner interface: build / refresh / apply for either the
bucketed-Chebyshev KPM preconditioner (ops/kpm.py) or the exact spectral
preconditioner (ops/spectral_precond.py)."""

from __future__ import annotations

from typing import Optional

from .fermion_det import FermionDetMatrix
from .kpm import KPMPreconditioner, kpm_update
from .spectral_precond import SpectralPreconditioner, build_spectral, spectral_update


# Auto-select crossover (sites): below this the exact spectral preconditioner's
# eigh(N) refresh is cheap and its 2-matmul apply is unbeatable; above it the
# O(N^3) eigh dominates the sweep and the blocked-KPM (Lanczos + dense-stride
# refresh, ~2 sqrt(C) matmuls per apply) wins. Not yet tuned on the H100.
AUTO_SPECTRAL_MAX_SITES = 4000


def build_preconditioner(kind: Optional[str], fdm: FermionDetMatrix, key):
    """kind: 'auto' (spectral below AUTO_SPECTRAL_MAX_SITES, kpm above),
    'spectral', 'kpm', or None."""
    if kind is None or kind == "none":
        return None
    if kind == "auto":
        kind = "spectral" if fdm.n_sites <= AUTO_SPECTRAL_MAX_SITES else "kpm"
    if kind == "spectral":
        return build_spectral(fdm)
    if kind == "kpm":
        return KPMPreconditioner.build(fdm, key)
    raise ValueError(f"unknown preconditioner kind {kind!r}")


def refresh_preconditioner(precond, fdm: FermionDetMatrix, key):
    """Pure update of whichever preconditioner is carried in the chain state."""
    if precond is None:
        return None
    if isinstance(precond, SpectralPreconditioner):
        return spectral_update(precond, fdm, key)
    return kpm_update(precond, fdm, key)
