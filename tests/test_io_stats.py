"""IO/statistics oracles: binning, rebinning, mean/stderr, momentum transform,
correlation ratios on synthetic data."""

import os

import numpy as np

from smoqyelphqmc_tpu.io import archive
from smoqyelphqmc_tpu.io.correlation_ratio import compute_correlation_ratio
from smoqyelphqmc_tpu.io.measurements_io import merge_bins, process_measurements, write_measurement_bin
from smoqyelphqmc_tpu.io.simulation_info import SimulationInfo, initialize_datafolder
from smoqyelphqmc_tpu.measure.container import MeasurementSpec

from _models import chain_model


def _synthetic_bins(tmp_path, n_bins=8, Ltau=4, L=(4,), rng=None):
    rng = rng or np.random.default_rng(0)
    geo = chain_model(L=L[0])[0]
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    sim = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="synth", sID=1)
    initialize_datafolder(sim)
    data = []
    for b in range(n_bins):
        corr = rng.standard_normal((1, Ltau + 1) + L)
        scalar = rng.standard_normal()
        tree = {
            "global": {"density": (np.asarray(scalar), np.asarray(0.0))},
            "local": {},
            "correlations": {"density": (corr[:, :], np.zeros_like(corr))},
            "composite": {},
        }
        data.append((scalar, corr))
        write_measurement_bin(sim, b, tree, spec, dtau=0.1)
    merge_bins(sim)
    return sim, spec, data


def test_stats_mean_and_stderr(tmp_path):
    sim, spec, data = _synthetic_bins(tmp_path)
    process_measurements(sim.datafolder, spec=spec)
    scalars = np.asarray([d[0] for d in data])
    f = archive.load(os.path.join(sim.datafolder, "stats.npz"))
    mean = f["global/density/mean"]
    err = f["global/density/std"]
    np.testing.assert_allclose(mean.real, scalars.mean(), rtol=1e-12)
    np.testing.assert_allclose(
        err.real, scalars.std(ddof=1) / np.sqrt(len(scalars)), rtol=1e-12
    )


def test_momentum_space_is_fft(tmp_path):
    sim, spec, data = _synthetic_bins(tmp_path)
    process_measurements(sim.datafolder, spec=spec)
    corrs = np.stack([d[1] for d in data])  # (nb, 1, Lt+1, L)
    mean_q = archive.load(os.path.join(sim.datafolder, "stats.npz"))[
        "correlations/density/mean_q"
    ]
    ref = np.fft.fftn(corrs, axes=(3,)).mean(axis=0)
    np.testing.assert_allclose(mean_q, ref, atol=1e-12)


def test_correlation_ratio_synthetic(tmp_path):
    """A correlation with a known structure-factor peak gives the expected ratio."""
    rng = np.random.default_rng(3)
    L = (8,)
    Ltau = 4
    geo = chain_model(L=8)[0]
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])
    sim = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="ratio", sID=1)
    initialize_datafolder(sim)
    # C(r) = A + B cos(2 pi r / L): S(0) = A*L at q=0 and B*L/2 at q=+-1
    r = np.arange(8)
    for b in range(6):
        A, B = 2.0 + 0.01 * rng.standard_normal(), 1.0 + 0.01 * rng.standard_normal()
        C = A + B * np.cos(2 * np.pi * r / 8)
        corr = np.broadcast_to(C, (1, Ltau + 1, 8)).copy()
        tree = {
            "global": {},
            "local": {},
            "correlations": {"density": (corr, np.zeros_like(corr))},
            "composite": {},
        }
        write_measurement_bin(sim, b, tree, spec, dtau=0.1)
    merge_bins(sim)
    R, dR = compute_correlation_ratio(
        sim.datafolder, "density", q_point=(0,), q_neighbors=[(1,), (7,)]
    )
    # S(0) = 8A = 16, S(+-1) = 8B/2 = 4 -> R = 1 - 4/16 = 0.75
    np.testing.assert_allclose(R.real, 0.75, atol=0.02)
    assert dR < 0.05


def test_rename_complete_and_tuning_profile(tmp_path):
    import os

    from smoqyelphqmc_tpu.io import (
        initialize_datafolder,
        rename_complete_simulation,
        save_density_tuning_profile,
    )
    from smoqyelphqmc_tpu.io.simulation_info import SimulationInfo

    sim = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="fin", sID=1)
    initialize_datafolder(sim)
    save_density_tuning_profile(sim, [(0.1, 1.0, 4.0), (0.2, 1.1, 4.1)])
    assert os.path.exists(os.path.join(sim.datafolder, "density_tuning_profile_pID-0.csv"))
    target = rename_complete_simulation(sim)
    assert target.endswith("-complete") and os.path.isdir(target)


def test_csv_export_surface(tmp_path):
    """Time-displaced and integrated CSV tables are exported alongside the
    equal-time ones, in position and momentum space (the reference tutorial's
    process_measurements output set, holstein_honeycomb.jl:723-736)."""
    sim, spec, data = _synthetic_bins(tmp_path)
    # mark the correlation time-displaced as well
    spec.correlations["density"] = spec.correlations["density"].__class__(
        kind="density", id_pairs=((0, 0),), time_displaced=True, integrated=True
    )
    # rewrite one bin so the merged attrs carry the new flags
    import glob as _glob

    for p in _glob.glob(os.path.join(sim.bins_folder, "*.npz")):
        os.remove(p)
    for b, (scalar, corr) in enumerate(data):
        tree = {
            "global": {"density": (np.asarray(scalar), np.asarray(0.0))},
            "local": {},
            "correlations": {"density": (corr, np.zeros_like(corr))},
            "composite": {},
        }
        write_measurement_bin(sim, b, tree, spec, dtau=0.1)
    merge_bins(sim)
    process_measurements(sim.datafolder, spec=spec)
    for tag in ("equal_time", "equal_time_momentum", "time_displaced",
                "time_displaced_momentum", "integrated", "integrated_momentum"):
        path = os.path.join(sim.datafolder, f"correlations_density_{tag}.csv")
        assert os.path.exists(path), tag
        with open(path) as f:
            lines = f.read().strip().splitlines()
        assert lines[0].split() == ["name", "index", "mean_real", "mean_imag", "std"]
        assert len(lines) > 1


def test_global_update_guards():
    """Empty candidate sets raise instead of sampling from an empty range."""
    import jax
    import pytest

    from smoqyelphqmc_tpu.updates.context import initialize_qmc
    from smoqyelphqmc_tpu.updates.global_updates import (
        radial_update,
        reflection_update,
        swap_update,
    )

    geo, tbm, tbp, em, elph = chain_model(L=4, beta=0.5, dtau=0.1)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-6, use_preconditioner=False)
    with pytest.raises(ValueError, match="reflection_update"):
        reflection_update(ctx, state, phonon_types=[])
    with pytest.raises(ValueError, match="swap_update"):
        swap_update(ctx, state, phonon_type_pairs=[])
