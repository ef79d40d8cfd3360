"""Driver-level checkpoint/resume: a run interrupted by its runtime limit must
resume from the checkpoint and produce the complete output set
(/root/reference/tutorials/holstein_honeycomb_checkpoint.jl semantics)."""

import glob
import os

import pytest

import numpy as np

from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
from smoqyelphqmc_tpu.io import SimulationInfo
from smoqyelphqmc_tpu.measure.container import MeasurementSpec

from _models import honeycomb_model


def test_runtime_limit_interrupt_and_resume(tmp_path):
    geo, tbm, tbp, elph_model, elph = honeycomb_model(L=2, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])

    def cfg(runtime):
        return SimulationConfig(
            beta=0.4, dtau=0.1, N_therm=2, N_measurements=4, N_bins=2,
            Nt=2, Nrv=3, tol=1e-7, seed=21,
            checkpoint_freq_hours=0.0,  # checkpoint every sweep
            runtime_limit_hours=runtime,
        )

    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="resume_test", sID=1)
    # first run: runtime limit 0 => must stop immediately after checkpointing
    meta1 = run_simulation(sim_info, tbm, elph_model, spec, cfg(0.0))
    cps = glob.glob(os.path.join(sim_info.datafolder, "checkpoint_pID-0_slot-*.pkl"))
    assert cps, "no checkpoint written on interrupt"
    assert not os.path.exists(os.path.join(sim_info.datafolder, "stats.npz"))

    # second run with the same sim_info: resumes and completes
    sim_info2 = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="resume_test", sID=1)
    meta2 = run_simulation(sim_info2, tbm, elph_model, spec, cfg(np.inf))
    assert os.path.exists(os.path.join(sim_info2.datafolder, "stats.npz"))
    # completed runs delete their checkpoints
    cps = glob.glob(os.path.join(sim_info2.datafolder, "checkpoint_pID-0_slot-*.pkl"))
    assert not cps


def _bin_contents(datafolder):
    from smoqyelphqmc_tpu.io import archive

    out = {}
    for path in sorted(glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.npz"))):
        for key, val in archive.datasets(archive.load(path)).items():
            out[(os.path.basename(path), key)] = val
    return out


def test_midbin_resume_is_bit_identical(tmp_path):
    """Interrupting mid-bin and resuming must reproduce the uninterrupted run's
    bin files EXACTLY: the checkpoint carries the partial-bin accumulator and
    the host measurement RNG (the reference checkpoints the whole container,
    holstein_honeycomb_checkpoint.jl:516-531)."""
    geo, tbm, tbp, elph_model, elph = honeycomb_model(L=2, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])

    def cfg(runtime, freq=np.inf):
        return SimulationConfig(
            beta=0.4, dtau=0.1, N_therm=1, N_measurements=4, N_bins=2,
            Nt=2, Nrv=3, tol=1e-7, seed=33,
            checkpoint_freq_hours=freq,
            runtime_limit_hours=runtime,
        )

    # uninterrupted reference run
    ref_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="uninterrupted", sID=1)
    run_simulation(ref_info, tbm, elph_model, spec, cfg(np.inf))
    ref_bins = _bin_contents(ref_info.datafolder)
    assert ref_bins

    # interrupted run: checkpoint every sweep, stop immediately (mid-bin since
    # the runtime limit fires after the first thermalization sweep, before any
    # bin completes), then resume to completion
    int_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="interrupted", sID=1)
    run_simulation(int_info, tbm, elph_model, spec, cfg(0.0, freq=0.0))
    int_info2 = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="interrupted", sID=1)
    run_simulation(int_info2, tbm, elph_model, spec, cfg(np.inf, freq=0.0))
    res_bins = _bin_contents(int_info2.datafolder)

    assert set(res_bins) == set(ref_bins)
    for k in ref_bins:
        np.testing.assert_array_equal(res_bins[k], ref_bins[k], err_msg=str(k))


@pytest.mark.slow
def test_multiwalker_interrupt_and_resume(tmp_path):
    """n_walkers=2: interrupt + resume produces the complete per-walker output
    set (bins for both pIDs, merged stats, no leftover checkpoints) — the MPI +
    checkpoint tutorial composition (holstein_honeycomb_checkpoint.jl:383-416,
    holstein_honeycomb_mpi.jl:59-72)."""
    geo, tbm, tbp, elph_model, elph = honeycomb_model(L=2, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])

    def cfg(runtime):
        return SimulationConfig(
            beta=0.4, dtau=0.1, N_therm=1, N_measurements=4, N_bins=2,
            Nt=2, Nrv=3, tol=1e-7, seed=5, n_walkers=2,
            checkpoint_freq_hours=0.0,
            runtime_limit_hours=runtime,
        )

    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="mw_resume", sID=1)
    run_simulation(sim_info, tbm, elph_model, spec, cfg(0.0))
    cps = glob.glob(os.path.join(sim_info.datafolder, "checkpoint_pID-0_slot-*.pkl"))
    assert cps, "no multiwalker checkpoint written on interrupt"
    assert not os.path.exists(os.path.join(sim_info.datafolder, "stats.npz"))

    sim_info2 = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="mw_resume", sID=1)
    meta = run_simulation(sim_info2, tbm, elph_model, spec, cfg(np.inf))
    assert os.path.exists(os.path.join(sim_info2.datafolder, "stats.npz"))
    for w in (0, 1):
        bins = glob.glob(os.path.join(sim_info2.datafolder, "bins", f"bin-*_pID-{w}.npz"))
        assert len(bins) == 2, (w, bins)
    assert not glob.glob(os.path.join(sim_info2.datafolder, "checkpoint_pID-*_slot-*.pkl"))
