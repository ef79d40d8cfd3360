"""End-to-end driver smoke tests (the reference's test strategy, SURVEY.md
section 4: full tiny simulations through the driver layer)."""

import os

import numpy as np
import pytest

from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
from smoqyelphqmc_tpu.io import (
    SimulationInfo,
    compute_composite_correlation_ratio,
)
from smoqyelphqmc_tpu.measure.container import MeasurementSpec

from _models import honeycomb_model, chain_model


def _run(tmp_path, model_fn, cfg_kw=None, spec_fn=None, **model_kw):
    geo, tbm, tbp, elph_model, elph = model_fn(**model_kw)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("greens", [(0, 0)], time_displaced=True)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    spec.add_correlation("phonon_greens", [(0, 0)], time_displaced=True)
    if spec_fn:
        spec_fn(spec)
    defaults = dict(
        beta=model_kw.get("beta", 0.5),
        dtau=model_kw.get("dtau", 0.1),
        N_therm=2,
        N_measurements=4,
        N_bins=2,
        Nt=4,
        Nrv=4,
        tol=1e-8,
        seed=11,
    )
    defaults.update(cfg_kw or {})
    cfg = SimulationConfig(**defaults)
    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="test_sim")
    meta = run_simulation(sim_info, tbm, elph_model, spec, cfg)
    return sim_info, meta


def test_driver_end_to_end_holstein(tmp_path):
    def add_cdw(spec):
        spec.add_composite_correlation(
            "cdw", "density", ids=[0, 1], coefficients=[1.0, -1.0], integrated=True
        )

    sim_info, meta = _run(
        tmp_path, honeycomb_model, spec_fn=add_cdw, L=2, beta=0.5, dtau=0.1, alpha=0.5
    )
    d = sim_info.datafolder
    assert os.path.exists(os.path.join(d, "model_summary.toml"))
    assert os.path.exists(os.path.join(d, "binned_data.npz"))
    assert os.path.exists(os.path.join(d, "stats.npz"))
    assert os.path.exists(os.path.join(d, "global_stats.csv"))
    assert any(f.startswith("simulation_info") for f in os.listdir(d))
    assert 0.0 <= meta["hmc_acceptance_rate"] <= 1.0
    # correlation ratio machinery runs
    R, dR = compute_composite_correlation_ratio(
        d, "cdw", q_point=(0, 0), q_neighbors=[(1, 0), (0, 1), (1, 1)]
    )
    assert np.isfinite(R.real) and np.isfinite(dR)


def _archive_tree(path):
    from smoqyelphqmc_tpu.io import archive

    return archive.datasets(archive.load(path))


def test_sweep_batching_matches_unbatched(tmp_path):
    """cfg.sweeps_per_dispatch fuses k sweeps into ONE dispatched executable
    (lax.scan over the same sweep body, driver.py sweep_k/measured_step_k) —
    the sampled chain and every written bin must match the k=1 run."""
    metas, trees = {}, {}
    for k in (1, 4):
        sub = tmp_path / f"k{k}"
        sub.mkdir()
        sim_info, meta = _run(
            sub, honeycomb_model,
            cfg_kw=dict(N_therm=3, N_measurements=6, N_bins=2, sweeps_per_dispatch=k),
            L=2, beta=0.5, dtau=0.1, alpha=0.5,
        )
        metas[k] = meta
        trees[k] = _archive_tree(os.path.join(sim_info.datafolder, "binned_data.npz"))
    assert metas[1]["hmc_acceptance_rate"] == metas[4]["hmc_acceptance_rate"]
    assert metas[1]["n_first_measured_batch"] == 1
    # first measured batch clips to the bin boundary: min(k, bin_size) = 3
    assert metas[4]["n_first_measured_batch"] == 3
    assert trees[1].keys() == trees[4].keys()
    # the CHAIN is exact (acceptance above); the f32 measurement contractions
    # may differ at f32 rounding (~2e-7) because XLA fuses the scan body
    # differently from the single-step program
    for name in trees[1]:
        np.testing.assert_allclose(
            trees[4][name], trees[1][name], rtol=5e-6, atol=5e-6, err_msg=name
        )


def test_sweep_batching_multiwalker(tmp_path):
    """Multiwalker twin: the batched scan runs through run_sweep/run_measured
    with the fallback controller recording once per batch."""
    metas, trees = {}, {}
    for k in (1, 3):
        sub = tmp_path / f"k{k}"
        sub.mkdir()
        sim_info, meta = _run(
            sub, honeycomb_model,
            cfg_kw=dict(
                N_therm=3, N_measurements=6, N_bins=2, n_walkers=2,
                sweeps_per_dispatch=k,
            ),
            L=2, beta=0.5, dtau=0.1, alpha=0.5,
        )
        metas[k] = meta
        trees[k] = _archive_tree(
            os.path.join(sim_info.with_pID(0).datafolder, "binned_data.npz")
        )
    assert metas[1]["hmc_acceptance_rate"] == metas[3]["hmc_acceptance_rate"]
    assert trees[1].keys() == trees[3].keys()
    # chain exact; f32 measurement rounding as in the single-walker test
    for name in trees[1]:
        np.testing.assert_allclose(
            trees[3][name], trees[1][name], rtol=5e-6, atol=5e-6, err_msg=name
        )


def test_driver_ssh_chain(tmp_path):
    sim_info, meta = _run(tmp_path, chain_model, L=4, beta=0.5, dtau=0.1, alpha=0.4, ssh=True)
    assert os.path.exists(os.path.join(sim_info.datafolder, "stats.npz"))


@pytest.mark.slow
def test_driver_density_tuning(tmp_path):
    sim_info, meta = _run(
        tmp_path,
        honeycomb_model,
        cfg_kw=dict(target_density=1.0),
        L=2,
        beta=0.5,
        dtau=0.1,
        alpha=0.3,
    )
    assert "final_mu" in meta
    assert np.isfinite(meta["final_mu"])


def test_driver_acceptance_targeted_dt(tmp_path):
    """target_acceptance tunes the HMC timestep during thermalization without
    recompiling the sweep (dt is a traced HMCParams leaf): with acceptance at
    ~100% and target 0.5, dt must GROW from its pi/(2 Nt) start, and the tuned
    value is recorded in the metadata."""
    sim_info, meta = _run(
        tmp_path, chain_model,
        cfg_kw=dict(N_therm=12, target_acceptance=0.5),
        L=2, beta=0.5, dtau=0.1, alpha=0.3,
    )
    dt0 = np.pi / (2 * 4)
    assert "hmc_dt_final" in meta
    assert meta["hmc_dt_final"] > dt0 * 1.2
    assert meta["hmc_dt_final"] <= 8 * dt0 + 1e-12


@pytest.mark.slow
def test_driver_acceptance_targeted_dt_multiwalker(tmp_path):
    sim_info, meta = _run(
        tmp_path, chain_model,
        cfg_kw=dict(N_therm=10, target_acceptance=0.5, n_walkers=2),
        L=2, beta=0.5, dtau=0.1, alpha=0.3,
    )
    dt0 = np.pi / (2 * 4)
    assert meta["hmc_dt_final"] > dt0 * 1.1


def test_driver_kpm_diagnostics_in_metadata(tmp_path):
    """A KPM-preconditioned run records the preconditioner's self-diagnostics
    in the metadata -> simulation_info.toml (the reference
    warns on deactivation, KPMPreconditioner.jl:573-594)."""
    sim_info, meta = _run(
        tmp_path, chain_model,
        cfg_kw=dict(preconditioner="kpm"),
        L=4, beta=0.5, dtau=0.1, alpha=0.3,
    )
    assert "kpm_active" in meta
    assert "kpm_order_clip_count" in meta
    assert "kpm_inactive_walkers" in meta
    assert meta["kpm_active"] is True  # healthy tiny config: never deactivates
    assert meta["kpm_order_clip_count"] >= 0


@pytest.mark.slow
def test_driver_kpm_diagnostics_multiwalker(tmp_path):
    sim_info, meta = _run(
        tmp_path, chain_model,
        cfg_kw=dict(preconditioner="kpm", n_walkers=2),
        L=4, beta=0.5, dtau=0.1, alpha=0.3,
    )
    assert meta["kpm_active"] is True
    assert meta["kpm_inactive_walkers"] == 0


def test_fold_kpm_diagnostics_warns_on_deactivation():
    """Forced deactivation / order clipping produce visible warnings and the
    metadata records them (unit-level: the flags are leaves on the carried
    preconditioner state, so forcing them exercises the exact production
    read path)."""
    import warnings

    import jax.numpy as jnp

    from smoqyelphqmc_tpu.driver import fold_kpm_diagnostics
    from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner
    from smoqyelphqmc_tpu.updates.context import initialize_qmc, make_fdm

    geo, tbm, tbp, elph_model, elph = chain_model(L=4, beta=0.5, dtau=0.1, alpha=0.3)
    ctx, state = initialize_qmc(tbp, elph, use_preconditioner=False)
    fdm = make_fdm(ctx, state.x)
    import jax

    pre = KPMPreconditioner.build(fdm, jax.random.PRNGKey(0))
    bad = pre.replace(
        active=jnp.asarray(False), order_clip_count=jnp.asarray(7, jnp.int32)
    )
    meta = {}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fold_kpm_diagnostics(meta, bad)
    msgs = [str(w.message) for w in rec]
    assert meta["kpm_active"] is False
    assert meta["kpm_inactive_walkers"] == 1
    assert meta["kpm_order_clip_count"] == 7
    assert any("DEACTIVATED" in m for m in msgs)
    assert any("clipped" in m for m in msgs)

    # non-KPM preconditioners are a no-op
    meta2 = {}
    fold_kpm_diagnostics(meta2, None)
    assert meta2 == {}
