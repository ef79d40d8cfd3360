"""Multi-walker / multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from smoqyelphqmc_tpu.parallel.walkers import (
    init_walker_states,
    shard_walker_states,
    walker_mesh,
    walker_sweep,
)
from smoqyelphqmc_tpu.updates.context import initialize_qmc
from smoqyelphqmc_tpu.updates.hmc import HMCParams

from _models import honeycomb_model


def test_walker_sweep_vmapped():
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=0.5, dtau=0.1, alpha=0.4)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-6)
    states = init_walker_states(ctx, state, n_walkers=4, seed=1)
    params = HMCParams(Nt=2)
    step = jax.jit(lambda s: walker_sweep(ctx, s, params))
    new_states, (r, s, h) = step(states)
    assert new_states.x.shape == (4,) + state.x.shape
    assert np.all(np.isfinite(np.asarray(new_states.x)))
    # walkers evolve independently: keys differ => trajectories differ
    x = np.asarray(new_states.x)
    assert not np.allclose(x[0], x[1])


def test_walker_sweep_sharded_over_mesh():
    n_dev = len(jax.devices())
    assert n_dev >= 8, f"expected 8 virtual CPU devices, got {n_dev}"
    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=0.5, dtau=0.1, alpha=0.4)
    ctx, state = initialize_qmc(tbp, elph, seed=0, tol=1e-6)
    mesh = walker_mesh(8)
    states = init_walker_states(ctx, state, n_walkers=8, seed=2)
    states = shard_walker_states(states, mesh)
    params = HMCParams(Nt=2)
    step = jax.jit(lambda s: walker_sweep(ctx, s, params))
    new_states, _ = step(states)
    jax.block_until_ready(new_states.x)
    # output stays sharded over the walker axis
    shard_devs = {sh.device for sh in new_states.x.addressable_shards}
    assert len(shard_devs) == 8
    assert np.all(np.isfinite(np.asarray(new_states.x)))


def test_graft_entry():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(4)


@pytest.mark.slow
def test_driver_n_walkers(tmp_path):
    import os

    from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu.io import SimulationInfo
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec

    geo, tbm, tbp, _, elph = honeycomb_model(L=2, beta=0.4, dtau=0.1, alpha=0.4)
    # rebuild unexpanded models for the driver
    from _models import honeycomb_model as hm

    geo, tbm, tbp, elph_model, elph = hm(L=2, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])
    cfg = SimulationConfig(
        beta=0.4, dtau=0.1, N_therm=1, N_measurements=2, N_bins=2,
        Nt=2, Nrv=3, tol=1e-7, seed=9, n_walkers=2,
    )
    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="walker_driver")
    meta = run_simulation(sim_info, tbm, elph_model, spec, cfg)
    assert meta["n_walkers"] == 2
    assert os.path.exists(os.path.join(sim_info.datafolder, "stats.npz"))
    # both walkers contributed bin files
    import glob

    bins = glob.glob(os.path.join(sim_info.bins_folder, "bin-*_pID-*.npz"))
    pids = {p.split("pID-")[1].split(".")[0] for p in bins}
    assert pids == {"0", "1"}


@pytest.mark.slow
def test_driver_n_walkers_with_mu_tuning(tmp_path):
    import os

    from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu.io import SimulationInfo
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec

    from _models import honeycomb_model as hm

    geo, tbm, tbp, elph_model, elph = hm(L=2, beta=0.4, dtau=0.1, alpha=0.3)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])
    cfg = SimulationConfig(
        beta=0.4, dtau=0.1, N_therm=1, N_measurements=2, N_bins=2,
        Nt=2, Nrv=3, tol=1e-7, seed=13, n_walkers=2, target_density=1.0,
    )
    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="walker_mu")
    meta = run_simulation(sim_info, tbm, elph_model, spec, cfg)
    assert len(meta["final_mu_per_walker"]) == 2
    assert all(np.isfinite(v) for v in meta["final_mu_per_walker"])
    assert os.path.exists(os.path.join(sim_info.datafolder, "stats.npz"))
    # per-walker density-tuning profiles (save_density_tuning_profile per pID)
    for w in (0, 1):
        path = os.path.join(sim_info.datafolder, f"density_tuning_profile_pID-{w}.csv")
        assert os.path.exists(path), path
        with open(path) as f:
            assert len(f.read().strip().splitlines()) >= 2


def test_distributed_helpers_on_virtual_mesh():
    """Multi-host helper API exercised on the 8-virtual-device mesh: the global
    mesh covers every device, this (single) process owns every walker id, and
    per-walker scalars gather to a fully-replicated host array."""
    import jax
    import jax.numpy as jnp

    from smoqyelphqmc_tpu.parallel import (
        gather_walker_scalars,
        global_walker_mesh,
        local_walker_ids,
    )

    mesh = global_walker_mesh()
    assert mesh.devices.size == len(jax.devices())
    W = 2 * mesh.devices.size
    ids = local_walker_ids(mesh, W)
    assert sorted(ids) == list(range(W))  # single-process: owns all walkers
    vals = jnp.arange(W, dtype=jnp.float64)
    gathered = gather_walker_scalars(vals, mesh)
    np.testing.assert_array_equal(gathered, np.arange(W))
