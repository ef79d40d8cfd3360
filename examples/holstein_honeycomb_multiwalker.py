"""Multi-walker honeycomb Holstein simulation (JAX equivalent of
/root/reference/tutorials/holstein_honeycomb_mpi.jl): instead of MPI ranks, W
independent Markov chains ride a vmapped walker axis sharded over the device
mesh; each walker writes its own bins tagged by pID, exactly mirroring the
reference's per-rank output files, and statistics are merged on host."""

from __future__ import annotations

import sys

import jax
import numpy as np

from _common import holstein_honeycomb_model, holstein_honeycomb_spec

from smoqyelphqmc_tpu.driver import SimulationConfig
from smoqyelphqmc_tpu.io import (
    SimulationInfo,
    initialize_datafolder,
    merge_bins,
    model_summary,
    process_measurements,
    save_simulation_info,
)
from smoqyelphqmc_tpu.io.measurements_io import write_measurement_bin
from smoqyelphqmc_tpu.measure.container import MeasurementAccumulator
from smoqyelphqmc_tpu.measure.greens_estimator import build_greens_estimator
from smoqyelphqmc_tpu.models.electron_phonon import ElectronPhononParameters
from smoqyelphqmc_tpu.models.tight_binding import TightBindingParameters
from smoqyelphqmc_tpu.parallel.walkers import (
    init_walker_states,
    shard_walker_states,
    walker_device_count,
    walker_measure,
    walker_mesh,
    walker_sweep,
)
from smoqyelphqmc_tpu.updates.context import initialize_qmc
from smoqyelphqmc_tpu.updates.hmc import HMCParams


def run(
    sID=1, Omega=1.0, alpha=1.5, mu=0.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10, n_walkers=None,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000, seed=1, filepath=".",
):
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_mw_w{Omega:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    initialize_datafolder(sim_info)
    model_summary(sim_info, beta, dtau, geo, tbm, (em,))

    cfg = SimulationConfig(beta=beta, dtau=dtau, Nt=Nt, Nrv=Nrv, tol=tol, maxiter=maxiter, seed=seed)
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    ctx, state0 = initialize_qmc(tbp, elph, seed=seed, tol=tol, maxiter=maxiter)

    W = n_walkers or len(jax.devices())
    mesh = walker_mesh(walker_device_count(W, len(jax.devices())))
    states = shard_walker_states(init_walker_states(ctx, state0, W, seed=seed + 1), mesh)
    est = build_greens_estimator(elph.Ltau, geo.n_orbitals, geo.L, Nrv=Nrv)
    params = HMCParams(Nt=Nt)

    sweep = jax.jit(lambda s: walker_sweep(ctx, s, params))
    measure = jax.jit(lambda s, keys: walker_measure(ctx, spec, s, est, keys, tol=tol, maxiter=maxiter))

    metadata = {"n_walkers": W, "hmc_acceptance_rate": 0.0, "measurement_iters": 0.0}
    for _ in range(N_therm):
        states, _ = sweep(states)

    accs = [MeasurementAccumulator(spec) for _ in range(W)]
    key = jax.random.PRNGKey(seed + 17)
    bin_size = max(N_measurements // N_bins, 1)
    for m in range(N_measurements):
        states, (_, _, h) = sweep(states)
        metadata["hmc_acceptance_rate"] += float(np.mean(np.asarray(h.accepted)))
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, W)
        out, iters = measure(states, keys)
        metadata["measurement_iters"] += float(np.mean(np.asarray(iters)))
        host = jax.tree_util.tree_map(np.asarray, out)
        for w in range(W):
            accs[w].accumulate(jax.tree_util.tree_map(lambda a, w=w: a[w], host))
        if (m + 1) % bin_size == 0:
            b = (m + 1) // bin_size - 1
            for w in range(W):
                si = SimulationInfo(
                    filepath=filepath, datafolder_prefix=sim_info.datafolder_prefix,
                    sID=sim_info.sID, pID=w,
                )
                write_measurement_bin(si, b, accs[w].finalize_bin(), spec, dtau=dtau)

    metadata["hmc_acceptance_rate"] /= max(N_measurements, 1)
    metadata["measurement_iters"] /= max(N_measurements, 1)
    merge_bins(sim_info)
    save_simulation_info(sim_info, metadata)
    process_measurements(sim_info.datafolder, n_bins=N_bins, spec=spec)
    return metadata


if __name__ == "__main__":
    args = sys.argv[1:]
    run(
        sID=int(args[0]), Omega=float(args[1]), alpha=float(args[2]), mu=float(args[3]),
        L=int(args[4]), beta=float(args[5]), N_therm=int(args[6]),
        N_measurements=int(args[7]), N_bins=int(args[8]),
        n_walkers=int(args[9]) if len(args) > 9 else None,
    )
