"""Honeycomb Holstein with chemical-potential tuning to a target density
(JAX equivalent of /root/reference/tutorials/holstein_honeycomb_density_tuning.jl)."""

from __future__ import annotations

import sys

from _common import holstein_honeycomb_model, holstein_honeycomb_spec

from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
from smoqyelphqmc_tpu.io import SimulationInfo


def run(
    sID=1, Omega=1.0, alpha=1.5, n_target=1.0, L=3, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, mu=0.0)
    spec = holstein_honeycomb_spec(geo)
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"holstein_honeycomb_n{n_target:.2f}_w{Omega:.2f}_a{alpha:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed,
        target_density=n_target,
    )
    return run_simulation(sim_info, tbm, em, spec, cfg)


if __name__ == "__main__":
    args = sys.argv[1:]
    run(
        sID=int(args[0]), Omega=float(args[1]), alpha=float(args[2]),
        n_target=float(args[3]), L=int(args[4]), beta=float(args[5]),
        N_therm=int(args[6]), N_measurements=int(args[7]), N_bins=int(args[8]),
    )
