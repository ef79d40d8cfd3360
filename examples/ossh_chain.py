"""Optical-SSH chain (JAX equivalent of /root/reference/examples/ossh_chain.jl)."""

from __future__ import annotations

import sys

from _common import basic_spec, ossh_chain_model

from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
from smoqyelphqmc_tpu.io import SimulationInfo


def run(
    sID=1, Omega=1.0, alpha=0.5, mu=0.0, L=16, beta=4.0,
    N_therm=100, N_measurements=200, N_bins=10,
    dtau=0.05, Nt=24, Nrv=10, tol=1e-10, seed=1, filepath=".",
):
    geo, tbm, em = ossh_chain_model(L, Omega, alpha, mu)
    spec = basic_spec(geo, bond_ids=[tbm.bond_ids[0]])
    sim_info = SimulationInfo(
        filepath=filepath,
        datafolder_prefix=f"ossh_chain_w{Omega:.2f}_a{alpha:.2f}_mu{mu:.2f}_L{L}_b{beta:.2f}",
        sID=sID,
    )
    cfg = SimulationConfig(
        beta=beta, dtau=dtau, N_therm=N_therm, N_measurements=N_measurements,
        N_bins=N_bins, Nt=Nt, Nrv=Nrv, tol=tol, seed=seed, use_radial_updates=True,
    )
    return run_simulation(sim_info, tbm, em, spec, cfg)


if __name__ == "__main__":
    a = sys.argv[1:]
    run(sID=int(a[0]), Omega=float(a[1]), alpha=float(a[2]), mu=float(a[3]),
        L=int(a[4]), beta=float(a[5]), N_therm=int(a[6]), N_measurements=int(a[7]), N_bins=int(a[8]))
