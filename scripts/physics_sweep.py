"""Production-scale physics validation: CDW correlation ratio vs beta.

Reproduces a known TREND, not a point: on the
half-filled honeycomb Holstein model (Omega = t, alpha = 1.5 — the reference
tutorial config, /root/reference/tutorials/holstein_honeycomb.jl:53-68) the
Q = Gamma staggered-CDW correlation ratio

    R_cdw(L, beta) = 1 - <S(Q + dq)>_dq / S(Q)

must grow with beta and, across system sizes, cross near the finite-T CDW
transition (R grows with L in the ordered phase, shrinks with L in the
disordered phase) — the standard finite-size-crossing diagnostic used with
this estimator (PRE 105, 065302; honeycomb-Holstein CDW physics per
PRL 122, 077602). Each (L, beta) point runs the PRODUCTION multi-walker
driver (W vmapped walkers, shared-precond controller, contraction-engine
measurements, binned .npz archives) and takes jackknife error bars over the merged
walker bins.

Run: python scripts/physics_sweep.py [--Ls 6,9] [--betas 2,4,6,8,10]
     [--therm 300] [--meas 600] [--bins 8] [--walkers 8]
     [--out /tmp/physics_sweep]
"""

import json
import os
import shutil
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "examples")


def main():
    Ls = [6, 9]
    betas = [2.0, 4.0, 6.0, 8.0, 10.0]
    n_therm, n_meas, n_bins, W = 300, 600, 8, 8
    out_dir = "/tmp/physics_sweep"
    for i, a in enumerate(sys.argv):
        if a == "--Ls":
            Ls = [int(s) for s in sys.argv[i + 1].split(",")]
        if a == "--betas":
            betas = [float(s) for s in sys.argv[i + 1].split(",")]
        if a == "--therm":
            n_therm = int(sys.argv[i + 1])
        if a == "--meas":
            n_meas = int(sys.argv[i + 1])
        if a == "--bins":
            n_bins = int(sys.argv[i + 1])
        if a == "--walkers":
            W = int(sys.argv[i + 1])
        if a == "--out":
            out_dir = sys.argv[i + 1]

    # persistent XLA compile cache: the sweep compiles one large driver
    # program per (L, beta) pair, which a warm cache skips on reruns
    from smoqyelphqmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from _common import holstein_honeycomb_model, holstein_honeycomb_spec

    from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu.io import SimulationInfo, compute_composite_correlation_ratio

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for L in Ls:
        geo, tbm, em = holstein_honeycomb_model(L, 1.0, 1.5, 0.0)
        spec = holstein_honeycomb_spec(geo)
        for beta in betas:
            folder = os.path.join(out_dir, f"L{L}_b{beta:g}")
            shutil.rmtree(folder, ignore_errors=True)
            os.makedirs(folder, exist_ok=True)
            sim_info = SimulationInfo(
                filepath=folder, datafolder_prefix=f"hh_L{L}_b{beta:g}", sID=1
            )
            cfg = SimulationConfig(
                beta=beta, dtau=0.05, N_therm=n_therm, N_measurements=n_meas,
                N_bins=n_bins, Nt=24, Nrv=10, tol=1e-10, maxiter=10_000,
                seed=1000 + 7 * L + int(10 * beta), n_walkers=W,
            )
            t0 = time.perf_counter()
            run_simulation(sim_info, tbm, em, spec, cfg, resume=False)
            wall = time.perf_counter() - t0
            R, dR = compute_composite_correlation_ratio(
                sim_info.datafolder, "cdw", q_point=(0, 0),
                q_neighbors=[(1, 0), (0, 1), (1, 1), (L - 1, 0), (0, L - 1),
                             (L - 1, L - 1)],
                spec=spec,
            )
            row = {
                "L": L, "beta": beta, "Rcdw": round(float(R.real), 4),
                "Rcdw_err": round(float(dR), 4), "wall_s": round(wall, 1),
                "walkers": W, "therm": n_therm, "meas": n_meas,
                "bins_total": n_bins * W,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    print("\n| L | beta | R_cdw | err |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['L']} | {r['beta']:g} | {r['Rcdw']:.3f} | {r['Rcdw_err']:.3f} |")
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(rows, f, indent=1)
    csv_path = os.path.join(out_dir, "rcdw_vs_beta.csv")
    with open(csv_path, "w") as f:
        f.write("L,beta,Rcdw,Rcdw_err,walkers,therm,meas,bins_total\n")
        for r in rows:
            f.write(
                f"{r['L']},{r['beta']},{r['Rcdw']},{r['Rcdw_err']},"
                f"{r['walkers']},{r['therm']},{r['meas']},{r['bins_total']}\n"
            )
    print(f"\nCSV: {csv_path}")


if __name__ == "__main__":
    main()
