"""Subprocess entry point for the 2-process multi-host driver test.

Each process is one 'host' of a jax.distributed cluster (CPU backend, 2 virtual
devices per process — the CI stand-in for one accelerator host per process). Both run
the SAME driver program SPMD; the driver shards the walker axis over the global
4-device mesh and each process writes only its own walkers' bin files — the
per-rank output-file scheme of the reference's MPI tutorial
(/root/reference/tutorials/holstein_honeycomb_mpi.jl:24-72).

Usage: python _multihost_worker.py <port> <process_id> <num_processes> <workdir> [json-opts]

json-opts (all optional): {"runtime": hours (default inf — 0.0 interrupts after
the first sweep, the kill+resume half of the checkpoint+MPI tutorial
composition, /root/reference/tutorials/holstein_honeycomb_checkpoint.jl:383-416),
"devices": virtual CPU devices per process (default 2), "prefix": datafolder
prefix (default "mh"), "tune": per-walker mu tuning (default true)}
"""

import json
import os
import sys


def main() -> None:
    port, pid, nproc, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    opts = json.loads(sys.argv[5]) if len(sys.argv) > 5 else {}
    runtime = float(opts.get("runtime", float("inf")))
    devices = int(opts.get("devices", 2))
    prefix = opts.get("prefix", "mh")
    tune = bool(opts.get("tune", True))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"

    # the package is used from the repo root without an install step
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(tests_dir))
    sys.path.insert(0, tests_dir)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from smoqyelphqmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

    from smoqyelphqmc_tpu.parallel.distributed import (
        global_walker_mesh,
        initialize_distributed,
        local_walker_ids,
    )

    initialize_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _models import chain_model

    from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu.io import SimulationInfo
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec

    geo, tbm, _tbp, elph_model, _elph = chain_model(L=4, beta=0.4, dtau=0.1, alpha=0.4)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)])
    W = 4
    cfg = SimulationConfig(
        beta=0.4, dtau=0.1,
        N_therm=int(opts.get("therm", 1)),
        N_measurements=int(opts.get("meas", 2)),
        N_bins=int(opts.get("bins", 2)),
        Nt=2, Nrv=2, tol=1e-7, seed=3, n_walkers=W,
        target_density=1.0 if tune else None,  # exercises per-walker tuners + profiles
        checkpoint_freq_hours=0.0,    # exercises per-process local-block checkpoints
        runtime_limit_hours=runtime,  # 0.0 -> interrupt after the first sweep/batch
        sweeps_per_dispatch=int(opts.get("k", 1)),
    )
    # explicit sID: the auto-increment scans the filesystem and can race between
    # the two processes (documented in _run_multiwalker)
    sim_info = SimulationInfo(filepath=workdir, datafolder_prefix=prefix, sID=1)
    meta = run_simulation(sim_info, tbm, elph_model, spec, cfg)

    mesh = global_walker_mesh()
    owned = [int(w) for w in local_walker_ids(mesh, W)]
    report = {
        "pid": pid,
        "owned": owned,
        "n_global_devices": len(jax.devices()),
        "hmc_acceptance_rate": float(meta["hmc_acceptance_rate"]),
    }
    if "final_mu_per_walker" in meta:
        report["final_mu_per_walker"] = {
            str(k): float(v) for k, v in meta["final_mu_per_walker"].items()
        }
    with open(os.path.join(workdir, f"worker{pid}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
