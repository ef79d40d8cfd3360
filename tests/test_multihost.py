"""Multi-host walker-fleet execution: two REAL processes coordinated by
jax.distributed (localhost coordinator), each owning half the walkers of one
driver run — the JAX equivalent of the reference's MPI walker launch
(/root/reference/tutorials/holstein_honeycomb_mpi.jl:17-72).

The single-process helper API is covered in test_multichip.py; this file proves
the WIRED driver path: per-host bin ownership, per-process checkpoints, and a
process-0 statistics merge that sees every host's bins."""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_workers(workdir: str, nproc: int = 2, timeout: int = 600, opts: dict = None):
    """Spawn nproc copies of _multihost_worker.py against one coordinator."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    # the worker sets its own JAX env; scrub the parent test process's settings
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    argv_tail = [json.dumps(opts)] if opts else []
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), str(nproc), workdir] + argv_tail,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    return outs


@pytest.mark.slow
def test_two_process_walker_fleet(tmp_path):
    workdir = str(tmp_path)
    _launch_workers(workdir)

    # --- disjoint per-host walker ownership covering every walker -------------
    reports = []
    for i in range(2):
        with open(os.path.join(workdir, f"worker{i}.json")) as f:
            reports.append(json.load(f))
    owned = [set(r["owned"]) for r in reports]
    assert owned[0] & owned[1] == set(), owned
    assert owned[0] | owned[1] == {0, 1, 2, 3}, owned
    assert all(r["n_global_devices"] == 4 for r in reports)

    datafolder = os.path.join(workdir, "mh-1")

    # --- every walker's bin stream exists (written by exactly the owning host:
    # the multihost accumulate path reads ONLY addressable shards and raises on
    # a non-owned walker id, so completion itself proves ownership discipline) -
    bins = glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.npz"))
    pids = sorted({p.split("pID-")[1].split(".")[0] for p in bins})
    assert pids == ["0", "1", "2", "3"], pids
    assert len(bins) == 4 * 2  # W walkers x N_bins

    # --- per-walker tuner artifacts, written by the owning host only ----------
    for w in range(4):
        prof = os.path.join(datafolder, f"density_tuning_profile_pID-{w}.csv")
        assert os.path.exists(prof), prof
    mu_reported = {}
    for r in reports:
        for k, v in r["final_mu_per_walker"].items():
            assert int(k) in set(r["owned"])  # each host reports only its own
            mu_reported[int(k)] = v
    assert sorted(mu_reported) == [0, 1, 2, 3]
    assert all(np.isfinite(v) for v in mu_reported.values())

    # --- process-0 merge: one stats.npz built from ALL hosts' bins ------------
    stats = os.path.join(datafolder, "stats.npz")
    assert os.path.exists(stats)
    from smoqyelphqmc_tpu.io import archive

    # DQMC-only globals are NaN by design (container.py mirrors the reference's
    # make_measurements.jl:93-117 placeholder entries)
    NAN_BY_DESIGN = ("sgndetG", "logdetG", "action_fermionic", "action_total")
    dsets = archive.datasets(archive.load(stats))
    assert dsets
    for n, v in dsets.items():
        if any(k in n for k in NAN_BY_DESIGN):
            continue
        assert np.all(np.isfinite(v)), n

    # --- per-process checkpoints were written during the run and deleted ------
    assert glob.glob(os.path.join(datafolder, "*checkpoint*")) == []


def _bin_contents(datafolder):
    from smoqyelphqmc_tpu.io import archive

    out = {}
    for path in sorted(glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.npz"))):
        for key, val in archive.datasets(archive.load(path)).items():
            out[(os.path.basename(path), key)] = val
    return out


@pytest.mark.slow
def test_multihost_kill_and_resume(tmp_path):
    """The multi-host failure path: both processes stop at a
    runtime limit mid-run (each writes its per-process local-walker-block
    checkpoint), BOTH relaunch, resume through driver.to_global /
    local_walker_block, and the completed run's bins are BIT-IDENTICAL to an
    uninterrupted 2-process run's — the cross-process lift of
    test_midbin_resume_is_bit_identical (ref composition:
    /root/reference/tutorials/holstein_honeycomb_checkpoint.jl:383-416 +
    holstein_honeycomb_mpi.jl:24-72)."""
    workdir = str(tmp_path)

    # uninterrupted reference fleet
    _launch_workers(workdir, opts={"prefix": "ref"})
    ref_bins = _bin_contents(os.path.join(workdir, "ref-1"))
    assert ref_bins

    # interrupted fleet: runtime limit 0 stops every process after the first
    # thermalization sweep, mid-bin, leaving per-process checkpoints behind
    _launch_workers(workdir, opts={"prefix": "int", "runtime": 0.0})
    datafolder = os.path.join(workdir, "int-1")
    for p in range(2):
        cps = glob.glob(os.path.join(datafolder, f"checkpoint_pID-{p}_slot-*.pkl"))
        assert cps, f"no per-process checkpoint for process {p}"
    assert not os.path.exists(os.path.join(datafolder, "stats.npz"))

    # relaunch: resumes from the per-process checkpoints and completes
    _launch_workers(workdir, opts={"prefix": "int"})
    assert os.path.exists(os.path.join(datafolder, "stats.npz"))
    assert glob.glob(os.path.join(datafolder, "checkpoint_pID-*_slot-*.pkl")) == []

    res_bins = _bin_contents(datafolder)
    assert set(res_bins) == set(ref_bins)
    for k in ref_bins:
        np.testing.assert_array_equal(res_bins[k], ref_bins[k], err_msg=str(k))


@pytest.mark.slow
def test_multihost_kill_and_resume_batched(tmp_path):
    """sweeps_per_dispatch > 1 composes with per-process checkpoints: batch
    boundaries sit on the ABSOLUTE sweep-index grid (driver._batch), so a
    killed+resumed fleet partitions sweeps exactly like an uninterrupted one
    and the bins stay bit-identical even though each dispatch now covers two
    sweeps. Tuner off (mu tuning forces k=1)."""
    workdir = str(tmp_path)
    opts = {"tune": False, "k": 2, "therm": 2, "meas": 4, "bins": 2}

    _launch_workers(workdir, opts={**opts, "prefix": "ref"})
    ref_bins = _bin_contents(os.path.join(workdir, "ref-1"))
    assert ref_bins

    _launch_workers(workdir, opts={**opts, "prefix": "int", "runtime": 0.0})
    datafolder = os.path.join(workdir, "int-1")
    for p in range(2):
        cps = glob.glob(os.path.join(datafolder, f"checkpoint_pID-{p}_slot-*.pkl"))
        assert cps, f"no per-process checkpoint for process {p}"

    _launch_workers(workdir, opts={**opts, "prefix": "int"})
    assert os.path.exists(os.path.join(datafolder, "stats.npz"))

    res_bins = _bin_contents(datafolder)
    assert set(res_bins) == set(ref_bins)
    for k in ref_bins:
        np.testing.assert_array_equal(res_bins[k], ref_bins[k], err_msg=str(k))


@pytest.mark.slow
def test_four_process_walker_fleet(tmp_path):
    """nproc=4 x 1 device per process: each host owns exactly one walker
    (the reference's one-rank-one-chain MPI layout,
    holstein_honeycomb_mpi.jl:24-72)."""
    workdir = str(tmp_path)
    _launch_workers(workdir, nproc=4, opts={"prefix": "mh4", "devices": 1})

    reports = []
    for i in range(4):
        with open(os.path.join(workdir, f"worker{i}.json")) as f:
            reports.append(json.load(f))
    owned = [set(r["owned"]) for r in reports]
    assert all(len(o) == 1 for o in owned), owned
    assert set().union(*owned) == {0, 1, 2, 3}, owned
    assert all(r["n_global_devices"] == 4 for r in reports)

    datafolder = os.path.join(workdir, "mh4-1")
    bins = glob.glob(os.path.join(datafolder, "bins", "bin-*_pID-*.npz"))
    pids = sorted({p.split("pID-")[1].split(".")[0] for p in bins})
    assert pids == ["0", "1", "2", "3"], pids
    assert os.path.exists(os.path.join(datafolder, "stats.npz"))
    assert glob.glob(os.path.join(datafolder, "*checkpoint*")) == []
