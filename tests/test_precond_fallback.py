"""Shared walker-mean preconditioner refresh: automatic per-walker fallback.

The shared refresh (parallel/walkers.shared_precond_refresh) is validated
iteration-neutral when walker propagators agree; at strong coupling or during
early thermalization they genuinely differ, so the driver guards it with a
host-side controller (parallel/walkers.PrecondFallbackController) that demotes
to per-walker refresh when iteration counts blow past the running floor and
probes shared mode periodically to promote back."""

import pytest

import numpy as np

from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
from smoqyelphqmc_tpu.io import SimulationInfo
from smoqyelphqmc_tpu.measure.container import MeasurementSpec
from smoqyelphqmc_tpu.parallel.walkers import PrecondFallbackController

from _models import honeycomb_model


# ---------------------------------------------------------------------------
# controller unit tests (pure host logic, no device)
# ---------------------------------------------------------------------------

def test_controller_demotes_on_iteration_spike():
    c = PrecondFallbackController(ratio=1.5, retry_every=8)
    assert c.choose()  # starts shared
    c.record(10.0, True)
    assert c.choose()  # healthy: floor=10, 10 <= 1.5*10
    c.record(11.0, True)
    assert c.choose()
    c.record(20.0, True)  # spike: 20 > 1.5 * 10
    assert not c.choose()  # demoted to per-walker
    assert c.mode == "perwalker"


def test_controller_probes_and_promotes_back():
    c = PrecondFallbackController(ratio=1.5, retry_every=4)
    c.record(10.0, True)
    c.choose()
    c.record(30.0, True)  # trip
    took = []
    for _ in range(3):
        shared = c.choose()
        took.append(shared)
        c.record(10.0, shared)
    assert took == [False, False, False]
    # 4th per-walker sweep is the probe
    assert c.choose() is True
    c.record(10.0, True)  # probe is healthy -> promote
    assert c.choose() is True
    assert c.mode == "shared"


def test_controller_probe_failure_stays_perwalker():
    c = PrecondFallbackController(ratio=1.5, retry_every=2)
    c.record(10.0, True)
    c.choose()
    c.record(30.0, True)  # trip
    assert not c.choose()
    c.record(10.0, False)
    assert c.choose() is True  # probe
    c.record(25.0, True)  # probe still unhealthy (25 > 1.5 * 10)
    assert c.choose() is False
    assert c.mode == "perwalker"


def test_controller_fallback_counts_probe_sweeps_as_shared():
    c = PrecondFallbackController(ratio=1.5, retry_every=2)
    c.record(10.0, True)
    c.choose()
    c.record(100.0, True)  # trip
    n_pw = 0
    for _ in range(6):
        shared = c.choose()
        if not shared:
            n_pw += 1
        c.record(100.0, shared)  # never healthy -> stays per-walker
    assert c.fallback_sweeps == n_pw
    assert 0 < n_pw < 6  # probes interleave


def test_controller_guards_non_finite_and_disabled():
    c = PrecondFallbackController(ratio=1.5)
    c.record(float("nan"), True)
    assert c.choose()  # NaN ignored, floor untouched
    assert c.floor == np.inf
    d = PrecondFallbackController(ratio=float("inf"))
    assert not d.enabled
    assert d.choose() is True  # disabled -> always shared


# ---------------------------------------------------------------------------
# integration through the multi-walker driver
# ---------------------------------------------------------------------------

def _run_walkers(tmp_path, **cfg_kw):
    geo, tbm, tbp, elph_model, elph = honeycomb_model(L=2, beta=0.5, dtau=0.1, alpha=0.5)
    spec = MeasurementSpec(geometry=geo)
    spec.add_correlation("density", [(0, 0)], integrated=True)
    defaults = dict(
        beta=0.5, dtau=0.1, N_therm=3, N_measurements=4, N_bins=2, Nt=4, Nrv=2,
        tol=1e-8, seed=5, n_walkers=2,
    )
    defaults.update(cfg_kw)
    cfg = SimulationConfig(**defaults)
    sim_info = SimulationInfo(filepath=str(tmp_path), datafolder_prefix="fb_sim")
    return run_simulation(sim_info, tbm, elph_model, spec, cfg)


@pytest.mark.slow
def test_driver_forced_fallback(tmp_path):
    # ratio < 1 makes every resolved shared sweep look unhealthy -> the
    # controller must demote and the per-walker sweep variant must run
    meta = _run_walkers(tmp_path, precond_fallback_ratio=0.5, precond_retry_every=100)
    assert meta["precond_fallback_sweeps"] > 0


def test_driver_shared_mode_stays_healthy(tmp_path):
    # homogeneous tiny walkers: the shared refresh is iteration-neutral and a
    # generous ratio must never trip
    meta = _run_walkers(tmp_path, precond_fallback_ratio=10.0)
    assert meta["precond_fallback_sweeps"] == 0


@pytest.mark.slow
def test_driver_pinned_perwalker(tmp_path):
    meta = _run_walkers(tmp_path, shared_precond=False)
    # every update sweep (therm + measurement) ran per-walker refresh
    assert meta["precond_fallback_sweeps"] == 7
