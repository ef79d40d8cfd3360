"""High-level simulation driver.

The reference has no framework CLI: its tutorials hand-write a run_simulation
function (/root/reference/tutorials/holstein_honeycomb.jl:53-543, SURVEY.md
section 1 L7). This module packages that flow as a reusable driver: model
expansion, QMC context/state setup, a jitted (reflection + swap [+ radial] + HMC)
sweep, measurement passes with bin-averaged .npz output, chemical-potential
tuning, wall-clock-gated checkpoint/resume with runtime-limit self-termination,
and final statistics processing. The examples/ scripts mirror the reference's
tutorials and examples on top of this driver."""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from .io.checkpoint import delete_checkpoints, read_checkpoint, runtime_exceeded, write_checkpoint
from .io.measurements_io import merge_bins, process_measurements, write_measurement_bin
from .io.simulation_info import SimulationInfo, initialize_datafolder, model_summary, save_simulation_info
from .measure.container import MeasurementAccumulator, MeasurementSpec, make_measurements
from .measure.greens_estimator import build_greens_estimator, update_greens_estimator
from .measure.scalar import measure_n, measure_Nsqrd
from .models.electron_phonon import ElectronPhononParameters
from .models.tight_binding import TightBindingParameters
from .updates.context import QMCState, initialize_qmc, make_fdm
from .updates.global_updates import radial_update, reflection_update, swap_update
from .updates.hmc import HMCParams, hmc_update
from .updates.mu_tuner import MuTunerState, init_mu_tuner, mu_tuner_update
from .utils.compile_cache import enable_compile_cache


@dataclasses.dataclass
class SimulationConfig:
    beta: float
    dtau: float = 0.05
    N_therm: int = 100
    N_measurements: int = 100
    N_bins: int = 10
    Nt: int = 24
    hmc_dt: float = 0.0  # leapfrog timestep; 0 -> pi / (2 Nt)
    hmc_jitter: float = 0.05  # +-fractional timestep noise per trajectory
    # 'leapfrog' (reference-matching) or 'omelyan' (2nd-order minimum-norm:
    # 2 solves/step, ~3x the stable timestep -- run with ~Nt/3 steps)
    hmc_integrator: str = "leapfrog"
    # None = fixed timestep. A value in (0, 1) targets that HMC acceptance
    # rate: during thermalization dt follows the stochastic approximation
    # dt <- dt * exp(0.08 (accepted - target)), clamped to [dt0/8, 8 dt0],
    # then freezes for the measurement phase. Exactness is unaffected
    # (Metropolis corrects any integrator error at every dt); this only
    # trades acceptance against trajectory length.
    target_acceptance: Optional[float] = None
    eta: float = 0.0  # EFA mass-regularization (ExactFourierAccelerator eta)
    Nrv: int = 10
    tol: float = 1e-10
    maxiter: int = 10_000
    seed: int = 1
    symmetric: bool = True
    use_radial_updates: bool = False
    target_density: Optional[float] = None  # enables mu tuning
    checkpoint_freq_hours: float = np.inf
    runtime_limit_hours: float = np.inf
    use_preconditioner: bool = True
    preconditioner: Optional[str] = None  # 'auto' (default) | 'spectral' | 'kpm' | 'none'
    # f32 Krylov inner solves + f64 defect correction for the f64 action /
    # measurement solves; converges to the f64 solution of the f64 operator
    # (ops/cg.py:cg_solve_mixed), so accuracy is unchanged while the inner
    # iterations run at f32 speed
    mixed_precision: bool = True
    # contraction-engine dtype: f32 rounding (~1e-7) is far below statistical
    # noise
    measurement_dtype: str = "float32"
    # leapfrog force-solve dtype: forces only shape the proposal (tolerance
    # sqrt(tol) ~ 1e-5); Metropolis exactness rests on the f64 endpoint actions
    force_dtype: str = "float32"
    # estimator-refresh solve dtype. None = follow measurement_dtype: the Nrv
    # random-vector solves only bias observables at the solve tolerance (f32
    # floor 2e-5), 3-4 orders below the stochastic noise and below the f32
    # rounding of the stored GR fields; Markov exactness never involves them.
    # Set 'float64' to recover full-precision measurement solves
    measure_solve_dtype: Optional[str] = None
    n_walkers: int = 1  # > 1: vmapped walker axis, one bin stream per walker (pID)
    # Multi-walker preconditioner refresh policy. True = ONE refresh per sweep
    # from the walker-mean propagator (parallel/walkers.shared_precond_refresh;
    # a vmapped eigh batches poorly). Iteration-neutral when walker propagators
    # agree; guarded by an automatic fallback: if a sweep's mean trajectory-CG
    # iteration count exceeds precond_fallback_ratio x the best sweep seen so
    # far (strong coupling / early thermalization, where walkers genuinely
    # differ), subsequent sweeps refresh PER WALKER, re-probing shared mode
    # every precond_retry_every sweeps. False = always refresh per walker.
    shared_precond: bool = True
    precond_fallback_ratio: float = 1.5
    precond_retry_every: int = 32
    # Sweeps fused into ONE dispatched executable (lax.scan over the sweep
    # body), amortizing the per-dispatch host overhead k-fold. Batch
    # boundaries are aligned to the ABSOLUTE sweep-index grid (k = distance
    # to the next multiple of sweeps_per_dispatch, clipped to bin/phase
    # ends), so an interrupted+resumed run partitions sweeps identically to
    # an uninterrupted one (bit-identical resume is verified on the CPU;
    # on a GPU, atomic scatter-adds may reorder sums). Forced to 1
    # when mu tuning is active (the tuner feeds mu back on the host every
    # sweep). k > 1 coarsens checkpoint/runtime-limit checks and the
    # precond-fallback controller's feedback to batch granularity;
    # device-side dt targeting is unaffected (it updates inside the scan).
    # Each DISTINCT batch size compiles its own scan program: keep N_therm,
    # the bin size (N_measurements / N_bins), and N_measurements multiples
    # of this value or the ragged tail batches pay extra compiles.
    sweeps_per_dispatch: int = 1


def _mark(label: str, t0: float) -> float:
    """Optional coarse phase-timing trace (SMOQY_DRIVER_TIMING=1): prints the
    wall time since the previous mark. The driver's jitted loops are async;
    these marks bracket the HOST-side phases (init / compile / finalize) that
    dominate small runs and are otherwise invisible."""
    import os

    t1 = time.time()
    if os.environ.get("SMOQY_DRIVER_TIMING") == "1":
        print(f"[driver-timing] {label}: {t1 - t0:.1f}s", flush=True)
    return t1


def _msolve_dtype(cfg: SimulationConfig) -> Optional[str]:
    """Estimator-refresh solve dtype: explicit cfg.measure_solve_dtype override,
    else follow cfg.measurement_dtype (None = full-precision rhs dtype)."""
    dt = cfg.measure_solve_dtype or cfg.measurement_dtype
    return "float32" if jnp.dtype(dt) == jnp.float32 else None


def fold_kpm_diagnostics(metadata: Dict, precond) -> None:
    """Fold the carried KPM preconditioner's self-diagnostics into the run
    metadata (-> simulation_info.toml) and warn visibly on deactivation.

    The reference @warn-s when its KPM preconditioner self-deactivates
    (/root/reference/src/KPMPreconditioner.jl:573-594 semantics); here the
    final carried state records (a) whether KPM deactivated — live Lanczos
    bounds out of the valid window or the truncation-positivity guard fired —
    in which case CG ran UNPRECONDITIONED, and (b) how many frequencies wanted
    a higher Chebyshev order than the static cap allowed (silent quality
    loss). Multi-walker states carry (W,)-shaped leaves; reduce over walkers.
    No-op for non-KPM preconditioners (spectral/None have no `active`)."""
    import warnings

    if precond is None or not hasattr(precond, "active") or not hasattr(
        precond, "order_clip_count"
    ):
        return

    def read(a):
        # multihost: a (W,)-leaf sharded over the global mesh is not np-readable
        # from one process — reduce over this host's addressable shards only
        if hasattr(a, "is_fully_addressable") and not a.is_fully_addressable:
            return np.concatenate(
                [np.atleast_1d(np.asarray(s.data)) for s in a.addressable_shards]
            )
        return np.asarray(a)

    active = read(precond.active)
    clips = read(precond.order_clip_count)
    n_inactive = int(np.sum(~active)) if active.ndim else int(not active)
    metadata["kpm_active"] = bool(np.all(active))
    metadata["kpm_inactive_walkers"] = n_inactive
    metadata["kpm_order_clip_count"] = int(np.max(clips))
    if n_inactive:
        warnings.warn(
            f"KPM preconditioner DEACTIVATED in the final state ({n_inactive} "
            "walker(s)): Lanczos bounds outside the valid window or the "
            "truncation-positivity guard fired — those CG solves ran "
            "unpreconditioned. Consider raising cap_max / n_lanczos or "
            "switching preconditioner='spectral'.",
            stacklevel=2,
        )
    if int(np.max(clips)) > 0:
        warnings.warn(
            f"KPM order cap clipped {int(np.max(clips))} frequency orders in "
            "the final refresh: the static cap_max bounds the Chebyshev fit "
            "below its requested order (preconditioner quality silently "
            "degraded; CG iteration counts may rise).",
            stacklevel=2,
        )


def run_simulation(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    recenter: Optional[Callable] = None,
    resume: bool = True,
) -> Dict:
    """Full simulation: thermalize, measure into bins, post-process. Returns the
    metadata dict (acceptance rates, CG iteration averages — the reference's
    simulation_info.toml content, tutorials/holstein_honeycomb.jl:110-130).

    With cfg.n_walkers > 1 the chain state carries a leading walker axis
    (sharded over the device mesh when several devices are visible); each walker
    writes its own pID-tagged bin stream, replacing the reference's MPI ranks."""
    enable_compile_cache()
    if cfg.n_walkers > 1:
        return _run_multiwalker(
            sim_info, tight_binding_model, electron_phonon_model, spec, cfg, recenter, resume
        )
    start_time = time.time()
    initialize_datafolder(sim_info)
    geo = spec.geometry
    model_summary(
        sim_info, cfg.beta, cfg.dtau, geo, tight_binding_model, (electron_phonon_model,)
    )

    rng = np.random.default_rng(cfg.seed)
    _t = _mark("datafolder+summary", start_time)
    tbp = TightBindingParameters.from_model(tight_binding_model, rng)
    elph = ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, electron_phonon_model, tbp, rng)
    ctx, state = initialize_qmc(
        tbp,
        elph,
        seed=cfg.seed,
        symmetric=cfg.symmetric,
        tol=cfg.tol,
        maxiter=cfg.maxiter,
        eta=cfg.eta,
        use_preconditioner=cfg.use_preconditioner,
        preconditioner=cfg.preconditioner,
        mixed_precision=cfg.mixed_precision,
        force_dtype=cfg.force_dtype,
    )
    _t = _mark("initialize_qmc", _t)
    est = build_greens_estimator(
        elph.Ltau, geo.n_orbitals, geo.L, Nrv=cfg.Nrv, dtype=cfg.measurement_dtype
    )
    _t = _mark("build_greens_estimator", _t)
    hmc_params = HMCParams(
        Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, integrator=cfg.hmc_integrator
    )

    tuner: Optional[MuTunerState] = None
    tuning_history = []
    tune_step = jax.jit(mu_tuner_update)  # one dispatch per update, not one per op
    if cfg.target_density is not None:
        tuner = init_mu_tuner(
            cfg.target_density, cfg.beta, tbp.n_sites, float(np.asarray(tbp.mu))
        )

    metadata: Dict = {
        "N_therm": cfg.N_therm,
        "N_measurements": cfg.N_measurements,
        "N_bins": cfg.N_bins,
        "Nt": cfg.Nt,
        "Nrv": cfg.Nrv,
        "tol": cfg.tol,
        "maxiter": cfg.maxiter,
        "seed": cfg.seed,
        "hmc_acceptance_rate": 0.0,
        "reflection_acceptance_rate": 0.0,
        "swap_acceptance_rate": 0.0,
        "radial_acceptance_rate": 0.0,
        "hmc_iters": 0.0,
        "reflection_iters": 0.0,
        "swap_iters": 0.0,
        "measurement_iters": 0.0,
        "cg_converged_rate": 0.0,
        "measurement_converged_rate": 0.0,
    }

    # ------------------------------------------------------------------
    # jitted kernels
    # ------------------------------------------------------------------
    # per-sweep statistics ride a single device vector so the host loop never
    # blocks on device->host transfers mid-bin. Order: [refl_acc, swap_acc,
    # rad_acc, hmc_acc, refl_iters, swap_iters, hmc_iters, cg_converged]
    _STAT_KEYS = (
        "reflection_acceptance_rate", "swap_acceptance_rate",
        "radial_acceptance_rate", "hmc_acceptance_rate",
        "reflection_iters", "swap_iters", "hmc_iters", "cg_converged_rate",
    )

    # dt rides the jit as a traced argument (HMCParams.dt is a pytree leaf), so
    # acceptance-targeted tuning never recompiles the sweep program
    dt0 = float(hmc_params.timestep())

    def _sweep_once(ctx_, state_: QMCState, acc_vec, dt_):
        state_, r_stats = reflection_update(ctx_, state_)
        state_, s_stats = swap_update(ctx_, state_)
        if cfg.use_radial_updates:
            state_, rad_stats = radial_update(ctx_, state_)
        else:
            rad_stats = r_stats
        state_, h_stats = hmc_update(
            ctx_, state_, hmc_params.replace(dt=dt_), recenter=recenter
        )
        vec = jnp.stack([
            r_stats.accepted.astype(jnp.float64),
            s_stats.accepted.astype(jnp.float64),
            rad_stats.accepted.astype(jnp.float64),
            h_stats.accepted.astype(jnp.float64),
            r_stats.iters.astype(jnp.float64),
            s_stats.iters.astype(jnp.float64),
            h_stats.iters_avg,
            # every solve of this sweep converged (non-convergence rejects)
            (r_stats.converged & s_stats.converged & rad_stats.converged
             & h_stats.converged).astype(jnp.float64),
        ])
        if cfg.target_acceptance is not None:
            step = 0.08 * (h_stats.accepted.astype(jnp.float64) - cfg.target_acceptance)
            dt_ = jnp.clip(dt_ * jnp.exp(step), dt0 / 8.0, 8.0 * dt0)
        # accumulate inside the jit — an eager per-sweep add costs a dispatch
        # of its own
        return state_, acc_vec + vec, dt_

    sweep = jax.jit(_sweep_once)

    def _measure_once(ctx_, state_: QMCState, est_, key, iters_acc):
        # the RNG split happens inside the jit (an eager split per sweep costs a
        # dispatch roundtrip); returns the advanced key
        key, sub = jax.random.split(key)
        fdm = make_fdm(ctx_, state_.x)
        upd = update_greens_estimator(
            est_, fdm, sub, precond=state_.precond, tol=cfg.tol, maxiter=cfg.maxiter,
            mixed=cfg.mixed_precision, solve_dtype=_msolve_dtype(cfg),
        )
        out = make_measurements(ctx_, spec, upd.estimator, state_.x)
        n_re, _ = measure_n(upd.estimator)
        Nsq_re, _ = measure_Nsqrd(upd.estimator)
        # iters_acc: [solve iterations, converged passes]
        iters_acc = iters_acc + jnp.stack(
            [upd.iters.astype(jnp.float64), upd.converged.astype(jnp.float64)]
        )
        return upd.estimator, out, iters_acc, 2.0 * n_re, Nsq_re, key

    @jax.jit
    def measured_step(ctx_, state_: QMCState, est_, key, iters_acc, sums, acc_vec, dt_):
        """ONE executable per measured sweep: update sweep + estimator refresh
        + measurement pass + device-side bin accumulation. Alternating between
        separate sweep / measure / accumulate executables costs three
        dispatches per sweep."""
        state_, acc_vec, _ = _sweep_once(ctx_, state_, acc_vec, dt_)
        est_, out, iters_acc, n, Nsq, key = _measure_once(ctx_, state_, est_, key, iters_acc)
        sums = jax.tree_util.tree_map(jnp.add, sums, out)
        return state_, acc_vec, est_, sums, iters_acc, n, Nsq, key

    # k-sweep batched variants (cfg.sweeps_per_dispatch > 1): lax.scan over
    # the SAME bodies, one dispatch + one host sync per k sweeps. Static k is
    # compiled per distinct value; batch sizes come from the absolute-grid
    # alignment in the loops below, so only k_disp (and at most one bin/phase
    # tail size) ever compiles.
    @functools.partial(jax.jit, static_argnames="k")
    def sweep_k(ctx_, state_, acc_vec, dt_, *, k):
        def body(carry, _):
            s, a, d = carry
            s, a, d = _sweep_once(ctx_, s, a, d)
            return (s, a, d), None

        (state_, acc_vec, dt_), _ = jax.lax.scan(
            body, (state_, acc_vec, dt_), None, length=k
        )
        return state_, acc_vec, dt_

    @functools.partial(jax.jit, static_argnames="k")
    def measured_step_k(ctx_, state_, est_, key, iters_acc, sums, acc_vec, dt_, *, k):
        def body(carry, _):
            s, e, ky, ia, sm, a = carry
            s, a, _ = _sweep_once(ctx_, s, a, dt_)
            e, out, ia, _, _, ky = _measure_once(ctx_, s, e, ky, ia)
            sm = jax.tree_util.tree_map(jnp.add, sm, out)
            return (s, e, ky, ia, sm, a), None

        (state_, est_, key, iters_acc, sums, acc_vec), _ = jax.lax.scan(
            body, (state_, est_, key, iters_acc, sums, acc_vec), None, length=k
        )
        return state_, acc_vec, est_, sums, iters_acc, key

    @jax.jit
    def tune_pass(ctx_, state_: QMCState, est_, key):
        key, sub = jax.random.split(key)
        fdm = make_fdm(ctx_, state_.x)
        upd = update_greens_estimator(
            est_, fdm, sub, precond=state_.precond, tol=cfg.tol, maxiter=cfg.maxiter,
            mixed=cfg.mixed_precision, solve_dtype=_msolve_dtype(cfg),
        )
        n_re, _ = measure_n(upd.estimator)
        Nsq_re, _ = measure_Nsqrd(upd.estimator)
        return upd.estimator, upd.iters, 2.0 * n_re, Nsq_re, key

    def set_mu(ctx_, mu):
        return ctx_.replace(tbp=ctx_.tbp.replace(mu=jnp.asarray(mu)))

    # ------------------------------------------------------------------
    # resume
    # ------------------------------------------------------------------
    therm_done = 0
    meas_done = 0
    cp_stamp: Optional[float] = None
    bin_size = max(cfg.N_measurements // cfg.N_bins, 1)
    acc = MeasurementAccumulator(spec)
    key_host = jax.random.PRNGKey(cfg.seed + 7919)
    sweep_acc = jnp.zeros(len(_STAT_KEYS))  # device-side running sums
    meas_iters_acc = jnp.zeros((2,), jnp.float64)
    dt_cur = jnp.asarray(dt0, jnp.float64)

    def sync_metadata():
        """Fold the device accumulators into metadata (host sync point)."""
        nonlocal sweep_acc, meas_iters_acc
        vals = np.asarray(sweep_acc)
        for k, v in zip(_STAT_KEYS, vals):
            metadata[k] += float(v)
        meas = np.asarray(meas_iters_acc)
        metadata["measurement_iters"] += float(meas[0])
        metadata["measurement_converged_rate"] += float(meas[1])
        sweep_acc = jnp.zeros(len(_STAT_KEYS))
        meas_iters_acc = jnp.zeros((2,), jnp.float64)

    if resume:
        cp = read_checkpoint(sim_info.datafolder, sim_info.pID)
        if cp is not None:
            s = cp["state"]
            state = QMCState(
                x=jnp.asarray(s["x"]), key=jnp.asarray(s["key"]), precond=state.precond
            )
            therm_done = int(s["therm_done"])
            meas_done = int(s["meas_done"])
            metadata.update(s["metadata"])
            if tuner is not None and s.get("tuner") is not None:
                tuner = tuner.replace(**{k: jnp.asarray(v) for k, v in s["tuner"].items()})
                ctx = set_mu(ctx, tuner.mu)
            # partial-bin accumulator + host measurement RNG: restoring both makes
            # a mid-bin resume bit-identical to an uninterrupted run (the reference
            # checkpoints the full measurement container, _checkpoint.jl:516-531)
            if s.get("key_host") is not None:
                key_host = jnp.asarray(s["key_host"])
            if s.get("hmc_dt") is not None:
                dt_cur = jnp.asarray(s["hmc_dt"])
            if s.get("acc_sums") is not None:
                acc.sums = s["acc_sums"]
                acc.count = int(s["acc_count"])
            if s.get("tuning_history"):
                tuning_history = [tuple(t) for t in s["tuning_history"]]

    def maybe_checkpoint():
        nonlocal cp_stamp
        # frequency gate FIRST (same test write_checkpoint applies) so a
        # closed gate costs nothing per sweep
        if cp_stamp is not None and (
            time.time() - cp_stamp
        ) < cfg.checkpoint_freq_hours * 3600.0:
            return
        sync_metadata()
        tree = {
            "x": state.x,
            "key": state.key,
            "key_host": key_host,
            "hmc_dt": dt_cur,
            "therm_done": therm_done,
            "meas_done": meas_done,
            "metadata": dict(metadata),
            "acc_sums": acc.sums,
            "acc_count": acc.count,
            "tuning_history": list(tuning_history),
            "tuner": None
            if tuner is None
            else {
                "mu": tuner.mu,
                "t": tuner.t,
                "mu_sum": tuner.mu_sum,
                "n_sum": tuner.n_sum,
                "N_sum": tuner.N_sum,
                "Nsq_sum": tuner.Nsq_sum,
                "weight": tuner.weight,
            },
        }
        cp_stamp = write_checkpoint(
            sim_info.datafolder,
            tree,
            pID=sim_info.pID,
            checkpoint_timestamp=cp_stamp,
            checkpoint_freq_hours=cfg.checkpoint_freq_hours,
        )

    def out_of_time() -> bool:
        return runtime_exceeded(start_time, cfg.runtime_limit_hours)

    # ------------------------------------------------------------------
    # thermalize
    # ------------------------------------------------------------------
    # phase wall-clock instrumentation: the FIRST sweep of each phase carries
    # the trace+compile cost, so whole-simulation scaling studies
    # (scripts/e2e_scaling.py) read post-compile sweep costs from metadata
    # instead of cold/warm process pairs
    # sweep batching (cfg.sweeps_per_dispatch): k sweeps per dispatched
    # executable, batch boundaries on the ABSOLUTE sweep-index grid so an
    # interrupted+resumed run partitions sweeps exactly like an uninterrupted
    # one. Forced to 1 when mu tuning is active (host feedback per sweep).
    k_disp = max(int(getattr(cfg, "sweeps_per_dispatch", 1)), 1)
    if tuner is not None:
        k_disp = 1

    def _batch(done, *ends):
        k = k_disp - done % k_disp
        for e in ends:
            k = min(k, e - done)
        return max(k, 1)

    t_phase = time.time()
    n_timed = 0
    while therm_done < cfg.N_therm:
        k = _batch(therm_done, cfg.N_therm)
        if k == 1:
            state, sweep_acc, dt_cur = sweep(ctx, state, sweep_acc, dt_cur)
        else:
            state, sweep_acc, dt_cur = sweep_k(ctx, state, sweep_acc, dt_cur, k=k)
        if tuner is not None:
            est, iters, n, Nsq, key_host = tune_pass(ctx, state, est, key_host)
            tuner = tune_step(tuner, n, Nsq)
            ctx = set_mu(ctx, tuner.mu)
            tuning_history.append((tuner.mu, n, Nsq))  # device scalars, lazy
        therm_done += k
        n_timed += k
        if n_timed == k:
            jax.block_until_ready(dt_cur)
            metadata["t_first_therm_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_therm_batch"] = k
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time():
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, state.precond)
            return metadata
    if n_timed:
        jax.block_until_ready(dt_cur)
        metadata["t_therm_s"] = round(time.time() - t_phase, 3)
        metadata["n_therm_timed"] = n_timed

    # ------------------------------------------------------------------
    # measure
    # ------------------------------------------------------------------
    # zeros template for the device-carried bin sums (shape-only trace)
    sums_struct = jax.eval_shape(
        lambda c, e, x: make_measurements(c, spec, e, x), ctx, est, state.x
    )
    sums0 = jax.tree_util.tree_map(
        lambda sd: jnp.zeros(sd.shape, sd.dtype), sums_struct
    )
    if acc.sums is not None:
        # mid-bin resume: continue the restored partial-bin sums on device
        sums_dev = jax.tree_util.tree_map(jnp.asarray, acc.sums)
    else:
        sums_dev = sums0
    t_phase = time.time()
    n_timed = 0
    while meas_done < cfg.N_measurements:
        # dt frozen after thermalization (the tuned value is NOT fed back)
        k = _batch(
            meas_done, cfg.N_measurements,
            meas_done + bin_size - meas_done % bin_size,
        )
        if k == 1:
            state, sweep_acc, est, sums_dev, meas_iters_acc, n, Nsq, key_host = measured_step(
                ctx, state, est, key_host, meas_iters_acc, sums_dev, sweep_acc, dt_cur
            )
        else:
            state, sweep_acc, est, sums_dev, meas_iters_acc, key_host = measured_step_k(
                ctx, state, est, key_host, meas_iters_acc, sums_dev, sweep_acc, dt_cur,
                k=k,
            )
        if tuner is not None:
            tuner = tune_step(tuner, n, Nsq)
            ctx = set_mu(ctx, tuner.mu)
            tuning_history.append((tuner.mu, n, Nsq))  # device scalars, lazy
        acc.sums = sums_dev
        acc.count += k
        meas_done += k
        n_timed += k
        if n_timed == k:
            jax.block_until_ready(meas_iters_acc)
            metadata["t_first_measured_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_measured_batch"] = k
        if meas_done % bin_size == 0:
            bin_index = meas_done // bin_size - 1
            write_measurement_bin(sim_info, bin_index, acc.finalize_bin(), spec, dtau=cfg.dtau)
            sums_dev = sums0
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time() and meas_done < cfg.N_measurements:
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, state.precond)
            return metadata
    if n_timed:
        jax.block_until_ready(meas_iters_acc)
        metadata["t_measure_s"] = round(time.time() - t_phase, 3)
        metadata["n_measure_timed"] = n_timed

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------
    sync_metadata()
    n_updates = cfg.N_therm + cfg.N_measurements
    for k in ("hmc", "reflection", "swap", "radial"):
        metadata[f"{k}_acceptance_rate"] /= max(n_updates, 1)
    metadata["hmc_iters"] /= max(n_updates, 1)
    metadata["cg_converged_rate"] /= max(n_updates, 1)
    metadata["reflection_iters"] /= max(n_updates, 1)
    metadata["swap_iters"] /= max(n_updates, 1)
    metadata["measurement_iters"] /= max(cfg.N_measurements, 1)
    metadata["measurement_converged_rate"] /= max(cfg.N_measurements, 1)
    fold_kpm_diagnostics(metadata, state.precond)
    if cfg.target_acceptance is not None:
        metadata["hmc_dt_final"] = float(np.asarray(dt_cur))
    if tuner is not None:
        metadata["final_mu"] = float(np.asarray(tuner.mu))
        from .io.simulation_info import save_density_tuning_profile

        save_density_tuning_profile(sim_info, tuning_history)

    _t = _mark("loops-done", start_time)
    merge_bins(sim_info)
    _t = _mark("merge_bins", _t)
    save_simulation_info(sim_info, metadata)
    process_measurements(sim_info.datafolder, n_bins=cfg.N_bins, spec=spec)
    _t = _mark("process_measurements", _t)
    delete_checkpoints(sim_info.datafolder, sim_info.pID)
    return metadata


def _run_multiwalker(
    sim_info: SimulationInfo,
    tight_binding_model,
    electron_phonon_model,
    spec: MeasurementSpec,
    cfg: SimulationConfig,
    recenter=None,
    resume: bool = True,
) -> Dict:
    """Walker-axis variant of run_simulation: W independent chains advance as one
    vmapped program (sharded over the device mesh when possible); per-walker bin
    streams are tagged by pID exactly like the reference's MPI ranks
    (tutorials/holstein_honeycomb_mpi.jl:59-72).

    Full parity with the single-walker path: radial updates, a cheap tuning pass
    during thermalization, per-walker density-tuning profiles, and wall-clock-gated
    checkpoint/resume (incl. the partial-bin accumulators and host RNG, so the MPI
    + checkpoint tutorial composition, holstein_honeycomb_checkpoint.jl:383-416,
    carries over).

    MULTI-HOST: when `jax.distributed.initialize()` was called with more than one
    process (parallel.distributed.initialize_distributed), the walker axis is
    sharded over the GLOBAL mesh and every host runs this same driver program
    SPMD. Each host then writes ONLY the bin files / tuning profiles of its own
    walkers (parallel.distributed.local_walker_ids — the per-rank output files of
    the reference's MPI tutorial, holstein_honeycomb_mpi.jl:59-72), checkpoints
    its local walker block under its process index, and process 0 alone
    initializes the datafolder and runs the final statistics merge. Multi-host
    callers should pass an explicit sID in SimulationInfo (the auto-increment
    scans the filesystem and can race across hosts)."""
    from .parallel.distributed import (
        barrier,
        global_walker_array,
        global_walker_mesh,
        local_walker_block,
        local_walker_ids,
        walker_row,
        walker_row_tree,
    )
    from .parallel.walkers import (
        init_walker_states,
        shard_walker_states,
        walker_device_count,
        walker_mesh,
    )

    start_time = time.time()
    multihost = jax.process_count() > 1
    proc = jax.process_index()
    if not multihost or proc == 0:
        initialize_datafolder(sim_info)
    geo = spec.geometry
    if not multihost or proc == 0:
        model_summary(
            sim_info, cfg.beta, cfg.dtau, geo, tight_binding_model, (electron_phonon_model,)
        )
    barrier("datafolder_init")

    rng = np.random.default_rng(cfg.seed)
    tbp = TightBindingParameters.from_model(tight_binding_model, rng)
    elph = ElectronPhononParameters.from_model(cfg.beta, cfg.dtau, electron_phonon_model, tbp, rng)
    ctx, state0 = initialize_qmc(
        tbp, elph, seed=cfg.seed, symmetric=cfg.symmetric, tol=cfg.tol,
        maxiter=cfg.maxiter, eta=cfg.eta, use_preconditioner=cfg.use_preconditioner,
        preconditioner=cfg.preconditioner, mixed_precision=cfg.mixed_precision,
        force_dtype=cfg.force_dtype,
    )
    W = cfg.n_walkers
    if multihost:
        # global mesh over every process's devices; each host owns the walkers
        # whose shards live on its devices (W must divide evenly)
        mesh = global_walker_mesh()
        owned = list(local_walker_ids(mesh, W))
    else:
        mesh = walker_mesh(walker_device_count(W, len(jax.devices())))
        owned = list(range(W))

    def carry(a, walker_axis: bool = False):
        """Commit a single-host loop carry to the mesh layout the jitted steps
        return it in: an uncommitted first input would make every step
        program compile twice, once for each input layout."""
        if multihost:
            return a
        spec = PartitionSpec("walkers") if walker_axis else PartitionSpec()
        return jax.device_put(a, NamedSharding(mesh, spec))

    states = shard_walker_states(init_walker_states(ctx, state0, W, seed=cfg.seed + 1), mesh)
    est = build_greens_estimator(
        elph.Ltau, geo.n_orbitals, geo.L, Nrv=cfg.Nrv, dtype=cfg.measurement_dtype
    )
    hmc_params = HMCParams(
        Nt=cfg.Nt, dt=cfg.hmc_dt, jitter=cfg.hmc_jitter, integrator=cfg.hmc_integrator
    )

    # per-walker chemical potential: each chain tunes its own mu, exactly like the
    # reference's independent MPI ranks. mu always rides a per-walker context leaf
    # so one jitted program serves both the tuned and fixed-mu cases.
    mu0 = float(np.asarray(tbp.mu))
    mu_walkers = carry(jnp.full((W,), mu0), walker_axis=True)
    tuners = None
    # one (mu, n, N2) triple per tuner update; (W,) device vectors single-host,
    # owned-walker numpy blocks multi-host (a cross-host array is not readable)
    tuning_history_vecs = []
    if cfg.target_density is not None:
        t0 = init_mu_tuner(cfg.target_density, cfg.beta, tbp.n_sites, mu0)
        tuners = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (W,) + jnp.shape(a)), t0)
        tune_step = jax.jit(jax.vmap(mu_tuner_update))

    def hist_entry(mu, n, N2):
        if multihost:
            return tuple(local_walker_block(a, owned) for a in (mu, n, N2))
        return (mu, n, N2)

    def with_mu(ctx_, mu):
        return ctx_.replace(tbp=ctx_.tbp.replace(mu=mu))

    from .measure.greens_estimator import update_greens_estimator as _upd_est
    from .measure.scalar import measure_n as _m_n, measure_Nsqrd as _m_N2

    _STAT_KEYS = (
        "reflection_acceptance_rate", "swap_acceptance_rate",
        "radial_acceptance_rate", "hmc_acceptance_rate",
        "reflection_iters", "swap_iters", "hmc_iters", "cg_converged_rate",
    )

    from .parallel.walkers import shared_precond_refresh

    dt0 = float(hmc_params.timestep())

    def _sweep_body(s, mus, acc_vec, dt_, shared: bool):
        if shared:
            # ONE preconditioner refresh per sweep from the walker-mean
            # propagator (vmapped eigh batches poorly; iteration counts are
            # unchanged when walker propagators agree — see
            # parallel/walkers.py:shared_precond_refresh)
            s = shared_precond_refresh(with_mu(ctx, jnp.mean(mus)), s)
            refresh_in_hmc = s.precond is None
        else:
            # per-walker refresh inside hmc_update (fallback for strong
            # coupling / early thermalization, where walkers genuinely differ)
            refresh_in_hmc = True
        hmc_p = hmc_params.replace(refresh_precond_at_start=refresh_in_hmc, dt=dt_)

        def one(s1, mu):
            c = with_mu(ctx, mu)
            s1, r = reflection_update(c, s1)
            s1, sw = swap_update(c, s1)
            if cfg.use_radial_updates:
                s1, rad = radial_update(c, s1)
            else:
                rad = r
            s1, h = hmc_update(c, s1, hmc_p, recenter=recenter)
            vec = jnp.stack([
                r.accepted.astype(jnp.float64),
                sw.accepted.astype(jnp.float64),
                rad.accepted.astype(jnp.float64),
                h.accepted.astype(jnp.float64),
                r.iters.astype(jnp.float64),
                sw.iters.astype(jnp.float64),
                h.iters_avg,
                (r.converged & sw.converged & rad.converged & h.converged).astype(jnp.float64),
            ])
            return s1, vec

        s, vecs = jax.vmap(one)(s, mus)
        if cfg.target_acceptance is not None:
            # ONE shared dt, driven by the walker-mean acceptance
            step = 0.08 * (jnp.mean(vecs[:, 3]) - cfg.target_acceptance)
            dt_ = jnp.clip(dt_ * jnp.exp(step), dt0 / 8.0, 8.0 * dt0)
        m = jnp.mean(vecs, axis=0)
        # walker-averaged per-sweep stats accumulated inside the jit; m[6] is
        # this sweep's mean trajectory-CG iteration count (fallback controller)
        return s, acc_vec + m, dt_, m[6]

    sweep_shared = jax.jit(lambda s, mus, a, d: _sweep_body(s, mus, a, d, True))
    sweep_perwalker = jax.jit(lambda s, mus, a, d: _sweep_body(s, mus, a, d, False))

    # preconditioner-refresh fallback controller (host side; see
    # parallel/walkers.PrecondFallbackController). shared_precond=False pins
    # per-walker refresh by disabling the controller with mode preset.
    from .parallel.walkers import PrecondFallbackController

    pc = PrecondFallbackController(
        ratio=cfg.precond_fallback_ratio,
        retry_every=cfg.precond_retry_every,
        enabled=cfg.shared_precond and states.precond is not None,
    )
    if not cfg.shared_precond:
        pc.mode = "perwalker"
    metadata_fallback = {"n": 0}  # mirrors pc.fallback_sweeps across resume

    def run_sweep(s, mus, acc_vec, dt_, k=1):
        if not pc.enabled:
            use_shared = pc.mode == "shared"
            if not use_shared:
                metadata_fallback["n"] += k
            if k == 1:
                fn = sweep_shared if use_shared else sweep_perwalker
                s, acc_vec, dt_, _ = fn(s, mus, acc_vec, dt_)
            else:
                s, acc_vec, dt_, _ = sweep_k_mw(
                    s, mus, acc_vec, dt_, k=k, shared=use_shared
                )
            return s, acc_vec, dt_
        use_shared = pc.choose()
        if k == 1:
            fn = sweep_shared if use_shared else sweep_perwalker
            s, acc_vec, dt_, it_dev = fn(s, mus, acc_vec, dt_)
        else:
            s, acc_vec, dt_, it_dev = sweep_k_mw(
                s, mus, acc_vec, dt_, k=k, shared=use_shared
            )
        pc.record(it_dev, use_shared)
        if not use_shared:
            metadata_fallback["n"] += k
        return s, acc_vec, dt_

    def run_measured(s, mus, acc_vec, dt_, key, iters_acc, msums, k=1):
        """Measured-sweep twin of run_sweep: same fallback-controller choice,
        fused sweep+measure executable (dt discarded — frozen). k > 1 runs
        the batched scan twin; the (n_w, N2_w) tuner outputs are only defined
        for k == 1 (mu tuning forces k = 1)."""
        if not pc.enabled:
            use_shared = pc.mode == "shared"
            if not use_shared:
                metadata_fallback["n"] += k
            if k == 1:
                fn = measured_shared if use_shared else measured_perwalker
                s, acc_vec, _, key, iters_acc, msums, n_w, N2_w = fn(
                    s, mus, acc_vec, dt_, key, iters_acc, msums
                )
            else:
                s, acc_vec, _, key, iters_acc, msums = measured_k_mw(
                    s, mus, acc_vec, dt_, key, iters_acc, msums,
                    k=k, shared=use_shared,
                )
                n_w = N2_w = None
            return s, acc_vec, key, iters_acc, msums, n_w, N2_w
        use_shared = pc.choose()
        if k == 1:
            fn = measured_shared if use_shared else measured_perwalker
            s, acc_vec, it_dev, key, iters_acc, msums, n_w, N2_w = fn(
                s, mus, acc_vec, dt_, key, iters_acc, msums
            )
        else:
            s, acc_vec, it_dev, key, iters_acc, msums = measured_k_mw(
                s, mus, acc_vec, dt_, key, iters_acc, msums,
                k=k, shared=use_shared,
            )
            n_w = N2_w = None
        pc.record(it_dev, use_shared)
        if not use_shared:
            metadata_fallback["n"] += k
        return s, acc_vec, key, iters_acc, msums, n_w, N2_w

    def _refresh_est(s1, key, mu):
        c = with_mu(ctx, mu)
        fdm = make_fdm(c, s1.x)
        upd = _upd_est(
            est, fdm, key, precond=s1.precond, tol=cfg.tol,
            maxiter=cfg.maxiter, mixed=cfg.mixed_precision,
            solve_dtype=_msolve_dtype(cfg),
        )
        n_re, _ = _m_n(upd.estimator)
        N2_re, _ = _m_N2(upd.estimator)
        return c, upd, 2.0 * n_re, N2_re

    @jax.jit
    def tune(s, key, mus):
        # cheap thermalization pass: estimator refresh + (n, N^2) only — no
        # correlation contractions (the single-walker tune_pass equivalent)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, W)

        def one(s1, k, mu):
            _, upd, n, N2 = _refresh_est(s1, k, mu)
            return upd.iters, n, N2

        iters, n_w, N2_w = jax.vmap(one)(s, keys, mus)
        return n_w, N2_w, key

    def _measured_body(s, mus, acc_vec, dt_, key, iters_acc, msums, shared):
        """ONE executable per measured sweep: update sweep + per-walker
        estimator refresh + measurement pass + device-side bin accumulation
        (W-axis sums). Alternating separate sweep / measure / per-walker
        accumulate executables costs 2 + W dispatches per sweep. dt is
        returned updated but the measured loop discards it (frozen after
        thermalization)."""
        s, acc_vec, dt2, it_dev = _sweep_body(s, mus, acc_vec, dt_, shared)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, W)

        def one(s1, k, mu):
            c, upd, n, N2 = _refresh_est(s1, k, mu)
            out = make_measurements(c, spec, upd.estimator, s1.x)
            return out, upd.iters, upd.converged, n, N2

        out, iters, conv, n_w, N2_w = jax.vmap(one)(s, keys, mus)
        msums = jax.tree_util.tree_map(jnp.add, msums, out)
        # iters_acc: [walker-mean solve iterations, walker-mean converged]
        iters_acc = iters_acc + jnp.stack([
            jnp.mean(iters.astype(jnp.float64)), jnp.mean(conv.astype(jnp.float64))
        ])
        return s, acc_vec, it_dev, key, iters_acc, msums, n_w, N2_w

    measured_shared = jax.jit(
        lambda s, mus, a, d, k, ia, ms: _measured_body(s, mus, a, d, k, ia, ms, True)
    )
    measured_perwalker = jax.jit(
        lambda s, mus, a, d, k, ia, ms: _measured_body(s, mus, a, d, k, ia, ms, False)
    )

    # k-sweep batched twins (cfg.sweeps_per_dispatch > 1): lax.scan over the
    # same bodies — one dispatch + one host sync per k sweeps. The fallback
    # controller sees the LAST sweep's mean iteration count per batch (its
    # feedback cadence coarsens to batch granularity, documented on the
    # config field); mu tuning forces k = 1 in the loops below.
    @functools.partial(jax.jit, static_argnames=("k", "shared"))
    def sweep_k_mw(s, mus, a, d, *, k, shared):
        def body(carry, _):
            s, a, d, _ = carry
            return _sweep_body(s, mus, a, d, shared), None

        (s, a, d, it), _ = jax.lax.scan(
            body, (s, a, d, jnp.zeros((), jnp.float64)), None, length=k
        )
        return s, a, d, it

    @functools.partial(jax.jit, static_argnames=("k", "shared"))
    def measured_k_mw(s, mus, a, d, key, ia, ms, *, k, shared):
        def body(carry, _):
            s, a, _, key, ia, ms = carry
            s, a, it, key, ia, ms, _, _ = _measured_body(
                s, mus, a, d, key, ia, ms, shared
            )
            return (s, a, it, key, ia, ms), None

        (s, a, it, key, ia, ms), _ = jax.lax.scan(
            body,
            (s, a, jnp.zeros((), jnp.float64), key, ia, ms),
            None,
            length=k,
        )
        return s, a, it, key, ia, ms

    metadata: Dict = {
        "n_walkers": W,
        "N_therm": cfg.N_therm,
        "N_measurements": cfg.N_measurements,
        "N_bins": cfg.N_bins,
        "seed": cfg.seed,
        "hmc_acceptance_rate": 0.0,
        "reflection_acceptance_rate": 0.0,
        "swap_acceptance_rate": 0.0,
        "radial_acceptance_rate": 0.0,
        "hmc_iters": 0.0,
        "reflection_iters": 0.0,
        "swap_iters": 0.0,
        "measurement_iters": 0.0,
        "cg_converged_rate": 0.0,
        "measurement_converged_rate": 0.0,
    }
    accs = {w: MeasurementAccumulator(spec) for w in owned}
    # device-carried W-axis bin sums for the fused measured step (accs keep the
    # checkpoint format: per-walker rows are sliced out at checkpoint/bin time)
    msums = None
    mcount = 0

    def _out_struct():
        def one(s1, k, mu):
            c, upd, n, N2 = _refresh_est(s1, k, mu)
            return make_measurements(c, spec, upd.estimator, s1.x)

        keys = jax.random.split(jax.random.PRNGKey(0), W)
        return jax.eval_shape(
            lambda s, ks, mus: jax.vmap(one)(s, ks, mus), states, keys, mu_walkers
        )

    def _zeros_struct(struct):
        if multihost:
            n_local = len(owned)
            return jax.tree_util.tree_map(
                lambda sd: global_walker_array(
                    np.zeros((n_local,) + sd.shape[1:], sd.dtype), mesh, W
                ),
                struct,
            )
        return jax.tree_util.tree_map(
            lambda sd: carry(jnp.zeros(sd.shape, sd.dtype), walker_axis=True), struct
        )

    bin_size = max(cfg.N_measurements // cfg.N_bins, 1)
    therm_done = 0
    meas_done = 0
    cp_stamp: Optional[float] = None
    key = carry(jax.random.PRNGKey(cfg.seed + 17))
    sweep_acc = carry(jnp.zeros(len(_STAT_KEYS)))  # device-side running sums
    meas_iters_acc = carry(jnp.zeros((2,), jnp.float64))
    dt_cur = carry(jnp.asarray(dt0, jnp.float64))

    def sync_metadata():
        nonlocal sweep_acc, meas_iters_acc
        vals = np.asarray(sweep_acc)
        for k, v in zip(_STAT_KEYS, vals):
            metadata[k] += float(v)
        meas = np.asarray(meas_iters_acc)
        metadata["measurement_iters"] += float(meas[0])
        metadata["measurement_converged_rate"] += float(meas[1])
        metadata["precond_fallback_sweeps"] = metadata_fallback["n"]
        sweep_acc = carry(jnp.zeros(len(_STAT_KEYS)))
        meas_iters_acc = carry(jnp.zeros((2,), jnp.float64))

    # ------------------------------------------------------------------
    # resume
    # ------------------------------------------------------------------
    cp_pID = proc if multihost else sim_info.pID

    def to_global(a):
        """Resume helper: local walker block (multihost) or full array -> device."""
        return global_walker_array(np.asarray(a), mesh, W) if multihost else carry(
            jnp.asarray(a), walker_axis=True
        )

    if resume:
        cp = read_checkpoint(sim_info.datafolder, cp_pID)
        if cp is not None:
            s = cp["state"]
            qs = QMCState(x=to_global(s["x"]), key=to_global(s["key"]), precond=states.precond)
            states = qs if multihost else shard_walker_states(qs, mesh)
            therm_done = int(s["therm_done"])
            meas_done = int(s["meas_done"])
            metadata.update(s["metadata"])
            metadata_fallback["n"] = int(metadata.get("precond_fallback_sweeps", 0))
            # the fallback controller's (floor, mode) trajectory decides which
            # refresh runs each sweep — restoring it makes the resumed chain
            # bit-identical to an uninterrupted one (test_multihost_kill_and_resume)
            if s.get("precond_controller") is not None:
                pc.load_state(s["precond_controller"])
            key = carry(jnp.asarray(s["key_host"]))
            mu_walkers = to_global(s["mu_walkers"])
            if s.get("hmc_dt") is not None:
                dt_cur = carry(jnp.asarray(s["hmc_dt"]))
            if tuners is not None and s.get("tuners") is not None:
                tuners = tuners.replace(**{k: to_global(v) for k, v in s["tuners"].items()})
            if s.get("tuning_history_vecs") is not None:
                tuning_history_vecs = [tuple(t) for t in s["tuning_history_vecs"]]
            if s.get("accs") is not None:
                for w, a in zip(owned, s["accs"]):
                    accs[w].sums = a["sums"]
                    accs[w].count = int(a["count"])
                if accs[owned[0]].sums is not None:
                    # mid-bin resume: reassemble the device W-axis sums from
                    # the per-walker checkpoint rows
                    mcount = accs[owned[0]].count
                    rows = [accs[w].sums for w in owned]
                    if multihost:
                        msums = jax.tree_util.tree_map(
                            lambda *rs: global_walker_array(np.stack(rs), mesh, W), *rows
                        )
                    else:
                        msums = jax.tree_util.tree_map(
                            lambda *rs: carry(jnp.asarray(np.stack(rs)), walker_axis=True),
                            *rows,
                        )

    def to_local(a):
        """Checkpoint helper: owned walker block (multihost) or the array itself."""
        return local_walker_block(a, owned) if multihost else a

    def maybe_checkpoint():
        nonlocal cp_stamp
        # frequency gate FIRST (same test write_checkpoint applies): building
        # the tree below eagerly reads each owned walker's measurement-sum
        # shard to host — a per-sweep device->host transfer that would defeat
        # the fused-executable dispatch pipeline when the gate is closed
        if cp_stamp is not None and (
            time.time() - cp_stamp
        ) < cfg.checkpoint_freq_hours * 3600.0:
            return
        sync_metadata()
        tree = {
            "x": to_local(states.x),
            "key": to_local(states.key),
            "key_host": key,
            "hmc_dt": dt_cur,
            "therm_done": therm_done,
            "meas_done": meas_done,
            "metadata": dict(metadata),
            "mu_walkers": to_local(mu_walkers),
            "tuners": None
            if tuners is None
            else {
                "mu": to_local(tuners.mu),
                "t": to_local(tuners.t),
                "mu_sum": to_local(tuners.mu_sum),
                "n_sum": to_local(tuners.n_sum),
                "N_sum": to_local(tuners.N_sum),
                "Nsq_sum": to_local(tuners.Nsq_sum),
                "weight": to_local(tuners.weight),
            },
            "tuning_history_vecs": [tuple(t) for t in tuning_history_vecs],
            # per-walker partial-bin sums: lazy device slices on a single host
            # (write_checkpoint materializes them only when the freq gate
            # opens); multihost must read its addressable shard rows eagerly
            "accs": [
                {
                    "sums": None
                    if not mcount
                    else (
                        walker_row_tree(msums, w)
                        if multihost
                        else jax.tree_util.tree_map(lambda a: a[w], msums)
                    ),
                    "count": mcount,
                }
                for w in owned
            ],
            "precond_controller": pc.state_dict(),
        }
        cp_stamp = write_checkpoint(
            sim_info.datafolder,
            tree,
            pID=cp_pID,
            checkpoint_timestamp=cp_stamp,
            checkpoint_freq_hours=cfg.checkpoint_freq_hours,
        )

    def out_of_time() -> bool:
        return runtime_exceeded(start_time, cfg.runtime_limit_hours)

    # ------------------------------------------------------------------
    # thermalize
    # ------------------------------------------------------------------
    # phase wall-clock instrumentation (see the single-walker path): first
    # sweep of each phase carries trace+compile; scripts/e2e_scaling.py reads
    # post-compile sweep costs from these metadata keys
    # sweep batching on the absolute grid (see the single-walker path / the
    # cfg.sweeps_per_dispatch docstring); mu tuning forces k = 1
    k_disp = max(int(getattr(cfg, "sweeps_per_dispatch", 1)), 1)
    if tuners is not None:
        k_disp = 1

    def _batch(done, *ends):
        k = k_disp - done % k_disp
        for e in ends:
            k = min(k, e - done)
        return max(k, 1)

    t_phase = time.time()
    n_timed = 0
    while therm_done < cfg.N_therm:
        k = _batch(therm_done, cfg.N_therm)
        states, sweep_acc, dt_cur = run_sweep(
            states, mu_walkers, sweep_acc, dt_cur, k=k
        )
        if tuners is not None:
            n_w, N2_w, key = tune(states, key, mu_walkers)
            tuners = tune_step(tuners, n_w, N2_w)
            mu_walkers = tuners.mu
            # ONE lazy (W,)-vector triple per sweep; split per walker at save time
            tuning_history_vecs.append(hist_entry(mu_walkers, n_w, N2_w))
        therm_done += k
        n_timed += k
        if n_timed == k:
            jax.block_until_ready(dt_cur)
            metadata["t_first_therm_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_therm_batch"] = k
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time():
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, states.precond)
            return metadata
    if n_timed:
        jax.block_until_ready(dt_cur)
        metadata["t_therm_s"] = round(time.time() - t_phase, 3)
        metadata["n_therm_timed"] = n_timed

    # ------------------------------------------------------------------
    # measure
    # ------------------------------------------------------------------
    msums0 = _zeros_struct(_out_struct())
    if msums is None:
        msums = msums0
    t_phase = time.time()
    n_timed = 0
    while meas_done < cfg.N_measurements:
        # dt frozen after thermalization (the tuned value is NOT fed back);
        # sweep + measure + accumulate run as ONE fused executable
        k = _batch(
            meas_done, cfg.N_measurements,
            meas_done + bin_size - meas_done % bin_size,
        )
        states, sweep_acc, key, meas_iters_acc, msums, n_w, N2_w = run_measured(
            states, mu_walkers, sweep_acc, dt_cur, key, meas_iters_acc, msums, k=k
        )
        mcount += k
        if tuners is not None:
            tuners = tune_step(tuners, n_w, N2_w)
            mu_walkers = tuners.mu
            tuning_history_vecs.append(hist_entry(mu_walkers, n_w, N2_w))
        meas_done += k
        n_timed += k
        if n_timed == k:
            jax.block_until_ready(meas_iters_acc)
            metadata["t_first_measured_sweep_s"] = round(time.time() - t_phase, 3)
            metadata["n_first_measured_batch"] = k
        if meas_done % bin_size == 0:
            b = meas_done // bin_size - 1
            # single host: materialize each (W, ...) leaf ONCE and slice rows
            # from the host copy — walker_row per walker would transfer the
            # full measurement-sums tree W times per bin. Multihost keeps the
            # addressable-shard row reads (zero-communication ownership).
            host = (
                None
                if multihost
                else jax.tree_util.tree_map(np.asarray, msums)
            )
            for w in owned:
                # per-walker bin average from this host's addressable rows
                row = (
                    walker_row_tree(msums, w)
                    if multihost
                    else jax.tree_util.tree_map(lambda a: a[w], host)
                )
                avg = jax.tree_util.tree_map(
                    lambda a: np.asarray(a) / mcount, row
                )
                write_measurement_bin(
                    sim_info.with_pID(w), b, avg, spec, dtau=cfg.dtau
                )
            msums = msums0
            mcount = 0
        if cfg.checkpoint_freq_hours < np.inf:
            maybe_checkpoint()
        if out_of_time() and meas_done < cfg.N_measurements:
            maybe_checkpoint()
            fold_kpm_diagnostics(metadata, states.precond)
            return metadata
    if n_timed:
        jax.block_until_ready(meas_iters_acc)
        metadata["t_measure_s"] = round(time.time() - t_phase, 3)
        metadata["n_measure_timed"] = n_timed

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------
    sync_metadata()
    n_updates = cfg.N_therm + cfg.N_measurements
    for k in ("hmc", "reflection", "swap", "radial"):
        metadata[f"{k}_acceptance_rate"] /= max(n_updates, 1)
    metadata["hmc_iters"] /= max(n_updates, 1)
    metadata["cg_converged_rate"] /= max(n_updates, 1)
    metadata["reflection_iters"] /= max(n_updates, 1)
    metadata["swap_iters"] /= max(n_updates, 1)
    metadata["measurement_iters"] /= max(cfg.N_measurements, 1)
    metadata["measurement_converged_rate"] /= max(cfg.N_measurements, 1)
    fold_kpm_diagnostics(metadata, states.precond)
    # sweeps the fallback controller ran with per-walker refresh (0 = the
    # shared walker-mean refresh stayed iteration-neutral throughout)
    metadata["precond_fallback_sweeps"] = metadata_fallback["n"]
    if cfg.target_acceptance is not None:
        metadata["hmc_dt_final"] = float(np.asarray(dt_cur))
    if tuners is not None:
        from .io.simulation_info import save_density_tuning_profile

        # history rows are indexed by OWNED-walker position in multihost mode
        # (hist_entry extracted the local block at append time)
        if multihost:
            metadata["final_mu_per_walker"] = {
                int(w): float(walker_row(mu_walkers, w)) for w in owned
            }
        else:
            metadata["final_mu_per_walker"] = [float(v) for v in np.asarray(mu_walkers)]
        host_rows = [tuple(np.asarray(a) for a in t) for t in tuning_history_vecs]
        for i, w in enumerate(owned):
            j = i if multihost else w
            save_density_tuning_profile(
                sim_info.with_pID(w), [(mu[j], n[j], N2[j]) for (mu, n, N2) in host_rows]
            )
    # every host must have written its bins before process 0 merges
    barrier("bins_complete")
    if not multihost or proc == 0:
        merge_bins(sim_info)
        save_simulation_info(sim_info, metadata)
        process_measurements(sim_info.datafolder, n_bins=cfg.N_bins, spec=spec)
    delete_checkpoints(sim_info.datafolder, cp_pID)
    barrier("finalize_done")
    return metadata
