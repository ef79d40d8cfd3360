#!/usr/bin/env python3
"""Smoke test of the simulation on an NVIDIA GPU: the quickest proof that the
main path starts, runs and gives right answers on the card.

Default run, one card, at the flagship deployment (the one bench.py builds):
the Holstein honeycomb of examples/_common.py with L=12, beta=12, dtau=0.05
(Ltau=240, N=288 sites), alpha=0.6, Omega=1, W=8 walkers, Nrv=10 and the
'auto' preconditioner (spectral at this size). Phases:

  device      JAX's devices, and the card's name and power limit from nvidia-smi
  kernels     each hot operation at full width against a plain reference
              (NumPy or a dense solve on the host), then XLA's times for them
  main_path   run_simulation through the driver with W=8 for a few sweeps
  cpu_parity  the card against the CPU backend, in this same process

`--four-cards` runs only the sharded-walker phase: W=8 walkers over a 1-D
mesh of four cards, against the same program on one card.

Every number line ends with the card's name and power limit. The last line of
standard output is one JSON object, {"ok": true, "device": {...}}. The script
exits non-zero without that line when JAX finds no GPU, when any phase raises,
or when any comparison misses its tolerance.

Run:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

# DQMC-only globals the PFF formulation records as NaN (measure/container.py)
NAN_BY_DESIGN = ("sgndetG", "logdetG", "action_fermionic", "action_total")


@dataclasses.dataclass(frozen=True)
class Deployment:
    """One simulation size. FLAGSHIP is the deployment the default run uses."""

    L: int = 12
    beta: float = 12.0
    dtau: float = 0.05
    alpha: float = 0.6
    Omega: float = 1.0
    W: int = 8
    Nrv: int = 10
    Nt: int = 24
    N_therm: int = 4
    N_measurements: int = 4
    N_bins: int = 2
    seed: int = 0
    copy_bytes: int = 1 << 30  # array size of the copy-bandwidth probe


FLAGSHIP = Deployment()


class CheckFailed(AssertionError):
    """A comparison missed its tolerance or a required property did not hold."""


class Reporter:
    """Prints result lines, each ending with the card's name and power limit."""

    def __init__(self, card: str):
        self.card = card

    def line(self, text: str) -> None:
        print(f"{text} | {self.card}", flush=True)

    def check(self, name: str, err: float, tol: float) -> None:
        ok = bool(err <= tol)  # NaN fails
        self.line(f"[check] {name}: error {err:.3e} tol {tol:.0e} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise CheckFailed(f"{name}: error {err:.3e} exceeds tolerance {tol:.0e}")

    def require(self, name: str, cond: bool, detail: str) -> None:
        self.line(f"[check] {name}: {detail} {'ok' if cond else 'FAILED'}")
        if not cond:
            raise CheckFailed(f"{name}: {detail}")


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, run as a plain child process
    that never starts JAX (one line per card, joined)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": platform, "kind": kind, "count": count}})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the walker mesh over four cards against one card",
    )
    return p.parse_args(argv)


def plan(args) -> list:
    """Phases to run, in order."""
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "kernels", "main_path", "cpu_parity"]


# ----------------------------------------------------------------------
# set-up
# ----------------------------------------------------------------------


def build(dep: Deployment) -> SimpleNamespace:
    """Model, QMC context and state, and the fermion matrix at `dep`, with the
    driver's production settings (mixed-precision f64 solves, f32 forces)."""
    import numpy as np
    from _common import holstein_honeycomb_model, holstein_honeycomb_spec

    from smoqyelphqmc_tpu.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu.updates.context import initialize_qmc, make_fdm

    geo, tbm, em = holstein_honeycomb_model(dep.L, dep.Omega, dep.alpha, 0.0)
    rng = np.random.default_rng(dep.seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(dep.beta, dep.dtau, em, tbp, rng)
    ctx, state = initialize_qmc(
        tbp, elph, seed=dep.seed, tol=1e-10, preconditioner="auto",
        mixed_precision=True, force_dtype="float32",
    )
    return SimpleNamespace(
        geo=geo, tbm=tbm, em=em, spec=holstein_honeycomb_spec(geo),
        ctx=ctx, state=state, fdm=make_fdm(ctx, state.x),
    )


def _rel_max(out, ref) -> float:
    import numpy as np

    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max() / np.abs(ref).max())


def _rhs(dep: Deployment, fdm, salt: int):
    """(2 W, Ltau, N) right-hand sides: 2 channels per walker, as in the
    force solves of a W-walker sweep."""
    import numpy as np

    return np.random.default_rng(dep.seed + salt).standard_normal((2 * dep.W, fdm.Ltau, fdm.n_sites))


def _true_residual(mtm, x, b) -> float:
    """max over systems of |b - A x| / |b|, in f64 on the host."""
    import numpy as np

    x = np.asarray(x, np.float64)
    r = b - mtm(x)
    return float(np.max(np.linalg.norm(r, axis=(-2, -1)) / np.linalg.norm(b, axis=(-2, -1))))


# ----------------------------------------------------------------------
# kernels: each check compares the card with a plain reference
# ----------------------------------------------------------------------


def check_mtm(sim, dep, rep) -> None:
    """mul_MtM at batch 2W against bench.numpy_mtm (NumPy, f64, host)."""
    import jax
    import jax.numpy as jnp
    from bench import numpy_mtm

    v = _rhs(dep, sim.fdm, 1)
    ref = numpy_mtm(sim.fdm)(v)
    apply = jax.jit(lambda f, u: f.mul_MtM(u))
    for dt, tol in (("float64", 1e-12), ("float32", 1e-5)):
        f = sim.fdm.astype(dt)
        out = apply(f, jnp.asarray(v, dtype=dt))
        rep.check(f"mul_MtM {dt} batch {2 * dep.W} vs NumPy f64", _rel_max(out, ref), tol)


def check_fourier(sim, dep, rep) -> None:
    """TauFourier forward and inverse against numpy.fft. At TF32 the f32 case
    would miss its tolerance by about 100x, so this guards the precision."""
    import jax
    import numpy as np

    from smoqyelphqmc_tpu.ops.fourier import TauFourier

    Ltau = sim.fdm.Ltau
    rng = np.random.default_rng(dep.seed + 2)
    are, aim = rng.standard_normal((2, 2 * dep.W, Ltau, sim.fdm.n_sites))
    a = are + 1j * aim
    l = np.arange(Ltau)[:, None]
    # u[w] = Ltau^-1/2 sum_l exp(-i (2 pi w + pi) l / Ltau) v[l], and its inverse
    ref_fwd = np.fft.fft(a * np.exp(-1j * np.pi * l / Ltau), axis=-2) / np.sqrt(Ltau)
    ref_inv = np.exp(1j * np.pi * l / Ltau) * np.fft.ifft(a, axis=-2) * np.sqrt(Ltau)
    fwd = jax.jit(lambda t, x, y: t.forward(x, y))
    inv = jax.jit(lambda t, x, y: t.inverse(x, y))
    for dt, tol in (("float64", 1e-12), ("float32", 1e-5)):
        tf = TauFourier.build(Ltau, dtype=dt)
        x, y = are.astype(dt), aim.astype(dt)
        ure, uim = fwd(tf, x, y)
        vre, vim = inv(tf, x, y)
        u = np.asarray(ure, np.float64) + 1j * np.asarray(uim, np.float64)
        v = np.asarray(vre, np.float64) + 1j * np.asarray(vim, np.float64)
        rep.check(f"TauFourier forward {dt} vs numpy.fft", _rel_max(u, ref_fwd), tol)
        rep.check(f"TauFourier inverse {dt} vs numpy.fft", _rel_max(v, ref_inv), tol)


def check_spectral(sim, dep, rep) -> None:
    """Spectral preconditioner refresh (f32 eigh): its eigenbasis must
    reconstruct the tau-averaged propagator Bbar (dense f64 on the host)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from smoqyelphqmc_tpu.ops.kpm import averaged_propagator
    from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral

    fdm = sim.fdm
    pre = jax.jit(build_spectral)(fdm)
    Q = np.asarray(pre.Q, np.float64)
    B = np.asarray(averaged_propagator(fdm).apply(jnp.eye(fdm.n_sites))).T
    B = 0.5 * (B + B.T)
    lam = np.einsum("ij,ik,kj->j", Q, B, Q)  # Rayleigh quotients of the columns
    recon = (Q * lam) @ Q.T
    err = float(np.linalg.norm(recon - B) / np.linalg.norm(B))
    rep.check(f"spectral refresh f32 eigh: Q diag(lam) Q^T vs Bbar (N={fdm.n_sites})", err, 1e-5)


def _solver(tol: float, mixed: bool):
    import jax

    from smoqyelphqmc_tpu.ops.fermion_det import solve_MtM

    return jax.jit(
        lambda f, p, b: solve_MtM(f, b, precond=p, tol=tol, maxiter=10_000, mixed=mixed)
    )


def check_cg_f64(sim, dep, rep) -> None:
    """f64 solve (mixed-precision CG, spectral preconditioner) to tol 1e-10:
    its true residual through NumPy's M^T M."""
    import jax.numpy as jnp
    from bench import numpy_mtm

    b = _rhs(dep, sim.fdm, 3)
    x, st = _solver(1e-10, True)(sim.fdm, sim.state.precond, jnp.asarray(b))
    rep.require("f64 CG converged", bool(st.converged), f"{int(st.iters)} f32 inner iterations")
    rep.check(
        "f64 CG tol 1e-10 true residual (NumPy M^T M)",
        _true_residual(numpy_mtm(sim.fdm), x, b), 1e-9,
    )


def check_cg_f32(sim, dep, rep) -> None:
    """f32 solve to tol 1e-5 (the force-solve precision): its true residual
    through NumPy's M^T M of the same f32 tables, in f64 arithmetic."""
    import jax.numpy as jnp
    from bench import numpy_mtm

    b = _rhs(dep, sim.fdm, 4)
    f32 = sim.fdm.astype(jnp.float32)
    x, st = _solver(1e-5, False)(f32, sim.state.precond, jnp.asarray(b, jnp.float32))
    rep.require("f32 CG converged", bool(st.converged), f"{int(st.iters)} iterations per solve")
    rep.check("f32 CG tol 1e-5 true residual (NumPy M^T M)", _true_residual(numpy_mtm(f32), x, b), 1e-4)


def check_force(sim, dep, rep) -> None:
    """f32 fermionic force against the f64 force at the same field (the bound
    tests/test_mixed_precision.py uses)."""
    import jax
    import numpy as np

    from smoqyelphqmc_tpu.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields

    ctx, fdm, x = sim.ctx, sim.fdm, sim.state.x
    Phi, _ = sample_pseudofermion_fields(jax.random.PRNGKey(dep.seed + 5), ctx.elph, fdm, x)

    def force(solve_dtype):
        fn = jax.jit(
            lambda f, p, phi, xx: fermionic_action_and_force(
                phi, ctx.elph, f, xx, ctx.plan, precond=p, tol=1e-5, maxiter=10_000,
                solve_dtype=solve_dtype,
            )
        )
        res = fn(fdm, sim.state.precond, Phi, x)
        rep.require(f"{solve_dtype} force solve converged", bool(res.stats.converged),
                    f"{int(res.stats.iters)} iterations")
        return np.asarray(res.force)

    rep.check("f32 force vs f64 force (relative to max)", _rel_max(force("float32"), force("float64")), 1e-4)


KERNEL_CHECKS = (check_mtm, check_fourier, check_spectral, check_cg_f64, check_cg_f32, check_force)


def kernel_timings(sim, dep, rep) -> None:
    """XLA's times for the hot operations: the bar a hand-written kernel must
    beat. Device times come from the host clock around block_until_ready."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def timed(fn, *args, reps=5):
        jax.block_until_ready(fn(*args))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    fdm = sim.fdm
    n_apply = 100

    @jax.jit
    def apply_loop(f, v):
        def body(_, u):
            u = f.mul_MtM(u)
            return u / jnp.sqrt(jnp.mean(u * u))  # keeps the loop finite

        return lax.fori_loop(0, n_apply, body, v)

    # copy bandwidth probe: read one array, write one
    n_copy = dep.copy_bytes // 4
    big = jnp.zeros((n_copy,), jnp.float32)
    t_copy = timed(jax.jit(lambda a: a + 1.0), big, reps=10)
    copy_gbs = 2 * n_copy * 4 / t_copy / 1e9
    rep.line(f"[time] copy {dep.copy_bytes / 2**30:.3f} GiB f32 (read + write): {copy_gbs:.1f} GB/s")
    del big

    batch = 2 * dep.W
    v = jnp.asarray(_rhs(dep, fdm, 6))
    for dt in ("float64", "float32"):
        f = fdm.astype(dt)
        t = timed(apply_loop, f, v.astype(dt), reps=3) / n_apply
        item = jnp.dtype(dt).itemsize
        plane = fdm.Ltau * fdm.n_sites * item
        # compulsory bytes: read v, write M^T M v, read each propagator table once
        nbytes = (2 * batch + 2 * fdm.cb.n_colors + 1) * plane
        rep.line(
            f"[time] mul_MtM {dt} batch {batch}: {t * 1e6:.1f} us/apply (with rescale), "
            f"{nbytes / 1e6:.2f} MB compulsory/apply, {nbytes / t / 1e9:.1f} GB/s "
            f"= {nbytes / t / 1e9 / copy_gbs:.3f} of copy"
        )

    b = jnp.asarray(_rhs(dep, fdm, 7))
    for name, solve, f, rhs in (
        ("f32 tol 1e-5 (force solve)", _solver(1e-5, False), fdm.astype(jnp.float32), b.astype(jnp.float32)),
        ("f64 tol 1e-10 mixed (action solve)", _solver(1e-10, True), fdm, b),
    ):
        t = timed(solve, f, sim.state.precond, rhs, reps=3)
        _, st = solve(f, sim.state.precond, rhs)
        rep.line(
            f"[time] CG {name}, batch {batch}, cold start: {t * 1e3:.2f} ms/solve, "
            f"{int(st.iters)} iterations, {t / max(int(st.iters), 1) * 1e6:.1f} us/iteration"
        )


def phase_kernels(sim, dep, rep) -> None:
    for check in KERNEL_CHECKS:
        check(sim, dep, rep)
    kernel_timings(sim, dep, rep)


# ----------------------------------------------------------------------
# main path: run_simulation through the driver
# ----------------------------------------------------------------------


def _memory_analysis_line(compiled) -> str:
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} {getattr(ma, f, 0) / 2**20:.1f} MiB" for f in fields)


def run_driver(sim, dep, rep, n_therm: int, n_meas: int, n_bins: int) -> dict:
    """run_simulation with dep.W walkers into a fresh directory; checks the
    files it writes and the finiteness of every statistic."""
    import numpy as np

    from smoqyelphqmc_tpu.driver import SimulationConfig, run_simulation
    from smoqyelphqmc_tpu.io import SimulationInfo, archive

    cfg = SimulationConfig(
        beta=dep.beta, dtau=dep.dtau, N_therm=n_therm, N_measurements=n_meas,
        N_bins=n_bins, Nt=dep.Nt, Nrv=dep.Nrv, seed=dep.seed + 1,
        n_walkers=dep.W, preconditioner="auto",
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sim_info = SimulationInfo(filepath=tmp, datafolder_prefix="flagship", sID=1)
        t0 = time.perf_counter()
        meta = run_simulation(sim_info, sim.tbm, sim.em, sim.spec, cfg)
        wall = time.perf_counter() - t0
        d = sim_info.datafolder
        bins = glob.glob(os.path.join(d, "bins", f"bin-*_pID-*{archive.EXT}"))
        rep.require("bins written", len(bins) == dep.W * n_bins,
                    f"{len(bins)} bin files for {dep.W} walkers x {n_bins} bins")
        for name in ("binned_data", "stats"):
            path = os.path.join(d, name + archive.EXT)
            rep.require(f"{name} archive written", os.path.exists(path), os.path.basename(path))
        stats = archive.datasets(archive.load(os.path.join(d, "stats" + archive.EXT)))
        bad = [k for k, v in stats.items()
               if not any(n in k for n in NAN_BY_DESIGN) and not np.all(np.isfinite(v))]
        rep.require("observables finite", not bad, f"{len(stats)} statistics, non-finite: {bad[:5]}")
    rep.require("every CG converged", meta["cg_converged_rate"] == 1.0
                and meta["measurement_converged_rate"] == 1.0,
                f"update sweeps {meta['cg_converged_rate']:.3f}, "
                f"measurements {meta['measurement_converged_rate']:.3f}")
    rep.require("HMC acceptance above 0", meta["hmc_acceptance_rate"] > 0.0,
                f"acceptance {meta['hmc_acceptance_rate']:.3f}")
    rep.line(
        f"[run] W={dep.W} therm {n_therm} + measured {n_meas} sweeps in {wall:.1f} s wall; "
        f"CG iterations per solve: HMC {meta['hmc_iters']:.1f}, "
        f"measurement {meta['measurement_iters']:.1f}; "
        f"reflection/swap acceptance {meta['reflection_acceptance_rate']:.3f}/"
        f"{meta['swap_acceptance_rate']:.3f}; preconditioner fallback sweeps "
        f"{meta.get('precond_fallback_sweeps', 0)}"
    )
    return meta


def _steady(meta: dict, phase: str):
    """(seconds per steady sweep, first-batch seconds) from the driver's
    phase clocks; the first batch carries the compile."""
    first = meta[f"t_first_{phase}_sweep_s"]
    n_first = meta[f"n_first_{phase}_batch"]
    key = "therm" if phase == "therm" else "measure"
    n = meta[f"n_{key}_timed"] - n_first
    if n <= 0:
        return float("nan"), first
    return (meta[f"t_{key}_s"] - first) / n, first


def phase_main_path(sim, dep, rep) -> None:
    import jax

    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states, walker_sweep
    from smoqyelphqmc_tpu.updates.hmc import HMCParams

    meta = run_driver(sim, dep, rep, dep.N_therm, dep.N_measurements, dep.N_bins)
    for phase, label in (("therm", "update"), ("measured", "measured")):
        per, first = _steady(meta, phase)
        rep.line(
            f"[time] driver {label} sweeps: {dep.W / per:.3f} walker-sweeps/s steady "
            f"({per:.3f} s/sweep); first sweep {first:.1f} s, so compile ~{first - per:.1f} s"
        )
    states = init_walker_states(sim.ctx, sim.state, dep.W, seed=dep.seed + 1)
    compiled = jax.jit(lambda s: walker_sweep(sim.ctx, s, HMCParams(Nt=dep.Nt))).lower(states).compile()
    rep.line(f"[memory] W={dep.W} sweep step memory_analysis: {_memory_analysis_line(compiled)}")


# ----------------------------------------------------------------------
# cpu parity: the card against the CPU backend, same process
# ----------------------------------------------------------------------


def phase_cpu_parity(sim, dep, rep) -> None:
    import jax
    import numpy as np

    from smoqyelphqmc_tpu.measure.container import make_measurements
    from smoqyelphqmc_tpu.measure.greens_estimator import build_greens_estimator, update_greens_estimator
    from smoqyelphqmc_tpu.ops.pff import fermionic_action, sample_pseudofermion_fields
    from smoqyelphqmc_tpu.ops.preconditioner import build_preconditioner
    from smoqyelphqmc_tpu.updates.context import make_fdm

    spec = sim.spec

    def action(ctx, x, key):
        fdm = make_fdm(ctx, x)
        pre = build_preconditioner("auto", fdm, key)
        Phi, _ = sample_pseudofermion_fields(key, ctx.elph, fdm, x)
        res = fermionic_action(Phi, ctx.elph, fdm, x, precond=pre, tol=1e-10,
                               maxiter=ctx.maxiter, mixed=True)
        return res.Sf, res.stats.converged

    def measure(ctx, est, x, key):
        # the driver's measurement pass: estimator refresh + contraction
        fdm = make_fdm(ctx, x)
        pre = build_preconditioner("auto", fdm, key)
        upd = update_greens_estimator(est, fdm, key, precond=pre, tol=1e-10,
                                      maxiter=ctx.maxiter, mixed=True, solve_dtype="float32")
        out = make_measurements(ctx, spec, upd.estimator, x)
        g_re, g_im = out["correlations"]["greens"]
        return {
            "density": out["global"]["density"][0],
            "double_occ": out["global"]["double_occ"][0],
            "equal-time greens": g_re[:, 0] + 1j * g_im[:, 0],
        }, upd.converged

    ctx, x = sim.ctx, sim.state.x
    est = build_greens_estimator(ctx.Ltau, sim.geo.n_orbitals, sim.geo.L, Nrv=dep.Nrv, dtype="float32")
    key = jax.random.PRNGKey(dep.seed + 11)
    results = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        args = jax.device_put((ctx, est, x, key), dev)
        t0 = time.perf_counter()
        sf, ok_a = jax.device_get(jax.jit(action)(args[0], args[2], args[3]))
        obs, ok_m = jax.device_get(jax.jit(measure)(*args))
        rep.require(f"{dev.platform} solves converged", bool(ok_a) and bool(ok_m),
                    f"action {bool(ok_a)}, estimator {bool(ok_m)}; {time.perf_counter() - t0:.1f} s")
        results[dev.platform] = (sf, obs)
    (sf_a, obs_a), (sf_c, obs_c) = results[jax.devices()[0].platform], results["cpu"]
    rep.check(f"S_F f64 {jax.devices()[0].platform} vs cpu (S_F = {float(sf_c):.6f})",
              abs(float(sf_a) - float(sf_c)) / abs(float(sf_c)), 1e-9)
    for name in obs_c:
        rep.check(f"{name} {jax.devices()[0].platform} vs cpu", _rel_max(np.asarray(obs_a[name]), obs_c[name]), 1e-4)


# ----------------------------------------------------------------------
# four cards: the walker axis sharded over a 1-D mesh
# ----------------------------------------------------------------------


def phase_four_cards(sim, dep, rep, n_cards: int = 4) -> None:
    import jax
    import numpy as np

    from smoqyelphqmc_tpu.measure.greens_estimator import build_greens_estimator
    from smoqyelphqmc_tpu.parallel.walkers import (
        init_walker_states,
        shard_walker_states,
        walker_measure,
        walker_mesh,
        walker_sweep,
    )
    from smoqyelphqmc_tpu.updates.hmc import HMCParams

    if len(jax.devices()) < n_cards:
        raise CheckFailed(f"--four-cards needs {n_cards} devices, JAX sees {len(jax.devices())}")
    ctx, W = sim.ctx, dep.W
    params = HMCParams(Nt=dep.Nt)
    est = build_greens_estimator(ctx.Ltau, sim.geo.n_orbitals, sim.geo.L, Nrv=dep.Nrv, dtype="float32")

    @jax.jit
    def step(states, key):
        states, (r, sw, h) = walker_sweep(ctx, states, params)
        out, _ = walker_measure(ctx, sim.spec, states, est, jax.random.split(key, W),
                                tol=ctx.tol, maxiter=ctx.maxiter, mixed=True)
        return states, (r.accepted, sw.accepted, h.accepted), out["global"]["density"][0]

    base = init_walker_states(ctx, sim.state, W, seed=dep.seed + 1)
    key = jax.random.PRNGKey(dep.seed + 13)
    runs = {}
    for n in (n_cards, 1):
        mesh = walker_mesh(n)
        states = shard_walker_states(base, mesh)
        out = step(states, key)  # compile + first step
        jax.block_until_ready(out)
        reps = 3
        t0 = time.perf_counter()
        s = states
        for i in range(reps):
            s, _, _ = step(s, jax.random.fold_in(key, i))
        jax.block_until_ready(s)
        rate = reps * W / (time.perf_counter() - t0)
        rep.line(f"[time] {n} card(s), W={W}: {rate:.3f} walker-sweeps/s (sweep + measurement), "
                 f"{rate / n:.3f} per card")
        runs[n] = out
        if n == n_cards:
            devs = {sh.device for sh in out[0].x.addressable_shards}
            rep.require("state spans distinct devices", len(devs) == n_cards,
                        f"x on {len(devs)} devices")
            for d in mesh.devices.flat:
                ms = d.memory_stats()
                if d.platform == "cpu" and ms is None:
                    rep.line(f"[memory] {d}: memory_stats not reported on cpu")
                    continue
                rep.require(f"{d} holds memory", ms["bytes_in_use"] > 0,
                            f"bytes_in_use {ms['bytes_in_use']}")
    (s4, acc4, dens4), (s1, acc1, dens1) = runs[n_cards], runs[1]
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(acc4, acc1))
    rep.require("accept decisions identical, 4 cards vs 1", same,
                f"HMC accepted {np.asarray(acc4[2]).astype(int).tolist()}")
    # x passes through Nt f32 force solves stopped at tol_force = 1e-5. The
    # mesh reorders sums (the walker-mean all-reduce, and 2 walkers per card
    # instead of 8 change XLA's reductions), which moves where each solve
    # stops, so the two trajectories agree to the force tolerance, not to
    # roundoff: a misplaced shard would differ at O(1).
    rep.check("x 4 cards vs 1 (relative to max)", _rel_max(np.asarray(s4.x), np.asarray(s1.x)), 1e-4)
    rep.check("density 4 cards vs 1", _rel_max(np.asarray(dens4), np.asarray(dens1)), 1e-4)
    run_driver(sim, dep, rep, n_therm=2, n_meas=2, n_bins=1)


PHASES = {
    "kernels": phase_kernels,
    "main_path": phase_main_path,
    "cpu_parity": phase_cpu_parity,
    "four_cards": phase_four_cards,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's default backend is {backend!r}", file=sys.stderr)
        return 2
    from smoqyelphqmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rep = Reporter(card_name_and_power())
    dev = jax.devices()[0]
    print(f"[device] nvidia-smi name, power.limit: {rep.card}", flush=True)
    rep.line(f"[device] jax.devices(): {jax.devices()}; kind {dev.device_kind!r}; count {len(jax.devices())}")
    sim = build(FLAGSHIP)
    rep.line(f"[device] deployment {FLAGSHIP}: Ltau {sim.fdm.Ltau}, N {sim.fdm.n_sites}, "
             f"preconditioner {type(sim.state.precond).__name__}")
    for name in plan(args)[1:]:
        t0 = time.perf_counter()
        PHASES[name](sim, FLAGSHIP, rep)
        rep.line(f"[phase] {name} done in {time.perf_counter() - t0:.1f} s")
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
