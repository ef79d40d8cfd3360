"""Benchmark: CG matvec throughput on the BASELINE.md headline config.

Holstein honeycomb L=12, beta=12, dtau=0.05 (Ltau=240, N=288 sites): times the
innermost hot operation of the whole framework — the M^T M space-time matvec
(2 checkerboard sweeps x 2 + diagonal scalings per application,
BASELINE.md per-sweep cost model) — on the default device, and compares against
the same computation pinned to one host CPU core (stand-in for the reference's
single-core Julia loop nest, which performs the identical memory-bound sweeps).

Runs in one process on the default device, which must be a GPU: a run that
finds no GPU exits non-zero instead of timing the CPU. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extras"}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def build_case(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, seed=0):
    from smoqyelphqmc_tpu import (
        Bond,
        ElectronPhononModel,
        ElectronPhononParameters,
        HolsteinCoupling,
        Lattice,
        ModelGeometry,
        PhononMode,
        TightBindingModel,
        TightBindingParameters,
        UnitCell,
    )
    from smoqyelphqmc_tpu.models.fermion_path_integral import build_path_integral
    from smoqyelphqmc_tpu.ops.checkerboard import build_checkerboard_structure
    from smoqyelphqmc_tpu.ops.fermion_det import FermionDetMatrix

    uc = UnitCell(
        lattice_vecs=[[1.5, np.sqrt(3) / 2], [1.5, -np.sqrt(3) / 2]],
        basis_vecs=[[0.0, 0.0], [1.0, 0.0]],
    )
    lat = Lattice(L=[L, L], periodic=[True, True])
    geo = ModelGeometry(uc, lat)
    bonds = [
        Bond(orbitals=(0, 1), displacement=[0, 0]),
        Bond(orbitals=(0, 1), displacement=[-1, 0]),
        Bond(orbitals=(0, 1), displacement=[0, -1]),
    ]
    for b in bonds:
        geo.add_bond(b)
    tbm = TightBindingModel(geo, bonds, [1.0] * 3, [0.0, 0.0], mu=0.0)
    em = ElectronPhononModel(geo, tbm)
    p1 = em.add_phonon_mode(PhononMode([0.0, 0.0], Omega))
    p2 = em.add_phonon_mode(PhononMode([1.0, 0.0], Omega))
    em.add_holstein_coupling(HolsteinCoupling(p1, 0, [0, 0], alpha, ph_sym_form=True))
    em.add_holstein_coupling(HolsteinCoupling(p2, 1, [0, 0], alpha, ph_sym_form=True))
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    fpi = build_path_integral(tbp, elph)
    structure = build_checkerboard_structure(np.asarray(tbp.neighbor_table), tbp.n_sites)
    fdm = FermionDetMatrix.from_path_integral(fpi, structure, symmetric=True)
    return fdm


def build_sim(L=12, beta=12.0, dtau=0.05, alpha=0.6, Omega=1.0, Nt=24, tol=1e-10, seed=0):
    """Full QMC context/state for sweep-level benchmarking."""
    import numpy as np

    from smoqyelphqmc_tpu.models.electron_phonon import ElectronPhononParameters
    from smoqyelphqmc_tpu.models.tight_binding import TightBindingParameters
    from smoqyelphqmc_tpu.updates.context import initialize_qmc

    import importlib.util, os, sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    from _common import holstein_honeycomb_model

    geo, tbm, em = holstein_honeycomb_model(L, Omega, alpha, 0.0)
    rng = np.random.default_rng(seed)
    tbp = TightBindingParameters.from_model(tbm, rng)
    elph = ElectronPhononParameters.from_model(beta, dtau, em, tbp, rng)
    ctx, state = initialize_qmc(
        tbp, elph, seed=seed, tol=tol, preconditioner="spectral", force_dtype="float32",
        mixed_precision=True,
    )
    return ctx, state


def bench_sweeps(n_sweeps=8, n_discard=2, Nt=24, sim=None):
    """Full QMC sweeps (reflection + swap + EFA-PFF-HMC) per second, plus the
    average CG iterations per solve inside the HMC trajectory.

    Window: the first call compiles, then `n_discard` post-compile sweeps run
    before the `n_sweeps`-sweep timed window opens."""
    import jax
    import jax.numpy as jnp

    from smoqyelphqmc_tpu.updates.global_updates import reflection_update, swap_update
    from smoqyelphqmc_tpu.updates.hmc import HMCParams, hmc_update

    ctx, state = build_sim(Nt=Nt) if sim is None else sim
    params = HMCParams(Nt=Nt)

    @jax.jit
    def sweep(s, iters_acc):
        s, _ = reflection_update(ctx, s)
        s, _ = swap_update(ctx, s)
        s, h = hmc_update(ctx, s, params)
        # accumulate INSIDE the jit: a separate eager add per sweep costs a
        # dispatch of its own
        return s, iters_acc + h.iters_avg

    # strong-typed accumulator: a weak-typed jnp.asarray(0.0) seed would make
    # the second call (which receives the strong-typed result) recompile the
    # whole sweep inside the timed loop
    iters = jnp.zeros((), jnp.float64)
    for _ in range(1 + n_discard):  # compile + warm-up batches
        state, iters = sweep(state, iters)
    jax.block_until_ready(iters)
    iters = jnp.zeros((), jnp.float64)
    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        state, iters = sweep(state, iters)
    jax.block_until_ready(iters)
    dt = time.perf_counter() - t0
    return n_sweeps / dt, float(iters) / n_sweeps


def bench_walker_sweeps(W=8, n_sweeps=6, n_discard=2, Nt=24, sim=None):
    """Aggregate walker-sweeps/sec with W chains batched on one device through
    the same CG (parallel/walkers.py). Same window as bench_sweeps: compile +
    n_discard warm batches, then a timed window."""
    import jax

    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states, walker_sweep
    from smoqyelphqmc_tpu.updates.hmc import HMCParams

    ctx, state0 = build_sim(Nt=Nt) if sim is None else sim
    states = init_walker_states(ctx, state0, W, seed=1)
    params = HMCParams(Nt=Nt)
    step = jax.jit(lambda s: walker_sweep(ctx, s, params))
    for _ in range(1 + n_discard):  # compile + warm-up batches
        states, _ = step(states)
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        states, _ = step(states)
    jax.block_until_ready(states)
    return n_sweeps * W / (time.perf_counter() - t0)


def bench_walker_measured(W=8, n_sweeps=6, n_discard=2, Nt=24, Nrv=10, sim=None,
                          k_scan=1):
    """Aggregate MEASURED walker-sweeps/sec: one full update sweep plus one
    estimator refresh + full tutorial measurement pass per walker per sweep —
    the end-to-end production rate of the flagship config. Window: compile +
    n_discard warm batches discarded, then >= n_sweeps timed (steady state).

    k_scan > 1 fuses k measured sweeps into one dispatched executable with
    device-side bin accumulation — exactly the production driver's
    cfg.sweeps_per_dispatch batching — so the per-dispatch host overhead
    amortizes k-fold."""
    import jax

    from smoqyelphqmc_tpu.measure.container import MeasurementSpec, make_measurements
    from smoqyelphqmc_tpu.measure.greens_estimator import (
        build_greens_estimator,
        update_greens_estimator,
    )
    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states, walker_sweep
    from smoqyelphqmc_tpu.updates.context import make_fdm
    from smoqyelphqmc_tpu.updates.hmc import HMCParams

    ctx, state0 = build_sim(Nt=Nt) if sim is None else sim
    import _common  # examples path inserted by build_sim

    geo = _common.holstein_honeycomb_model(12, 1.0, 0.6, 0.0)[0]
    spec = _common.holstein_honeycomb_spec(geo)
    states = init_walker_states(ctx, state0, W, seed=1)
    params = HMCParams(Nt=Nt)
    est0 = build_greens_estimator(ctx.elph.Ltau, geo.n_orbitals, geo.L, Nrv=Nrv, dtype="float32")

    @jax.jit
    def sweep_and_measure(states, key):
        states, _ = walker_sweep(ctx, states, params)
        keys = jax.random.split(key, W + 1)

        def one(state, k):
            fdm = make_fdm(ctx, state.x)
            upd = update_greens_estimator(
                est0, fdm, k, precond=state.precond, tol=ctx.tol, maxiter=ctx.maxiter,
                mixed=ctx.mixed_precision, solve_dtype="float32",
            )
            return make_measurements(ctx, spec, upd.estimator, state.x)

        out = jax.vmap(one)(states, keys[1:])
        return states, out, keys[0]

    import jax.numpy as jnp

    if k_scan > 1:
        # production sweeps_per_dispatch batching: scan the SAME body with
        # device-side bin-sum accumulation (mirrors driver.measured_k_mw)
        sums0 = jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype),
            jax.eval_shape(
                lambda s, k: sweep_and_measure(s, k)[1],
                states, jax.random.PRNGKey(0),
            ),
        )

        @jax.jit
        def sweep_k(states, key, sums):
            def body(carry, _):
                states, key, sums = carry
                states, out, key = sweep_and_measure(states, key)
                sums = jax.tree_util.tree_map(jnp.add, sums, out)
                return (states, key, sums), None

            (states, key, sums), _ = jax.lax.scan(
                body, (states, key, sums), None, length=k_scan
            )
            return states, key, sums

        key = jax.random.PRNGKey(7)
        sums = sums0
        for _ in range(1 + n_discard):  # compile + warm-up batches
            states, key, sums = sweep_k(states, key, sums)
        jax.block_until_ready(sums)
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            states, key, sums = sweep_k(states, key, sums)
        jax.block_until_ready(sums)
        return n_sweeps * k_scan * W / (time.perf_counter() - t0)

    key = jax.random.PRNGKey(7)
    for _ in range(1 + n_discard):  # compile + warm-up batches
        states, out, key = sweep_and_measure(states, key)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        states, out, key = sweep_and_measure(states, key)
    jax.block_until_ready(out)
    return n_sweeps * W / (time.perf_counter() - t0)


def bench_matvecs(n_iters=200, batch=2) -> float:
    """Return M^T M applications per second (one application = one batched field)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    fdm = build_case()

    v0 = jnp.asarray(np.random.default_rng(1).standard_normal((batch, fdm.Ltau, fdm.n_sites)))

    @jax.jit
    def loop(v):
        def body(_, v):
            v = fdm.mul_MtM(v)
            # rescale to prevent overflow over many applications
            return v / jnp.sqrt(jnp.mean(v * v))

        return lax.fori_loop(0, n_iters, body, v)

    jax.block_until_ready(loop(v0))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(loop(v0))
    dt = time.perf_counter() - t0
    return n_iters / dt


def numpy_mtm(fdm):
    """Pure-NumPy M^T M closure over a (symmetric, real-hopping) fdm's host
    tables — the timed kernel of bench_matvecs_numpy, factored out so tests and
    chip_smoke.py can check the XLA kernel against it."""
    n_colors = fdm.cb.n_colors
    C = np.asarray(fdm.cb.C)  # (n_colors, Ltau, N)
    S = np.asarray(fdm.cb.S)
    partner = np.asarray(fdm.cb.partner)  # (n_colors, N) int
    exp_nV = np.asarray(fdm.exp_nV)  # (Ltau, N)
    Ltau = fdm.Ltau
    sgn_first = np.full((Ltau, 1), -1.0)
    sgn_first[0, 0] = 1.0
    sgn_last = np.full((Ltau, 1), -1.0)
    sgn_last[Ltau - 1, 0] = 1.0
    assert fdm.symmetric and fdm.cb.S_im is None

    def apply_B(u):
        # symmetric factorization: CB^T (reversed colors) . exp(-dtau V) . CB
        for c in reversed(range(n_colors)):
            u = C[c] * u + S[c] * u[..., partner[c]]
        u = exp_nV * u
        for c in range(n_colors):
            u = C[c] * u + S[c] * u[..., partner[c]]
        return u

    def mul_MtM(v):
        u = apply_B(np.roll(v, 1, axis=-2))
        w = v + sgn_first * u  # M v
        u = apply_B(w)  # sym: B^T = B
        return w + sgn_last * np.roll(u, -1, axis=-2)  # M^T (M v)

    return mul_MtM


def bench_matvecs_numpy(n_iters=50, batch=2) -> float:
    """Implementation-independent single-core baseline: the SAME M^T M
    space-time matvec (4 checkerboard color sweeps + diagonal scaling + the
    antiperiodic tau-shift boundary) written in plain NumPy — no XLA anywhere
    in the timed loop. NumPy's elementwise kernels
    and fancy-index gathers are single-threaded, mirroring the reference's
    single-core Julia loop nest (checkerboard_matrix_multiply.jl:26-72: the
    same per-hop 2x2 mixes, there SIMD-vectorized over tau on one core)."""
    fdm = build_case()
    mul_MtM = numpy_mtm(fdm)
    v = np.random.default_rng(1).standard_normal((batch, fdm.Ltau, fdm.n_sites))
    v = mul_MtM(v)  # touch everything once (page-in)
    v /= np.sqrt(np.mean(v * v))
    t0 = time.perf_counter()
    for _ in range(n_iters):
        v = mul_MtM(v)
        v /= np.sqrt(np.mean(v * v))
    return n_iters / (time.perf_counter() - t0)


def _stage(name, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"[bench] {name}: {time.perf_counter() - t0:.1f}s wall", file=sys.stderr)
    return out


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "device"
    if mode == "cpu-baseline":
        import jax

        jax.config.update("jax_platforms", "cpu")
        print(json.dumps({"cpu_rate": bench_matvecs(n_iters=50)}))
        return

    import jax

    from smoqyelphqmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    result = {
        "metric": "MtM matvecs/sec (Holstein honeycomb L=12, beta=12, Ltau=240, N=288, f64)",
        "value": None,
        "unit": "matvec/s",
        "vs_baseline": None,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
        "extras": {},
    }
    ex = result["extras"]

    rate = _stage("matvecs", bench_matvecs)
    result["value"] = round(rate, 2)
    # ONE shared built sim across every sweep-level stage
    sim = build_sim(Nt=24)
    r = _stage("measured8", lambda: bench_walker_measured(W=8, sim=sim))
    ex.update(measured8_sweeps_per_sec=round(r, 4), walker8_measured_sweeps_per_sec=round(r, 4))
    r = _stage(
        "measured8k",
        lambda: bench_walker_measured(W=8, sim=sim, k_scan=6, n_sweeps=3, n_discard=1),
    )
    ex.update(measured8_k6_sweeps_per_sec=round(r, 4))  # sweeps_per_dispatch=6 batching
    sweeps, iters = _stage("sweeps", lambda: bench_sweeps(sim=sim))
    ex.update(hmc_sweeps_per_sec=round(sweeps, 4), cg_iters_per_solve=round(iters, 1))
    r = _stage("walker8", lambda: bench_walker_sweeps(W=8, sim=sim))
    ex.update(walker8_sweeps_per_sec=round(r, 4))

    np_rate = _stage("numpy-baseline", bench_matvecs_numpy)
    ex["numpy_matvecs_per_sec"] = round(np_rate, 2)
    ex["vs_numpy_baseline"] = round(rate / np_rate, 2)

    # single-core CPU baseline (the same XLA kernels pinned to one host core —
    # the same-machine stand-in for single-core Julia sweeps). It is a child
    # process only because it must pin itself to the CPU before JAX starts:
    # JAX_PLATFORMS=cpu keeps it off the card this process holds.
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
    env["OMP_NUM_THREADS"] = "1"
    out = _stage(
        "cpu-baseline",
        lambda: subprocess.run(
            [sys.executable, os.path.abspath(__file__), "cpu-baseline"],
            capture_output=True, text=True, env=env, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ),
    )
    cpu_rate = json.loads(out.stdout.strip().splitlines()[-1])["cpu_rate"]
    result["vs_baseline"] = round(rate / cpu_rate, 2)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
