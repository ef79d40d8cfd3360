"""System-size scaling study: solve cost and sweep cost at L = 6..24.

The reference's headline claim is NEAR-LINEAR scaling of the QMC sweep cost in
system size (/root/reference/README.md:9-11), delivered by an O(order * N)
KPM-preconditioned CG (/root/reference/src/KPMPreconditioner.jl:288-352). This
script measures, on the live device, for Holstein honeycomb at beta = 12
(Ltau = 240) and L in {6, 12, 18, 24} (N = 72 .. 1152):

  - M^T M matvec time (the O(N) kernel)
  - preconditioned CG solve time + iterations for spectral / kpm / none
  - preconditioner refresh time (eigh for spectral; Lanczos + dense stride
    matrix for kpm)
  - estimated per-sweep cost: 27 solves * t_solve + 3 refreshes
    (reflection + swap + 25 HMC solves; 3 refreshes/sweep)

and prints a Markdown table plus the implied auto-select
crossover. Run: python scripts/scaling_bench.py [--cpu] [--sizes 6,12]
[--skip-none] [--skip-spectral] — the skip flags drop the unpreconditioned
solve (minutes at N >= 2500) and the dense-eigh spectral path for the
large-N matrix-free KPM study (L=36/48, N=2592/4608).
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timeit(fn, *args, n=5):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sizes = [6, 12, 18, 24]
    for i, a in enumerate(sys.argv):
        if a == "--sizes":
            sizes = [int(s) for s in sys.argv[i + 1].split(",")]
    skip = {lbl for lbl in ("none", "spectral") if f"--skip-{lbl}" in sys.argv}
    import jax
    import jax.numpy as jnp

    from bench import build_case
    from smoqyelphqmc_tpu.ops.cg import cg_solve
    from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner, kpm_update
    from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral, spectral_update

    print(f"device: {jax.devices()[0].platform}")
    print("| L | N | matvec ms | spectral: refresh/solve ms (iters) | "
          "kpm: refresh/solve ms (iters) | none: solve ms (iters) | "
          "f32 force solve ms (iters) | est sweep ms spectral/kpm |")
    print("|---|---|---|---|---|---|---|---|")
    rows = []
    for L in sizes:
        fdm = build_case(L=L)
        N, Ltau = fdm.n_sites, fdm.Ltau
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.standard_normal((2, Ltau, N)))
        t_mv = timeit(jax.jit(fdm.mul_MtM), v, n=20) * 1e3

        results = {}
        for label in ("spectral", "kpm", "none"):
            if label in skip:
                results[label] = (float("nan"),) * 3
                continue
            try:
                if label == "spectral":
                    build = jax.jit(lambda f: build_spectral(f, dtype="float32"))
                    pre = build(fdm)
                    t_refresh = timeit(build, fdm, n=3) * 1e3
                    op = pre.as_operator()
                elif label == "kpm":
                    pre = KPMPreconditioner.build(fdm, jax.random.PRNGKey(0))
                    upd = jax.jit(kpm_update)
                    t_refresh = timeit(upd, pre, fdm, jax.random.PRNGKey(1), n=3) * 1e3
                    op = pre.as_operator()
                else:
                    t_refresh = 0.0
                    op = None
                solve = jax.jit(
                    lambda b, _op=op: cg_solve(fdm.mul_MtM, b, precond=_op, tol=1e-10, maxiter=8000)
                )
                x, stats = solve(v)
                jax.block_until_ready(x)
                t_solve = timeit(lambda b: solve(b)[0], v, n=3) * 1e3
                results[label] = (t_refresh, t_solve, int(stats.iters))
            except Exception as e:  # pragma: no cover
                print(f"  {label} failed at L={L}: {e}", file=sys.stderr)
                results[label] = (float("nan"),) * 3

        # production force-solve path: f32 solve_MtM with the AUTO-selected
        # preconditioner (spectral <= 4000 sites, kpm above)
        try:
            from smoqyelphqmc_tpu.ops.fermion_det import solve_MtM
            from smoqyelphqmc_tpu.ops.preconditioner import AUTO_SPECTRAL_MAX_SITES

            if N <= AUTO_SPECTRAL_MAX_SITES and "spectral" not in skip:
                pre32 = jax.jit(lambda f: build_spectral(f, dtype="float32"))(fdm)
            else:
                pre32 = KPMPreconditioner.build(fdm.astype(jnp.float32), jax.random.PRNGKey(0))
            s32 = jax.jit(
                lambda f, p, b: solve_MtM(f, b, precond=p, tol=1e-5, maxiter=2000)
            )
            v32 = v.astype(jnp.float32)
            x32, st32 = s32(fdm, pre32, v32)
            jax.block_until_ready(x32)
            t_f32 = timeit(lambda b: s32(fdm, pre32, b)[0], v32, n=5) * 1e3
            f32_col = f"{t_f32:.1f} ({int(st32.iters)})"
        except Exception as e:  # pragma: no cover
            print(f"  f32 solve failed at L={L}: {e}", file=sys.stderr)
            f32_col = "nan"

        sp, kp, no = results["spectral"], results["kpm"], results["none"]
        sweep_sp = 27 * sp[1] + 3 * sp[0]
        sweep_kp = 27 * kp[1] + 3 * kp[0]
        rows.append((L, N, t_mv, sp, kp, no, sweep_sp, sweep_kp))
        print(
            f"| {L} | {N} | {t_mv:.3f} | {sp[0]:.1f}/{sp[1]:.1f} ({sp[2]}) | "
            f"{kp[0]:.1f}/{kp[1]:.1f} ({kp[2]}) | {no[1]:.1f} ({no[2]}) | "
            f"{f32_col} | {sweep_sp:.0f}/{sweep_kp:.0f} |",
            flush=True,
        )

    # near-linearity diagnostic: cost ratio vs N ratio relative to the smallest size
    if len(rows) > 1:
        L0, N0 = rows[0][0], rows[0][1]
        base = min(rows[0][6], rows[0][7])
        print("\nscaling vs N (best preconditioner per size):")
        for r in rows:
            best = min(r[6], r[7])
            which = "spectral" if r[6] <= r[7] else "kpm"
            print(
                f"  L={r[0]:2d} N={r[1]:4d}: sweep {best:8.0f} ms = "
                f"{best / base:5.2f}x cost at {r[1] / N0:5.2f}x sites [{which}]"
            )


if __name__ == "__main__":
    main()
