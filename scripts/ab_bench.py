"""A/B performance harness for preconditioner and batching decisions.

Compares, at the BASELINE.md headline config:
  1. spectral (f32/f64) vs KPM preconditioner: solve time + iterations
  2. eigh-on-device cost (the spectral refresh)
  3. walker batching W in {1, 2, 4, 8}: batched MtM throughput scaling
Run on the GPU: python scripts/ab_bench.py (--cpu forces the CPU backend for a
dry run; its times say nothing about the card)."""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timeit(fn, *args, n=3):
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
    import jax
    import jax.numpy as jnp

    from bench import build_case
    from smoqyelphqmc_tpu.ops.cg import cg_solve
    from smoqyelphqmc_tpu.ops.kpm import KPMPreconditioner
    from smoqyelphqmc_tpu.ops.spectral_precond import build_spectral

    fdm = build_case()
    print(f"config: Ltau={fdm.Ltau} N={fdm.n_sites}")
    v = jnp.asarray(np.random.default_rng(0).standard_normal((2, fdm.Ltau, fdm.n_sites)))

    # 1. preconditioner comparison
    for label, builder in [
        ("spectral-f32", lambda: build_spectral(fdm, dtype="float32")),
        ("spectral-f64", lambda: build_spectral(fdm, dtype="float64")),
        ("kpm", lambda: KPMPreconditioner.build(fdm, jax.random.PRNGKey(0))),
        ("none", lambda: None),
    ]:
        try:
            t_build = time.perf_counter()
            pre = builder()
            if pre is not None:
                jax.block_until_ready(jax.tree_util.tree_leaves(pre)[0])
            t_build = time.perf_counter() - t_build
            solve = jax.jit(
                lambda b: cg_solve(
                    fdm.mul_MtM, b,
                    precond=pre.as_operator() if pre is not None else None,
                    tol=1e-10, maxiter=4000,
                )
            )
            x, stats = solve(v)
            jax.block_until_ready(x)
            t = timeit(lambda b: solve(b)[0], v, n=3)
            print(f"{label}: build {t_build*1e3:.1f} ms, solve {t*1e3:.1f} ms, iters {int(stats.iters)}")
        except Exception as e:
            print(f"{label}: FAILED {type(e).__name__}: {str(e)[:150]}")

    # 2. eigh cost in isolation
    try:
        from smoqyelphqmc_tpu.ops.kpm import averaged_propagator

        bbar = averaged_propagator(fdm)
        eye = jnp.eye(fdm.n_sites)
        densify = jax.jit(lambda: bbar.apply(eye).T)
        B = densify()
        jax.block_until_ready(B)
        eigh = jax.jit(jnp.linalg.eigh)
        w, Q = eigh(B)
        jax.block_until_ready(Q)
        print(f"eigh({fdm.n_sites}) f64: {timeit(lambda: eigh(B)[1], n=3)*1e3:.1f} ms")
        B32 = B.astype(jnp.float32)
        eigh32 = jax.jit(jnp.linalg.eigh)
        w, Q = eigh32(B32)
        jax.block_until_ready(Q)
        print(f"eigh({fdm.n_sites}) f32: {timeit(lambda: eigh32(B32)[1], n=3)*1e3:.1f} ms")
    except Exception as e:
        print(f"eigh: FAILED {type(e).__name__}: {str(e)[:150]}")

    # 3. walker batching of the matvec
    for W in (1, 2, 4, 8):
        vb = jnp.asarray(
            np.random.default_rng(1).standard_normal((W, 2, fdm.Ltau, fdm.n_sites))
        )
        mv = jax.jit(fdm.mul_MtM)
        t = timeit(mv, vb, n=10)
        print(f"W={W}: {t*1e3:.2f} ms/batched-matvec -> {W/t:.0f} walker-matvecs/s")


if __name__ == "__main__":
    main()
