"""Stage-level profile of the W-walker batched sweep.

Times each update stage vmapped at W in {1, 8}: reflection, swap, HMC
(trajectory), the preconditioner refresh alone, one force evaluation, and the
measurement-estimator refresh. Reports per-walker efficiency (t_1 / (t_W / W))
for each stage to locate where walker batching loses throughput.

Run: python scripts/walker_profile.py [--cpu] [--W 8] [--precond spectral|kpm]
"""

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
    W = 8
    precond = "spectral"
    for i, a in enumerate(sys.argv):
        if a == "--W":
            W = int(sys.argv[i + 1])
        if a == "--precond":
            precond = sys.argv[i + 1]
    import jax

    from bench import build_sim
    from smoqyelphqmc_tpu.ops.pff import fermionic_action_and_force, sample_pseudofermion_fields
    from smoqyelphqmc_tpu.ops.preconditioner import refresh_preconditioner
    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states
    from smoqyelphqmc_tpu.updates.context import make_fdm
    from smoqyelphqmc_tpu.updates.global_updates import reflection_update, swap_update
    from smoqyelphqmc_tpu.updates.hmc import HMCParams, hmc_update

    ctx, state0 = build_sim()
    if precond != "spectral":
        from smoqyelphqmc_tpu.updates.context import initialize_qmc  # rebuild

        ctx, state0 = build_sim()
    params = HMCParams(Nt=24)
    print(f"device: {jax.devices()[0].platform}, W={W}, precond={precond}")

    def stage_refresh(s):
        fdm = make_fdm(ctx, s.x)
        return refresh_preconditioner(s.precond, fdm, s.key)

    def stage_pff(s):
        fdm = make_fdm(ctx, s.x)
        return sample_pseudofermion_fields(s.key, ctx.elph, fdm, s.x)[0]

    def stage_force(s):
        fdm = make_fdm(ctx, s.x)
        Phi, _ = sample_pseudofermion_fields(s.key, ctx.elph, fdm, s.x)
        res = fermionic_action_and_force(
            Phi, ctx.elph, fdm, s.x, ctx.plan,
            precond=s.precond, tol=ctx.tol_force, maxiter=ctx.maxiter,
            solve_dtype=ctx.force_dtype,
        )
        return res.force

    def stage_reflection(s):
        return reflection_update(ctx, s)[0].x

    def stage_swap(s):
        return swap_update(ctx, s)[0].x

    def stage_hmc(s):
        return hmc_update(ctx, s, params)[0].x

    def stage_sweep(s):
        s, _ = reflection_update(ctx, s)
        s, _ = swap_update(ctx, s)
        s, _ = hmc_update(ctx, s, params)
        return s.x

    stages = [
        ("precond refresh", stage_refresh),
        ("pff sample", stage_pff),
        ("force eval (1 solve)", stage_force),
        ("reflection", stage_reflection),
        ("swap", stage_swap),
        ("hmc trajectory", stage_hmc),
        ("full sweep", stage_sweep),
    ]

    states_1 = init_walker_states(ctx, state0, 1, seed=1)
    states_W = init_walker_states(ctx, state0, W, seed=1)

    print(f"| stage | t(W=1) ms | t(W={W}) ms | per-walker ms | batching eff |")
    print("|---|---|---|---|---|")
    for name, fn in stages:
        f1 = jax.jit(jax.vmap(fn))
        t1 = timeit(f1, states_1, n=3) * 1e3
        tW = timeit(f1, states_W, n=3) * 1e3
        eff = t1 / (tW / W)
        print(f"| {name} | {t1:.1f} | {tW:.1f} | {tW / W:.1f} | {eff:.1f}x |", flush=True)


if __name__ == "__main__":
    main()
