"""Stage profile of the W-walker measurement pass.

Times, at the headline config (Holstein honeycomb L=12, beta=12, Ltau=240,
W walkers, Nrv random vectors):

- estimator refresh (Nrv batched f32 CG solves);
- the full tutorial measurement pass (make_measurements);
- each correlation kind in isolation (the contraction engine's cost split);
- the global+local scalar stage.

Run: python scripts/measure_profile.py [--W 8] [--Nrv 10]
"""

import sys
import time

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
    W = 8
    Nrv = 10
    for i, a in enumerate(sys.argv):
        if a == "--W":
            W = int(sys.argv[i + 1])
        if a == "--Nrv":
            Nrv = int(sys.argv[i + 1])
    import jax

    from bench import build_sim
    from smoqyelphqmc_tpu.measure.container import MeasurementSpec, make_measurements
    from smoqyelphqmc_tpu.measure.greens_estimator import (
        build_greens_estimator,
        update_greens_estimator,
    )
    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states
    from smoqyelphqmc_tpu.updates.context import make_fdm

    ctx, state0 = build_sim(Nt=24)
    import _common

    geo = _common.holstein_honeycomb_model(12, 1.0, 0.6, 0.0)[0]
    spec = _common.holstein_honeycomb_spec(geo)
    states = init_walker_states(ctx, state0, W, seed=1)
    est0 = build_greens_estimator(ctx.elph.Ltau, geo.n_orbitals, geo.L, Nrv=Nrv, dtype="float32")
    print(f"device: {jax.devices()[0]}, W={W}, Nrv={Nrv}")
    print(f"correlations: {list(spec.correlations)}  composites: {list(spec.composites)}")

    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, W)

    @jax.jit
    def refresh(states, keys):
        def one(state, k):
            fdm = make_fdm(ctx, state.x)
            upd = update_greens_estimator(
                est0, fdm, k, precond=state.precond, tol=ctx.tol, maxiter=ctx.maxiter,
                mixed=ctx.mixed_precision, solve_dtype="float32",
            )
            return upd.estimator

        return jax.vmap(one)(states, keys)

    ests = refresh(states, keys)
    jax.block_until_ready(ests.R)
    t_refresh = timeit(refresh, states, keys) * 1e3

    @jax.jit
    def full(ests, states):
        return jax.vmap(lambda e, s: make_measurements(ctx, spec, e, s.x))(ests, states)

    t_full = timeit(full, ests, states) * 1e3

    # global + local only
    empty = MeasurementSpec(geometry=spec.geometry)

    @jax.jit
    def glob_local(ests, states):
        return jax.vmap(lambda e, s: make_measurements(ctx, empty, e, s.x))(ests, states)

    t_gl = timeit(glob_local, ests, states) * 1e3

    rows = [("refresh", t_refresh), ("make_measurements (full)", t_full), ("global+local only", t_gl)]

    # each correlation kind in isolation (incremental over global+local)
    for name, req in list(spec.correlations.items()) + [
        (f"composite:{n}", c) for n, c in spec.composites.items()
    ]:
        one_spec = MeasurementSpec(geometry=spec.geometry)
        if name.startswith("composite:"):
            one_spec.composites[name.split(":", 1)[1]] = req
        else:
            one_spec.correlations[name] = req

        fn = jax.jit(
            lambda ests, states, sp=one_spec: jax.vmap(
                lambda e, s: make_measurements(ctx, sp, e, s.x)
            )(ests, states)
        )
        t = timeit(fn, ests, states) * 1e3
        rows.append((f"  {name}", t - t_gl))

    print("| stage | t ms (W total) | per-walker ms |")
    print("|---|---|---|")
    for name, t in rows:
        print(f"| {name} | {t:.1f} | {t / W:.2f} |", flush=True)


if __name__ == "__main__":
    main()
