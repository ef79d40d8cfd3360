"""A/B stress test of the shared walker-mean preconditioner refresh.

The shared refresh (parallel/walkers.shared_precond_refresh) was validated
iteration-neutral at one weak coupling; this script stresses it where walker
propagators genuinely differ:

  - STRONG COUPLING: alpha in {0.6, 2.0, 2.5} (reference refresh semantics:
    /root/reference/src/KPMPreconditioner.jl:554-597)
  - EARLY THERMALIZATION: the first 10 sweeps from independently-jittered
    walker fields, before the chains equilibrate
  - EQUILIBRATED: the same A/B after 30 equilibration sweeps

For each (alpha, phase) it runs W=8 walkers from IDENTICAL initial states with
(a) one shared walker-mean refresh per sweep and (b) per-walker refresh inside
hmc_update, and reports mean trajectory-CG iterations per solve per sweep.

Run: python scripts/precond_stress.py [--cpu] [--L 12] [--beta 12]
     [--alphas 0.6,2.0,2.5] [--W 8] [--nt 24]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    argv = sys.argv[1:]

    def arg(name, default, cast):
        if f"--{name}" in argv:
            return cast(argv[argv.index(f"--{name}") + 1])
        return default

    if "--cpu" in argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    L = arg("L", 12, int)
    beta = arg("beta", 12.0, float)
    alphas = arg("alphas", [0.6, 2.0, 2.5], lambda s: [float(x) for x in s.split(",")])
    W = arg("W", 8, int)
    Nt = arg("nt", 24, int)
    n_probe = arg("probe", 10, int)
    n_equil = arg("equil", 30, int)

    import jax
    import jax.numpy as jnp

    from bench import build_sim
    from smoqyelphqmc_tpu.parallel.walkers import init_walker_states, walker_sweep
    from smoqyelphqmc_tpu.updates.hmc import HMCParams

    params = HMCParams(Nt=Nt)

    # ctx passed as a jit ARG: all alphas share one compiled program per mode
    step_shared = jax.jit(lambda c, s: walker_sweep(c, s, params, shared_precond=True))
    step_pw = jax.jit(lambda c, s: walker_sweep(c, s, params, shared_precond=False))

    def probe(step, ctx, states, n):
        """Returns (states, per-sweep iters, per-sweep wall s). The float()
        pull per sweep waits for the sweep; the first sweep of a fresh mode
        carries compile and is excluded from the wall stats."""
        iters = []
        walls = []
        for k in range(n):
            t0 = time.perf_counter()
            states, (_, _, h) = step(ctx, states)
            iters.append(float(jnp.mean(h.iters_avg)))
            if k > 0:
                walls.append(time.perf_counter() - t0)
        return states, iters, walls

    print(f"device: {jax.devices()[0].platform}  L={L} beta={beta} W={W} Nt={Nt}")
    print("| alpha | phase | shared iters/solve (per sweep) | per-walker iters/solve | ratio | shared ms/sweep | per-walker ms/sweep |")
    print("|---|---|---|---|---|---|---|")
    for alpha in alphas:
        ctx, state0 = build_sim(L=L, beta=beta, alpha=alpha, Nt=Nt)
        states0 = init_walker_states(ctx, state0, W, seed=2)

        rows = []
        t0 = time.perf_counter()
        # EARLY THERMALIZATION: both modes from the identical jittered init
        _, it_sh, w_sh = probe(step_shared, ctx, states0, n_probe)
        _, it_pw, w_pw = probe(step_pw, ctx, states0, n_probe)
        rows.append(("early-therm", it_sh, it_pw, w_sh, w_pw))
        # EQUILIBRATED: burn in (per-walker refresh = the conservative
        # reference-faithful path), then A/B from the equilibrated state
        eq, _, _ = probe(step_pw, ctx, states0, n_equil)
        _, it_sh2, w_sh2 = probe(step_shared, ctx, eq, n_probe)
        _, it_pw2, w_pw2 = probe(step_pw, ctx, eq, n_probe)
        rows.append(("equilibrated", it_sh2, it_pw2, w_sh2, w_pw2))
        for phase, sh, pw, wsh, wpw in rows:
            m_sh, m_pw = np.mean(sh), np.mean(pw)
            fmt = lambda v: "/".join(f"{x:.1f}" for x in v)
            print(
                f"| {alpha} | {phase} | {m_sh:.2f} [{fmt(sh)}] | {m_pw:.2f} [{fmt(pw)}] | "
                f"{m_sh / m_pw:.3f} | {1e3 * np.mean(wsh):.0f} | {1e3 * np.mean(wpw):.0f} |",
                flush=True,
            )
        print(f"  (alpha={alpha}: {time.perf_counter() - t0:.0f}s wall)", file=sys.stderr)


if __name__ == "__main__":
    main()
