"""Many-walker parallelism: vmapped Markov chains sharded over a device mesh.

The reference's only parallel strategy is embarrassingly-parallel MPI walkers —
one rank per chain, collectives only at folder init / checkpoint / statistics
merging (/root/reference/tutorials/holstein_honeycomb_mpi.jl:24-72, SURVEY.md
section 2d). The accelerator replacement:

  - a leading walker axis on QMCState, advanced by `jax.vmap`ed update kernels
    (one traced program, W chains in flight — on one card this also batches
    all the CG solves together);
  - for multiple cards, the walker axis is sharded over a 1-D
    `jax.sharding.Mesh`. The chains are independent, so the updates and
    measurements need no communication; the one collective is the walker
    mean in `shared_precond_refresh`, which becomes an all-reduce across
    cards (statistics merging happens on host at postprocessing, exactly like
    the reference's per-rank files).

RNG: per-walker keys from `jax.random.split` replace per-rank seeds."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..measure.container import make_measurements
from ..measure.greens_estimator import GreensEstimator, update_greens_estimator
from ..updates.context import QMCContext, QMCState, make_fdm
from ..updates.global_updates import reflection_update, swap_update
from ..updates.hmc import HMCParams, hmc_update


def init_walker_states(ctx: QMCContext, base_state: QMCState, n_walkers: int, seed: int = 0) -> QMCState:
    """Replicate the chain state over a leading walker axis with independent keys
    and independently-jittered initial fields."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_walkers)
    noise = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), (n_walkers,) + base_state.x.shape)
    x = base_state.x[None] + noise
    precond = None
    if base_state.precond is not None:
        precond = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a[None], (n_walkers,) + a.shape), base_state.precond
        )
    return QMCState(x=x, key=keys, precond=precond)


def walker_device_count(n_walkers: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides n_walkers evenly: the
    walker axis is sharded in equal blocks, so a mesh whose size does not
    divide W cannot hold it."""
    return max(d for d in range(1, min(n_walkers, n_devices) + 1) if n_walkers % d == 0)


def walker_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("walkers",))


def shard_walker_states(states: QMCState, mesh: Mesh) -> QMCState:
    """Place the leading walker axis across the mesh; everything else replicated."""

    def put(a):
        spec = P("walkers", *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, states)


def shared_precond_refresh(ctx: QMCContext, states: QMCState) -> QMCState:
    """Refresh the carried preconditioner ONCE from the WALKER-MEAN propagator
    factors and broadcast it to every walker.

    One eigh replaces W batched ones, while the tau-averaged Bbar differs
    across equilibrated walkers by the same order as the tau fluctuations it
    already averages over — CG iteration counts at the headline configuration
    came out the same (13.6 vs 13.7) with the shared preconditioner, at 1/W
    the refresh cost. Preconditioner quality only
    affects iteration count, never the sampled distribution."""
    if states.precond is None:
        return states
    from ..updates.context import make_fdm as _make_fdm

    fdms = jax.vmap(lambda x: _make_fdm(ctx, x))(states.x)
    fdm_mean = jax.tree_util.tree_map(lambda a: jnp.mean(a, axis=0), fdms)
    template = jax.tree_util.tree_map(lambda a: a[0], states.precond)
    from ..ops.preconditioner import refresh_preconditioner

    pre = refresh_preconditioner(template, fdm_mean, states.key[0])
    W = states.x.shape[0]
    pre_w = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (W,) + a.shape), pre)
    return QMCState(x=states.x, key=states.key, precond=pre_w)


class PrecondFallbackController:
    """Host-side guard for the shared walker-mean preconditioner refresh.

    The shared refresh (shared_precond_refresh) is iteration-neutral when
    walker propagators agree — validated at weak coupling — but at strong
    coupling or during early thermalization walkers genuinely differ and a
    walker-mean Bbar can degrade every walker's CG. This controller tracks the
    running minimum of per-sweep mean trajectory-CG iteration counts; a
    shared-mode sweep exceeding `ratio` x that floor demotes to per-walker
    refresh, and a probe sweep every `retry_every` sweeps promotes back once
    shared mode is iteration-neutral again.

    Iteration counts are recorded as DEVICE scalars and resolved one sweep
    late (`resolve()` at the start of the next `choose()`), so the controller
    never stalls the dispatch pipeline waiting on the device.
    """

    def __init__(self, ratio: float = 1.5, retry_every: int = 32, enabled: bool = True):
        self.ratio = float(ratio)
        self.retry_every = max(int(retry_every), 1)
        self.enabled = bool(enabled) and np.isfinite(ratio)
        self.mode = "shared"
        self.floor = np.inf
        self.pw_count = 0  # sweeps since entering per-walker mode
        self.fallback_sweeps = 0  # total sweeps run with per-walker refresh
        self._pending = None  # (iters scalar — device array or float, was_shared)

    def _resolve(self):
        if self._pending is None:
            return
        it_dev, was_shared = self._pending
        self._pending = None
        it = float(np.asarray(it_dev))
        if not np.isfinite(it) or it <= 0.0:
            return
        self.floor = min(self.floor, it)
        healthy = it <= self.ratio * self.floor
        if was_shared:
            self.mode = "shared" if healthy else "perwalker"

    def choose(self) -> bool:
        """True = refresh shared this sweep (includes periodic probe sweeps)."""
        if not self.enabled:
            return True
        self._resolve()
        probing = (
            self.mode == "perwalker"
            and self.pw_count % self.retry_every == self.retry_every - 1
        )
        return self.mode == "shared" or probing

    def record(self, iters_dev, used_shared: bool):
        """Feed back this sweep's mean trajectory-CG iteration count (a device
        scalar is fine — it is not read until the next choose())."""
        if not self.enabled:
            return
        self._pending = (iters_dev, used_shared)
        if not used_shared:
            self.fallback_sweeps += 1
        if self.mode == "perwalker":
            self.pw_count += 1
        else:
            self.pw_count = 0

    def state_dict(self) -> dict:
        """Checkpointable controller state. The controller's (floor, mode)
        trajectory influences WHICH refresh runs each sweep, so a resumed run
        must restore it to reproduce an uninterrupted run bit-for-bit
        (tests/test_multihost.py::test_multihost_kill_and_resume). Resolves any
        pending device scalar first — the driver's checkpoint path is already a
        host sync point (it folds device accumulators into metadata)."""
        self._resolve()
        return {
            "mode": self.mode,
            "floor": float(self.floor),
            "pw_count": int(self.pw_count),
            "fallback_sweeps": int(self.fallback_sweeps),
        }

    def load_state(self, d: dict) -> None:
        self.mode = str(d["mode"])
        self.floor = float(d["floor"])
        self.pw_count = int(d["pw_count"])
        self.fallback_sweeps = int(d["fallback_sweeps"])
        self._pending = None


def walker_sweep(
    ctx: QMCContext, states: QMCState, hmc_params: HMCParams, recenter=None,
    shared_precond: bool = True,
):
    """One (reflection + swap + HMC) sweep for every walker. With
    shared_precond (default) the preconditioner refresh happens once per sweep
    from the walker-mean propagator instead of per walker inside hmc_update."""
    if shared_precond and states.precond is not None:
        states = shared_precond_refresh(ctx, states)
        hmc_params = hmc_params.replace(refresh_precond_at_start=False)

    def one(state):
        state, r = reflection_update(ctx, state)
        state, s = swap_update(ctx, state)
        state, h = hmc_update(ctx, state, hmc_params, recenter=recenter)
        return state, (r, s, h)

    return jax.vmap(one)(states)


def walker_measure(
    ctx: QMCContext,
    spec,
    states: QMCState,
    est: GreensEstimator,
    keys,
    tol: float = 1e-10,
    maxiter: int = 10_000,
    mixed: bool = False,
):
    """Refresh the Green's estimator and take a full measurement pass per walker.
    `est` is a single-template estimator; each walker gets its own random vectors."""

    def one(state, key):
        fdm = make_fdm(ctx, state.x)
        upd = update_greens_estimator(
            est, fdm, key, precond=state.precond, tol=tol, maxiter=maxiter, mixed=mixed
        )
        out = make_measurements(ctx, spec, upd.estimator, state.x)
        return out, upd.iters

    return jax.vmap(one)(states, keys)
