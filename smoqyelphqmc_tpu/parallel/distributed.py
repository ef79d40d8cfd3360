"""Multi-host walker scale-out via jax.distributed.

The reference scales by launching MPI ranks, one independent Markov chain each
(/root/reference/tutorials/holstein_honeycomb_mpi.jl:24-72). The JAX
equivalents, by deployment size:

  - one card:       vmapped walker axis (parallel/walkers.py)
  - one host's cards: the same walker axis sharded over `jax.sharding.Mesh` —
    chains are independent; the one collective is the walker mean of the
    shared preconditioner refresh (parallel/walkers.shared_precond_refresh)
  - multiple hosts: `jax.distributed.initialize()` + a global mesh
    over all processes' devices. Each host runs the SAME driver program
    (SPMD); walker state is globally sharded; each host writes only the bin
    files of ITS OWN walkers (pID-tagged), exactly like per-rank files in the
    reference, and statistics merging stays a host-side postprocessing step.

There is no point-to-point communication anywhere: besides that all-reduce,
like the reference's MPI usage, the only cross-process coordination is folder
initialization and final statistics merging (SURVEY.md section 2d).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime (call ONCE, before any jax op, on every
    host). Pass all three arguments on a cluster that JAX cannot detect on
    its own, such as one machine with several cards.

    Equivalent role to MPI.Init() in the reference's MPI tutorial."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_walker_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over ALL devices of ALL processes (jax.devices() is global
    after jax.distributed.initialize)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("walkers",))


def local_walker_ids(mesh: Mesh, n_walkers: int) -> Sequence[int]:
    """The walker indices whose shards live on THIS process — the set of pIDs
    this host is responsible for writing (per-rank output files in the
    reference, holstein_honeycomb_mpi.jl:59-72)."""
    n_dev = mesh.devices.size
    assert n_walkers % n_dev == 0, (
        f"n_walkers={n_walkers} must be a multiple of the mesh size {n_dev}"
    )
    per_dev = n_walkers // n_dev
    ids = []
    for flat_idx, dev in enumerate(mesh.devices.flat):
        if dev.process_index == jax.process_index():
            ids.extend(range(flat_idx * per_dev, (flat_idx + 1) * per_dev))
    return ids


def gather_walker_scalars(values, mesh: Mesh):
    """All-gather a per-walker scalar array to every host (e.g. acceptance
    diagnostics). Chains are independent, so this is only ever needed for
    reporting — never inside the update step."""
    import jax.numpy as jnp

    sharding = NamedSharding(mesh, P("walkers"))
    arr = jax.device_put(values, sharding) if not hasattr(values, "sharding") else values
    # replicate: an all-gather expressed as a resharding to fully-replicated
    return np.asarray(jax.device_put(arr, NamedSharding(mesh, P())))


def barrier(name: str = "smoqy_barrier") -> None:
    """Cross-process synchronization point (folder init / final merge gating —
    the role of MPI.Barrier around initialize_datafolder in the reference's MPI
    tutorial, holstein_honeycomb_mpi.jl:72). No-op with one process."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def walker_row(a, w: int) -> np.ndarray:
    """Host copy of walker `w`'s row of a leading-walker-axis array, read ONLY
    from this process's addressable shards — zero communication, so each host
    can extract exactly its owned walkers (per-rank file ownership in the
    reference, holstein_honeycomb_mpi.jl:59-72). `w` must be owned by this
    process (see local_walker_ids); raises otherwise."""
    if not isinstance(a, jax.Array) or a.is_fully_addressable:
        return np.asarray(a)[w]
    for shard in a.addressable_shards:
        sl = shard.index[0] if shard.index else slice(None)
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else a.shape[0]
        if start <= w < stop:
            return np.asarray(shard.data)[w - start]
    raise IndexError(
        f"walker {w} is not addressable on process {jax.process_index()}"
    )


def walker_row_tree(tree, w: int):
    """`walker_row` mapped over a pytree of leading-walker-axis arrays."""
    return jax.tree_util.tree_map(lambda a: walker_row(a, w), tree)


def local_walker_block(a, owned: Sequence[int]) -> np.ndarray:
    """Host copy of this process's contiguous walker block (stacked owned rows)
    — the per-process checkpoint payload."""
    return np.stack([walker_row(a, w) for w in owned], axis=0)


def global_walker_array(local_block: np.ndarray, mesh: Mesh, n_walkers: int):
    """Reassemble a global leading-walker-axis array from each process's local
    block (the inverse of local_walker_block; used on checkpoint resume)."""
    spec = P("walkers", *([None] * (local_block.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    global_shape = (n_walkers,) + local_block.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local_block, global_shape)
