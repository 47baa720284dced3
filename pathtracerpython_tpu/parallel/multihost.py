"""Multi-host runtime: process-group init and host-0 result assembly.

The reference's only "distributed backend" is a per-host
``multiprocessing.Pool`` with pickled results (``main.py:197-228``). Here
it is JAX's multi-controller runtime: every process runs this same
program, ``jax.distributed.initialize`` wires the processes into one
system, and data movement is XLA collectives (NCCL on GPUs) — no custom
transport. With an explicit coordinator:

    # in every process (same binary, same flags):
    from pathtracerpython_tpu.parallel import multihost
    multihost.initialize("localhost:12345", num_processes=2, process_id=i)
    mesh = make_mesh(dp=..., geom=...)     # global devices
    radiance = render_sharded(scene, cfg, mesh, ...)
    image = multihost.fetch_to_host(radiance)   # addressable everywhere
"""

from __future__ import annotations

import os

import jax
import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the multi-host runtime. Returns True if distributed mode
    is active.

    The coordinator comes from the argument or ``JAX_COORDINATOR_ADDRESS``;
    with neither it's a no-op, so the same entry point serves
    single-process runs. Nothing is auto-detected: multi-process runs pass
    ``num_processes`` and ``process_id`` too.
    """
    explicit = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if not explicit:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def is_primary() -> bool:
    return jax.process_index() == 0


def fetch_to_host(array: jax.Array) -> np.ndarray:
    """Assemble a (possibly cross-host sharded) array on every host.

    Uses ``jax.experimental.multihost_utils`` when shards span processes
    (an XLA all-gather), plain device-get otherwise.
    """
    if jax.process_count() == 1 or array.is_fully_addressable:
        return np.asarray(array)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(array, tiled=True)
    )


def sync(name: str = "barrier") -> None:
    """Cross-host barrier (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def to_global(x: jax.Array, mesh, spec) -> jax.Array:
    """Host-replicated value → global array laid out as ``spec`` on
    ``mesh``.

    Multi-process ``shard_map``/``jit`` require GLOBAL arrays; a value
    built identically on every process (camera rays, the scene pytree, an
    RNG key — everything ``render_sharded`` feeds the mesh) becomes one by
    each process materializing just its addressable shards. Single-process
    (including the virtual 8-device CPU mesh) is a no-op: XLA shards
    host-local arrays itself.
    """
    if jax.process_count() == 1:
        return x
    from jax.sharding import NamedSharding

    xnp = np.asarray(x)
    return jax.make_array_from_callback(
        xnp.shape, NamedSharding(mesh, spec), lambda idx: xnp[idx]
    )
