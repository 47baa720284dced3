"""Subprocess body for the 2-process ``jax.distributed`` test.

Each process owns 2 virtual CPU devices; ``jax.distributed.initialize``
wires them into one 4-device system (the runtime the reference fakes with
a pickling process pool, ``/root/reference/main.py:197-228``). Invoked by
tests/test_multihost.py as::

    python tests/multihost_worker.py PORT PROCESS_ID NUM_PROCESSES OUT.npy

Renders the Cornell box over a cross-process mesh twice (pure dp, and
dp x geom with the ppermute triangle ring crossing the process boundary),
assembles both on every process via ``multihost.fetch_to_host`` (a real
``process_allgather``), exercises ``multihost.sync``, and saves the
results for the parent to bit-compare against a single-process render.
"""

import os
import sys


def main() -> None:
    port, pid, nprocs, out = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    # 2 local virtual CPU devices per process (before any jax import)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    from pathtracerpython_tpu.parallel import make_mesh, multihost
    from pathtracerpython_tpu.parallel.shard import render_sharded
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    active = multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert active, "distributed branch did not activate"
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.local_devices()) == 2
    assert jax.device_count() == 2 * nprocs
    assert multihost.is_primary() == (pid == 0)

    scene = load_scene(cornell_sdl(), pad_to=32)
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=2)

    # (a) pure data parallel: rays sharded over all 4 devices, scene
    # replicated — the cross-process form of the reference's per-ray pool
    rad_dp = render_sharded(scene, cfg, make_mesh(dp=2 * nprocs), seed=3)
    img_dp = multihost.fetch_to_host(rad_dp)

    # (b) dp x geom: the triangle ring's ppermute crosses the process
    # boundary every ring step
    rad_ring = render_sharded(
        scene, cfg, make_mesh(dp=nprocs, geom=2), seed=3, geom_axis="geom"
    )
    img_ring = multihost.fetch_to_host(rad_ring)

    multihost.sync("after-render")
    np.save(out, np.stack([img_dp, img_ring]))
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
