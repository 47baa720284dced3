"""Scaling-efficiency harness (BASELINE north star: ≥90% from 1 to N).

Measures sharded-render throughput across mesh sizes on whatever devices
exist. On the virtual CPU mesh it validates the harness and the sharding
code path; on a host of several GPUs it reports the scaling efficiency.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/bench_scaling.py [--phases]

``--phases`` adds a comm/compute breakdown for the geometry ring: each
mesh is re-run with ``ppermute`` ablated to identity (results are then
wrong — timing only), so ``comm_share = 1 - compute_only/full`` isolates
the un-overlapped communication cost. On the virtual CPU mesh this
validates the plumbing; on several GPUs it reports the overlap.
"""

# Run-from-anywhere bootstrap: the scripts import the package from the
# repo root without requiring a pip install (VERDICT r4 weak #2 class).
import os as _os, sys as _sys
_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp


def main():
    from pathtracerpython_tpu.parallel import make_mesh, render_sharded
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", action="store_true",
                    help="ablate ring ppermute to isolate comm share")
    args = ap.parse_args()

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}", file=sys.stderr)

    scene = load_scene(cornell_sdl(), pad_to=32)
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=2)

    def timed(fn):
        fn(0)  # compile
        t0 = time.perf_counter()
        for s in (1, 2, 3):
            fn(s)
        return (time.perf_counter() - t0) / 3

    results = {}
    sizes = [d for d in (1, 2, 4, 8, n_dev) if d <= n_dev]
    for dp in sorted(set(sizes)):
        mesh = make_mesh(dp=dp, geom=1)

        def run(seed):
            out = render_sharded(scene, cfg, mesh, seed=seed)
            return float(jnp.sum(out))

        dt = timed(run)
        results[dp] = dt
        base = results[sizes[0]]
        eff = base / (dt * dp / sizes[0])
        print(f"dp={dp}: {dt*1e3:8.1f} ms/render  "
              f"scaling efficiency vs dp={sizes[0]}: {eff*100:5.1f}%")

    if args.phases and n_dev >= 2:
        # geometry-ring comm/compute split: time the geom mesh normally,
        # then with the per-step triangle-shard rotation replaced by
        # identity (same sweep count, zero traffic; results WRONG —
        # this is a timing ablation only).
        from pathtracerpython_tpu.parallel import ring as ring_mod

        geom = min(4, n_dev)
        mesh = make_mesh(dp=n_dev // geom, geom=geom)
        gcfg = RenderConfig(
            mode="fast", n_samples=2, n_bounces=2,
            geom_axis="geom", geom_axis_size=geom,
        )

        def run_geom(seed):
            out = render_sharded(
                scene, gcfg, mesh, seed=seed, geom_axis="geom"
            )
            return float(jnp.sum(out))

        full = timed(run_geom)
        orig = ring_mod._rotate_tri_shard
        try:
            ring_mod._rotate_tri_shard = lambda sc, axis, n: sc
            jax.clear_caches()  # the ablation must retrace, not cache-hit
            compute_only = timed(run_geom)
        finally:
            ring_mod._rotate_tri_shard = orig
            jax.clear_caches()
        comm_share = max(0.0, 1.0 - compute_only / full)
        print(f"geom={geom}: full {full*1e3:.1f} ms, compute-only "
              f"{compute_only*1e3:.1f} ms, un-overlapped comm share "
              f"{comm_share*100:.1f}%")
        results["geom_phases"] = {
            "geom": geom, "full_s": full, "compute_only_s": compute_only,
            "comm_share": comm_share,
        }

    print(json.dumps({str(k): v for k, v in results.items()}))


if __name__ == "__main__":
    main()
