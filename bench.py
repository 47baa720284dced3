"""Cornell-box render timing on one GPU.

Renders the packaged Cornell box at 512², 4 spp, 4 bounces, 3 NEE samples
per bounce (fast mode, all samples in one wavefront) in this one process,
and prints one JSON line: the device as JAX reports it, the card's name and
power limit from ``nvidia-smi``, the compile time, and the median and
quartiles of the render time over ``--reps`` renders after a warm-up, each
with a fresh seed and waited for with ``block_until_ready``.

Counted rays = closest-hit path segments + NEE shadow rays, i.e.
W·H·spp·bounces·(1 + n_light_samples): every ray that runs an
intersection sweep against the whole scene.

Refuses to run without a GPU: a CPU time is not a device measurement.

    python bench.py [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures on a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene
    from pathtracerpython_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    size, spp, bounces, nee = 512, 4, 4, 3
    scene = load_scene(cornell_sdl(), pad_to=32)
    scene = jax.device_put(dataclass_resize(scene, size))
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                       n_light_samples=nee, batch_samples=True)

    step = jax.jit(lambda sc, seed: jnp.sum(render(sc, cfg, seed=seed)))
    t0 = time.perf_counter()
    compiled = step.lower(scene, jnp.uint32(0)).compile()
    compile_s = time.perf_counter() - t0
    total = float(compiled(scene, jnp.uint32(0)))  # warm-up
    if not np.isfinite(total):
        print(f"non-finite render sum {total}", file=sys.stderr)
        return 1
    times = []
    for i in range(args.reps):
        seed = jnp.uint32(i + 1)
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(scene, seed))
        times.append(time.perf_counter() - t0)
    q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
    rays = size * size * spp * bounces * (1 + nee)
    print(json.dumps({
        "metric": "cornell_512_4spp_4b_render_s",
        "median_s": med, "q1_s": q1, "q3_s": q3, "reps": args.reps,
        "rays_per_s": rays / med,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": smi,
    }), flush=True)
    return 0


def dataclass_resize(scene, size: int):
    import dataclasses

    return dataclasses.replace(
        scene, meta=dataclasses.replace(scene.meta, width=size, height=size)
    )


if __name__ == "__main__":
    sys.exit(main())
