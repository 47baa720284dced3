"""CLI: render an SDL scene to a PNG.

Flag-compatible with the reference's argparse setup (``main.py:125-139``):
positional ``scene``, ``--out``, ``-r`` rays/pixel, ``-b`` bounces, and the
``--show-*`` debug views (which here write offline PNGs next to ``--out``
instead of opening a Qt window). Extensions: estimator mode, light
samples, seed, mesh sharding, triangle ordering, and image
normalization.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def setup(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ptpt", description="differentiable wavefront path tracer"
    )
    # reference-compatible flags (main.py:125-139)
    p.add_argument("scene", help="SDL scene file")
    p.add_argument("--out", default="out.png", help="output image path")
    p.add_argument("-r", "--rays-per-pixel", type=int, default=None,
                   help="samples per pixel (reference -r; default 1, or the "
                        "SDL's npaths under --honor-sdl)")
    p.add_argument("-b", "--bounces", type=int, default=1,
                   help="path bounces (reference -b)")
    p.add_argument("--honor-sdl", action="store_true",
                   help="honor the SDL fields the reference parses but "
                        "ignores: npaths (spp), seed, tonemapping (gamma), "
                        "background (paid on miss). Explicit -r/--seed "
                        "flags still win")
    p.add_argument("--show-img", action="store_true",
                   help="open the rendered image")
    p.add_argument("--show-scene", action="store_true",
                   help="write a 3-D wireframe debug view")
    p.add_argument("--show-normals", action="store_true",
                   help="include normals in the debug view")
    p.add_argument("--show-screen", action="store_true",
                   help="include colored screen points in the debug view")
    p.add_argument("--show-inter", action="store_true",
                   help="include first-hit points in the debug view")
    # extensions
    p.add_argument("--mode", choices=("fast", "reference"), default="fast",
                   help="estimator: fast (default) or reference-parity")
    p.add_argument("--light-samples", type=int, default=3,
                   help="NEE samples per shading point (reference hardcodes 3)")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default 0, or the SDL's seed under "
                        "--honor-sdl)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis size (0 = single device)")
    p.add_argument("--geom", type=int, default=1,
                   help="geometry-ring mesh axis size")
    p.add_argument("--normalization", choices=("minmax", "clip"),
                   default="minmax",
                   help="minmax reproduces the reference's auto-normalize")
    p.add_argument("--pad-to", type=int, default=128,
                   help="triangle buffer padding multiple")
    p.add_argument("--tri-order", choices=("morton", "median"),
                   default="morton",
                   help="spatial triangle order of fast-mode renders "
                        "(tight tile boxes for the culled sweep): morton "
                        "z-order (default) or median-split BVH leaves; "
                        "reference mode keeps the file order")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent XLA compilation cache "
                        "(utils/compile_cache.py; on by default — second "
                        "renders of a scene shape skip compilation)")
    p.add_argument("--metrics", action="store_true",
                   help="print a JSON metrics summary (timings, rays/s)")
    p.add_argument("--chunk-spp", type=int, default=-1,
                   help="render in sample chunks of this size, printing a "
                        "progress line per chunk (index, elapsed, rays/s) "
                        "— the batched analogue of the reference's tqdm "
                        "bars. -1 (default) auto-chunks at 16 spp when "
                        "-r >= 64; 0 disables chunking. NOTE: chunking "
                        "changes the sample->RNG mapping, so the converged "
                        "image differs from the unchunked render by MC "
                        "noise only (utils/checkpoint.render_progressive)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint each chunk here and auto-resume from "
                        "the latest (requires the [ckpt] extra / orbax; "
                        "implies chunking)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = setup(argv)

    if not args.no_compile_cache:
        from pathtracerpython_tpu.utils.compile_cache import (
            enable_compilation_cache,
        )

        enable_compilation_cache()

    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.image import radiance_to_image, save_png
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene import load_scene

    log = (lambda *a: None) if args.quiet else print

    # the culled sweep skips triangle tiles by their boxes, which only
    # works when neighbouring triangles share a tile; reference mode keeps
    # the file order, which decides its ties
    scene = load_scene(
        args.scene, pad_to=args.pad_to,
        tri_order=args.tri_order if args.mode == "fast" else None,
    )
    # SDL-field honoring: explicit CLI flags > SDL values (--honor-sdl) >
    # reference defaults (reference parse sites: scene_reader.py:151-170)
    meta = scene.meta
    n_samples = args.rays_per_pixel
    if n_samples is None:
        n_samples = (meta.npaths if args.honor_sdl and meta.npaths else 1)
    seed = args.seed
    if seed is None:
        seed = (meta.seed if args.honor_sdl and meta.seed is not None else 0)
    tonemapping = meta.tonemapping if args.honor_sdl else None
    args.seed = seed

    cfg = RenderConfig(
        mode=args.mode,
        n_samples=n_samples,
        n_bounces=args.bounces,
        n_light_samples=args.light_samples,
        use_background=args.honor_sdl,
    )
    log(f"scene: {args.scene} ({scene.meta.n_triangles} triangles, "
        f"{scene.meta.width}x{scene.meta.height})")
    log(f"config: {cfg}")

    from pathtracerpython_tpu.utils import MetricsLogger

    chunk_spp = args.chunk_spp
    if chunk_spp < 0:  # auto: chunk large sample counts for visibility
        chunk_spp = 16 if cfg.n_samples >= 64 else 0
    if args.ckpt_dir is not None and chunk_spp == 0:
        chunk_spp = max(1, min(16, cfg.n_samples))
    rays_per_spp = (
        scene.meta.width * scene.meta.height
        * cfg.n_bounces * (1 + cfg.n_light_samples)
    )

    def render_chunked(seed: int, checkpoint=True, progress=True):
        from pathtracerpython_tpu.utils.checkpoint import render_progressive

        def prog(done, total, spp_done, dt):
            log(f"chunk {done}/{total}: {spp_done} spp total, "
                f"{dt:.2f}s, "
                f"{rays_per_spp * chunk_spp / dt / 1e6:.1f} Mrays/s")

        return render_progressive(
            scene, cfg, cfg.n_samples, chunk_spp,
            checkpoint_dir=args.ckpt_dir if checkpoint else None,
            seed=seed,
            renderer=lambda sc, c, seed: render_once_cfg(c, seed),
            log=log, progress=prog if progress else None,
        )

    def render_once_cfg(cfg_chunk, seed: int):
        if args.dp > 0 or args.geom > 1:
            from pathtracerpython_tpu.parallel import make_mesh, render_sharded

            mesh = make_mesh(
                dp=args.dp if args.dp > 0 else None, geom=args.geom
            )
            return render_sharded(
                scene, cfg_chunk, mesh, seed=seed,
                geom_axis="geom" if args.geom > 1 else None,
            )
        return render(scene, cfg_chunk, seed=seed)

    def render_full(seed: int):
        # chunked and unchunked share ONE dispatch (render_once_cfg)
        return (render_chunked(seed) if chunk_spp > 0
                else render_once_cfg(cfg, seed))

    metrics = MetricsLogger()
    t0 = time.perf_counter()
    with metrics.timed("render") as box:
        radiance = render_full(args.seed)
        box["out"] = radiance
    log(f"rendered in {time.perf_counter() - t0:.2f}s")
    # upper bound: counts every wavefront lane-bounce (dead lanes are
    # masked, not compacted, so this IS the work dispatched)
    metrics.count(
        "rays_attempted",
        scene.meta.width * scene.meta.height * cfg.n_samples
        * cfg.n_bounces * (1 + cfg.n_light_samples),
    )
    if args.metrics:
        import json as _json

        # the first render pays jit compilation; a second render with a
        # different seed measures steady-state throughput. It uses the
        # SAME execution plan as the real render (chunked stays chunked)
        # minus checkpointing/progress noise.
        with metrics.timed("render_steady") as box:
            box["out"] = (
                render_chunked(args.seed + 1, checkpoint=False,
                               progress=False)
                if chunk_spp > 0 else render_once_cfg(cfg, args.seed + 1)
            )
        print(_json.dumps({
            **metrics.summary(),
            "rays_attempted_per_s_incl_compile": metrics.rate(
                "rays_attempted", "render"
            ),
            "rays_attempted_per_s_steady": metrics.rate(
                "rays_attempted", "render_steady"
            ),
        }))

    image = radiance_to_image(
        radiance, scene.meta.width, scene.meta.height,
        normalization=args.normalization,
        tonemapping=tonemapping,
    )
    save_png(image, args.out)
    log(f"wrote {args.out}")

    if args.show_scene or args.show_normals or args.show_screen or args.show_inter:
        from pathtracerpython_tpu.viz import plot_scene

        intersections = None
        if args.show_inter:
            from pathtracerpython_tpu.ops.camera import make_primary_rays
            from pathtracerpython_tpu.ops.geometry import nearest_hit

            o, d = make_primary_rays(
                scene.eye, scene.ortho, scene.meta.width, scene.meta.height
            )
            hit = nearest_hit(o, d, scene, mode=cfg.mode)
            import numpy as np

            intersections = np.asarray(hit.point)[np.asarray(hit.hit)]
        debug_path = os.path.splitext(args.out)[0] + "_scene.png"
        plot_scene(
            scene, debug_path,
            show_normals=args.show_normals,
            show_screen=args.show_screen,
            screen_colors=radiance if args.show_screen else None,
            intersections=intersections,
        )
        log(f"wrote {debug_path}")

    if args.show_img:
        # optional viewer: PIL is needed only for this flag
        from PIL import Image

        Image.fromarray(image).show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
