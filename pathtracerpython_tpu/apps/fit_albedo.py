"""Inverse rendering demo: recover the Cornell walls' albedos from a
rendered target image (BASELINE.json config 3: "albedo + emission
gradients, inverse-rendering fit of wall colors").

Run: python -m pathtracerpython_tpu.apps.fit_albedo [--steps N] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os


def run(
    scene_path: str | None = None,  # None = the packaged Cornell box
    steps: int = 60,
    lr: float = 0.05,
    out_dir: str = "/tmp/fit_albedo",
    fit_emission: bool = True,
    seed: int = 0,
    spp: int = 2,
    bounces: int = 2,
    checkpoint_every: int = 0,
    log=print,
) -> dict:
    import jax
    import numpy as np
    import optax

    from pathtracerpython_tpu.diff import fit
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.image import radiance_to_image, save_png
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    os.makedirs(out_dir, exist_ok=True)
    scene = load_scene(scene_path or cornell_sdl())
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces)

    target = render(scene, cfg, seed=seed)
    save_png(
        radiance_to_image(target, scene.meta.width, scene.meta.height),
        os.path.join(out_dir, "target.png"),
    )

    params = {"mat_rgb": scene.mat_rgb * 0.25}
    if fit_emission:
        params["light_color"] = scene.light_color * 2.0

    # full-fidelity resume: fit() checkpoints params + optimizer state +
    # RNG position, so a restart continues bit-identically
    params, losses = fit(
        params, optax.adam(lr), scene, cfg, target, steps=steps, seed=seed,
        checkpoint_dir=(
            os.path.join(out_dir, "ckpt") if checkpoint_every > 0 else None
        ),
        checkpoint_every=checkpoint_every,
    )

    fitted = render(_apply(scene, params), cfg, seed=seed)
    save_png(
        radiance_to_image(fitted, scene.meta.width, scene.meta.height),
        os.path.join(out_dir, "fitted.png"),
    )

    err = float(
        np.abs(
            np.asarray(params["mat_rgb"])[: scene.meta.n_objects]
            - np.asarray(scene.mat_rgb)[: scene.meta.n_objects]
        ).max()
    )
    result = {
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "max_albedo_err": err,
        "out_dir": out_dir,
    }
    log(json.dumps(result))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({**result, "losses": losses}, f)
    return result


def _apply(scene, params):
    from pathtracerpython_tpu.diff import apply_params

    return apply_params(scene, params)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default=None,
                   help="SDL scene (default: the packaged Cornell box)")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out", default="/tmp/fit_albedo")
    p.add_argument("--no-emission", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0)
    args = p.parse_args(argv)
    run(
        scene_path=args.scene, steps=args.steps, lr=args.lr,
        out_dir=args.out, fit_emission=not args.no_emission,
        checkpoint_every=args.checkpoint_every,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
