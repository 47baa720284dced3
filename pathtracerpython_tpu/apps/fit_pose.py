"""Inverse rendering demo: recover scene geometry poses from a target image
via vertex-position gradients (BASELINE.json config 4).

Two modes:

- ``light`` (default): recover the area light's lateral (x, z) position.
  The light's vertices enter the estimator smoothly (NEE sample points →
  shadow direction → cosine), so interior autodiff gradients are exact and
  the fit converges to ~1e-4 offset error. Only the lateral components are
  optimized: the reference estimator has no inverse-square distance
  falloff (``main.py:65-73``), and the MEASURED consequence
  (tests/test_pose.py::test_light_y_is_degenerate_measured) is that the
  vertical loss is a flat valley — L(y−δ) saturates immediately
  (within 6% from δ=0.05 to δ=0.2 while the lateral loss grows ~4×) and
  the interior dL/dy at a downward-displaced pose points AWAY from the
  truth, so a free y drifts down instead of converging (measured:
  y −0.15 → −0.195 over 150 Adam steps while x/z recovered).

- ``--object <name>`` (e.g. ``cube``): recover a rigid pose of a scene
  object. Default is the PLANAR 3-dof pose — (x, z) translation + yaw
  about the object's centroid — matching objects standing on the floor;
  ``--dof full`` optimizes the FULL 6-dof pose (xyz translation +
  yaw/pitch/roll). Unlike the light, object silhouettes DO carry
  vertical signal (measured: y-curvature of the cube loss is the same
  order as lateral — 7.0e-4 vs 1.6e-3 at δ=0.05 — and a 3-dof
  translation fit including y recovers (0.25, 0.2, 0.15) to <3e-3;
  tests/test_pose.py), which is why full mode exists; planar stays the
  default because the floor-contact prior makes it the robust choice
  for the Cornell cubes.
  For axis-aligned opaque geometry the interior derivative is
  degenerate — in-plane translation doesn't move any face's plane, so
  the true gradient lives entirely in silhouette/occlusion boundary
  terms. This mode therefore runs the SOFT estimator
  (``RenderConfig.soft_vis_beta``, diff/boundary.py): silhouettes blend
  over the surface behind them and shadows use smooth edge coverage,
  giving FD-validated boundary gradients (tests/test_boundary.py), and
  the fit recovers the cube's pose. The edge width is ANNEALED over
  ``--beta-stages`` stages from ``--soft-beta-start`` down to
  ``--soft-beta`` (wide basin first, sharp localization last); beta is
  a trace-time constant, so each stage re-jits — cheap at fit sizes.

Run: python -m pathtracerpython_tpu.apps.fit_pose [--steps N]
     python -m pathtracerpython_tpu.apps.fit_pose --object cube
"""

from __future__ import annotations

import argparse
import json
import os


def find_object_index(scene_path: str, name_fragment: str) -> int:
    """Index of the first SDL object whose OBJ path contains the fragment."""
    from pathtracerpython_tpu.scene.sdl import load_sdl

    desc = load_sdl(scene_path)
    for i, obj in enumerate(desc.objects):
        if name_fragment in os.path.basename(obj.mesh.path):
            return i
    raise ValueError(
        f"no object matching {name_fragment!r} in {scene_path}"
    )


def translate_object(scene, obj_index: int, offset):
    """Shift every triangle of material row ``obj_index`` by ``offset``
    (kept as a thin alias — the transform lives in diff.transforms)."""
    from pathtracerpython_tpu.diff.transforms import translate_object as t

    return t(scene, obj_index, offset)


def translate_light(scene, offset):
    """Shift the area light; ``diff.apply_params`` keeps the NEE sampling
    buffers and the light's rows in the main triangle buffer in sync (one
    code path owns that invariant)."""
    from pathtracerpython_tpu.diff import apply_params

    return apply_params(scene, {
        "light_v0": scene.light_v0 + offset,
        "light_v1": scene.light_v1 + offset,
        "light_v2": scene.light_v2 + offset,
    })


def run(
    scene_path: str | None = None,  # None = the packaged Cornell box
    object_name: str | None = None,  # None = light mode
    init_offset=(0.4, 0.0, 0.3),
    init_angle: float = 0.25,  # radians of yaw, object mode only
    steps: int = 120,
    lr: float = 0.05,
    out_dir: str = "/tmp/fit_pose",
    seed: int = 0,
    spp: int = 1,
    bounces: int = 1,
    soft_beta: float = 0.03,
    soft_beta_start: float | None = None,
    beta_stages: int = 4,
    pyramid: bool = True,
    dof: str = "planar",  # object mode: "planar" (x, z, yaw) or
    #                       "full" (xyz + yaw/pitch/roll)
    scene_arrays=None,  # pre-built SceneArrays override (e.g. the scene
    #                     plus synthetic clutter); scene_path still names
    #                     the SDL for object lookup
    log=print,
) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from pathtracerpython_tpu.ops.camera import make_primary_rays
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.image import radiance_to_image, save_png
    from pathtracerpython_tpu.render.integrator import render, render_rays
    from pathtracerpython_tpu.scene import cornell_sdl, load_scene

    scene_path = scene_path or cornell_sdl()
    os.makedirs(out_dir, exist_ok=True)
    scene = scene_arrays if scene_arrays is not None else load_scene(
        scene_path
    )

    def make_cfg(beta):
        # object mode needs boundary gradients -> soft estimator; light
        # mode keeps the hard estimator (the light enters the NEE math
        # smoothly)
        return RenderConfig(
            mode="fast", n_samples=spp, n_bounces=bounces,
            soft_vis_beta=beta if object_name is not None else 0.0,
        )

    lateral_only = object_name is None
    if object_name is None:
        move = lambda sc, off, ang: translate_light(sc, off)
        what = "light"
        betas = [soft_beta] * 1
        params = jnp.asarray(init_offset, jnp.float32)[jnp.asarray([0, 2])]
    else:
        from pathtracerpython_tpu.diff.transforms import (
            transform_object,
            transform_object_full,
        )

        obj_index = find_object_index(scene_path, object_name)
        if dof == "full":
            move = lambda sc, off, ang: transform_object_full(
                sc, obj_index, off, ang
            )
        else:
            move = lambda sc, off, ang: transform_object(
                sc, obj_index, off, ang
            )
        what = f"object {object_name} (#{obj_index}, {dof})"
        # annealing schedule: geometric from start (wide basin) to final
        # (sharp localization); beta is a trace-time constant, so each
        # stage is its own jitted step function
        # 4x final beta: measured on the default cube fit (0.5-unit +
        # 0.2-rad perturbation) — a 2x start leaves the first stage's
        # basin too narrow and the fit stalls at ~0.2 offset error
        start = (4.0 * soft_beta if soft_beta_start is None
                 else soft_beta_start)
        k = max(int(beta_stages), 1)
        betas = [
            float(start * (soft_beta / start) ** (i / max(k - 1, 1)))
            for i in range(k)
        ] if k > 1 else [soft_beta]
        io = jnp.asarray(init_offset, jnp.float32)
        if dof == "full":
            params = jnp.asarray(
                [io[0], io[1], io[2], init_angle, 0.0, 0.0], jnp.float32
            )  # full pose: (dx, dy, dz, yaw, pitch, roll)
        else:
            params = jnp.asarray(
                [io[0], io[2], init_angle], jnp.float32
            )  # planar pose: (dx, dz, yaw)

    def to_pose(params):
        if lateral_only:
            return jnp.asarray([params[0], 0.0, params[1]], jnp.float32), 0.0
        if object_name is not None and dof == "full":
            return params[0:3], params[3:6]
        return (
            jnp.asarray([params[0], 0.0, params[1]], jnp.float32),
            params[2],
        )

    w, h = scene.meta.width, scene.meta.height
    # fixed RNG: the loss is a deterministic, piecewise-smooth function of
    # the pose, so plain gradient descent applies
    key = jax.random.PRNGKey(seed)

    # Coarse-to-fine resolution pyramid (object mode, high-res scenes):
    # the pose basin is non-convex — from a large perturbation the
    # depth-axis gradient initially points AWAY from the truth until the
    # lateral axes align — and at
    # high resolution the boundary-band signal is a smaller fraction of
    # the pixel-mean loss, so escaping takes many more steps. A coarse
    # level first recovers the pose where the basin is benign, then the
    # native level polishes. Each level reruns the full beta anneal with
    # fresh optimizer moments (they are resolution-scale-dependent).
    levels = [(w, h)]
    if object_name is not None and pyramid and min(w, h) >= 96:
        levels = [(max(40, w // 4), max(40, h // 4)), (w, h)]

    opt = optax.adam(lr)
    losses = []
    stage_steps = [steps // len(betas)] * len(betas)
    stage_steps[-1] += steps - sum(stage_steps)

    final_cfg = make_cfg(betas[-1])
    save_png(
        radiance_to_image(render(scene, final_cfg, seed=seed), w, h),
        os.path.join(out_dir, "target.png"),
    )

    for lw, lh in levels:
        origins, dirs = make_primary_rays(scene.eye, scene.ortho, lw, lh)
        pixel_ids = jnp.arange(lw * lh, dtype=jnp.int32)
        opt_state = opt.init(params)

        for beta, n_steps in zip(betas, stage_steps):
            cfg = make_cfg(beta)
            # the target is re-rendered at each (level, beta) so the
            # optimum stays exactly at zero pose error throughout
            target = render_rays(
                origins, dirs, pixel_ids, scene, cfg, key
            )

            def loss_fn(params, cfg=cfg, target=target, origins=origins,
                        dirs=dirs, pixel_ids=pixel_ids):
                off, ang = to_pose(params)
                radiance = render_rays(
                    origins, dirs, pixel_ids, move(scene, off, ang), cfg,
                    key,
                )
                return 0.5 * jnp.mean((radiance - target) ** 2)

            @jax.jit
            def step(params, opt_state, loss_fn=loss_fn):
                loss, grads = jax.value_and_grad(loss_fn)(params)
                updates, opt_state = opt.update(grads, opt_state)
                return optax.apply_updates(params, updates), opt_state, loss

            for _ in range(n_steps):
                params, opt_state, loss = step(params, opt_state)
                losses.append(float(loss))

    offset, angle = to_pose(params)
    save_png(
        radiance_to_image(
            render(move(scene, offset, angle), final_cfg, seed=seed), w, h
        ),
        os.path.join(out_dir, "fitted.png"),
    )

    result = {
        "mode": what,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "init_offset_norm": float(np.linalg.norm(np.asarray(init_offset))),
        "final_offset_norm": float(jnp.linalg.norm(offset)),
        "final_offset": [float(x) for x in offset],
        "init_angle": float(init_angle) if not lateral_only else 0.0,
        "final_angle": (
            0.0 if lateral_only
            else [float(a) for a in jnp.atleast_1d(angle)]
        ),
        "betas": betas,
        "levels": levels,
        "out_dir": out_dir,
    }
    log(json.dumps(result))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({**result, "losses": losses}, f)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default=None,
                   help="SDL scene (default: the packaged Cornell box)")
    p.add_argument("--object", default=None,
                   help="translate this object instead of the light "
                        "(runs the soft estimator for boundary gradients)")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--init-angle", type=float, default=0.25,
                   help="initial yaw error in radians (object mode)")
    p.add_argument("--soft-beta", type=float, default=0.03,
                   help="FINAL soft-visibility edge width (object mode)")
    p.add_argument("--soft-beta-start", type=float, default=None,
                   help="anneal start width (default 2x --soft-beta)")
    p.add_argument("--beta-stages", type=int, default=4,
                   help="annealing stages (1 = constant beta)")
    p.add_argument("--lr-object", type=float, default=0.03,
                   help="learning rate used in object mode (the pose "
                        "anneal is tuned at 0.03; --lr covers light mode)")
    p.add_argument("--no-pyramid", action="store_true",
                   help="disable the coarse-to-fine resolution pyramid "
                        "(object mode, scenes >= 96px)")
    p.add_argument("--dof", choices=("planar", "full"), default="planar",
                   help="object-mode pose parameterization: planar "
                        "(x, z, yaw — floor-contact prior) or full "
                        "(xyz + yaw/pitch/roll)")
    p.add_argument("--out", default="/tmp/fit_pose")
    args = p.parse_args(argv)
    run(
        scene_path=args.scene, object_name=args.object, steps=args.steps,
        lr=args.lr_object if args.object else args.lr,
        out_dir=args.out, soft_beta=args.soft_beta,
        soft_beta_start=args.soft_beta_start, beta_stages=args.beta_stages,
        init_angle=args.init_angle, pyramid=not args.no_pyramid,
        dof=args.dof,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
