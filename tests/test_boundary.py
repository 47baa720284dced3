"""Boundary-aware (soft) visibility gradients — diff/boundary.py.

The round-1 gap (VERDICT item 2): hard visibility detaches, so an opaque
occluder's translation had zero interior gradient. With
``soft_vis_beta > 0`` the estimator is a continuous function of occluder
vertices and central finite differences validate autodiff — both for
shadows (soft NEE coverage) and silhouettes (front-hit blending).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.render.integrator import render, render_rays
from pathtracerpython_tpu.scene.arrays import pack_scene, recompute_derived
from pathtracerpython_tpu.scene.obj import mesh_from_arrays
from pathtracerpython_tpu.scene.sdl import SceneDescription, SdlObject


def make_occluder_scene():
    """Floor + overhead light + a small opaque blocker between them.

    The blocker shadows part of the floor and its silhouette covers part
    of the floor seen from the camera — both boundary terms in one scene.
    """
    floor = mesh_from_arrays(
        [[-4.0, -1.0, 2.0], [4.0, -1.0, 2.0], [4.0, -1.0, -8.0],
         [-4.0, -1.0, -8.0]],
        [[0, 1, 2], [0, 2, 3]],
    )
    blocker = mesh_from_arrays(
        [[-0.4, 0.0, -2.4], [0.4, 0.0, -2.4], [0.4, 0.0, -1.6],
         [-0.4, 0.0, -1.6]],
        [[0, 1, 2], [0, 2, 3]],
    )
    light = mesh_from_arrays(
        [[-0.7, 1.5, -2.7], [0.7, 1.5, -2.7], [0.7, 1.5, -1.3],
         [-0.7, 1.5, -1.3]],
        [[0, 1, 2], [0, 2, 3]],
    )
    desc = SceneDescription(
        eye=(0.0, 0.8, 3.0),
        width=12,
        height=12,
        ortho=(-1.0, -1.0, 1.0, 1.0),
        ambient=0.3,
        light_mesh=light,
        light_color=(1.0, 1.0, 1.0),
        objects=[
            SdlObject(mesh=floor, rgb=(0.7, 0.7, 0.7), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=1.0),
            SdlObject(mesh=blocker, rgb=(0.8, 0.2, 0.2), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=1.0),
        ],
    )
    return pack_scene(desc)


@pytest.fixture(scope="module")
def occ_scene():
    return make_occluder_scene()


def translate_blocker(scene, dx):
    """Shift the blocker (material row 1) by dx along x, differentiably."""
    mask = ((scene.tri_material == 1) & scene.tri_valid).astype(
        scene.tri_v0.dtype
    )
    shift = (mask * dx)[:, None] * jnp.asarray([1.0, 0.0, 0.0])
    moved = dataclasses.replace(
        scene,
        tri_v0=scene.tri_v0 + shift,
        tri_v1=scene.tri_v1 + shift,
        tri_v2=scene.tri_v2 + shift,
    )
    return recompute_derived(moved)


def scene_loss(scene, cfg, seed=0):
    """Mean radiance of the scene's camera view (smooth in soft mode)."""
    from pathtracerpython_tpu.ops.camera import make_primary_rays

    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    rad = render_rays(o, d, pids, scene, cfg, seed)
    return jnp.mean(rad)


BETA = 0.05


def occluder_loss_fn(occ_scene, cfg):
    def f(dx):
        return scene_loss(translate_blocker(occ_scene, dx), cfg)
    return f


def test_hard_estimator_has_no_boundary_gradient(occ_scene):
    """Documents the gap soft mode fills: the hard estimator's gradient
    w.r.t. an in-plane blocker translation is (near) zero."""
    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2)
    g = jax.grad(occluder_loss_fn(occ_scene, cfg))(0.0)
    assert abs(float(g)) < 1e-6


def test_soft_occluder_translation_grad_matches_fd(occ_scene):
    """Central FD validates the soft-estimator gradient of an opaque
    occluder's translation — the BASELINE config-4 case beyond the
    smooth light-only gradients of round 1."""
    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    f = occluder_loss_fn(occ_scene, cfg)
    ad = float(jax.grad(f)(0.0))
    eps = 2e-3  # << beta, stays within the smooth band
    fd = (float(f(eps)) - float(f(-eps))) / (2 * eps)
    assert abs(ad) > 1e-4, "boundary gradient should be nonzero"
    np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=1e-5)


def test_soft_grad_matches_fd_at_offsets(occ_scene):
    """FD agreement also away from zero (the fit traverses these)."""
    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    f = occluder_loss_fn(occ_scene, cfg)
    for dx0 in (0.12, -0.2):
        ad = float(jax.grad(f)(dx0))
        eps = 2e-3
        fd = (float(f(dx0 + eps)) - float(f(dx0 - eps))) / (2 * eps)
        np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=2e-5)


def test_soft_converges_to_hard(occ_scene):
    """At tiny beta the soft render approaches the hard render (pixels
    away from silhouette/shadow bands are essentially identical)."""
    hard = np.asarray(render(
        occ_scene, RenderConfig(mode="fast", n_bounces=1), seed=3
    ))
    soft = np.asarray(render(
        occ_scene,
        RenderConfig(mode="fast", n_bounces=1, soft_vis_beta=1e-4),
        seed=3,
    ))
    close = np.isclose(hard, soft, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() > 0.9, close.mean()


def test_soft_pose_fit_recovers_offset(occ_scene):
    """An optimizer driven by soft-visibility gradients recovers a
    0.3-unit blocker offset (the VERDICT 'done when' for this item)."""
    import optax

    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    target = render_target = None

    from pathtracerpython_tpu.ops.camera import make_primary_rays

    w, h = occ_scene.meta.width, occ_scene.meta.height
    o, d = make_primary_rays(occ_scene.eye, occ_scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_rays(o, d, pids, occ_scene, cfg, 5)

    def loss(dx):
        rad = render_rays(
            o, d, pids, translate_blocker(occ_scene, dx), cfg, 5
        )
        return 0.5 * jnp.mean((rad - target) ** 2)

    opt = optax.adam(0.05)
    dx = jnp.asarray(0.3)
    state = opt.init(dx)
    step = jax.jit(
        lambda dx, st: (lambda g: opt.update(g, st, dx))(jax.grad(loss)(dx))
    )
    for _ in range(60):
        updates, state = step(dx, state)
        dx = optax.apply_updates(dx, updates)
    assert abs(float(dx)) < 1e-2, float(dx)


def rotate_blocker(scene, theta):
    """Yaw the blocker about its centroid, differentiably."""
    from pathtracerpython_tpu.diff.transforms import rotate_object

    return rotate_object(scene, 1, theta)


def test_soft_rotation_grad_matches_fd(occ_scene):
    """Central FD validates the soft gradient of an occluder ROTATION
    (round-2 VERDICT item 3: beyond single-axis translation). The
    blocker is yawed about a corner-offset center so the silhouette
    genuinely moves (about the centroid, a square quad's yaw is
    near-symmetric at 12x12 resolution)."""
    from pathtracerpython_tpu.diff.transforms import rotate_object

    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)

    def f(theta):
        moved = rotate_object(
            occ_scene, 1, theta, center=(0.4, 0.0, -1.6)
        )
        return scene_loss(moved, cfg)

    for th0 in (0.0, 0.2):
        ad = float(jax.grad(f)(th0))
        eps = 2e-3
        fd = (float(f(th0 + eps)) - float(f(th0 - eps))) / (2 * eps)
        assert abs(ad) > 1e-5, ad
        np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=2e-5)


def test_soft_single_vertex_grad_matches_fd(occ_scene):
    """Per-vertex perturbation: move ONE stored corner of the blocker
    (both triangle rows that share it, keeping the quad watertight) and
    FD-gate the gradient — the general vertex-position reading of
    BASELINE configs[3]."""
    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    # blocker rows are material 1; corner (0.4, 0.0, -1.6) appears as
    # tri0.v2 and tri1.v1 (quad fan [0,1,2], [0,2,3])
    rows = np.nonzero(np.asarray(occ_scene.tri_material) == 1)[0][:2]
    corner = jnp.asarray([0.4, 0.0, -1.6], jnp.float32)

    def f(dx):
        shift = jnp.asarray([dx, 0.0, 0.0], jnp.float32)

        def move_field(field, row):
            near = jnp.linalg.norm(field[row] - corner) < 1e-5
            return field.at[row].add(jnp.where(near, 1.0, 0.0) * shift)

        sc = occ_scene
        for row in rows:
            sc = dataclasses.replace(
                sc,
                tri_v0=move_field(sc.tri_v0, row),
                tri_v1=move_field(sc.tri_v1, row),
                tri_v2=move_field(sc.tri_v2, row),
            )
        from pathtracerpython_tpu.scene.arrays import recompute_derived

        return scene_loss(recompute_derived(sc), cfg)

    ad = float(jax.grad(f)(0.0))
    eps = 2e-3
    fd = (float(f(eps)) - float(f(-eps))) / (2 * eps)
    assert abs(ad) > 1e-5, ad
    np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=2e-5)


def test_soft_multibounce_grad_matches_fd(occ_scene):
    """b=2 soft render: the blend runs inside the bounce scan (scatter
    continues from the hard hit); the translation gradient still
    FD-validates — the multi-bounce gate VERDICT r2 asked for."""
    cfg = RenderConfig(mode="fast", n_bounces=2, n_light_samples=2,
                       soft_vis_beta=BETA)
    f = occluder_loss_fn(occ_scene, cfg)
    ad = float(jax.grad(f)(0.0))
    eps = 2e-3
    fd = (float(f(eps)) - float(f(-eps))) / (2 * eps)
    assert abs(ad) > 1e-4, ad
    np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=2e-5)


def test_rotation_translation_fit_recovers_pose(occ_scene):
    """A 2-dof (dx, yaw) fit driven by soft gradients recovers a
    perturbed blocker pose (VERDICT r2 'done when': rotation +
    translation converges)."""
    import optax

    from pathtracerpython_tpu.diff.transforms import (
        rotate_object,
        translate_object,
    )

    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    center = (0.4, 0.0, -1.6)

    from pathtracerpython_tpu.ops.camera import make_primary_rays

    w, h = occ_scene.meta.width, occ_scene.meta.height
    o, d = make_primary_rays(occ_scene.eye, occ_scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_rays(o, d, pids, occ_scene, cfg, 5)

    def move(params):
        sc = rotate_object(occ_scene, 1, params[1], center=center)
        off = jnp.asarray([1.0, 0.0, 0.0]) * params[0]
        return translate_object(sc, 1, off)

    def loss(params):
        rad = render_rays(o, d, pids, move(params), cfg, 5)
        return 0.5 * jnp.mean((rad - target) ** 2)

    opt = optax.adam(0.04)
    params = jnp.asarray([0.25, 0.3], jnp.float32)
    state = opt.init(params)

    @jax.jit
    def step(p, st):
        g = jax.grad(loss)(p)
        up, st = opt.update(g, st)
        return optax.apply_updates(p, up), st

    for _ in range(80):
        params, state = step(params, state)
    assert abs(float(params[0])) < 2e-2, np.asarray(params)
    assert abs(float(params[1])) < 6e-2, np.asarray(params)


def make_stacked_occluder_scene():
    """Two blockers stacked within one coverage band (0.08 apart at
    BETA=0.05 -> band 0.3): the soft blend tracks ONE boundary (front +
    first-behind), so stacked silhouettes are outside its exactness
    scope — this scene documents the behavior bound."""
    from pathtracerpython_tpu.scene.obj import mesh_from_arrays
    from pathtracerpython_tpu.scene.sdl import SceneDescription, SdlObject

    floor = mesh_from_arrays(
        [[-4.0, -1.0, 2.0], [4.0, -1.0, 2.0], [4.0, -1.0, -8.0],
         [-4.0, -1.0, -8.0]],
        [[0, 1, 2], [0, 2, 3]],
    )
    def quad(y, x0, x1, z0, z1):
        return mesh_from_arrays(
            [[x0, y, z0], [x1, y, z0], [x1, y, z1], [x0, y, z1]],
            [[0, 1, 2], [0, 2, 3]],
        )
    light = quad(1.5, -0.7, 0.7, -2.7, -1.3)
    mat = dict(ka=0.3, kd=0.7, ks=0.0, kt=0.0, n=1.0)
    desc = SceneDescription(
        eye=(0.0, 0.8, 3.0), width=12, height=12,
        ortho=(-1.0, -1.0, 1.0, 1.0), ambient=0.3,
        light_mesh=light, light_color=(1.0, 1.0, 1.0),
        objects=[
            SdlObject(mesh=floor, rgb=(0.7, 0.7, 0.7), **mat),
            SdlObject(mesh=quad(0.0, -0.4, 0.4, -2.4, -1.6),
                      rgb=(0.8, 0.2, 0.2), **mat),
            # second blocker 0.08 below, laterally offset half a width
            SdlObject(mesh=quad(-0.08, -0.0, 0.8, -2.4, -1.6),
                      rgb=(0.2, 0.2, 0.8), **mat),
        ],
    )
    return pack_scene(desc)


def test_stacked_silhouettes_stay_continuous_and_converge():
    """Scope gate for the one-boundary blend: with TWO blockers stacked
    inside the band, the soft radiance must (a) stay finite, (b) still
    converge to the hard render at tiny beta, and (c) vary continuously
    under small translations (no step jumps at sub-band scale). FD
    exactness is NOT claimed here — that is the documented model limit
    (diff/boundary.py; single-boundary scenes are FD-gated above)."""
    scene = make_stacked_occluder_scene()
    cfg_soft = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                            soft_vis_beta=BETA)
    hard = np.asarray(render(
        scene, RenderConfig(mode="fast", n_bounces=1, n_light_samples=2),
        seed=3,
    ))
    tiny = np.asarray(render(
        scene, dataclasses.replace(cfg_soft, soft_vis_beta=1e-4), seed=3
    ))
    close = np.isclose(hard, tiny, rtol=1e-3, atol=1e-3).all(axis=1)
    assert close.mean() > 0.9, close.mean()

    f = occluder_loss_fn(scene, cfg_soft)
    base = float(f(0.0))
    assert np.isfinite(base)
    for eps in (1e-3, 5e-3):
        step = abs(float(f(eps)) - base)
        # continuity at sub-band scale: bounded by ~|grad|*eps with a
        # generous Lipschitz allowance (a hard-visibility pop would be
        # O(pixel value) ~ 1e-2+ at this resolution)
        assert step < 2e-3, (eps, step)


def test_coplanar_contact_does_not_blend():
    """A box standing ON the floor has its bottom face exactly in the
    floor plane. Floor pixels inside the coverage band of the bottom
    face's edges must keep the FLOOR as the blended front record: the
    coplanar near-miss ties the floor's t to the ulp, and before the
    F_TIE_EPS bias the winner was a platform/fusion coin flip that
    flipped a whole band-width ring of pixels between the two materials."""
    from pathtracerpython_tpu.diff.boundary import IMAX, soft_hits_sweep
    from pathtracerpython_tpu.ops.camera import make_primary_rays
    from pathtracerpython_tpu.scene.obj import mesh_from_arrays
    from pathtracerpython_tpu.scene.sdl import SceneDescription, SdlObject

    floor = mesh_from_arrays(
        [[-4.0, -1.0, 2.0], [4.0, -1.0, 2.0], [4.0, -1.0, -8.0],
         [-4.0, -1.0, -8.0]],
        [[0, 1, 2], [0, 2, 3]],
    )
    # a box whose BOTTOM face (y = -1.0 exactly) is coplanar with the floor
    v = []
    for y in (-1.0, -0.4):
        v += [[-0.3, y, -2.4], [0.3, y, -2.4], [0.3, y, -1.6],
              [-0.3, y, -1.6]]
    faces = [[0, 2, 1], [0, 3, 2],          # bottom (in the floor plane)
             [4, 5, 6], [4, 6, 7],          # top
             [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
             [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]]
    box = mesh_from_arrays(v, faces)
    light = mesh_from_arrays(
        [[-0.7, 1.5, -2.7], [0.7, 1.5, -2.7], [0.7, 1.5, -1.3],
         [-0.7, 1.5, -1.3]],
        [[0, 1, 2], [0, 2, 3]],
    )
    mat = dict(ka=0.3, kd=0.7, ks=0.0, kt=0.0, n=1.0)
    desc = SceneDescription(
        eye=(0.0, 0.8, 3.0), width=24, height=24,
        ortho=(-1.0, -1.0, 1.0, 1.0), ambient=0.3,
        light_mesh=light, light_color=(1.0, 1.0, 1.0),
        objects=[SdlObject(mesh=floor, rgb=(0.7, 0.7, 0.7), **mat),
                 SdlObject(mesh=box, rgb=(0.8, 0.2, 0.2), **mat)],
    )
    scene = pack_scene(desc)
    o, d = make_primary_rays(scene.eye, scene.ortho, 24, 24)
    sh = soft_hits_sweep(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        scene, 0.05,
    )
    found = np.asarray(sh.f_idx) != IMAX
    # wherever F is a NEAR-MISS (negative margin), its t must lead the
    # true hit by the bias — a coplanar competitor can never be F
    near = found & (np.asarray(sh.f_margin) < 0.0)
    ft, h1t = np.asarray(sh.f_t), np.asarray(sh.h1_t)
    has_h1 = np.asarray(sh.h1_idx) != IMAX
    both = near & has_h1
    assert (ft[both] < h1t[both] - 1e-5).all(), (
        ft[both & ~(ft < h1t - 1e-5)][:5], h1t[both & ~(ft < h1t - 1e-5)][:5]
    )
    # floor pixels adjacent to the box keep the floor as F (true hit)
    mats = np.asarray(scene.tri_material)
    fmat = mats[np.where(found, np.asarray(sh.f_idx), 0)]
    h1mat = mats[np.where(has_h1, np.asarray(sh.h1_idx), 0)]
    same_t = found & has_h1 & (np.abs(ft - h1t) < 1e-4 * (1 + np.abs(h1t)))
    assert (fmat[same_t] == h1mat[same_t]).all()
