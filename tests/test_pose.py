"""Pose-axis conditioning gates (VERDICT r3 task 5).

Round 3 excluded the vertical axis from both fit_pose modes with an
UNMEASURED rationale ("no inverse-square falloff ⇒ no vertical signal").
This module replaces the rationale with measurements, and they split it:

- the LIGHT's vertical position IS degenerate, but not because |dL/dy| is
  small — the loss along y is a flat valley (saturates immediately after
  the light detaches from the ceiling) and the interior gradient at a
  displaced pose points AWAY from the truth, so gradient descent drifts.
  Light mode stays lateral-only (apps/fit_pose.py docstring).
- an OBJECT's vertical position is NOT degenerate: the cube's silhouette
  carries y signal of the same order as lateral, FD-validates, and a
  translation fit including y recovers. Hence ``fit_pose --dof full``.

Plus the full-rotation extension: pitch/roll FD gates and a 6-dof
(xyz + yaw/pitch/roll) recovery fit through
``diff.transforms.transform_object_full``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pathtracerpython_tpu.ops.camera import make_primary_rays
from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.render.integrator import render_rays
from pathtracerpython_tpu.scene import cornell_sdl
from test_boundary import BETA, make_occluder_scene, scene_loss


@pytest.fixture(scope="module")
def occ_scene():
    return make_occluder_scene()


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    scene = cornell_scene
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    return scene, o, d, pids


def _light_loss_fn(cornell, cfg):
    from pathtracerpython_tpu.apps.fit_pose import translate_light

    scene, o, d, pids = cornell
    key = jax.random.PRNGKey(0)
    target = render_rays(o, d, pids, scene, cfg, key)

    def loss(off):
        rad = render_rays(o, d, pids, translate_light(scene, off), cfg, key)
        return 0.5 * jnp.mean((rad - target) ** 2)

    return loss


def test_light_y_is_degenerate_measured(cornell):
    """The measured form of the light-mode y-exclusion claim.

    (a) flat valley: moving the light DOWN saturates the loss — L(y−δ)
        changes <25% from δ=0.05 to δ=0.2 (measured 1.18e-3 → 1.12e-3),
        while the lateral loss keeps growing (x: 5.6e-4 → 2.2e-3, ≥2.5×);
    (b) non-restoring gradient: at a downward-displaced pose the interior
        dL/dy is POSITIVE (descent pushes y further down, away from the
        truth) — which is exactly the drift fit_pose documents.
    """
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1)
    loss = jax.jit(_light_loss_fn(cornell, cfg))

    def L(x, y, z):
        return float(loss(jnp.asarray([x, y, z], jnp.float32)))

    y_near, y_far = L(0, -0.05, 0), L(0, -0.2, 0)
    x_near = L(0.05, 0, 0) + L(-0.05, 0, 0)
    x_far = L(0.2, 0, 0) + L(-0.2, 0, 0)
    assert y_far < 1.25 * y_near, (y_near, y_far)   # saturated valley
    assert x_far > 2.5 * x_near, (x_near, x_far)    # restoring lateral

    g = jax.grad(_light_loss_fn(cornell, cfg))(
        jnp.asarray([0.2, -0.1, 0.15], jnp.float32)
    )
    assert float(g[1]) > 0.0, float(g[1])  # descent moves y AWAY from 0


def _cube_loss_fn(cornell, cfg):
    from pathtracerpython_tpu.apps.fit_pose import find_object_index
    from pathtracerpython_tpu.diff.transforms import transform_object

    scene, o, d, pids = cornell
    idx = find_object_index(cornell_sdl(), "cube")
    key = jax.random.PRNGKey(0)
    target = render_rays(o, d, pids, scene, cfg, key)

    def loss(off):
        moved = transform_object(scene, idx, off, 0.0)
        rad = render_rays(o, d, pids, moved, cfg, key)
        return 0.5 * jnp.mean((rad - target) ** 2)

    return loss


def test_cube_y_translation_grad_matches_fd(cornell):
    """Unlike the light, the cube's vertical translation FD-validates:
    its silhouette sweeps the image as it lifts, so y carries real,
    smooth (soft-estimator) signal — the measured basis for
    ``fit_pose --dof full``.

    Gate points sit clear of the floor (dy >= 0.1): within ~a band width
    of contact the cube's bottom edge, its shadow, and the floor stack
    several boundaries inside the blend band, the one-boundary-model
    limit tests/test_boundary.py already documents (measured here:
    FD/AD ratio 2-3x at dy=0.03-0.06, <=4e-2 at 0.1/0.15)."""
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       soft_vis_beta=0.06)
    loss = _cube_loss_fn(cornell, cfg)

    def f(dy):
        return loss(jnp.asarray([0.0, 1.0, 0.0]) * dy)

    for dy0 in (0.1, 0.15):
        ad = float(jax.grad(f)(dy0))
        eps = 5e-4
        fd = (float(f(dy0 + eps)) - float(f(dy0 - eps))) / (2 * eps)
        assert abs(ad) > 1e-5, (dy0, ad)
        np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=2e-5,
                                   err_msg=f"dy0={dy0}")


def test_cube_translation_fit_recovers_y(cornell):
    """A 3-dof translation fit INCLUDING y recovers a (0.25, 0.2, 0.15)
    cube displacement — the direct refutation of round-3's y-exclusion
    for objects (the light's drift does not transfer)."""
    import optax

    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       soft_vis_beta=0.06)
    loss = _cube_loss_fn(cornell, cfg)
    params = jnp.asarray([0.25, 0.2, 0.15], jnp.float32)
    opt = optax.adam(0.02)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        l, g = jax.value_and_grad(loss)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, l

    for _ in range(120):
        params, state, _ = step(params, state)
    err = np.abs(np.asarray(params))
    assert (err < 0.05).all(), err


def test_pitch_roll_grads_match_fd(occ_scene):
    """Central FD validates the soft gradient of the two NEW rotation
    axes (``rotate_object_euler``): pitch (about x) and roll (about z) of
    the blocker quad. Gate points sit away from the edge-on degeneracy at
    roll=0 (a coplanar quad tilting through exactly flat is the
    one-boundary kink tests/test_boundary.py already documents)."""
    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    from pathtracerpython_tpu.diff.transforms import rotate_object_euler

    for axis, points in ((1, (0.0, 0.1)), (2, (0.1, 0.25))):
        def f(th, axis=axis):
            ang = jnp.zeros(3).at[axis].set(th)
            return scene_loss(rotate_object_euler(occ_scene, 1, ang), cfg)

        for th0 in points:
            ad = float(jax.grad(f)(th0))
            eps = 1e-3
            fd = (float(f(th0 + eps)) - float(f(th0 - eps))) / (2 * eps)
            assert abs(ad) > 1e-5, (axis, th0, ad)
            np.testing.assert_allclose(
                ad, fd, rtol=8e-2, atol=2e-5,
                err_msg=f"axis={axis} th0={th0}",
            )


def test_full_pose_6dof_fit_recovers(occ_scene):
    """A full 6-dof pose fit (xyz translation + yaw/pitch/roll through
    ``transform_object_full``) recovers a simultaneous perturbation on
    every axis — the 3-axis-rotation recovery the round-3 VERDICT asked
    for, plus free vertical translation."""
    import optax

    cfg = RenderConfig(mode="fast", n_bounces=1, n_light_samples=2,
                       soft_vis_beta=BETA)
    from pathtracerpython_tpu.diff.transforms import transform_object_full

    scene = occ_scene
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_rays(o, d, pids, scene, cfg, 5)

    def loss(p):
        moved = transform_object_full(scene, 1, p[0:3], p[3:6])
        rad = render_rays(o, d, pids, moved, cfg, 5)
        return 0.5 * jnp.mean((rad - target) ** 2)

    params = jnp.asarray([0.2, 0.12, -0.15, 0.2, 0.15, -0.1], jnp.float32)
    opt = optax.adam(0.03)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        l, g = jax.value_and_grad(loss)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, l

    for _ in range(200):
        params, state, _ = step(params, state)
    err = np.abs(np.asarray(params))
    assert (err < 0.05).all(), err
