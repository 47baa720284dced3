"""Large synthetic scenes: Morton packing + the culled Triton kernels
(interpret mode) vs the brute-force XLA sweep oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.heavy

from pathtracerpython_tpu.kernels import intersect_triton as kt
from pathtracerpython_tpu.ops.camera import make_primary_rays
from pathtracerpython_tpu.ops.geometry import (
    any_hit_within,
    nearest_hit,
    safe_normalize,
)
from pathtracerpython_tpu.scene.arrays import pack_scene
from pathtracerpython_tpu.scene.synthetic import box_field_scene


@pytest.fixture(scope="module")
def boxes_scene():
    # 64 boxes → 772 real triangles; morton_order groups them into tight
    # T_TILE-triangle kernel tiles
    return pack_scene(box_field_scene(n_boxes=64, seed=3), morton_order=True)


def test_morton_pack_preserves_triangle_set(cornell_sdl):
    from pathtracerpython_tpu.scene.sdl import load_sdl

    desc = load_sdl(cornell_sdl)
    plain = pack_scene(desc)
    sorted_ = pack_scene(desc, morton_order=True)

    def key_set(sc):
        v = np.asarray(sc.tri_v0)[np.asarray(sc.tri_valid)]
        return {tuple(np.round(r, 5)) for r in v}

    assert key_set(plain) == key_set(sorted_)
    assert int(np.asarray(sorted_.tri_valid).sum()) == plain.meta.n_triangles
    # light triangles keep their flags through the permutation
    assert (
        int(np.asarray(sorted_.tri_is_light).sum())
        == plain.meta.n_light_triangles
    )


def test_culled_nearest_matches_bruteforce(boxes_scene):
    sc = boxes_scene
    o, d = make_primary_rays(sc.eye, sc.ortho, sc.meta.width, sc.meta.height)
    ref = nearest_hit(o, d, sc, mode="fast")
    t, idx = kt.nearest_t_idx_cm(o.T, safe_normalize(d).T, sc,
                                 interpret=True)
    h = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(idx) >= 0, h)
    np.testing.assert_array_equal(
        np.asarray(idx)[h], np.asarray(ref.tri_idx)[h]
    )
    np.testing.assert_allclose(
        np.asarray(t)[h], np.asarray(ref.t)[h], rtol=1e-6, atol=1e-6
    )


def test_culled_any_hit_matches_bruteforce(boxes_scene):
    sc = boxes_scene
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    n = 384
    origin = jax.random.uniform(
        k1, (n, 3), minval=-4.0, maxval=4.0
    ) * jnp.asarray([1.0, 0.25, 1.0]) + jnp.asarray([0.0, -0.5, -8.0])
    direction = safe_normalize(jax.random.normal(k2, (n, 3)))
    max_dist = jax.random.uniform(k3, (n,), minval=1.0, maxval=12.0)
    ref = any_hit_within(origin, direction, max_dist, sc)
    out = kt.any_hit_cm(origin.T, direction.T, max_dist, sc, interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_render_morton_scene_matches_plain(cornell_sdl):
    """Rendering must be invariant to triangle buffer order (fast mode)."""
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene.sdl import load_sdl

    desc = load_sdl(cornell_sdl)
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2)
    r_plain = np.asarray(render(pack_scene(desc), cfg, seed=4))
    r_sorted = np.asarray(
        render(pack_scene(desc, morton_order=True), cfg, seed=4)
    )
    np.testing.assert_allclose(r_sorted, r_plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,expect_unrolled", [(5, True), (7, False)])
def test_many_light_triangles_both_sides_of_gate(grid, expect_unrolled):
    """Light meshes on BOTH sides of the light pick's unroll gate
    (ops/sampling.pick_light_triangle: compare-and-count up to 64
    triangles, searchsorted beyond): 50 triangles take the unrolled pick,
    98 the searchsorted one. Either way the pick must invert the area CDF
    exactly as a float64 searchsorted does, and the render must see the
    light."""
    from pathtracerpython_tpu.ops.sampling import pick_light_triangle
    from pathtracerpython_tpu.render.config import RenderConfig
    from pathtracerpython_tpu.render.integrator import render
    from pathtracerpython_tpu.scene.obj import mesh_from_arrays
    from pathtracerpython_tpu.scene.sdl import SceneDescription, SdlObject
    from pathtracerpython_tpu.scene.synthetic import quad_mesh

    # light: a grid x grid field of quads = 2*grid^2 triangles, with
    # varying sizes so the CDF steps are uneven
    verts, faces = [], []
    off = 0
    for i in range(grid):
        for j in range(grid):
            x0, z0 = -0.5 + 0.2 * i, -2.4 + 0.2 * j
            s = 0.1 + 0.1 * ((i + 2 * j) % 3) / 2
            q = quad_mesh(
                [x0, 1.4, z0], [x0 + s, 1.4, z0],
                [x0 + s, 1.4, z0 + s], [x0, 1.4, z0 + s],
            )
            verts.append(q.vertices)
            faces.append(q.faces + off)
            off += 4
    light = mesh_from_arrays(
        np.concatenate(verts), np.concatenate(faces), path="gridlight"
    )
    floor = quad_mesh([-3, -1, 1], [3, -1, 1], [3, -1, -5], [-3, -1, -5])
    desc = SceneDescription(
        eye=(0.0, 0.0, 3.0), width=16, height=16,
        ortho=(-1.0, -1.0, 1.0, 1.0), ambient=0.3,
        light_mesh=light, light_color=(1.0, 1.0, 1.0),
        objects=[SdlObject(mesh=floor, rgb=(0.5, 0.5, 0.5), ka=0.3,
                           kd=0.7, ks=0.0, kt=0.0, n=1.0)],
    )
    scene = pack_scene(desc)
    n_light = scene.light_v0.shape[0]
    assert n_light == 2 * grid * grid
    assert (n_light <= 64) == expect_unrolled

    areas = np.asarray(scene.light_area)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (4096,)))
    got = np.asarray(pick_light_triangle(jnp.asarray(u), scene.light_area))
    cum = np.cumsum(areas.astype(np.float32))
    want = np.clip(np.searchsorted(cum, u * cum[-1], side="right"),
                   0, n_light - 1)
    np.testing.assert_array_equal(got, want)
    # every triangle is picked at a rate close to its area share
    rate = np.bincount(got, minlength=n_light) / u.size
    assert np.abs(rate - areas / areas.sum()).max() < 0.02

    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1)
    r = np.asarray(render(scene, cfg, seed=1))
    assert np.isfinite(r).all()
    assert (np.all(r == 1.0, axis=1)).any()  # primary rays see the light
    lit = r[~np.all(r == 1.0, axis=1)]
    assert (lit.max(axis=1) > 0.3 * 0.5).any()  # NEE lights the floor
