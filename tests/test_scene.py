"""Golden tests for SDL/OBJ parsing against the reference Cornell scene.

Expected values derive from the packaged Cornell box
(``pathtracerpython_tpu/scene/cornell/cornellroom.sdl``) and the reference
parser semantics (scene_reader.py) — 7 objects (30 triangles) plus a
2-triangle light, materials as listed in the SDL.
"""

import numpy as np
import pytest

from pathtracerpython_tpu.scene import load_scene, load_sdl, load_obj
from pathtracerpython_tpu.scene.arrays import recompute_derived


def test_sdl_fields(cornell_sdl):
    d = load_sdl(cornell_sdl)
    assert d.eye == (0.0, 0.0, 5.7)
    assert (d.width, d.height) == (40, 40)
    assert d.ortho == (-1.0, -1.0, 1.0, 1.0)
    assert d.background == (0.0, 0.0, 0.0)
    assert d.ambient == 0.5
    assert d.light_color == (1.0, 1.0, 1.0)
    assert d.npaths == 10
    assert d.tonemapping == 1.0
    assert d.seed == 9
    assert d.output is not None and d.output.endswith("cornell.pnm")
    assert len(d.objects) == 7
    # left wall RED, ka=0.3 kd=0.7 ks=0 kt=0 n=5
    o = d.objects[0]
    assert o.rgb == (1.0, 0.0, 0.0)
    assert (o.ka, o.kd, o.ks, o.kt, o.n) == (0.3, 0.7, 0.0, 0.0, 5.0)
    # cube1 has ks=0.9, cube2 ks=0.6
    assert d.objects[5].ks == 0.9
    assert d.objects[6].ks == 0.6


def test_obj_counts(cornell_sdl):
    d = load_sdl(cornell_sdl)
    tris = [o.mesh.num_triangles for o in d.objects]
    assert tris == [2, 2, 2, 2, 2, 10, 10]
    assert d.light_mesh.num_triangles == 2


def test_obj_normals_and_areas(cornell_sdl):
    # back wall: two triangles in plane z=-32.76, normal +z by winding
    import os

    back = load_obj(os.path.join(os.path.dirname(cornell_sdl), "back.obj"))
    assert back.num_triangles == 2
    np.testing.assert_allclose(back.normals, [[0, 0, 1], [0, 0, 1]], atol=1e-12)
    # area of each triangle = (2*3.822) * (2*3.8416) / 2
    expected = (2 * 3.822) * (2 * 3.8416) / 2
    np.testing.assert_allclose(back.areas, [expected, expected], rtol=1e-12)


def test_negative_indices_and_fan(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f -4 -3 -2 -1\n"  # quad with negative indices -> 2 fan triangles
    )
    m = load_obj(str(p))
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(m.areas, [0.5, 0.5])


def test_pack_scene(cornell_scene):
    s = cornell_scene
    assert s.meta.n_triangles == 32
    assert s.meta.n_object_triangles == 30
    assert s.meta.n_light_triangles == 2
    assert s.meta.n_objects == 7
    assert s.num_padded_triangles == 128
    assert s.tri_valid.sum() == 32
    assert s.tri_occluder.sum() == 30
    assert s.tri_is_light.sum() == 2
    # light tris are the last two valid entries
    assert bool(s.tri_is_light[30]) and bool(s.tri_is_light[31])
    assert s.mat_rgb.shape == (8, 3)
    np.testing.assert_allclose(np.asarray(s.mat_rgb)[0], [1, 0, 0])
    np.testing.assert_allclose(np.asarray(s.mat_rgb)[7], [0, 0, 0])  # light row
    assert s.meta.light_material == 7
    np.testing.assert_allclose(np.asarray(s.light_color), [1, 1, 1])
    np.testing.assert_allclose(np.asarray(s.eye), [0, 0, 5.7], rtol=1e-6)


def test_pack_scene_is_pytree(cornell_scene):
    import jax

    leaves = jax.tree_util.tree_leaves(cornell_scene)
    assert len(leaves) == 25  # the 25 data fields of SceneArrays
    # meta survives flatten/unflatten
    flat, treedef = jax.tree_util.tree_flatten(cornell_scene)
    s2 = jax.tree_util.tree_unflatten(treedef, flat)
    assert s2.meta == cornell_scene.meta


def test_recompute_derived_matches_host(cornell_scene):
    s2 = recompute_derived(cornell_scene)
    np.testing.assert_allclose(
        np.asarray(s2.tri_normal), np.asarray(cornell_scene.tri_normal),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(s2.tri_area), np.asarray(cornell_scene.tri_area), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s2.light_area), np.asarray(cornell_scene.light_area),
        rtol=1e-5,
    )


def test_astype(cornell_scene):
    import jax
    import jax.numpy as jnp
    import pytest

    sbf = cornell_scene.astype(jnp.bfloat16)
    assert sbf.tri_v0.dtype == jnp.bfloat16
    assert sbf.tri_material.dtype == jnp.int32
    if not jax.config.jax_enable_x64:
        # float64 without x64 would silently truncate — must be rejected
        with pytest.raises(ValueError, match="x64"):
            cornell_scene.astype(jnp.float64)
