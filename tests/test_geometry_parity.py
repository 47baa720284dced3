"""Function-level parity of our geometry ops vs the actual reference code.

The reference modules are imported directly (see reference_oracle.py) and
driven on random inputs; our batched masked sweeps must reproduce their
hit/miss decisions and distances. The reference computes in float64 while our
device path is float32, so assertions allow a small disagreement budget on
decision boundaries (measure-zero configurations).
"""

import numpy as np
import pytest

from reference_oracle import import_reference

from pathtracerpython_tpu.ops.geometry import (
    any_hit_within,
    intersect_reference,
    nearest_hit,
)
from pathtracerpython_tpu.ops.camera import make_primary_rays, make_screen_points
from pathtracerpython_tpu.scene import load_scene

@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference program's modules, imported when a test asks for
    them; the test skips where the program is not installed."""
    global ref_utils, ref_scene_reader, ref_main, ref_vector
    try:
        ref_utils, ref_scene_reader, ref_main, ref_vector = (
            import_reference()
        )
    except ImportError as e:
        pytest.skip(f"reference program not importable: {e}")


def _random_cases(rng, n):
    """Random rays vs random triangles in a ~[-2,2]^3 box."""
    v0 = rng.uniform(-2, 2, (n, 3))
    v1 = v0 + rng.uniform(-1.5, 1.5, (n, 3))
    v2 = v0 + rng.uniform(-1.5, 1.5, (n, 3))
    origins = rng.uniform(-3, 3, (n, 3))
    # aim roughly at the triangle so a good fraction are hits
    target = (v0 + v1 + v2) / 3 + rng.uniform(-0.5, 0.5, (n, 3))
    dirs = target - origins
    # point the last quarter AWAY from the triangle: the reference has no
    # t>0 check, so these must still register as (backward) hits
    dirs[3 * n // 4:] *= -1.0
    return origins, dirs, v0, v1, v2


def test_intersect_reference_parity():
    rng = np.random.default_rng(0)
    n = 500
    origins, dirs, v0, v1, v2 = _random_cases(rng, n)

    ref_hit = np.zeros(n, dtype=bool)
    ref_pt = np.zeros((n, 3))
    for i in range(n):
        tri = (v0[i], v1[i], v2[i])
        try:
            p = ref_utils.intersect((origins[i], dirs[i]), tri)
            ref_hit[i] = True
            ref_pt[i] = p
        except ref_utils.NoIntersection:
            pass

    f32 = np.float32
    hit, t = intersect_reference(
        origins.astype(f32), dirs.astype(f32),
        v0.astype(f32), v1.astype(f32), v2.astype(f32),
    )
    hit = np.asarray(hit)
    t = np.asarray(t)
    agree = hit == ref_hit
    # f32 vs f64 may disagree only on boundary-grazing configurations
    assert agree.mean() > 0.99, f"hit-mask agreement {agree.mean():.3f}"

    both = hit & ref_hit
    d_unit = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    our_pt = origins + d_unit * t[:, None]
    np.testing.assert_allclose(our_pt[both], ref_pt[both], atol=2e-3)
    # backward hits must be included (no t>0 check): random set contains some
    assert (t[both] < 0).any(), "expected some backward hits in reference mode"


@pytest.fixture(scope="module")
def ref_scene(cornell_sdl):
    return ref_scene_reader.Scene(cornell_sdl)


def test_screen_points_and_rays_parity(ref_scene, cornell_scene):
    ref_pts = ref_utils.make_screen_pts(*ref_scene.ortho, ref_scene.width,
                                        ref_scene.height)
    ref_rays = ref_utils.make_rays(ref_scene.eye, ref_pts)

    pts = np.asarray(make_screen_points(cornell_scene.ortho, 40, 40))
    np.testing.assert_allclose(pts, np.asarray(ref_pts), atol=1e-6)

    origins, dirs = make_primary_rays(cornell_scene.eye, cornell_scene.ortho,
                                      40, 40)
    ref_origins = np.stack([np.asarray(r[0]) for r in ref_rays])
    ref_dirs = np.stack([np.asarray(r[1]) for r in ref_rays])
    np.testing.assert_allclose(np.asarray(origins), ref_origins, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dirs), ref_dirs, atol=1e-6)


def test_nearest_hit_parity_primaries(ref_scene, cornell_scene):
    """Our nearest_hit vs the reference's intersect_objects on all 1600
    Cornell primary rays: hit mask, hit point, shading normal, light flag."""
    ref_pts = ref_utils.make_screen_pts(*ref_scene.ortho, ref_scene.width,
                                        ref_scene.height)
    ref_rays = ref_utils.make_rays(ref_scene.eye, ref_pts)
    ref_res = [
        ref_main.intersect_objects(r, ref_scene.objects, ref_scene.light_obj)
        for r in ref_rays
    ]

    origins, dirs = make_primary_rays(cornell_scene.eye, cornell_scene.ortho,
                                      40, 40)
    hit = nearest_hit(origins, dirs, cornell_scene, mode="reference")

    ref_hit = np.array([r is not None for r in ref_res])
    np.testing.assert_array_equal(np.asarray(hit.hit), ref_hit)

    idx = np.nonzero(ref_hit)[0]
    ref_pt = np.stack([np.asarray(ref_res[i][0], dtype=np.float64) for i in idx])
    ref_nrm = np.stack([np.asarray(list(ref_res[i][1]), dtype=np.float64) for i in idx])
    ref_is_light = np.array([ref_res[i][3] for i in idx])

    np.testing.assert_allclose(np.asarray(hit.point)[idx], ref_pt, atol=5e-3)
    np.testing.assert_allclose(np.asarray(hit.normal)[idx], ref_nrm, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(hit.is_light)[idx], ref_is_light)


def test_nearest_hit_material_parity(ref_scene, cornell_scene):
    """Material routing: the object dict the reference returns must map to
    our material row for every hit primary ray."""
    ref_pts = ref_utils.make_screen_pts(*ref_scene.ortho, ref_scene.width,
                                        ref_scene.height)
    ref_rays = ref_utils.make_rays(ref_scene.eye, ref_pts)

    origins, dirs = make_primary_rays(cornell_scene.eye, cornell_scene.ortho,
                                      40, 40)
    hit = nearest_hit(origins, dirs, cornell_scene, mode="reference")
    mats = np.asarray(hit.material)
    rgb = np.asarray(cornell_scene.mat_rgb)

    for i, r in enumerate(ref_rays):
        res = ref_main.intersect_objects(r, ref_scene.objects,
                                         ref_scene.light_obj)
        if res is None:
            continue
        _, _, obj, is_light = res
        if is_light:
            assert mats[i] == cornell_scene.meta.light_material
        else:
            ref_rgb = [obj["red"], obj["green"], obj["blue"]]
            np.testing.assert_allclose(rgb[mats[i]], ref_rgb, atol=1e-6)


def test_any_hit_occlusion_parity(ref_scene, cornell_scene):
    """Occlusion decisions vs the reference's shadow scan (main.py:41-55)
    for rays from random surface points toward random light points."""
    rng = np.random.default_rng(1)
    n = 200
    # random points in the room interior / on walls
    points = rng.uniform([-3.5, -3.5, -32], [3.5, 3.5, -17], (n, 3))
    light_tris = ref_scene.light_obj.triangles
    lp_idx = rng.integers(0, len(light_tris), n)
    bary = rng.dirichlet([1, 1, 1], n)
    light_pts = np.stack([
        sum(bary[i][j] * np.array(light_tris[lp_idx[i]][j]) for j in range(3))
        for i in range(n)
    ])

    ref_occ = np.zeros(n, dtype=bool)
    for i in range(n):
        vec = light_pts[i] - points[i]
        vec = vec / np.linalg.norm(vec)
        ray = (points[i], vec)
        light_sq = ref_utils.squared_dist(points[i], light_pts[i])
        done = False
        for obj in ref_scene.objects:
            for tri in obj["geometry"].triangles:
                try:
                    p = ref_utils.intersect(ray, tri)
                    d2 = ref_utils.squared_dist(p, points[i])
                    if d2 < ref_utils.ZERO:
                        continue
                    if d2 < light_sq:
                        done = True
                        break
                except ref_utils.NoIntersection:
                    pass
            if done:
                break
        ref_occ[i] = done

    f32 = np.float32
    dirs = (light_pts - points)
    max_dist = np.linalg.norm(dirs, axis=-1)
    occ = any_hit_within(
        points.astype(f32), dirs.astype(f32), max_dist.astype(f32),
        cornell_scene, mode="reference",
    )
    agree = np.asarray(occ) == ref_occ
    assert agree.mean() > 0.985, f"occlusion agreement {agree.mean():.3f}"
