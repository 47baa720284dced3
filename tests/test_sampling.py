"""Sampling primitives: parity with reference formulas + statistical sanity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reference_oracle import import_reference

from pathtracerpython_tpu.ops import sampling

@pytest.fixture(scope="module")
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


def test_rotation_about_y_matches_reference_rotate(reference):
    rng = np.random.default_rng(2)
    for _ in range(50):
        angle = rng.uniform(0, np.pi)
        v = rng.normal(size=3)
        ref = ref_main.rotate(np.array((0.0, 1.0, 0.0)), angle, v)
        rot = np.asarray(sampling.rotation_about_y(jnp.asarray(angle)))
        ours = rot @ v
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_rotate_frame_reference_matches(reference):
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        v = rng.normal(size=3)
        angle = np.arccos(np.dot(np.array((0.0, 1.0, 0.0)), n))
        ref = ref_main.rotate(np.array((0.0, 1.0, 0.0)), angle, v)
        ours = np.asarray(
            sampling.rotate_frame_reference(
                jnp.asarray(v, jnp.float32), jnp.asarray(n, jnp.float32)
            )
        )
        np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_pick_light_triangle_matches_reference_cdf(reference, monkeypatch):
    """Drive the reference's pick_random_triangle with known uniforms and
    compare indices. The reference draws uniform(0, sum(areas)); ours takes
    u in [0,1) and scales — patch its `uniform` to return our u * total."""
    rng = np.random.default_rng(4)
    areas = rng.uniform(0.1, 3.0, size=7)
    total = areas.sum()
    us = rng.uniform(0, 1, 200)

    ours = np.asarray(
        sampling.pick_light_triangle(jnp.asarray(us), jnp.asarray(areas))
    )
    for u, mine in zip(us, ours):
        monkeypatch.setattr(ref_utils, "uniform", lambda a, b, _u=u: _u * total)
        ref_idx = ref_utils.pick_random_triangle(list(areas))
        assert mine == ref_idx, (u, mine, ref_idx)


def test_barycentric_reference_normalization():
    rng = np.random.default_rng(5)
    u3 = jnp.asarray(rng.uniform(0, 1, (100, 3)))
    bary = np.asarray(sampling.sample_barycentric_reference(u3))
    np.testing.assert_allclose(bary.sum(-1), 1.0, atol=1e-6)
    # center bias: variance of normalized-uniform barycentrics is lower than
    # uniform (Dirichlet(1,1,1)) barycentrics
    assert bary.std() < 0.235  # uniform triangle sampling would be ~0.2357


def test_barycentric_uniform_is_uniform():
    key = jax.random.PRNGKey(0)
    u2 = jax.random.uniform(key, (20000, 2))
    bary = np.asarray(sampling.sample_barycentric_uniform(u2))
    np.testing.assert_allclose(bary.sum(-1), 1.0, atol=1e-6)
    assert (bary >= 0).all()
    # each coordinate of a uniform barycentric has mean 1/3, var 1/18
    np.testing.assert_allclose(bary.mean(0), [1 / 3] * 3, atol=0.01)
    np.testing.assert_allclose(bary.var(0), [1 / 18] * 3, atol=0.005)


def test_cosine_hemisphere_reference_formula():
    rng = np.random.default_rng(6)
    u2 = rng.uniform(0, 1, (100, 2))
    ours = np.asarray(sampling.cosine_hemisphere_reference(jnp.asarray(u2)))
    phi = np.arccos(np.sqrt(u2[:, 0]))
    theta = 6.28 * u2[:, 1]
    ref = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)


def test_cosine_hemisphere_fixed_statistics():
    key = jax.random.PRNGKey(1)
    n = jnp.asarray([0.0, 1.0, 0.0])
    u2 = jax.random.uniform(key, (50000, 2))
    d = np.asarray(sampling.cosine_hemisphere_fixed(u2, n))
    cos = d @ np.array([0.0, 1.0, 0.0])
    assert (cos >= -1e-6).all()
    # E[cos] for cosine-weighted = 2/3
    np.testing.assert_allclose(cos.mean(), 2 / 3, atol=0.01)


def test_build_onb_orthonormal():
    rng = np.random.default_rng(7)
    n = rng.normal(size=(100, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t, bt = sampling.build_onb(jnp.asarray(n, jnp.float32))
    t, bt = np.asarray(t), np.asarray(bt)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(bt, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose((t * n).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose((bt * n).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose((t * bt).sum(-1), 0.0, atol=1e-5)


def test_reflect():
    d = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(sampling.reflect(d, n))
    np.testing.assert_allclose(r, [[1.0, 1.0, 0.0]], atol=1e-6)


def test_cm_variants_match_row_major():
    """Component-major sampling functions == row-major on transposed data."""
    import jax
    import jax.numpy as jnp
    from pathtracerpython_tpu.ops import sampling as S

    key = jax.random.PRNGKey(0)
    n = 257
    u3 = jax.random.uniform(key, (n, 3), minval=0.01, maxval=0.99)
    u2 = u3[:, :2]
    nrm = S.safe_normalize(jax.random.normal(jax.random.fold_in(key, 1), (n, 3)))
    v = S.safe_normalize(jax.random.normal(jax.random.fold_in(key, 2), (n, 3)))

    np.testing.assert_allclose(
        np.asarray(S.cm_sample_barycentric_reference(u3.T)),
        np.asarray(S.sample_barycentric_reference(u3)).T, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(S.cm_sample_barycentric_uniform(u2.T)),
        np.asarray(S.sample_barycentric_uniform(u2)).T, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(S.cm_cosine_hemisphere_reference(u2.T)),
        np.asarray(S.cosine_hemisphere_reference(u2)).T, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(S.cm_rotate_frame_reference(v.T, nrm.T)),
        np.asarray(S.rotate_frame_reference(v, nrm)).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(S.cm_cosine_hemisphere_fixed(u2.T, nrm.T)),
        np.asarray(S.cosine_hemisphere_fixed(u2, nrm)).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(S.cm_reflect(v.T, nrm.T)),
        np.asarray(S.reflect(v, nrm)).T, rtol=1e-6, atol=1e-7)
    b = S.sample_barycentric_uniform(u2)
    v0, v1, v2 = (jax.random.normal(jax.random.fold_in(key, i), (n, 3))
                  for i in (3, 4, 5))
    np.testing.assert_allclose(
        np.asarray(S.cm_point_from_barycentric(b.T, v0.T, v1.T, v2.T)),
        np.asarray(S.point_from_barycentric(b, v0, v1, v2)).T, rtol=1e-6,
        atol=1e-6)
