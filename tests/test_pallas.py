"""Culled Triton sweep kernels (kernels/intersect_triton.py) vs the XLA
sweeps, in Pallas interpret mode on the CPU; the compiled kernels are
checked on the card by chip_smoke.py (phase "boxfield")."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.heavy

from pathtracerpython_tpu.kernels import intersect_triton as kt
from pathtracerpython_tpu.ops import geometry
from pathtracerpython_tpu.ops.camera import make_primary_rays
from pathtracerpython_tpu.ops.geometry import (
    any_hit_within,
    nearest_hit,
    safe_normalize,
)
from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.render.integrator import render
from pathtracerpython_tpu.scene.arrays import pack_scene
from pathtracerpython_tpu.scene.synthetic import box_field_scene


def primary_rays(scene):
    return make_primary_rays(
        scene.eye, scene.ortho, scene.meta.width, scene.meta.height
    )


def kernel_nearest(o, d, scene):
    """(hit, t, idx) of the interpreted kernel for row-major rays."""
    du = safe_normalize(d)
    t, idx = kt.nearest_t_idx_cm(o.T, du.T, scene, interpret=True)
    return np.asarray(idx) >= 0, np.asarray(t), np.asarray(idx)


def test_nearest_hit_matches_xla(cornell_scene):
    o, d = primary_rays(cornell_scene)
    ref = nearest_hit(o, d, cornell_scene, mode="fast")
    hit, t, idx = kernel_nearest(o, d, cornell_scene)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    h = np.asarray(ref.hit)
    np.testing.assert_array_equal(idx[h], np.asarray(ref.tri_idx)[h])
    np.testing.assert_allclose(t[h], np.asarray(ref.t)[h], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t[~h], 0.0)


def test_nearest_hit_unaligned_ray_count(cornell_scene):
    o, d = primary_rays(cornell_scene)
    o, d = o[:77], d[:77]  # not a multiple of R_BLK: padded lanes drop
    ref = nearest_hit(o, d, cornell_scene, mode="fast")
    hit, t, _ = kernel_nearest(o, d, cornell_scene)
    assert t.shape == (77,)
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    h = np.asarray(ref.hit)
    np.testing.assert_allclose(t[h], np.asarray(ref.t)[h], rtol=1e-6,
                               atol=1e-6)


def test_any_hit_matches_xla(cornell_scene):
    key = jax.random.PRNGKey(0)
    n = 300  # not a multiple of R_BLK either
    k1, k2, k3 = jax.random.split(key, 3)
    origin = jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0)
    direction = safe_normalize(
        jax.random.normal(k2, (n, 3), dtype=jnp.float32)
    )
    max_dist = jax.random.uniform(k3, (n,), minval=0.5, maxval=4.0)
    ref = any_hit_within(origin, direction, max_dist, cornell_scene)
    out = kt.any_hit_cm(origin.T, direction.T, max_dist, cornell_scene,
                        interpret=True)
    assert out.shape == (n,)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_full_render_pallas_backend(monkeypatch):
    """A whole render with the sweeps routed through the interpreted
    kernels (the CUDA branch of the dispatch) matches the XLA render."""
    scene = pack_scene(box_field_scene(n_boxes=30, seed=2, width=12,
                                       height=12), morton_order=True)
    assert geometry.use_sweep_kernel("fast", None)
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2)
    rx = np.asarray(render(scene, cfg, seed=2))

    def on_cuda(*args, cuda, default):
        return cuda(*args, interpret=True)

    monkeypatch.setattr(jax.lax, "platform_dependent", on_cuda)
    rk = np.asarray(render(scene, cfg, seed=2))
    # the kernel and XLA order some float ops differently, so rays exactly
    # grazing a triangle edge may classify differently — a measure-zero
    # set. Demand near-exact agreement everywhere else and bounded error
    # on the flips.
    close = np.isclose(rk, rx, rtol=1e-5, atol=1e-5)
    assert close.mean() > 0.99, f"only {close.mean():.4f} close"
    assert np.abs(rk - rx).max() < 0.05


def test_nearest_hit_gradients_match_xla(cornell_scene):
    """d(sum of hit distances)/d(origin, vertices): the kernel's custom
    VJP must agree with autodiff through the XLA sweep."""
    o, d = primary_rays(cornell_scene)
    o, d = o[:128], d[:128]

    def loss_xla(origin, v0):
        sc = dataclasses.replace(cornell_scene, tri_v0=v0)
        hit = nearest_hit(origin, d, sc, mode="fast")
        return jnp.sum(jnp.where(hit.hit, hit.t, 0.0))

    def loss_kernel(origin, v0):
        sc = dataclasses.replace(cornell_scene, tri_v0=v0)
        t, idx = kt.nearest_t_idx_cm(
            origin.T, safe_normalize(d).T, sc, interpret=True
        )
        return jnp.sum(jnp.where(idx >= 0, t, 0.0))

    gx = jax.grad(loss_xla, argnums=(0, 1))(o, cornell_scene.tri_v0)
    gk = jax.grad(loss_kernel, argnums=(0, 1))(o, cornell_scene.tri_v0)
    np.testing.assert_allclose(
        np.asarray(gk[0]), np.asarray(gx[0]), rtol=1e-4, atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(gk[1]), np.asarray(gx[1]), rtol=1e-4, atol=5e-5
    )


@pytest.mark.parametrize(
    "mode,geom_axis,expect",
    [
        ("fast", None, True),          # every fast-mode scene size
        ("reference", None, False),    # the parity path stays XLA
        ("fast", "geom", False),       # the ring sweeps its shards
        ("reference", "geom", False),
    ],
)
def test_kernel_choice(mode, geom_axis, expect):
    assert geometry.use_sweep_kernel(mode, geom_axis) is expect


def test_cpu_lowers_the_xla_sweep(cornell_scene):
    """Off CUDA the dispatch lowers the XLA sweep: the component-major
    fast-mode hit equals ``nearest_hit`` winner for winner."""
    o, d = primary_rays(cornell_scene)
    ref = nearest_hit(o, d, cornell_scene, mode="fast")
    got = geometry.nearest_hit_cm(o.T, d.T, cornell_scene, mode="fast")
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.tri_idx),
                                  np.asarray(ref.tri_idx))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-6)


def test_pack_triangles_pads_tiles_and_boxes(cornell_scene):
    tris, boxes = kt.pack_triangles(cornell_scene)
    t = cornell_scene.num_padded_triangles
    assert tris.shape == (16, -(-t // kt.T_TILE) * kt.T_TILE)
    assert boxes.shape == (8, tris.shape[1] // kt.T_TILE)
    tris, boxes = np.asarray(tris), np.asarray(boxes)
    valid = np.asarray(cornell_scene.tri_valid)
    np.testing.assert_array_equal(tris[9, :t] > 0.5, valid)
    np.testing.assert_allclose(
        tris[3:6, :t].T,
        np.asarray(cornell_scene.tri_v1 - cornell_scene.tri_v0),
    )
    # tile 0 holds all 32 real triangles; its box is their bounds, the
    # other (all-padding) tile is inverted so the kernel skips it
    v = np.concatenate([np.asarray(getattr(cornell_scene, f"tri_v{k}"))
                        [valid] for k in range(3)])
    np.testing.assert_allclose(boxes[0:3, 0], v.min(axis=0))
    np.testing.assert_allclose(boxes[3:6, 0], v.max(axis=0))
    assert (boxes[0:3, 1] > boxes[3:6, 1]).all()


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu):
    """The compiled (not interpreted) kernels on the card agree with the
    XLA sweeps there; skips without a GPU."""
    scene = jax.device_put(
        pack_scene(box_field_scene(n_boxes=200, seed=4, width=64,
                                   height=64), morton_order=True), gpu)
    with jax.default_device(gpu):
        o, d = primary_rays(scene)
        ref = nearest_hit(o, d, scene, mode="fast")
        t, idx = kt.nearest_t_idx_cm(o.T, safe_normalize(d).T, scene)
        h = np.asarray(ref.hit)
        np.testing.assert_array_equal(np.asarray(idx) >= 0, h)
        np.testing.assert_allclose(np.asarray(t)[h], np.asarray(ref.t)[h],
                                   rtol=1e-5)
