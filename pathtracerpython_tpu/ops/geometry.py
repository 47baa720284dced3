"""Batched ray-triangle intersection sweeps (masked SoA, no exceptions).

Two intersection semantics are provided:

- ``mode="reference"`` mirrors the reference renderer exactly
  (``utils.py:98-147``): plane-intersection + three-edge-cross sign test,
  near-parallel rejection at ``|dot| > 1e-5``, and — deliberately — **no
  t > 0 check**, so hits behind the ray origin count, ordered by squared
  distance (``main.py:100,115``). Misses are masks, not ``NoIntersection``
  exceptions.

- ``mode="fast"`` (default) is Möller–Trumbore with a proper ``t > eps``
  near-clip: branch-free, differentiable, and the semantics the culled
  Triton kernels (``kernels/intersect_triton.py``) implement.

The nearest-hit / any-hit sweeps scan triangle *tiles* with a
``lax.scan`` carry of the running best hit, bounding peak memory to
O(n_rays × tile) so XLA fuses the whole tile chain into the reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pathtracerpython_tpu.scene.arrays import SceneArrays

# The reference's global epsilon (utils.py:18): parallel-plane rejection,
# self-hit exclusion (squared distance!), and shadow-distance slack.
ZERO = 1e-5


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def safe_normalize(v, eps: float = 1e-30):
    """Normalize along the last axis; zero vectors map to zero (and produce
    zero, not NaN, gradients — required for masked dead-ray lanes)."""
    sq = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * lax.rsqrt(jnp.maximum(sq, eps))


def intersect_reference(origin, direction, v0, v1, v2):
    """Reference-semantics intersection for broadcastable ray/triangle packs.

    Args are [..., 3]; rays broadcast against triangles. Returns
    ``(hit, t)`` where ``t`` is the *signed* parameter along the normalized
    direction (may be negative: the reference has no t>0 check) and ``hit``
    excludes only near-parallel rays and failed in-triangle tests.

    Mirrors ``utils.py:98-147``: the plane normal is cross(v1-v2, v3-v2),
    the in-triangle test takes the three edge crosses and requires
    sign(dot(c1,c2)) > 0 and sign(dot(c1,c3)) > 0. We skip the reference's
    normalization of the cross products — positive rescaling cannot change
    the sign of a dot product, so the accepted set is identical up to
    float underflow on degenerate (measure-zero) configurations.
    """
    d = safe_normalize(direction)
    n_plane = safe_normalize(jnp.cross(v0 - v1, v2 - v1))
    denom = _dot(d, n_plane)
    not_parallel = jnp.abs(denom) > ZERO
    safe = jnp.where(not_parallel, denom, 1.0)
    t = (_dot(n_plane, v0) - _dot(n_plane, origin)) / safe
    p = origin + d * t[..., None]
    # in-triangle sign test (utils.py:72-91), vertices renamed v1,v2,v3→v0,v1,v2
    c1 = jnp.cross(v0 - v1, p - v1)
    c2 = jnp.cross(v1 - v2, p - v2)
    c3 = jnp.cross(v2 - v0, p - v0)
    inside = (_dot(c1, c2) > 0.0) & (_dot(c1, c3) > 0.0)
    return not_parallel & inside, t


def intersect_moller(origin, direction, v0, v1, v2, eps: float = 1e-7):
    """Möller–Trumbore for broadcastable ray/triangle packs.

    ``direction`` must be normalized by the caller for metric ``t``.
    Returns ``(hit, t)`` with ``hit`` requiring ``t > eps`` (forward hits
    only — the sane default the reference lacks).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(direction, e2)
    det = _dot(e1, pvec)
    not_parallel = jnp.abs(det) > eps
    inv_det = 1.0 / jnp.where(not_parallel, det, 1.0)
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = not_parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return hit, t


def resolve_hit_attributes(scene: SceneArrays, tri_idx, found):
    """(normal, material, is_light) for winning triangle indices.

    Plain direct gathers by default (XLA fuses them into consumers — the
    fastest path measured end-to-end); the packed one-hot matmul variant
    engages only when ops.gather.ONEHOT_ROWS is raised above the scene's
    triangle count (a knob, see gather.py notes)."""
    from pathtracerpython_tpu.ops.gather import (
        ONEHOT_ROWS,
        take_columns_packed,
    )

    if scene.tri_normal.shape[0] > ONEHOT_ROWS:
        return (
            scene.tri_normal[tri_idx],
            scene.tri_material[tri_idx],
            scene.tri_is_light[tri_idx] & found,
        )

    f = scene.tri_normal.dtype
    normal, matf, lightf = take_columns_packed(
        [
            scene.tri_normal,
            scene.tri_material.astype(f)[:, None],
            scene.tri_is_light.astype(f)[:, None],
        ],
        tri_idx,
    )
    material = matf[..., 0].astype(jnp.int32)
    is_light = (lightf[..., 0] > 0.5) & found
    return normal, material, is_light


class NearestHit(NamedTuple):
    """Per-ray nearest-hit record (masked lanes instead of None)."""

    hit: jax.Array       # bool[N] — any triangle hit
    t: jax.Array         # f[N] signed distance along normalized direction
    tri_idx: jax.Array   # i32[N] index into the scene triangle buffer
    point: jax.Array     # f[N, 3]
    normal: jax.Array    # f[N, 3] geometric (winding) normal of hit triangle
    material: jax.Array  # i32[N] material row
    is_light: jax.Array  # bool[N]


def _sweep_tiles(n_tris: int, tile: int, body, init):
    """Scan ``body(carry, tile_start) -> carry`` over triangle tiles."""
    n_tiles = (n_tris + tile - 1) // tile
    starts = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    carry = lax.scan(lambda c, s: (body(c, s), None), init, starts)[0]
    return carry


def nearest_hit(
    origin: jax.Array,
    direction: jax.Array,
    scene: SceneArrays,
    mode: str = "fast",
    tile: int = 128,
    geom_axis: str | None = None,
    geom_axis_size: int = 0,
) -> NearestHit:
    """Closest-hit sweep of [N] rays against the whole padded tri buffer.

    Replaces the reference's ``intersect_objects`` (``main.py:83-122``):
    the light's triangles are part of the buffer (appended last at pack
    time, so equal-distance ties resolve identically to the reference's
    first-minimum ``min``), padding is masked via ``tri_valid``, and the
    ordering key is squared distance in reference mode (backward hits
    count) vs. forward ``t`` in fast mode.
    """
    if geom_axis is not None:
        from pathtracerpython_tpu.parallel.ring import nearest_hit_ring

        return nearest_hit_ring(
            origin, direction, scene, mode, tile,
            axis_name=geom_axis, axis_size=geom_axis_size,
        )

    n = origin.shape[0]
    T = scene.tri_v0.shape[0]
    tile = min(tile, T)
    d_unit = safe_normalize(direction)
    big = jnp.asarray(jnp.finfo(origin.dtype).max, origin.dtype)

    def body(carry, start):
        best_key, best_t, best_idx = carry
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, tile, axis=0)
        v0, v1, v2 = sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2)
        valid = sl(scene.tri_valid)
        o = origin[:, None, :]
        d = d_unit[:, None, :]
        if mode == "reference":
            hit, t = intersect_reference(o, d, v0[None], v1[None], v2[None])
            key = t * t  # reference orders by squared distance (main.py:115)
            # self-hit exclusion: squared distance > ZERO (main.py:100)
            hit = hit & (key > ZERO)
        else:
            hit, t = intersect_moller(o, d, v0[None], v1[None], v2[None])
            key = t
        key = jnp.where(hit & valid[None, :], key, big)
        tile_arg = jnp.argmin(key, axis=1)  # first minimum within tile
        rows = jnp.arange(n)
        tile_key = key[rows, tile_arg]
        tile_t = t[rows, tile_arg]
        better = tile_key < best_key  # strict: earlier tiles win ties
        return (
            jnp.where(better, tile_key, best_key),
            jnp.where(better, tile_t, best_t),
            jnp.where(better, start + tile_arg.astype(jnp.int32), best_idx),
        )

    init = (
        jnp.full((n,), big, origin.dtype),
        jnp.zeros((n,), origin.dtype),
        jnp.zeros((n,), jnp.int32),
    )
    best_key, best_t, best_idx = _sweep_tiles(T, tile, body, init)

    found = best_key < big
    point = origin + d_unit * best_t[:, None]
    normal, material, is_light = resolve_hit_attributes(
        scene, best_idx, found
    )
    return NearestHit(
        hit=found,
        t=best_t,
        tri_idx=best_idx,
        point=point,
        normal=normal,
        material=material,
        is_light=is_light,
    )


def any_hit_within(
    origin: jax.Array,
    direction: jax.Array,
    max_dist: jax.Array,
    scene: SceneArrays,
    mode: str = "fast",
    tile: int = 128,
    geom_axis: str | None = None,
    geom_axis_size: int = 0,
) -> jax.Array:
    """Shadow-occlusion sweep: is any *occluder* triangle strictly between
    the origin and ``max_dist`` along (normalized) ``direction``?

    Replaces the reference's per-sample occlusion scan (``main.py:41-55``):
    only ``scene.objects`` triangles participate (``tri_occluder`` — the
    light's own mesh never occludes), a hit closer than sqrt(ZERO) is the
    point itself and is skipped, and in reference mode backward hits count
    (squared-distance comparison against the squared light distance).

    ``max_dist``: the euclidean origin→light distance, [N].
    Returns occluded bool[N].
    """
    if geom_axis is not None:
        from pathtracerpython_tpu.parallel.ring import any_hit_ring

        return any_hit_ring(
            origin, direction, max_dist, scene, mode, tile,
            axis_name=geom_axis, axis_size=geom_axis_size,
        )

    T = scene.tri_v0.shape[0]
    tile = min(tile, T)
    d_unit = safe_normalize(direction)

    def body(occluded, start):
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, tile, axis=0)
        v0, v1, v2 = sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2)
        occ_mask = sl(scene.tri_occluder)
        o = origin[:, None, :]
        d = d_unit[:, None, :]
        if mode == "reference":
            hit, t = intersect_reference(o, d, v0[None], v1[None], v2[None])
            sq = t * t
            blocking = hit & (sq >= ZERO) & (sq < (max_dist * max_dist)[:, None])
        else:
            hit, t = intersect_moller(o, d, v0[None], v1[None], v2[None])
            blocking = hit & (t < max_dist[:, None] - 1e-4)
        blocking = blocking & occ_mask[None, :]
        return occluded | jnp.any(blocking, axis=1)

    init = jnp.zeros(origin.shape[0], dtype=bool)
    return _sweep_tiles(T, tile, body, init)


IMAX = 2**31 - 1


def normalize3(v3, eps: float = 1e-30):
    """Normalize along axis 0 of a component-major [3, ...] array."""
    sq = jnp.sum(v3 * v3, axis=0, keepdims=True)
    return v3 * lax.rsqrt(jnp.maximum(sq, eps))


class NearestHitCM(NamedTuple):
    """Component-major nearest-hit record: vectors are [3, N], the
    integrator's working layout (see render/integrator.py)."""

    hit: jax.Array       # bool[N]
    t: jax.Array         # f[N]
    tri_idx: jax.Array   # i32[N]
    point3: jax.Array    # f[3, N]
    normal3: jax.Array   # f[3, N]
    material: jax.Array  # i32[N]
    is_light: jax.Array  # bool[N]


def use_sweep_kernel(mode: str, geom_axis: str | None) -> bool:
    """Whether a sweep goes through ``lax.platform_dependent`` to the
    culled Triton kernels on CUDA devices (every other platform lowers the
    XLA sweep of the same call): fast mode without the geometry ring. On
    an H100 the kernels beat the dense XLA sweep on every scene measured,
    from the 32-triangle Cornell box to the 100k-triangle box field, so
    no scene size keeps the XLA sweep there."""
    return mode == "fast" and geom_axis is None


def _nearest_t_idx_kernel(o3, d3, scene, interpret: bool = False):
    from pathtracerpython_tpu.kernels.intersect_triton import (
        nearest_t_idx_cm,
    )

    return nearest_t_idx_cm(o3, normalize3(d3), scene, interpret=interpret)


def _nearest_t_idx_xla(o3, d3, scene, tile):
    hit = nearest_hit(o3.T, d3.T, scene, mode="fast", tile=tile)
    return jnp.where(hit.hit, hit.t, 0.0), jnp.where(hit.hit, hit.tri_idx, -1)


def nearest_hit_cm(
    o3, d3, scene: SceneArrays,
    mode: str = "fast", tile: int = 128,
    geom_axis: str | None = None, geom_axis_size: int = 0,
) -> NearestHitCM:
    """Component-major closest hit (see ``nearest_hit``)."""
    if not use_sweep_kernel(mode, geom_axis):
        hit = nearest_hit(
            o3.T, d3.T, scene, mode=mode, tile=tile,
            geom_axis=geom_axis, geom_axis_size=geom_axis_size,
        )
        return NearestHitCM(
            hit=hit.hit, t=hit.t, tri_idx=hit.tri_idx,
            point3=hit.point.T, normal3=hit.normal.T,
            material=hit.material, is_light=hit.is_light,
        )

    # each branch normalizes the direction once, as ``nearest_hit`` does,
    # so that off CUDA this path matches the row-major sweeps bit for bit
    t, idx = lax.platform_dependent(
        o3, d3, scene,
        cuda=_nearest_t_idx_kernel,
        default=lambda o, d, s: _nearest_t_idx_xla(o, d, s, tile),
    )
    d3u = normalize3(d3)
    found = idx >= 0
    safe_idx = jnp.maximum(idx, 0)
    return NearestHitCM(
        hit=found,
        t=t,
        tri_idx=safe_idx,
        point3=o3 + d3u * t[None, :],
        normal3=scene.tri_normal[safe_idx].T,
        material=scene.tri_material[safe_idx],
        is_light=scene.tri_is_light[safe_idx] & found,
    )


def any_hit_within_cm(
    o3, d3_unit, max_dist, scene: SceneArrays,
    mode: str = "fast", tile: int = 128,
    geom_axis: str | None = None, geom_axis_size: int = 0,
) -> jax.Array:
    """Component-major shadow occlusion; ``d3_unit`` must be normalized."""
    xla = lambda o, d, m, s: any_hit_within(
        o.T, d.T, m, s, mode=mode, tile=tile,
        geom_axis=geom_axis, geom_axis_size=geom_axis_size,
    )
    if not use_sweep_kernel(mode, geom_axis):
        return xla(o3, d3_unit, max_dist, scene)

    from pathtracerpython_tpu.kernels.intersect_triton import any_hit_cm

    return lax.platform_dependent(
        o3, d3_unit, max_dist, scene, cuda=any_hit_cm, default=xla,
    )


def first_occluder_index(
    origin: jax.Array,
    direction: jax.Array,
    max_dist: jax.Array,
    scene: SceneArrays,
    mode: str = "reference",
    tile: int = 128,
    geom_axis: str | None = None,
    geom_axis_size: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """(buffer index, material row) of the FIRST occluder in scan order;
    index is -1 (material 0) when unoccluded.

    Exists to reproduce a reference bug: ``compute_shadow_rays`` reads the
    occlusion scan's leaked loop variable ``obj`` for the direct-light
    color (``main.py:42-71``), so the shaded color depends on which object
    blocked the LAST light sample. "First in scan order" = smallest buffer
    index (pack order preserves the reference's object→triangle iteration
    order, with the light — never scanned — last). The material is
    resolved here because under geometry sharding the caller only holds a
    shard of the material table.
    """
    if geom_axis is not None:
        from pathtracerpython_tpu.parallel.ring import first_occluder_ring

        return first_occluder_ring(
            origin, direction, max_dist, scene, mode, tile,
            axis_name=geom_axis, axis_size=geom_axis_size,
        )

    T = scene.tri_v0.shape[0]
    tile = min(tile, T)
    d_unit = safe_normalize(direction)

    def body(best, start):
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, tile, axis=0)
        v0, v1, v2 = sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2)
        occ_mask = sl(scene.tri_occluder)
        o = origin[:, None, :]
        d = d_unit[:, None, :]
        if mode == "reference":
            hit, t = intersect_reference(o, d, v0[None], v1[None], v2[None])
            sq = t * t
            blocking = hit & (sq >= ZERO) & (sq < (max_dist * max_dist)[:, None])
        else:
            hit, t = intersect_moller(o, d, v0[None], v1[None], v2[None])
            blocking = hit & (t < max_dist[:, None] - 1e-4)
        blocking = blocking & occ_mask[None, :]
        tidx = jnp.arange(tile, dtype=jnp.int32)[None, :] + start
        cand = jnp.where(blocking, tidx, IMAX)
        return jnp.minimum(best, jnp.min(cand, axis=1))

    init = jnp.full(origin.shape[0], IMAX, jnp.int32)
    best = _sweep_tiles(T, tile, body, init)
    found = best != IMAX
    material = scene.tri_material[jnp.where(found, best, 0)]
    return jnp.where(found, best, -1), jnp.where(found, material, 0)
