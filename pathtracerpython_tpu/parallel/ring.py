"""Geometry-ring intersection: triangles sharded over a mesh axis, streamed
around a ring with ``lax.ppermute``.

For scenes whose triangle buffers exceed one device's memory, replicating
geometry is impossible. The answer here is the ring-attention pattern with
triangles as the
streamed context: every device keeps its rays and running best-hit state
resident, intersects them against the triangle shard it currently holds,
then rotates the shard to its ring neighbour. ``axis_size - 1`` rotations
run (the last sweep needs no further ppermute), so after the loop each ray
has seen every triangle exactly once; the rotated scene binding is
function-local and ends one rotation short of home — nothing reuses it.

The reference has no analogue — its nearest-hit scan is a per-ray Python
loop over all triangles (``main.py:94-109``); this module is that scan's
scale-out form. Compute on each step is the same tiled sweep the replicated
path uses (``ops.geometry``), so XLA overlaps the ppermute DMA of step i+1's
shard with step i's intersection math.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax

from pathtracerpython_tpu.scene.arrays import SceneArrays, TRI_FIELDS


def _rotate_tri_shard(scene: SceneArrays, axis_name: str, n: int) -> SceneArrays:
    """ppermute every per-triangle buffer one step around the ring."""
    perm = [(j, (j + 1) % n) for j in range(n)]
    rotated = {
        f: lax.ppermute(getattr(scene, f), axis_name, perm) for f in TRI_FIELDS
    }
    return dataclasses.replace(scene, **rotated)


def _hit_key(hit, mode: str, big):
    """The nearest-hit ordering key: squared distance in reference mode
    (backward hits count, ``main.py:100,115``), forward t in fast mode."""
    key = hit.t * hit.t if mode == "reference" else hit.t
    return jnp.where(hit.hit, key, big)


def nearest_hit_ring(
    origin: jax.Array,
    direction: jax.Array,
    scene: SceneArrays,
    mode: str,
    tile: int,
    axis_name: str,
    axis_size: int,
):
    """Ring nearest-hit: must run inside ``shard_map`` with the scene's
    TRI_FIELDS sharded along ``axis_name`` (rays shard-local).

    Returns a ``NearestHit`` whose ``tri_idx`` is GLOBAL (shard offset
    applied), with normals/materials resolved during the step that held the
    winning shard — no post-hoc cross-device gather needed.
    """
    from pathtracerpython_tpu.ops.geometry import NearestHit, nearest_hit

    n = axis_size
    me = lax.axis_index(axis_name)
    shard_t = scene.tri_v0.shape[0]
    big = jnp.asarray(jnp.finfo(origin.dtype).max, origin.dtype)
    nrays = origin.shape[0]

    best = NearestHit(
        hit=jnp.zeros(nrays, bool),
        t=jnp.zeros(nrays, origin.dtype),
        tri_idx=jnp.zeros(nrays, jnp.int32),
        point=jnp.zeros((nrays, 3), origin.dtype),
        normal=jnp.zeros((nrays, 3), origin.dtype),
        material=jnp.zeros(nrays, jnp.int32),
        is_light=jnp.zeros(nrays, bool),
    )
    best_key = jnp.full((nrays,), big, origin.dtype)

    for step in range(n):
        local = nearest_hit(origin, direction, scene, mode=mode, tile=tile)
        # device `me` holds, at this step, the shard born on device me-step
        owner = jnp.mod(me - step, n)
        global_idx = local.tri_idx + owner.astype(jnp.int32) * shard_t
        key = _hit_key(local, mode, big)
        # tie-break exact-equal keys to the LOWEST global buffer index —
        # the replicated sweep's (and the reference's first-minimum)
        # semantics; ring visit order must not leak into results. Exact
        # ties are real: linspace primary rays hit shared edges of
        # coplanar wall triangles with bit-identical t.
        better = (key < best_key) | (
            (key == best_key) & local.hit & (global_idx < best.tri_idx)
        )
        best_key = jnp.where(better, key, best_key)
        bsel = lambda a, b: jnp.where(
            better[(...,) + (None,) * (a.ndim - 1)], a, b
        )
        best = NearestHit(
            hit=best.hit | (better & local.hit),
            t=bsel(local.t, best.t),
            tri_idx=bsel(global_idx, best.tri_idx),
            point=bsel(local.point, best.point),
            normal=bsel(local.normal, best.normal),
            material=bsel(local.material, best.material),
            is_light=bsel(local.is_light, best.is_light),
        )
        if step + 1 < n:
            scene = _rotate_tri_shard(scene, axis_name, n)
    return best


def any_hit_ring(
    origin: jax.Array,
    direction: jax.Array,
    max_dist: jax.Array,
    scene: SceneArrays,
    mode: str,
    tile: int,
    axis_name: str,
    axis_size: int,
) -> jax.Array:
    """Ring shadow-occlusion: OR of the per-shard any-hit sweeps.

    Same contract as ``ops.geometry.any_hit_within`` (occluder set only —
    the light's own mesh never blocks, ``main.py:42``), distributed over the
    geometry ring.
    """
    from pathtracerpython_tpu.ops.geometry import any_hit_within

    occluded = jnp.zeros(origin.shape[0], bool)
    for step in range(axis_size):
        occluded = occluded | any_hit_within(
            origin, direction, max_dist, scene,
            mode=mode, tile=tile,
        )
        if step + 1 < axis_size:
            scene = _rotate_tri_shard(scene, axis_name, axis_size)
    return occluded


def first_occluder_ring(
    origin, direction, max_dist, scene, mode, tile, axis_name, axis_size
):
    """Ring form of ``ops.geometry.first_occluder_index``: (global buffer
    index, material) of the min-index blocking triangle across shards, or
    (-1, 0). Material is resolved in the step that held the shard."""
    from pathtracerpython_tpu.ops.geometry import IMAX, first_occluder_index

    n = axis_size
    me = lax.axis_index(axis_name)
    shard_t = scene.tri_v0.shape[0]
    best = jnp.full(origin.shape[0], IMAX, jnp.int32)
    best_mat = jnp.zeros(origin.shape[0], jnp.int32)
    for step in range(n):
        local, local_mat = first_occluder_index(
            origin, direction, max_dist, scene, mode=mode, tile=tile
        )
        owner = jnp.mod(me - step, n).astype(jnp.int32)
        glob = jnp.where(local >= 0, local + owner * shard_t, IMAX)
        better = glob < best
        best = jnp.where(better, glob, best)
        best_mat = jnp.where(better, local_mat, best_mat)
        if step + 1 < n:
            scene = _rotate_tri_shard(scene, axis_name, n)
    found = best != IMAX
    return (
        jnp.where(found, best, -1),
        jnp.where(found, best_mat, 0),
    )
