"""Culled ray-triangle sweeps as Pallas kernels on the Triton route.

The XLA sweeps of ``ops.geometry`` test every ray against every triangle
tile. These kernels do the same Möller–Trumbore arithmetic but skip
whole triangle tiles whose bounding box no ray of the block can reach:

- one program per block of ``R_BLK`` rays. Its rays live in registers as
  ``[R_BLK]`` rows, and the running best ``(t, idx)`` (or the occlusion
  bits) is carried through a loop over triangle tiles inside the program;
- triangles come component-major as ``f32[16, T]`` (v0 | e1 | e2 | valid |
  occluder | pad) with ``T`` a multiple of ``T_TILE``; a tile's box is
  ``f32[8, C]`` (min | max | pad) computed in XLA from the same pack.
  ``scene.arrays.pack_scene(morton_order=True)`` makes the boxes tight;
- a tile whose box misses every ray of the block (or lies beyond every
  ray's current best ``t`` / shadow distance) is skipped; otherwise it is
  tested in sub-tiles of ``T_SUB`` triangles as ``[T_SUB, R_BLK]``
  arrays;
- tie-break: the smallest triangle index among minimal-``t`` hits wins
  inside a sub-tile, and a strict ``<`` keeps the earlier sub-tile, which
  is exactly the XLA sweep's first-minimum rule. Skipping never changes
  the winner: a skipped tile holds no hit closer than the running best;
- backward: ``jax.custom_vjp`` re-solves Möller–Trumbore on each ray's
  winning triangle in plain JAX; the winner index and the occlusion bits
  get no gradient, as on the XLA path.

Fast-mode semantics only (``t > 1e-4``); reference-mode sweeps stay on
the XLA path. Off the GPU the kernels run only when a caller asks for
``interpret=True`` (the tests do).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pathtracerpython_tpu.ops.geometry import intersect_moller

R_BLK = 128     # rays per program (one ray per thread at 4 warps)
T_TILE = 64     # triangles per culled tile
T_SUB = 16      # triangles per [T_SUB, R_BLK] Möller–Trumbore step
NUM_WARPS = 4

BIG = 3.0e38
IMAX = 2**31 - 1
DET_EPS = 1e-7   # ops.geometry.intersect_moller's parallel rejection
T_MIN = 1e-4     # and its forward near-clip
BOX_SLACK = 1e-3


def _pad_to(x, mult, axis, value=0.0):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def pack_triangles(scene) -> tuple[jax.Array, jax.Array]:
    """(tris f32[16, T], boxes f32[8, C]) with T = C * T_TILE."""
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    f = v0.dtype
    valid = scene.tri_valid.astype(f)[:, None]
    occ = scene.tri_occluder.astype(f)[:, None]
    rows = jnp.concatenate(
        [v0, v1 - v0, v2 - v0, valid, occ, jnp.zeros((v0.shape[0], 5), f)],
        axis=1,
    )
    rows = _pad_to(rows, T_TILE, axis=0)
    c = rows.shape[0] // T_TILE
    ok = (rows[:, 9] > 0.5).reshape(c, T_TILE, 1, 1)
    verts = jnp.stack(
        [v0, v1, v2], axis=1
    )  # [T, 3, 3]
    verts = _pad_to(verts, T_TILE, axis=0).reshape(c, T_TILE, 3, 3)
    lo = jnp.min(jnp.where(ok, verts, BIG), axis=(1, 2))
    hi = jnp.max(jnp.where(ok, verts, -BIG), axis=(1, 2))
    boxes = jnp.concatenate([lo, hi, jnp.zeros((c, 2), f)], axis=1)
    return rows.T, boxes.T


def _ray_rows(o3, d3u, extra=None):
    """f32[8, N] ray pack (o | d | extra | pad), N a multiple of R_BLK.
    Padding lanes sit far outside any scene and hit nothing."""
    n = o3.shape[1]
    ext = jnp.zeros((1, n), o3.dtype) if extra is None else extra[None, :]
    rays = jnp.concatenate(
        [o3, d3u, ext, jnp.zeros((1, n), o3.dtype)], axis=0
    )
    pad = (-n) % R_BLK
    if pad:
        fill = jnp.asarray([1e6, 1e6, 1e6, 0.0, 1.0, 0.0, 0.0, 0.0],
                           o3.dtype)[:, None]
        rays = jnp.concatenate(
            [rays, jnp.broadcast_to(fill, (8, pad))], axis=1
        )
    return rays


def _box_reaches(box_ref, j, o, inv_d, t_bound):
    """bool[R]: the ray's slab interval meets tile ``j``'s box before
    ``t_bound`` (with slack); all-invalid tiles have lo > hi."""
    enter = None
    exit_ = None
    for k in range(3):
        lo = (box_ref[k, j] - o[k]) * inv_d[k]
        hi = (box_ref[k + 3, j] - o[k]) * inv_d[k]
        tn = jnp.minimum(lo, hi)
        tf = jnp.maximum(lo, hi)
        enter = tn if enter is None else jnp.maximum(enter, tn)
        exit_ = tf if exit_ is None else jnp.minimum(exit_, tf)
    nonempty = box_ref[0, j] <= box_ref[3, j]
    return (
        (exit_ >= jnp.maximum(enter, 0.0) - BOX_SLACK)
        & (enter <= t_bound + BOX_SLACK)
        & nonempty
    )


def _moller(tri_ref, base, o, d):
    """(hit, t), each [T_SUB, R]: Möller–Trumbore for triangles
    ``base .. base + T_SUB`` in the operation order of
    ``ops.geometry.intersect_moller``. ``hit`` includes the valid mask."""
    col = lambda c: tri_ref[c, pl.ds(base, T_SUB)][:, None]
    ox, oy, oz = (x[None, :] for x in o)
    dx, dy, dz = (x[None, :] for x in d)
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    # pvec = d × e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    not_par = jnp.abs(det) > DET_EPS
    inv_det = 1.0 / jnp.where(not_par, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec × e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        not_par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
        & (col(9) > 0.5)
    )
    return hit, t


def _load_rays(ray_ref):
    o = [ray_ref[k, :] for k in range(3)]
    d = [ray_ref[k + 3, :] for k in range(3)]
    inv_d = [
        1.0 / jnp.where(jnp.abs(x) < 1e-12, jnp.where(x >= 0, 1e-12, -1e-12), x)
        for x in d
    ]
    return o, d, inv_d


def _nearest_kernel(ray_ref, tri_ref, box_ref, t_ref, idx_ref, *, n_tiles):
    o, d, inv_d = _load_rays(ray_ref)
    r = o[0].shape[0]

    def sub_step(base, carry):
        best_t, best_idx = carry
        hit, t = _moller(tri_ref, base, o, d)
        key = jnp.where(hit, t, BIG)
        sub_min = jnp.min(key, axis=0)
        gidx = lax.broadcasted_iota(jnp.int32, key.shape, 0) + base
        cand = jnp.where(hit & (key == sub_min[None, :]), gidx, IMAX)
        sub_idx = jnp.min(cand, axis=0)
        better = sub_min < best_t
        return (
            jnp.where(better, sub_min, best_t),
            jnp.where(better, sub_idx, best_idx),
        )

    def tile_step(j, carry):
        reach = _box_reaches(box_ref, j, o, inv_d, carry[0])
        any_reach = jnp.max(reach.astype(jnp.int32)) > 0

        def sweep(c):
            return lax.fori_loop(
                0, T_TILE // T_SUB,
                lambda s, cc: sub_step(j * T_TILE + s * T_SUB, cc), c,
            )

        return lax.cond(any_reach, sweep, lambda c: c, carry)

    init = (jnp.full((r,), BIG, jnp.float32), jnp.full((r,), -1, jnp.int32))
    best_t, best_idx = lax.fori_loop(0, n_tiles, tile_step, init)
    t_ref[...] = best_t
    idx_ref[...] = best_idx


def _any_hit_kernel(ray_ref, tri_ref, box_ref, occ_ref, *, n_tiles):
    o, d, inv_d = _load_rays(ray_ref)
    max_d = ray_ref[6, :]
    r = max_d.shape[0]

    def sub_step(base, occ):
        hit, t = _moller(tri_ref, base, o, d)
        occluder = tri_ref[10, pl.ds(base, T_SUB)][:, None] > 0.5
        blocking = hit & occluder & (t < max_d[None, :] - T_MIN)
        return jnp.maximum(occ, jnp.max(blocking.astype(jnp.int32), axis=0))

    def cond(carry):
        j, occ = carry
        return (j < n_tiles) & (jnp.min(occ) == 0)

    def body(carry):
        j, occ = carry
        reach = _box_reaches(box_ref, j, o, inv_d, max_d) & (occ == 0)
        any_reach = jnp.max(reach.astype(jnp.int32)) > 0

        def sweep(c):
            return lax.fori_loop(
                0, T_TILE // T_SUB,
                lambda s, cc: sub_step(j * T_TILE + s * T_SUB, cc), c,
            )

        return j + 1, lax.cond(any_reach, sweep, lambda c: c, occ)

    _, occ = lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((r,), jnp.int32))
    )
    occ_ref[...] = occ


def _call(kernel, rays, tris, boxes, out_shape, interpret):
    n = rays.shape[1]
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    return pl.pallas_call(
        functools.partial(kernel, n_tiles=boxes.shape[1]),
        grid=(n // R_BLK,),
        in_specs=[
            pl.BlockSpec((8, R_BLK), lambda i: (0, i)),
            full(tris),
            full(boxes),
        ],
        out_specs=[pl.BlockSpec((R_BLK,), lambda i: (i,))] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(rays, tris, boxes)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _nearest(o3, d3u, tri_cols, interpret):
    tris, boxes = tri_cols
    n = o3.shape[1]
    t, idx = _call(
        _nearest_kernel, _ray_rows(o3, d3u), tris, boxes,
        [
            jax.ShapeDtypeStruct(((n + R_BLK - 1) // R_BLK * R_BLK,),
                                 jnp.float32),
            jax.ShapeDtypeStruct(((n + R_BLK - 1) // R_BLK * R_BLK,),
                                 jnp.int32),
        ],
        interpret,
    )
    t, idx = t[:n], idx[:n]
    return jnp.where(idx >= 0, t, 0.0), idx


def _nearest_fwd(o3, d3u, tri_cols, interpret):
    t, idx = _nearest(o3, d3u, tri_cols, interpret)
    return (t, idx), (o3, d3u, tri_cols, idx)


def _nearest_bwd(interpret, res, cots):
    """dt flows through a per-ray re-solve of Möller–Trumbore on the
    winning triangle; the discrete index gets no gradient."""
    o3, d3u, tri_cols, idx = res
    dt = jnp.where(idx >= 0, cots[0], 0.0)
    safe = jnp.maximum(idx, 0)

    def t_of(o3_, d3_, cols):
        tris, _ = cols
        w = tris[:9, safe]  # [9, N]: v0 | e1 | e2 of each winner
        v0 = w[0:3].T
        _, t = intersect_moller(o3_.T, d3_.T, v0, v0 + w[3:6].T,
                                v0 + w[6:9].T)
        return t

    _, vjp = jax.vjp(t_of, o3, d3u, tri_cols)
    return vjp(dt)


_nearest.defvjp(_nearest_fwd, _nearest_bwd)


def nearest_t_idx_cm(o3, d3_unit, scene, interpret: bool = False):
    """Closest forward hit per ray: o3/d3_unit f32[3, N] (d3 normalized).
    Returns (t [N], 0 on miss; idx [N] into the scene buffer, -1 on miss)."""
    return _nearest(o3, d3_unit, pack_triangles(scene), interpret)


def any_hit_cm(o3, d3_unit, max_dist, scene, interpret: bool = False):
    """bool[M]: an occluder triangle lies strictly between each origin and
    ``max_dist`` along ``d3_unit``. Occlusion is detached from autodiff."""
    sg = lax.stop_gradient
    m = o3.shape[1]
    tris, boxes = pack_triangles(jax.tree.map(sg, scene))
    occ = _call(
        _any_hit_kernel, _ray_rows(sg(o3), sg(d3_unit), sg(max_dist)),
        tris, boxes,
        [jax.ShapeDtypeStruct(((m + R_BLK - 1) // R_BLK * R_BLK,),
                              jnp.int32)],
        interpret,
    )[0]
    return occ[:m] > 0
