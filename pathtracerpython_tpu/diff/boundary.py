"""Boundary-aware (soft) visibility: differentiable silhouettes & shadows.

The hard estimator's visibility terms are step functions of scene
geometry: the nearest-hit winner and the binary shadow occlusion both
detach (``stop_gradient`` discipline), so translating an opaque object
yields zero interior gradient (round-1 VERDICT item 2; the reference has
no gradients at all — its occlusion scan is ``main.py:41-55``).

This module provides the smooth-estimator counterpart used when
``RenderConfig.soft_vis_beta > 0``:

- every triangle is given a *coverage* profile
  ``sigmoid(edge_margin / beta)`` where ``edge_margin`` is the SIGNED
  world-space distance from the ray's in-plane intersection point to the
  nearest triangle edge (positive inside, negative outside). At
  ``beta → 0`` this converges to the hard indicator;
- **shadows**: occlusion = ``min(1, Σ coverages)`` over occluder
  triangles in the shadow window. Summing (not maxing) makes interior
  mesh edges exact — two triangles sharing an edge sum to full coverage
  where a max would leak light;
- **silhouettes**: the front-most *extended* hit F (accepting margins
  down to ``-BAND_SIGMAS·beta``) is blended over the first true hit
  behind it: ``color = cov_F · shade(F) + (1 - cov_F) · shade(behind)``.
  When F is a real hit (margin ≥ 0) "behind" is the second hit; when F
  is a near-miss in front of the winner, "behind" is the winner — the
  two cases meet continuously at cov = 0.5 on the edge, so the radiance
  is a continuous, a.e.-differentiable function of vertex positions and
  central finite differences validate the autodiff gradient
  (tests/test_boundary.py).

Everything here is plain XLA (jnp + lax.scan tile sweeps over the whole
triangle buffer, O(N·T)): gradients flow through the whole sweep, not a
custom VJP — this is the *fit* path; the hard sweeps remain the
production render path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pathtracerpython_tpu.ops.geometry import safe_normalize
from pathtracerpython_tpu.scene.arrays import SceneArrays

BAND_SIGMAS = 6.0   # extended-hit acceptance: margin > -BAND_SIGMAS * beta
T_MIN = 1e-4
BIG = 3.0e38
IMAX = 2**31 - 1

# A NEAR-MISS (margin < 0) must lead the nearest true hit by this
# relative t-margin to become the blended front record F. Without it,
# COPLANAR CONTACT geometry (e.g. a box standing on the floor: its
# bottom face lies exactly in the floor plane) makes F a coin flip
# between the true hit and the coplanar near-miss at ulp-identical t: the
# whole band-width ring around the contact could flip between
# floor-white and cube-red across eager-vs-jit fusion and between
# platforms' transcendentals, which made pose fits platform-dependent.
# With the bias, coplanar competitors stably lose (their blend
# contribution was unphysical — a face buried in another surface is not
# a silhouette), while genuine
# front silhouettes lead by far more than eps and are unaffected.
F_TIE_EPS = 1e-4


def _f_key(t, margin):
    """Extended-front ordering key: true hits order by t; near-misses
    pay the coplanar-tie bias."""
    return jnp.where(margin < 0.0, t + F_TIE_EPS * (1.0 + jnp.abs(t)), t)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def plane_hit_and_margin(origin, d_unit, v0, v1, v2, eps: float = 1e-7):
    """Möller–Trumbore plane solve + signed edge margin.

    Args broadcast ([..., 3]). Returns (ok, t, margin): ``ok`` only
    excludes near-parallel rays; ``margin`` is the world-space signed
    distance from the ray-plane intersection point to the nearest edge
    (positive strictly inside the triangle). All outputs are smooth in
    the vertices wherever the ray is not parallel to the plane.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d_unit, e2)
    det = _dot(e1, pvec)
    ok = jnp.abs(det) > eps
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = _dot(d_unit, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det

    # barycentric λ = (1-u-v, u, v) belong to (v0, v1, v2); the distance
    # from an interior point to the edge opposite vertex i is λ_i · h_i
    # with h_i = 2·area / |edge_i|
    cross = jnp.cross(e1, e2)
    two_area = jnp.sqrt(jnp.sum(cross * cross, axis=-1) + 1e-30)

    def h(edge):
        return two_area / jnp.sqrt(jnp.sum(edge * edge, axis=-1) + 1e-30)

    m0 = (1.0 - u - v) * h(v2 - v1)
    m1 = u * h(v0 - v2)
    m2 = v * h(v1 - v0)
    margin = jnp.minimum(jnp.minimum(m0, m1), m2)
    return ok, t, margin


class SoftHits(NamedTuple):
    """Per-ray records for the silhouette blend (row-major, [N] fields)."""

    f_t: jax.Array        # front extended hit (margin > -band)
    f_idx: jax.Array
    f_margin: jax.Array   # differentiable signed edge distance of F
    h1_t: jax.Array       # first true hit
    h1_idx: jax.Array
    h2_t: jax.Array       # second true hit (distinct triangle)
    h2_idx: jax.Array


def _sweep(n_tris, tile, body, init):
    starts = jnp.arange((n_tris + tile - 1) // tile, dtype=jnp.int32) * tile
    # checkpoint: the scan's backward otherwise stacks every tile's
    # [n_rays, tile(, 3)] plane-solve intermediates — at 128^2/5k tris
    # that is tens of GB; rematerializing bounds residuals to one tile
    return lax.scan(
        jax.checkpoint(lambda c, s: (body(c, s), None)), init, starts
    )[0]


def soft_hits_sweep(
    origin, direction, scene: SceneArrays, beta: float, tile: int = 128,
) -> SoftHits:
    """One pass over the triangle buffer collecting F / hit1 / hit2.

    True hits use the hard acceptance (margin >= 0); F additionally
    accepts near-misses down to ``-BAND_SIGMAS·beta``. Winners follow the
    dense sweeps' (t, index) lexicographic rule.
    """
    n = origin.shape[0]
    T = scene.tri_v0.shape[0]
    tile = min(tile, T)
    d_unit = safe_normalize(direction)
    band = BAND_SIGMAS * float(beta)

    def pick_first(ak, at, aidx, am, bk, bt, bidx, bm):
        """Lexicographic (key, idx) minimum of two (key, t, idx, margin)
        records — ordered by the biased key, reporting the true t."""
        better = (bk < ak) | ((bk == ak) & (bidx < aidx))
        return (
            jnp.where(better, bk, ak),
            jnp.where(better, bt, at),
            jnp.where(better, bidx, aidx),
            jnp.where(better, bm, am),
        )

    def body(carry, start):
        fk, ft, fidx, fm, h1t, h1idx, h2t, h2idx = carry
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, tile, axis=0)
        v0, v1, v2 = sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2)
        valid = sl(scene.tri_valid)
        o = origin[:, None, :]
        d = d_unit[:, None, :]
        ok, t, margin = plane_hit_and_margin(
            o, d, v0[None], v1[None], v2[None]
        )
        base = ok & valid[None, :] & (t > T_MIN)
        tidx = jnp.arange(tile, dtype=jnp.int32)[None, :] + start

        def tile_two_min(accept):
            key = jnp.where(accept, t, BIG)
            a1 = jnp.argmin(key, axis=1)
            rows = jnp.arange(n)
            k1 = key[rows, a1]
            key2 = key.at[rows, a1].set(BIG)
            a2 = jnp.argmin(key2, axis=1)
            k2 = key2[rows, a2]
            i1 = jnp.where(k1 < BIG, tidx[0][a1], IMAX)
            i2 = jnp.where(k2 < BIG, tidx[0][a2], IMAX)
            return (k1, i1, a1), (k2, i2)

        # true hits: two smallest t this tile, merged into (h1, h2)
        (k1, i1, _), (k2, i2) = tile_two_min(base & (margin >= 0.0))
        # merge ordered pairs: winner, then min of the losers
        first_is_old = (h1t < k1) | ((h1t == k1) & (h1idx < i1))
        n1t = jnp.where(first_is_old, h1t, k1)
        n1i = jnp.where(first_is_old, h1idx, i1)
        lt = jnp.where(first_is_old, k1, h1t)
        li = jnp.where(first_is_old, i1, h1idx)
        second_is_l = (lt < h2t) | ((lt == h2t) & (li < h2idx))
        s2t = jnp.where(second_is_l, lt, h2t)
        s2i = jnp.where(second_is_l, li, h2idx)
        better2 = (k2 < s2t) | ((k2 == s2t) & (i2 < s2i))
        n2t = jnp.where(better2, k2, s2t)
        n2i = jnp.where(better2, i2, s2i)

        # extended front hit: min biased key among margin > -band (true
        # hits at t, near-misses at t + eps — the coplanar-tie bias)
        ext = base & (margin > -band)
        keyf = jnp.where(ext, _f_key(t, margin), BIG)
        af = jnp.argmin(keyf, axis=1)
        rows = jnp.arange(n)
        kf = keyf[rows, af]
        tf_true = t[rows, af]
        imf = margin[rows, af]
        idf = jnp.where(kf < BIG, tidx[0][af], IMAX)
        nfk, nft, nfidx, nfm = pick_first(
            fk, ft, fidx, fm, kf, tf_true, idf, imf
        )
        nft = jnp.where(nfidx != IMAX, nft, BIG)

        return (nfk, nft, nfidx, nfm, n1t, n1i, n2t, n2i)

    big = jnp.full((n,), BIG, origin.dtype)
    imax = jnp.full((n,), IMAX, jnp.int32)
    zero = jnp.zeros((n,), origin.dtype)
    _, ft, fidx, fm, h1t, h1idx, h2t, h2idx = _sweep(
        T, tile, body, (big, big, imax, zero, big, imax, big, imax)
    )
    return SoftHits(ft, fidx, fm, h1t, h1idx, h2t, h2idx)


def soft_visibility(
    origin, direction, max_dist, scene: SceneArrays, beta: float,
    tile: int = 128,
) -> jax.Array:
    """Smooth shadow visibility in [0, 1]: ``1 - min(1, Σ coverage)``
    over occluder triangles strictly inside the shadow window.

    Replaces the binary ``any_hit_within`` for the soft estimator; fully
    differentiable w.r.t. occluder vertices through the edge margins.
    """
    n = origin.shape[0]
    T = scene.tri_v0.shape[0]
    tile = min(tile, T)
    d_unit = safe_normalize(direction)

    def body(cov_sum, start):
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, tile, axis=0)
        v0, v1, v2 = sl(scene.tri_v0), sl(scene.tri_v1), sl(scene.tri_v2)
        occ = sl(scene.tri_occluder)
        o = origin[:, None, :]
        d = d_unit[:, None, :]
        ok, t, margin = plane_hit_and_margin(
            o, d, v0[None], v1[None], v2[None]
        )
        window = ok & occ[None, :] & (t > T_MIN) & (
            t < max_dist[:, None] - T_MIN
        )
        cov = jnp.where(window, jax.nn.sigmoid(margin / beta), 0.0)
        return cov_sum + jnp.sum(cov, axis=1)

    cov = _sweep(T, tile, body, jnp.zeros((n,), origin.dtype))
    return 1.0 - jnp.minimum(cov, 1.0)
