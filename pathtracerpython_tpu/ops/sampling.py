"""Monte-Carlo sampling primitives (light picking, hemispheres, frames).

Counter-based (threefry) and batched: every function takes explicit PRNG
keys, so streams are reproducible and shard-invariant — the integrator
derives one key per (pixel, sample) and folds in (bounce, purpose), meaning
an N-chip render draws exactly the numbers a 1-chip render does.

Reference-mode functions mirror the reference's estimator quirks on purpose
(SURVEY.md §2.4); ``*_fixed`` variants are the numerically sane defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracerpython_tpu.ops.geometry import safe_normalize

# The reference truncates 2π to 6.28 (main.py:19) — azimuths never cover the
# last ~3.2 mrad. Reproduced in reference mode only.
TAU_REFERENCE = 6.28
TAU = 2.0 * jnp.pi


def pick_light_triangle(u: jax.Array, areas: jax.Array) -> jax.Array:
    """Area-proportional triangle pick via CDF inversion.

    Equivalent to the reference's linear CDF scan (``utils.py:28-39``):
    index i such that cum[i-1] <= u * total < cum[i].
    ``u``: uniforms in [0, 1), any shape. Returns int32 indices.

    Small light meshes use an unrolled compare-and-count (L-1 vectorized
    compares, fused into the consumer) — ``jnp.searchsorted`` lowers to a
    per-element loop of gathers, which only pays off for large lights.
    """
    cum = jnp.cumsum(areas)
    total = cum[-1]
    x = u * total
    n = areas.shape[0]
    if n <= 64:
        idx = jnp.zeros(u.shape, jnp.int32)
        for i in range(n - 1):
            idx = idx + (x >= cum[i]).astype(jnp.int32)
        return idx
    idx = jnp.searchsorted(cum, x, side="right")
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)


def sample_barycentric_reference(u3: jax.Array) -> jax.Array:
    """Reference barycentric sampling: three uniforms normalized to sum 1
    (``utils.py:21-25``) — NOT uniform over the triangle (center-biased).

    ``u3``: [..., 3] uniforms. Returns [..., 3] barycentrics.
    """
    return u3 / jnp.sum(u3, axis=-1, keepdims=True)


def sample_barycentric_uniform(u2: jax.Array) -> jax.Array:
    """Uniform triangle sampling via the sqrt trick. ``u2``: [..., 2]."""
    su = jnp.sqrt(u2[..., 0])
    a = 1.0 - su
    b = su * (1.0 - u2[..., 1])
    c = su * u2[..., 1]
    return jnp.stack([a, b, c], axis=-1)


def point_from_barycentric(bary, v0, v1, v2):
    """[..., 3] point = a*v0 + b*v1 + c*v2."""
    return (
        bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2
    )


def rotation_about_y(angle: jax.Array) -> jax.Array:
    """The reference's quaternion-derived rotation matrix (``main.py:148-162``)
    specialized to axis (0, 1, 0): axis components b = d = 0, c = -sin(θ/2).

    Returns [..., 3, 3] acting on column vectors (R @ v).
    """
    a = jnp.cos(angle / 2.0)
    c = -jnp.sin(angle / 2.0)
    aa, cc, ac = a * a, c * c, a * c
    zero = jnp.zeros_like(a)
    row0 = jnp.stack([aa - cc, zero, -2 * ac], axis=-1)
    row1 = jnp.stack([zero, aa + cc, zero], axis=-1)
    row2 = jnp.stack([2 * ac, zero, aa - cc], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate_frame_reference(v: jax.Array, normal: jax.Array) -> jax.Array:
    """The reference's (buggy) tangent-frame alignment: rotate ``v`` about the
    FIXED y-axis by arccos(normal_y) (``main.py:248-249, 260-261``). Only
    y-facing surfaces get a correct frame — reproduced for parity.
    """
    angle = jnp.arccos(jnp.clip(normal[..., 1], -1.0, 1.0))
    rot = rotation_about_y(angle)
    # HIGHEST precision: a default-precision f32 product may run in a
    # reduced format (TF32 on the GPU), which would round the frame (the
    # parity path must be f32-exact like the reference)
    return jnp.einsum("...ij,...j->...i", rot, v,
                      precision=jax.lax.Precision.HIGHEST)


def cosine_hemisphere_reference(u2: jax.Array) -> jax.Array:
    """The reference's canonical-frame cosine sample (``main.py:242-246``):
    phi = arccos(sqrt(u1)), theta = TAU_REFERENCE * u2, direction
    (sinφ cosθ, sinφ sinθ, cosφ) — cosine-weighted about +z.
    ``u2``: [..., 2] uniforms → [..., 3] unit vectors.
    """
    phi = jnp.arccos(jnp.sqrt(u2[..., 0]))
    theta = TAU_REFERENCE * u2[..., 1]
    sp = jnp.sin(phi)
    return jnp.stack(
        [sp * jnp.cos(theta), sp * jnp.sin(theta), jnp.cos(phi)], axis=-1
    )


def build_onb(normal: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless orthonormal basis around ``normal`` (Duff et al. 2017).

    Returns (tangent, bitangent), each shaped like ``normal``.
    """
    n = normal
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


def cosine_hemisphere_fixed(u2: jax.Array, normal: jax.Array) -> jax.Array:
    """Correct cosine-weighted hemisphere sample about ``normal``."""
    r = jnp.sqrt(u2[..., 0])
    theta = TAU * u2[..., 1]
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u2[..., 0]))
    t, bt = build_onb(normal)
    return safe_normalize(
        x[..., None] * t + y[..., None] * bt + z[..., None] * normal
    )


def reflect(direction: jax.Array, normal: jax.Array) -> jax.Array:
    """Mirror reflection of an *incoming* direction (d points toward the
    surface): r = d - 2 dot(d, n) n. The sane version — the reference's
    specular branch instead reflects the raw stored direction without
    negation (``main.py:254-256``), see the integrator's reference path.
    """
    return direction - 2.0 * jnp.sum(direction * normal, axis=-1, keepdims=True) * normal


# ---------------------------------------------------------------------------
# Component-major (axis-0 xyz) variants — the integrator's working layout.
# Same math as the row-major functions above; [3, ...] instead of [..., 3]
# keeps each component a dense row.
# ---------------------------------------------------------------------------


def cm_normalize(v3, eps: float = 1e-30):
    sq = jnp.sum(v3 * v3, axis=0, keepdims=True)
    return v3 * jax.lax.rsqrt(jnp.maximum(sq, eps))


def cm_dot(a3, b3):
    return jnp.sum(a3 * b3, axis=0)


def cm_cross(a3, b3):
    return jnp.stack([
        a3[1] * b3[2] - a3[2] * b3[1],
        a3[2] * b3[0] - a3[0] * b3[2],
        a3[0] * b3[1] - a3[1] * b3[0],
    ])


def cm_sample_barycentric_reference(u3):
    """u3 [3, ...] → barycentrics [3, ...] (reference: normalized uniforms)."""
    return u3 / jnp.sum(u3, axis=0, keepdims=True)


def cm_sample_barycentric_uniform(u2):
    """u2 [2, ...] → [3, ...] uniform over the triangle (sqrt trick)."""
    su = jnp.sqrt(u2[0])
    return jnp.stack([1.0 - su, su * (1.0 - u2[1]), su * u2[1]])


def cm_point_from_barycentric(bary, v0, v1, v2):
    """All [3, ...]: bary-weighted combination."""
    return bary[0][None] * v0 + bary[1][None] * v1 + bary[2][None] * v2


def cm_cosine_hemisphere_reference(u2):
    """Reference canonical cosine sample (main.py:242-246): [3, ...]."""
    phi = jnp.arccos(jnp.sqrt(u2[0]))
    theta = TAU_REFERENCE * u2[1]
    sp = jnp.sin(phi)
    return jnp.stack([sp * jnp.cos(theta), sp * jnp.sin(theta), jnp.cos(phi)])


def cm_rotate_frame_reference(v3, n3):
    """Reference y-axis frame rotation (main.py:248-261), component-major."""
    angle = jnp.arccos(jnp.clip(n3[1], -1.0, 1.0))
    a = jnp.cos(angle / 2.0)
    c = -jnp.sin(angle / 2.0)
    aa_cc = a * a - c * c
    two_ac = 2.0 * a * c
    # R @ v for axis (0,1,0): rows [aa-cc, 0, -2ac], [0, 1, 0], [2ac, 0, aa-cc]
    return jnp.stack([
        aa_cc * v3[0] - two_ac * v3[2],
        v3[1],
        two_ac * v3[0] + aa_cc * v3[2],
    ])


def cm_build_onb(n3):
    """Branchless ONB (Duff et al. 2017), component-major."""
    sign = jnp.where(n3[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n3[2])
    b = n3[0] * n3[1] * a
    t3 = jnp.stack([1.0 + sign * n3[0] ** 2 * a, sign * b, -sign * n3[0]])
    b3 = jnp.stack([b, sign + n3[1] ** 2 * a, -n3[1]])
    return t3, b3


def cm_cosine_hemisphere_fixed(u2, n3):
    """Cosine-weighted hemisphere about n3; u2 [2, ...], n3 [3, ...]."""
    r = jnp.sqrt(u2[0])
    theta = TAU * u2[1]
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u2[0]))
    t3, b3 = cm_build_onb(n3)
    return cm_normalize(x[None] * t3 + y[None] * b3 + z[None] * n3)


def cm_reflect(d3, n3):
    """Mirror reflection of an incoming direction, component-major."""
    return d3 - 2.0 * cm_dot(d3, n3)[None] * n3
