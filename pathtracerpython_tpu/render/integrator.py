"""The wavefront path-tracing integrator (component-major layout).

Replaces the reference's driver loop (``main.py:165-293``) — two
``multiprocessing.Pool`` fan-outs per bounce plus a sequential Python
scatter phase — with a single jitted program over a flat ray SoA:

    for each sample:                      (lax.scan, or extra lanes)
        state = primary rays              (ops.camera)
        for each bounce:                  (lax.scan over bounce index)
            hit   = nearest_hit_cm        (XLA sweep / culled Triton kernel)
            color = shade(hit)            (ambient + NEE; light on hit)
            state = scatter(hit, state)   (diffuse/specular branch, masked)

Layout:

- every per-ray vector is **component-major** f32[3, N] — xyz on the
  leading axis, rays on the minor axis, so each component is a dense row.
  This is also the layout the Triton intersection kernels consume.
- RNG is a dense counter-based Threefry (ops/rng.py): one scalar key pair
  per (bounce, purpose), hashed against the GLOBAL path counter
  ``pixel_id * n_samples + sample`` per lane — reproducible,
  shard-invariant, and no [N, 2] key arrays.

Dead rays are masked lanes (``alive``), not ``None`` entries; the per-ray
scalar throughput (the reference's ``accumulated_k``, ``main.py:190``) and
the radiance accumulator ride in the state. Estimator semantics per mode
are documented in ``RenderConfig``; the ``reference`` path mirrors
``main.py:142-145`` (ambient + NEE with the leaked-loop-variable color
quirk, SURVEY.md §2.4-9), ``:214-215`` (light hits pay light_color), and
``:233-268`` (branch by ``uniform(0, kd+ks)``, y-axis tangent frames,
raw-direction specular reflection, Phong-toward-eye weight).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pathtracerpython_tpu.ops import rng, sampling
from pathtracerpython_tpu.ops.camera import make_primary_rays
from pathtracerpython_tpu.ops.geometry import (
    NearestHitCM,
    any_hit_within_cm,
    nearest_hit_cm,
    normalize3,
)
from pathtracerpython_tpu.ops.sampling import (
    cm_cosine_hemisphere_fixed,
    cm_cosine_hemisphere_reference,
    cm_dot,
    cm_point_from_barycentric,
    cm_reflect,
    cm_rotate_frame_reference,
    cm_sample_barycentric_reference,
    cm_sample_barycentric_uniform,
)
from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.scene.arrays import SceneArrays

# purpose salts for per-bounce key derivation
_P_NEE = 0
_P_SCATTER = 1


class RayState(NamedTuple):
    """Per-ray wavefront state; vectors are component-major [3, N]."""

    origin3: jax.Array      # f32[3, N]
    direction3: jax.Array   # f32[3, N] raw dir (primaries unnormalized,
    #                         like the reference's make_rays — the specular
    #                         branch consumes it raw, main.py:254-256)
    throughput: jax.Array   # f32[N] — the reference's accumulated_k
    alive: jax.Array        # bool[N]
    radiance3: jax.Array    # f32[3, N] accumulated pixel color
    counters: jax.Array     # u32[N] global path id = pixel_id * spp + sample
    prev_specular: jax.Array  # bool[N] (fast-mode emission rule)


class Materials(NamedTuple):
    """Per-ray material properties (resolved once per bounce)."""

    rgb3: jax.Array  # f[3, N]
    ka: jax.Array    # f[N]
    kd: jax.Array    # f[N]
    ks: jax.Array    # f[N]
    n: jax.Array     # f[N]


def resolve_materials(scene: SceneArrays, material) -> Materials:
    from pathtracerpython_tpu.ops.gather import cm_take

    rgb3 = cm_take(scene.mat_rgb.T, material)
    scalars = cm_take(
        jnp.stack([scene.mat_ka, scene.mat_kd, scene.mat_ks, scene.mat_n]),
        material,
    )
    return Materials(
        rgb3=rgb3,
        ka=scalars[0], kd=scalars[1], ks=scalars[2], n=scalars[3],
    )


def _power_numpy_semantics(base, exponent):
    """x ** p with numpy float semantics: negative base with an integral
    exponent keeps the sign parity; negative base with a fractional
    exponent is NaN. The reference raises a possibly-negative Phong cosine
    to a float power (``main.py:263-264``)."""
    r = jnp.round(exponent)
    is_int = r == exponent
    odd = jnp.mod(r, 2.0) == 1.0
    mag = jnp.power(jnp.abs(base), exponent)
    neg_case = jnp.where(is_int, jnp.where(odd, -mag, mag), jnp.nan)
    return jnp.where(base >= 0.0, mag, neg_case)


def shade_nee(
    hit: NearestHitCM, mat: Materials, u, scene: SceneArrays,
    cfg: RenderConfig, shading_normal3=None,
):
    """Direct lighting via next-event estimation; returns [3, N].

    Reference contract (``main.py:23-73``): ``n_light_samples`` light
    points (triangle ∝ area, normalized-uniform barycentrics), occlusion
    against object triangles only, contribution = mean over samples of the
    **unclamped** dot(shadow_dir, normal), times light_color × a color
    that — due to the reference's leaked loop variable (SURVEY.md §2.4-9)
    — belongs to the LAST sample's occluder or the last SDL object.

    Fast mode: uniform barycentrics, clamped cosine, the true material.
    ``u``: [S*5, N] uniforms.
    """
    s = cfg.n_light_samples
    n = hit.point3.shape[1]
    point3 = hit.point3
    # fast mode shades on the side the ray arrived from (consistent with
    # scatter); reference mode uses the raw winding normal (parity)
    normal3 = hit.normal3 if shading_normal3 is None else shading_normal3

    u = u.reshape(s, 5, n)
    tri = sampling.pick_light_triangle(u[:, 0], scene.light_area)  # [S, N]
    if cfg.mode == "reference":
        bary = cm_sample_barycentric_reference(
            jnp.moveaxis(u[:, 1:4], 1, 0)  # [3, S, N]
        )
    else:
        bary = cm_sample_barycentric_uniform(jnp.moveaxis(u[:, 1:3], 1, 0))
    from pathtracerpython_tpu.ops.gather import cm_take

    lv = cm_take(
        jnp.concatenate(
            [scene.light_v0.T, scene.light_v1.T, scene.light_v2.T]
        ),
        tri,
    )  # [9, S, N]
    light_pt3 = cm_point_from_barycentric(
        bary, lv[0:3], lv[3:6], lv[6:9]
    )  # [3, S, N]

    vec3 = light_pt3 - point3[:, None, :]
    # sqrt(x + tiny), not a bare norm: lanes shading ON the light have
    # |vec| ~ 0 where the norm's backward pass is NaN
    dist = jnp.sqrt(jnp.sum(vec3 * vec3, axis=0) + 1e-24)  # [S, N]
    sdir3 = normalize3(vec3)

    flat_o3 = jnp.broadcast_to(
        point3[:, None, :], vec3.shape
    ).reshape(3, s * n)
    flat_d3 = sdir3.reshape(3, s * n)
    flat_dist = dist.reshape(s * n)

    cos = jnp.sum(sdir3 * normal3[:, None, :], axis=0)  # [S, N]
    if cfg.mode != "reference":
        cos = jnp.maximum(cos, 0.0)

    if cfg.soft_vis_beta > 0.0 and cfg.mode == "fast":
        # boundary-aware smooth shadow coverage (diff/boundary.py):
        # differentiable w.r.t. occluder vertices
        from pathtracerpython_tpu.diff.boundary import soft_visibility

        vis = soft_visibility(
            flat_o3.T, flat_d3.T, flat_dist, scene, cfg.soft_vis_beta,
            tile=cfg.tile,
        ).reshape(s, n)
        mean_cos = jnp.mean(vis * cos, axis=0)  # [N]
    else:
        occluded = any_hit_within_cm(
            flat_o3, flat_d3, flat_dist, scene,
            mode=cfg.mode, tile=cfg.tile,
            geom_axis=cfg.geom_axis, geom_axis_size=cfg.geom_axis_size,
        ).reshape(s, n)
        mean_cos = jnp.mean(jnp.where(occluded, 0.0, cos), axis=0)  # [N]

    if cfg.mode == "reference":
        # quirk 9: color from the LAST sample's occluder / last SDL object
        from pathtracerpython_tpu.ops.geometry import first_occluder_index

        occ_idx, occ_mat = first_occluder_index(
            point3.T, sdir3[:, -1, :].T, dist[-1], scene,
            mode=cfg.mode, tile=cfg.tile,
            geom_axis=cfg.geom_axis, geom_axis_size=cfg.geom_axis_size,
        )
        quirk_mat = jnp.where(
            occ_idx >= 0, occ_mat, scene.meta.n_objects - 1
        )
        direct_rgb3 = cm_take(scene.mat_rgb.T, quirk_mat)
    else:
        direct_rgb3 = mat.rgb3

    return scene.light_color[:, None] * direct_rgb3 * mean_cos[None, :]


def shade(hit: NearestHitCM, mat: Materials, u, scene: SceneArrays,
          cfg: RenderConfig, prev_specular, shading_normal3=None):
    """Per-bounce color [3, N]: light hits pay the light color, surface
    hits pay ambient + NEE (``compute_color``, ``main.py:142-145``);
    misses pay 0. Fast mode kills the reference's emission double-count
    (quirk §2.4-6): a light hit only pays when the path arrived from the
    camera or a specular bounce."""
    ambient3 = mat.rgb3 * (mat.ka * scene.ambient)[None, :]
    with jax.named_scope("nee"):
        direct3 = shade_nee(hit, mat, u, scene, cfg, shading_normal3)
    surface3 = ambient3 + direct3

    light3 = jnp.broadcast_to(scene.light_color[:, None], surface3.shape)
    if cfg.mode != "reference":
        light3 = jnp.where(prev_specular[None, :], light3, 0.0)
    color3 = jnp.where(hit.is_light[None, :], light3, surface3)
    # opt-in SDL background (cfg.use_background): a miss pays the parsed
    # background color; the lane dies right after, so it pays at most once
    miss3 = (
        jnp.broadcast_to(scene.background[:, None], surface3.shape)
        if cfg.use_background else jnp.zeros_like(surface3)
    )
    return jnp.where(hit.hit[None, :], color3, miss3)


def arrival_side_normal(normal3, d_in3):
    """Flip the geometric normal onto the side the ray arrived from."""
    return normal3 * jnp.sign(-cm_dot(normal3, d_in3) + 1e-12)[None, :]


def scatter(
    state: RayState, hit: NearestHitCM, mat: Materials, u,
    scene: SceneArrays, cfg: RenderConfig, shading_normal3=None,
):
    """BRDF sampling: (new_dir3, throughput_factor, survives,
    chose_specular) for every lane. ``u``: [3, N] uniforms.

    Reference contract (``main.py:233-268``): branch by
    ``uniform(0, kd+ks) <= kd``; diffuse = canonical cosine sample rotated
    about the fixed y-axis by arccos(normal_y), factor ``kd·dot(dir, n)``;
    specular = reflect the RAW previous direction (no negation), rotate
    the same way, factor ``ks·dot(eye_vec, dir)^n`` toward the eye.

    Fast mode: cosine-importance diffuse about the true shading normal,
    mirror reflection of the incident direction; branch w.p. kd/(kd+ks),
    factor kd+ks either way."""
    kd, ks, n_phong = mat.kd, mat.ks, mat.n
    normal3 = hit.normal3

    if cfg.mode == "reference":
        diffuse_local = cm_cosine_hemisphere_reference(u[1:3])
        diffuse_dir3 = cm_rotate_frame_reference(diffuse_local, normal3)
        spec = normalize3(
            2.0 * cm_dot(normal3, state.direction3)[None, :] * normal3
            - state.direction3
        )
        spec_dir3 = cm_rotate_frame_reference(spec, normal3)
        eye_vec3 = normalize3(scene.eye[:, None] - hit.point3)

        choose_diffuse = u[0] * (kd + ks) <= kd
        new_dir3 = jnp.where(choose_diffuse[None, :], diffuse_dir3, spec_dir3)
        diffuse_k = kd * cm_dot(diffuse_dir3, normal3)
        spec_k = ks * _power_numpy_semantics(
            cm_dot(eye_vec3, spec_dir3), n_phong
        )
        factor = jnp.where(choose_diffuse, diffuse_k, spec_k)
    else:
        d_in3 = normalize3(state.direction3)
        n_sh3 = (shading_normal3 if shading_normal3 is not None
                 else arrival_side_normal(normal3, d_in3))
        diffuse_dir3 = cm_cosine_hemisphere_fixed(u[1:3], n_sh3)
        spec_dir3 = cm_reflect(d_in3, n_sh3)

        w = kd + ks
        p_diffuse = jnp.where(w > 0.0, kd / jnp.maximum(w, 1e-12), 1.0)
        choose_diffuse = u[0] < p_diffuse
        new_dir3 = jnp.where(choose_diffuse[None, :], diffuse_dir3, spec_dir3)
        factor = w

    survives = hit.hit & ~hit.is_light
    return new_dir3, factor, survives, ~choose_diffuse


def _soft_hit_and_shade(o3, d3, state, scene, cfg, u_nee):
    """Silhouette-blended hit + color for the soft estimator
    (cfg.soft_vis_beta > 0; see diff/boundary.py for the math).

    Returns (hard hit1 record for path continuation, blended color3).
    The blend ``cov·shade(front) + (1-cov)·shade(behind)`` makes the
    radiance continuous in occluder vertex positions: gradients flow
    through the front hit's edge margin (and through both hit distances).
    """
    from pathtracerpython_tpu.diff.boundary import (
        IMAX as B_IMAX,
        soft_hits_sweep,
    )

    sh = soft_hits_sweep(o3.T, d3.T, scene, cfg.soft_vis_beta, tile=cfg.tile)
    d3u = normalize3(d3)

    def rec(t, idx) -> NearestHitCM:
        found = idx != B_IMAX
        safe = jnp.where(found, idx, 0)
        t_ = jnp.where(found, t, 0.0)
        return NearestHitCM(
            hit=found,
            t=t_,
            tri_idx=safe,
            point3=o3 + d3u * t_[None, :],
            normal3=scene.tri_normal[safe].T,
            material=scene.tri_material[safe],
            is_light=scene.tri_is_light[safe] & found,
        )

    front = rec(sh.f_t, sh.f_idx)
    # "behind" = the first true hit past the front record: hit2 when the
    # front IS hit1, else hit1 (front is then a near-miss in front of it)
    front_is_h1 = sh.f_idx == sh.h1_idx
    behind = rec(
        jnp.where(front_is_h1, sh.h2_t, sh.h1_t),
        jnp.where(front_is_h1, sh.h2_idx, sh.h1_idx),
    )
    hit1 = rec(sh.h1_t, sh.h1_idx)

    cov = jnp.where(
        front.hit, jax.nn.sigmoid(sh.f_margin / cfg.soft_vis_beta), 0.0
    )

    def shade_rec(r: NearestHitCM):
        m = resolve_materials(scene, r.material)
        n3 = arrival_side_normal(r.normal3, normalize3(d3))
        return shade(r, m, u_nee, scene, cfg, state.prev_specular, n3)

    color3 = (
        cov[None, :] * shade_rec(front)
        + (1.0 - cov)[None, :] * shade_rec(behind)
    )
    return hit1, color3


def bounce_step(
    state: RayState, bounce_idx, scene: SceneArrays, cfg: RenderConfig,
    k0, k1,
) -> RayState:
    """One wavefront bounce: intersect → shade → scatter, fully masked."""
    nk0, nk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_NEE)
    sk0, sk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_SCATTER)

    u_nee = rng.uniforms(nk0, nk1, state.counters, cfg.n_light_samples * 5)
    u_scatter = rng.uniforms(sk0, sk1, state.counters, 3)

    if cfg.soft_vis_beta > 0.0 and cfg.mode == "fast":
        hit, color3 = _soft_hit_and_shade(
            state.origin3, state.direction3, state, scene, cfg, u_nee
        )
        mat = resolve_materials(scene, hit.material)
        shading_n3 = arrival_side_normal(
            hit.normal3, normalize3(state.direction3)
        )
    else:
        with jax.named_scope("nearest_hit"):
            hit = nearest_hit_cm(
                state.origin3, state.direction3, scene, mode=cfg.mode,
                tile=cfg.tile, geom_axis=cfg.geom_axis,
                geom_axis_size=cfg.geom_axis_size,
            )
        mat = resolve_materials(scene, hit.material)
        if cfg.mode == "fast":
            # one arrival-side normal for BOTH direct lighting and
            # scattering (backface-consistent shading; reference mode
            # keeps raw windings)
            shading_n3 = arrival_side_normal(
                hit.normal3, normalize3(state.direction3)
            )
        else:
            shading_n3 = None

        color3 = shade(
            hit, mat, u_nee, scene, cfg, state.prev_specular, shading_n3,
        )
    contrib3 = jnp.where(
        state.alive[None, :], color3 * state.throughput[None, :], 0.0
    )
    radiance3 = state.radiance3 + contrib3

    with jax.named_scope("scatter"):
        new_dir3, factor, survives, chose_spec = scatter(
            state, hit, mat, u_scatter, scene, cfg, shading_n3
        )
    alive = state.alive & survives
    throughput = jnp.where(alive, state.throughput * factor, state.throughput)
    origin3 = jnp.where(alive[None, :], hit.point3, state.origin3)
    direction3 = jnp.where(alive[None, :], new_dir3, state.direction3)

    return RayState(
        origin3=origin3,
        direction3=direction3,
        throughput=throughput,
        alive=alive,
        radiance3=radiance3,
        counters=state.counters,
        prev_specular=state.alive & chose_spec,
    )


def init_rays(origins3, directions3, counters) -> RayState:
    """Fresh primary-ray state. ``counters``: u32[N] global path ids."""
    n = origins3.shape[1]
    return RayState(
        origin3=origins3,
        direction3=directions3,
        throughput=jnp.ones(n, origins3.dtype),
        alive=jnp.ones(n, dtype=bool),
        radiance3=jnp.zeros((3, n), origins3.dtype),
        counters=counters.astype(jnp.uint32),
        prev_specular=jnp.ones(n, dtype=bool),  # camera counts as specular
    )


def render_rays(
    origins, directions, pixel_ids, scene: SceneArrays, cfg: RenderConfig,
    base_key,
) -> jax.Array:
    """Trace the given primary rays; return radiance [N, 3] (mean over
    ``cfg.n_samples`` sample passes). This is the shard-local entry point —
    ``parallel.shard`` calls it on a slice of pixels with global ids.

    Row-major [N, 3] at the boundary (one transpose in, one out); all
    internal state is component-major.

    Two execution plans with IDENTICAL results (the RNG stream depends
    only on (pixel, sample)): a lax.scan over samples (default, minimal
    memory) or ``cfg.batch_samples`` (all spp as extra lanes — fewer
    launches, n_samples× the live state).
    """
    n = origins.shape[0]
    s_total = cfg.n_samples
    check_counter_space(n, s_total)  # local lower bound; render()/sharded
    #                                  entries check the global pixel count
    o3 = origins.T
    d3 = directions.T
    pid = pixel_ids.astype(jnp.uint32)
    k0, k1 = rng.key_from_seed(base_key)

    def bounce_sweep(state):
        def body(st, b):
            return bounce_step(st, b, scene, cfg, k0, k1), None

        if cfg.remat_bounces:
            body = jax.checkpoint(body)
        return lax.scan(
            body, state, jnp.arange(cfg.n_bounces, dtype=jnp.uint32)
        )[0]

    if cfg.batch_samples and s_total > 1:
        rep3 = lambda x: jnp.concatenate([x] * s_total, axis=1)
        counters = (
            jnp.concatenate(
                [pid * s_total + s for s in range(s_total)]
            )
        )
        state = init_rays(rep3(o3), rep3(d3), counters)
        state = bounce_sweep(state)
        return jnp.mean(
            state.radiance3.reshape(3, s_total, n), axis=1
        ).T

    def one_sample(carry, sample_idx):
        counters = pid * s_total + sample_idx
        state = init_rays(o3, d3, counters)
        state = bounce_sweep(state)
        return carry + state.radiance3, None

    total3 = lax.scan(
        one_sample,
        jnp.zeros((3, n), origins.dtype),
        jnp.arange(s_total, dtype=jnp.uint32),
    )[0]
    return (total3 / s_total).T


def check_counter_space(n_pixels: int, n_samples: int) -> None:
    """Path counters are uint32 (pixel_id * spp + sample); past 2^32 they
    would silently alias RNG streams across paths — refuse instead."""
    if n_pixels * n_samples >= 2**32:
        raise ValueError(
            f"pixels*samples = {n_pixels}*{n_samples} overflows the uint32 "
            "path counter space; chunk samples (utils.render_progressive) "
            "or tile the image"
        )


def render(scene: SceneArrays, cfg: RenderConfig, seed: int = 0) -> jax.Array:
    """Render the scene's camera view; returns radiance [W*H, 3] in the
    reference's pixel order (x-outer / y-inner)."""
    w, h = scene.meta.width, scene.meta.height
    check_counter_space(w * h, cfg.n_samples)
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    return render_rays(origins, dirs, pixel_ids, scene, cfg, seed)


def render_image(scene: SceneArrays, cfg: RenderConfig, seed: int = 0):
    """Render and convert to a uint8 image with reference normalization."""
    from pathtracerpython_tpu.render.image import radiance_to_image

    radiance = render(scene, cfg, seed=seed)
    return radiance_to_image(radiance, scene.meta.width, scene.meta.height)
