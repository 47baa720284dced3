"""Device-side scene layout: flat SoA arrays, padded and masked.

The reference keeps scene geometry as Python lists of tuples-of-``V`` inside
object dicts (``scene_reader.py:172-183``) and appends the light as a pseudo
object at intersection time (``main.py:91``). Here the whole scene is packed
once into padded SoA buffers:

- all object triangles in SDL order, then the light's triangles, then padding
  (this ordering reproduces the reference's nearest-hit tie-breaking: Python
  ``min`` returns the first minimal element in iteration order, as does
  ``jnp.argmin``);
- per-triangle material indices into flat material rows (light = last row);
- masks instead of ``None`` / exceptions: ``tri_valid`` excludes padding,
  ``tri_occluder`` additionally excludes light triangles because the
  reference's shadow-occlusion scan loops ``scene.objects`` only
  (``main.py:42``).

``SceneArrays`` is a registered JAX dataclass: array fields are pytree leaves
(differentiable where float), and static metadata lives in ``SceneMeta``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pathtracerpython_tpu.scene.sdl import SceneDescription, load_sdl


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (non-traced) scene metadata."""

    width: int
    height: int
    n_triangles: int  # real triangles incl. light (before padding)
    n_object_triangles: int  # real object triangles (excl. light)
    n_objects: int
    n_light_triangles: int
    light_material: int  # material row index for the light (== n_objects)
    path: str = ""
    tonemapping: float | None = None
    seed: int | None = None
    npaths: int | None = None

    def __hash__(self):
        return hash((self.width, self.height, self.n_triangles, self.n_objects,
                     self.n_light_triangles, self.path))


# Pytree leaf fields, in flattening order. TRI_FIELDS are the per-triangle
# buffers — the set sharded along the geometry mesh axis in ring mode
# (parallel/ring.py); everything else is replicated.
TRI_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_normal", "tri_area",
    "tri_material", "tri_valid", "tri_occluder", "tri_is_light",
)
DATA_FIELDS = TRI_FIELDS + (
    "mat_rgb", "mat_ka", "mat_kd", "mat_ks", "mat_kt", "mat_n",
    "light_v0", "light_v1", "light_v2", "light_area", "light_color",
    "light_tri_rows",
    "ambient", "eye", "ortho", "background",
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=list(DATA_FIELDS),
    meta_fields=["meta"],
)
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Flat SoA scene. Shapes: T = padded triangle count, M = n_objects + 1
    material rows (light last), L = light triangle count."""

    # triangles (object tris, then light tris, then padding)
    tri_v0: jax.Array      # f[T, 3]
    tri_v1: jax.Array      # f[T, 3]
    tri_v2: jax.Array      # f[T, 3]
    tri_normal: jax.Array  # f[T, 3]  geometric normal from winding
    tri_area: jax.Array    # f[T]
    tri_material: jax.Array  # i32[T]
    tri_valid: jax.Array     # bool[T]  excludes padding
    tri_occluder: jax.Array  # bool[T]  valid & not light (shadow-scan set)
    tri_is_light: jax.Array  # bool[T]
    # materials (row per SDL object + final light row)
    mat_rgb: jax.Array  # f[M, 3]
    mat_ka: jax.Array   # f[M]
    mat_kd: jax.Array   # f[M]
    mat_ks: jax.Array   # f[M]
    mat_kt: jax.Array   # f[M]
    mat_n: jax.Array    # f[M]
    # light source (NEE sampling set; duplicated from the tri buffer tail)
    light_v0: jax.Array    # f[L, 3]
    light_v1: jax.Array    # f[L, 3]
    light_v2: jax.Array    # f[L, 3]
    light_area: jax.Array  # f[L]
    light_color: jax.Array  # f[3]
    light_tri_rows: jax.Array  # i32[L] — row of light triangle l in the
    #                            main tri buffer (keeps the two copies of
    #                            the light geometry in sync when light
    #                            vertices are optimized; diff.apply_params)
    # globals
    ambient: jax.Array     # f[]
    eye: jax.Array         # f[3]
    ortho: jax.Array       # f[4]  (x0, y0, x1, y1)
    background: jax.Array  # f[3]
    meta: SceneMeta

    @property
    def num_padded_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    def astype(self, dtype) -> "SceneArrays":
        """Cast all float leaves to ``dtype`` (ints/bools unchanged).

        Requesting float64 without ``jax_enable_x64`` would silently
        truncate back to float32 (with a warning per leaf) — reject it
        up front instead.
        """
        if (jnp.dtype(dtype) == jnp.dtype("float64")
                and not jax.config.jax_enable_x64):
            raise ValueError(
                "SceneArrays.astype(float64) requires jax_enable_x64; "
                "enable it (jax.config.update('jax_enable_x64', True)) "
                "or cast to float32/bfloat16"
            )
        def cast(x):
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating):
                return jnp.asarray(x, dtype)
            return jnp.asarray(x)
        leaves, treedef = jax.tree_util.tree_flatten(self)
        return jax.tree_util.tree_unflatten(treedef, [cast(l) for l in leaves])


def _morton_argsort(centroids: np.ndarray) -> np.ndarray:
    """Spatial (Z-order) sort of triangle centroids — groups nearby
    triangles into contiguous buffer tiles so the culled sweep's per-tile
    boxes are tight and tile-granular culling bites
    (kernels/intersect_triton.py)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-12) * 1023.0)
    q = np.clip(q, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _median_split_argsort(cent: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Order triangles into median-split BVH leaves of ``leaf`` rows.

    Recursive widest-axis median splits, with each split point rounded to
    a multiple of ``leaf`` so interior leaves stay exactly full — a
    multiple of the culled sweep's tile (kernels/intersect_triton.py
    T_TILE), so its tiles coincide with real spatial partitions instead
    of raw morton runs.
    """
    out = []
    stack = [np.arange(cent.shape[0])]
    while stack:
        ids = stack.pop()
        if len(ids) <= leaf:
            out.append(ids)
            continue
        c = cent[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = ids[np.argsort(c[:, ax], kind="stable")]
        half = max(leaf, ((len(ids) // 2 + leaf - 1) // leaf) * leaf)
        if half >= len(ids):
            half = len(ids) - leaf
        stack.append(srt[:half])
        stack.append(srt[half:])
    return np.concatenate(out)


def pack_scene(
    desc: SceneDescription, pad_to: int = 128, dtype=np.float32,
    morton_order: bool = False, tri_order: str | None = None,
) -> SceneArrays:
    """Pack a parsed SDL scene into padded SoA device arrays.

    ``tri_order`` spatially sorts the triangle buffer (fast-mode only: it
    changes the reference's nearest-hit tie-break order, so leave it off
    when gating against reference-mode parity): "morton" (centroid
    z-order) or "median" (median-split BVH leaves aligned to the culled
    sweep's tiles). ``morton_order=True`` is the legacy alias for
    tri_order="morton".
    """
    assert desc.objects, "scene has no objects"
    assert desc.light_mesh is not None, "scene has no light"

    v0s, v1s, v2s, normals, areas, mats, is_light = [], [], [], [], [], [], []
    for i, obj in enumerate(desc.objects):
        a, b, c = obj.mesh.triangle_vertices()
        v0s.append(a); v1s.append(b); v2s.append(c)
        normals.append(obj.mesh.normals)
        areas.append(obj.mesh.areas)
        mats.append(np.full(obj.mesh.num_triangles, i, dtype=np.int32))
        is_light.append(np.zeros(obj.mesh.num_triangles, dtype=bool))
    n_obj_tris = sum(o.mesh.num_triangles for o in desc.objects)

    lm = desc.light_mesh
    la, lb, lc = lm.triangle_vertices()
    v0s.append(la); v1s.append(lb); v2s.append(lc)
    normals.append(lm.normals)
    areas.append(lm.areas)
    n_objects = len(desc.objects)
    mats.append(np.full(lm.num_triangles, n_objects, dtype=np.int32))
    is_light.append(np.ones(lm.num_triangles, dtype=bool))

    tri_v0 = np.concatenate(v0s).astype(dtype)
    tri_v1 = np.concatenate(v1s).astype(dtype)
    tri_v2 = np.concatenate(v2s).astype(dtype)
    tri_normal = np.concatenate(normals).astype(dtype)
    tri_area = np.concatenate(areas).astype(dtype)
    tri_material = np.concatenate(mats)
    tri_is_light = np.concatenate(is_light)
    n_tris = tri_v0.shape[0]

    light_tri_rows = n_obj_tris + np.arange(
        lm.num_triangles, dtype=np.int32
    )
    if tri_order is None and morton_order:
        tri_order = "morton"
    if tri_order is not None and tri_order != "none":
        cent = (tri_v0 + tri_v1 + tri_v2) / 3.0
        if tri_order == "morton":
            order = _morton_argsort(cent)
        elif tri_order == "median":
            order = _median_split_argsort(cent)
        else:
            raise ValueError(f"unknown tri_order {tri_order!r}")
        tri_v0, tri_v1, tri_v2 = tri_v0[order], tri_v1[order], tri_v2[order]
        tri_normal, tri_area = tri_normal[order], tri_area[order]
        tri_material = tri_material[order]
        tri_is_light = tri_is_light[order]
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.shape[0])
        light_tri_rows = inverse[light_tri_rows].astype(np.int32)

    T = max(_round_up(n_tris, pad_to), pad_to)
    pad = T - n_tris

    def pad0(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths)

    tri_valid = pad0(np.ones(n_tris, dtype=bool))
    # Degenerate padding triangles far away so even unmasked math is inert.
    far = np.zeros((pad, 3), dtype=dtype) + np.asarray([0.0, 0.0, 1e8], dtype)

    scene = SceneArrays(
        tri_v0=np.concatenate([tri_v0, far]),
        tri_v1=np.concatenate([tri_v1, far]),
        tri_v2=np.concatenate([tri_v2, far]),
        tri_normal=pad0(tri_normal),
        tri_area=pad0(tri_area),
        tri_material=pad0(tri_material),
        tri_valid=tri_valid,
        tri_occluder=tri_valid & ~pad0(tri_is_light),
        tri_is_light=pad0(tri_is_light),
        mat_rgb=np.asarray(
            [list(o.rgb) for o in desc.objects] + [[0.0, 0.0, 0.0]], dtype
        ),
        mat_ka=np.asarray([o.ka for o in desc.objects] + [0.0], dtype),
        mat_kd=np.asarray([o.kd for o in desc.objects] + [0.0], dtype),
        mat_ks=np.asarray([o.ks for o in desc.objects] + [0.0], dtype),
        mat_kt=np.asarray([o.kt for o in desc.objects] + [0.0], dtype),
        mat_n=np.asarray([o.n for o in desc.objects] + [1.0], dtype),
        light_v0=la.astype(dtype),
        light_v1=lb.astype(dtype),
        light_v2=lc.astype(dtype),
        light_area=lm.areas.astype(dtype),
        light_color=np.asarray(desc.light_color, dtype),
        light_tri_rows=light_tri_rows,
        ambient=np.asarray(desc.ambient if desc.ambient is not None else 0.0, dtype),
        eye=np.asarray(desc.eye, dtype),
        ortho=np.asarray(desc.ortho, dtype),
        background=np.asarray(desc.background or (0.0, 0.0, 0.0), dtype),
        meta=SceneMeta(
            width=desc.width,
            height=desc.height,
            n_triangles=n_tris,
            n_object_triangles=n_obj_tris,
            n_objects=n_objects,
            n_light_triangles=lm.num_triangles,
            light_material=n_objects,
            path=desc.path,
            tonemapping=desc.tonemapping,
            seed=desc.seed,
            npaths=desc.npaths,
        ),
    )
    # device arrays, not numpy: eager ops (e.g. gather-by-tracer inside a
    # scan) require jax arrays even outside jit
    return jax.tree_util.tree_map(jnp.asarray, scene)


def load_scene(
    path: str, pad_to: int = 128, dtype=np.float32,
    morton_order: bool = False, tri_order: str | None = None,
) -> SceneArrays:
    """Parse an SDL file and pack it for the device."""
    return pack_scene(
        load_sdl(path), pad_to=pad_to, dtype=dtype,
        morton_order=morton_order, tri_order=tri_order,
    )


def recompute_derived(scene: SceneArrays) -> SceneArrays:
    """Recompute normals/areas from vertices, differentiably.

    ``pack_scene`` precomputes ``tri_normal``/``tri_area``/``light_area`` on
    host. When optimizing vertex positions, run the perturbed scene through
    this so the derived quantities carry gradients (reference normal/area
    formulas: ``scene_reader.py:5-8``, ``vector.py:164``).
    """
    def derive(v0, v1, v2):
        cross = jnp.cross(v1 - v0, v2 - v0)
        # guard BEFORE the sqrt: d(sqrt)/dx at 0 is inf, and inf·0 = NaN in
        # the backward pass for degenerate (padding) triangles
        sq = jnp.sum(cross * cross, axis=-1, keepdims=True)
        degenerate = sq == 0.0
        norm = jnp.sqrt(jnp.where(degenerate, 1.0, sq))
        normal = jnp.where(degenerate, 0.0, cross / norm)
        area = jnp.where(degenerate[..., 0], 0.0, norm[..., 0] / 2.0)
        return normal, area

    tri_normal, tri_area = derive(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    _, light_area = derive(scene.light_v0, scene.light_v1, scene.light_v2)
    keep_pad = scene.tri_valid[:, None]
    return dataclasses.replace(
        scene,
        tri_normal=jnp.where(keep_pad, tri_normal, scene.tri_normal),
        tri_area=jnp.where(scene.tri_valid, tri_area, scene.tri_area),
        light_area=light_area,
    )
