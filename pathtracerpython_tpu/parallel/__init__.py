"""Distributed execution: device meshes, sharded rendering, geometry rings.

The reference's only parallelism is a per-host ``multiprocessing.Pool`` with
one ``apply_async`` per ray (``main.py:197-204, 208-228``). Here parallelism
is a ``jax.sharding.Mesh`` over devices, rays/pixels sharded along
data-parallel axes with ``shard_map``, scene geometry either replicated
(small scenes) or sharded along a geometry axis and streamed around a ring
with ``lax.ppermute`` (large scenes) — the structural analogue of ring
attention, with triangles playing the role of KV context.
"""

from pathtracerpython_tpu.parallel.mesh import make_mesh
from pathtracerpython_tpu.parallel.pipeline import render_pipelined
from pathtracerpython_tpu.parallel.shard import (
    render_sharded,
    scene_partition_specs,
)

__all__ = [
    "make_mesh",
    "render_pipelined",
    "render_sharded",
    "scene_partition_specs",
]
