"""Pipeline parallelism: bounce stages across a ``pp`` mesh axis.

SURVEY.md §2.2 maps the reference's (nonexistent) pipeline parallelism to
"pipeline bounce stages across cores". This module implements that
analogue the way a transformer framework pipelines layers (GPipe): the
bounce loop — the renderer's depth dimension, the analogue of the layer
stack — is partitioned into contiguous per-stage ranges over the ``pp``
axis, the pixel wavefront is split into microbatches, and the classic
``M + P - 1``-step schedule streams each microbatch through every stage,
handing the full ray state (``render.integrator.RayState``) to the next
stage with a ``lax.ppermute`` ring hop per step. The first ``P - 1``
steps and last ``P - 1`` steps are the usual pipeline bubbles.

Semantics: BIT-IDENTICAL to the single-device per-sample scan
(``render_rays`` with ``batch_samples=False``) — every microbatch passes
through the same ``bounce_step`` calls in the same order with the same
RNG counters (keyed by global pixel id; the reference's per-ray
scheduling is ``/root/reference/main.py:197-228``). Verified in
tests/test_pipeline.py on the virtual CPU mesh.

When to use: path tracing has no per-stage weights, so unlike a
transformer there is no memory reason to prefer PP over DP — DP is the
production axis (``parallel/shard.py``). PP exists as the complete,
tested mapping of the strategy: it trades bubble overhead for a
DIFFERENT communication pattern (state ring-hops instead of a final
gather), which is the right shape when per-device HBM cannot hold the
whole wavefront's live state at once (very deep bounce budgets with
rematerialization disabled) or when composing with mesh axes whose
collectives are already saturated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pathtracerpython_tpu.ops.camera import make_primary_rays
from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.render.integrator import (
    bounce_step,
    check_counter_space,
    init_rays,
)
from pathtracerpython_tpu.scene.arrays import SceneArrays


def render_pipelined(
    scene: SceneArrays,
    cfg: RenderConfig,
    mesh: Mesh,
    *,
    seed: int = 0,
    pp_axis: str = "pp",
    microbatches: int | None = None,
) -> jax.Array:
    """Render with bounce stages pipelined over ``mesh[pp_axis]``.

    Returns radiance [W*H, 3], bit-identical to
    ``render(scene, cfg)`` for configs in the per-sample-scan family
    (``batch_samples`` is a lane-layout optimization of the same sum —
    the pipeline uses the scan family's counters). Requirements:
    ``cfg.n_bounces % P == 0`` (contiguous equal bounce ranges per
    stage) and ``W*H % microbatches == 0``.

    ``microbatches`` defaults to ``2 * P`` — the standard GPipe-style
    bubble fraction ``(P-1)/(M+P-1)`` at M=2P is ~33%; raise it to
    shrink bubbles at the cost of smaller per-step wavefronts.
    """
    from pathtracerpython_tpu.ops import rng

    p_size = mesh.shape[pp_axis]
    n_b = cfg.n_bounces
    assert n_b % p_size == 0, (
        f"n_bounces={n_b} must divide evenly into pp={p_size} stages"
    )
    bpp = n_b // p_size

    w, h = scene.meta.width, scene.meta.height
    n = w * h
    m = microbatches if microbatches is not None else 2 * p_size
    assert n % m == 0, f"W*H={n} must be a multiple of microbatches={m}"
    n_mb = n // m
    s_total = cfg.n_samples
    check_counter_space(n, s_total)

    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    o3, d3 = origins.T, dirs.T
    pid = jnp.arange(n, dtype=jnp.uint32)
    k0, k1 = rng.key_from_seed(jax.random.PRNGKey(seed))

    def stage_fn(o3, d3, pid, sc):
        s = lax.axis_index(pp_axis)
        shift = [(i, (i + 1) % p_size) for i in range(p_size)]

        def one_sample(total3, sample_idx):
            counters = pid * jnp.uint32(s_total) + sample_idx

            def ingest(t):
                mb = jnp.minimum(t, m - 1) * n_mb  # clamped: idle reads
                #                                    re-feed the last one
                return init_rays(
                    lax.dynamic_slice(o3, (0, mb), (3, n_mb)),
                    lax.dynamic_slice(d3, (0, mb), (3, n_mb)),
                    lax.dynamic_slice(counters, (mb,), (n_mb,)),
                )

            def step(carry, t):
                state, out3 = carry
                # stage 0 adopts incoming microbatch t (while any remain)
                fresh = ingest(t)
                adopt = (s == 0) & (t < m)
                state = jax.tree.map(
                    lambda a, b: jnp.where(adopt, a, b), fresh, state
                )
                # this stage's contiguous bounce range
                start = (s.astype(jnp.uint32)) * jnp.uint32(bpp)

                def body(st, i):
                    return bounce_step(st, start + i, sc, cfg, k0, k1), None

                state = lax.scan(
                    body, state, jnp.arange(bpp, dtype=jnp.uint32)
                )[0]
                # the last stage emits microbatch t - (P-1)
                m_out = t - (p_size - 1)
                emit = (s == p_size - 1) & (m_out >= 0)
                off = jnp.maximum(m_out, 0) * n_mb
                cur = lax.dynamic_slice(out3, (0, off), (3, n_mb))
                out3 = lax.dynamic_update_slice(
                    out3,
                    jnp.where(emit, state.radiance3, cur),
                    (0, off),
                )
                # hand every stage's state to the next (stage 0's inbound
                # from stage P-1 is dead weight — overwritten by ingest)
                state = jax.tree.map(
                    lambda x: lax.ppermute(x, pp_axis, shift), state
                )
                return (state, out3), None

            out3 = jnp.zeros((3, n), o3.dtype)
            (_, out3), _ = lax.scan(
                step, (ingest(jnp.int32(0)), out3),
                jnp.arange(m + p_size - 1, dtype=jnp.int32),
            )
            # only the last stage wrote real radiance; psum broadcasts it
            return total3 + lax.psum(out3, pp_axis), None

        total3 = lax.scan(
            one_sample, jnp.zeros((3, n), o3.dtype),
            jnp.arange(s_total, dtype=jnp.uint32),
        )[0]
        return total3 / s_total

    from pathtracerpython_tpu.parallel.shard import scene_partition_specs

    fn = shard_map(
        stage_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), scene_partition_specs(scene)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(o3, d3, pid, scene).T
