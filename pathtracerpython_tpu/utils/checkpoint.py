"""Checkpoint / resume (orbax-backed) and progressive rendering.

Recovery story (SURVEY.md §5): the accumulation state — radiance sum,
samples completed, base seed — is checkpointed every chunk, so a preempted
render resumes from the last chunk instead of restarting; the same
machinery checkpoints optimizer state for long inverse-rendering fits.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


class CheckpointManager:
    """Thin orbax wrapper: numbered pytree checkpoints under a directory."""

    def __init__(self, directory: str):
        import orbax.checkpoint as ocp

        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._ckpt = ocp.StandardCheckpointer()

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> None:
        self._ckpt.save(self._path(step), state, force=True)
        self._ckpt.wait_until_finished()

    def restore(self, step: int, template: Any) -> Any:
        return self._ckpt.restore(self._path(step), template)

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return max(steps) if steps else None


def render_progressive(
    scene,
    cfg,
    total_samples: int,
    chunk_samples: int,
    checkpoint_dir: str | None,
    seed: int = 0,
    renderer=None,
    log=print,
    progress=None,
):
    """Accumulate ``total_samples`` spp in chunks, checkpointing after each.

    Resumes automatically from the latest checkpoint in ``checkpoint_dir``.
    ``checkpoint_dir=None`` skips checkpointing entirely (pure
    progress-chunked rendering — no orbax dependency, no resume); the
    chunk→seed mapping is identical either way, so a checkpointed run
    bit-matches an uncheckpointed one at the same ``chunk_samples``.
    Returns radiance [W*H, 3] (mean over all completed samples). Sample
    chunk i uses RNG seed ``fold_in(seed, i)``, so for a FIXED
    ``chunk_samples`` the result is independent of how many times the job
    restarted (a resumed run bit-matches an uninterrupted one). Changing
    ``chunk_samples`` changes the chunk→seed mapping and therefore the
    (equally converged) result. When ``chunk_samples`` does not divide
    ``total_samples``, the final chunk still renders a full
    ``chunk_samples`` — the returned mean is over ``samples_done`` (which
    may exceed ``total_samples``), never over a partial weighting.

    ``progress``: optional callback
    ``progress(chunk_done, n_chunks, samples_done, chunk_seconds)``
    invoked after each chunk completes (device-synced timing) — the
    CLI's per-chunk status line (the reference streams tqdm bars per
    phase, ``main.py:199-224``; at accelerator batch sizes the natural
    progress granularity is the sample chunk).
    """
    import dataclasses
    import time

    from pathtracerpython_tpu.render.integrator import render

    if renderer is None:
        renderer = render

    n_chunks = -(-total_samples // chunk_samples)
    cfg_chunk = dataclasses.replace(cfg, n_samples=chunk_samples)

    w, h = scene.meta.width, scene.meta.height
    template = {
        "radiance_sum": jnp.zeros((w * h, 3), jnp.float32),
        "samples_done": jnp.zeros((), jnp.int32),
        "chunks_done": jnp.zeros((), jnp.int32),
    }
    mgr = None
    state = template
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, template)
            log(f"resumed at chunk {int(state['chunks_done'])}/{n_chunks}")

    start = int(state["chunks_done"])
    for chunk in range(start, n_chunks):
        t0 = time.perf_counter()
        chunk_seed = jax.random.fold_in(jax.random.PRNGKey(seed), chunk)
        chunk_seed = int(jax.random.randint(
            chunk_seed, (), 0, np.iinfo(np.int32).max
        ))
        radiance = renderer(scene, cfg_chunk, seed=chunk_seed)
        state = {
            "radiance_sum": state["radiance_sum"]
            + radiance * chunk_samples,
            "samples_done": state["samples_done"] + chunk_samples,
            "chunks_done": jnp.asarray(chunk + 1, jnp.int32),
        }
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        if mgr is not None:
            mgr.save(chunk + 1, state)
            log(f"chunk {chunk + 1}/{n_chunks} checkpointed "
                f"({int(state['samples_done'])} spp)")
        if progress is not None:
            progress(chunk + 1, n_chunks, int(state["samples_done"]), dt)

    return state["radiance_sum"] / jnp.maximum(state["samples_done"], 1)
