"""Checkpoint/resume, metrics, profiling utilities."""

import numpy as np
import pytest

from pathtracerpython_tpu.render.config import RenderConfig
from pathtracerpython_tpu.render.integrator import render
from pathtracerpython_tpu.utils import (
    CheckpointManager,
    MetricsLogger,
    render_progressive,
)


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    state = {"a": jnp.arange(12.0).reshape(3, 4), "n": jnp.asarray(7)}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    mgr.save(3, state)
    assert mgr.latest_step() == 3
    back = mgr.restore(3, state)
    np.testing.assert_array_equal(np.asarray(back["a"]), np.asarray(state["a"]))
    assert int(back["n"]) == 7


def test_progressive_resume_matches_uninterrupted(cornell_scene, tmp_path):
    cfg = RenderConfig(mode="fast", n_bounces=1)
    quiet = lambda *a: None

    full = render_progressive(
        cornell_scene, cfg, total_samples=4, chunk_samples=2,
        checkpoint_dir=str(tmp_path / "full"), seed=5, log=quiet,
    )

    # "crash" after the first chunk: run once with a checkpoint dir, then
    # resume in a fresh call — result must equal the uninterrupted run
    partial_dir = str(tmp_path / "partial")
    render_progressive(
        cornell_scene, cfg, total_samples=2, chunk_samples=2,
        checkpoint_dir=partial_dir, seed=5, log=quiet,
    )
    resumed = render_progressive(
        cornell_scene, cfg, total_samples=4, chunk_samples=2,
        checkpoint_dir=partial_dir, seed=5, log=quiet,
    )
    np.testing.assert_allclose(
        np.asarray(resumed), np.asarray(full), rtol=1e-6, atol=1e-7
    )


def test_metrics_logger():
    import jax.numpy as jnp

    m = MetricsLogger()
    with m.timed("phase_a") as box:
        box["out"] = jnp.ones((8, 8)) * 2
    m.count("rays", 64)
    s = m.summary()
    assert s["calls"]["phase_a"] == 1
    assert s["timings_s"]["phase_a"] > 0
    assert m.rate("rays", "phase_a") > 0


def test_progressive_compose_with_sharded_renderer(cornell_scene, tmp_path):
    """render_progressive accepts any renderer with the render() signature
    — here the mesh-sharded one (checkpointed distributed rendering)."""
    import functools

    from pathtracerpython_tpu.parallel import make_mesh, render_sharded

    mesh = make_mesh(dp=4, geom=1)
    renderer = functools.partial(render_sharded, mesh=mesh)
    cfg = RenderConfig(mode="fast", n_bounces=1)
    out = render_progressive(
        cornell_scene, cfg, total_samples=2, chunk_samples=1,
        checkpoint_dir=str(tmp_path / "ck"), seed=3,
        renderer=renderer, log=lambda *a: None,
    )
    single = render_progressive(
        cornell_scene, cfg, total_samples=2, chunk_samples=1,
        checkpoint_dir=str(tmp_path / "ck2"), seed=3, log=lambda *a: None,
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(single), rtol=1e-6, atol=1e-7
    )


@pytest.fixture
def restore_cache_config():
    import jax

    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_env_dir_wins(tmp_path, monkeypatch,
                                    restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the helper sets no other one in code."""
    import jax

    from pathtracerpython_tpu.utils import compile_cache

    d = str(tmp_path / "env_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == d
    assert compile_cache.enable_compilation_cache() == d
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_helper(monkeypatch, restore_cache_config):
    """Unset, the cache is <checkout>/.jax_cache: a fixed path (no
    temporary name, process id or time in it) that git ignores."""
    import os

    import jax

    from pathtracerpython_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
