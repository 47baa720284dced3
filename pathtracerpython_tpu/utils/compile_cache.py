"""Persistent XLA compilation cache wiring.

A cold render compiles for tens of seconds on the GPU; JAX's persistent
executable cache lets every later process that builds the same program
skip that (repeated CLI renders of a scene shape, fit loops, benchmark
reruns). Entries are keyed by the JAX version and the device, so an
upgrade never serves a stale executable.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and this
  module sets no other directory;
- otherwise ``<checkout>/.jax_cache``, a fixed path inside the checkout
  (listed in ``.gitignore``), so that a second process finds what the
  first one stored.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the repo's."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent) and return
    its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took meaningful compile time; tiny programs
    # recompile faster than they deserialize
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
