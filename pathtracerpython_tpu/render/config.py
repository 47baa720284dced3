"""Render configuration — the runtime knobs the reference spreads across its
CLI (``main.py:125-139``, ``-r``/``-b``) and hardcoded defaults
(``n_light_samples=3`` at ``main.py:23``), as one hashable static dataclass.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the wavefront integrator.

    mode:
      - ``"fast"`` (default): Möller–Trumbore, correct tangent frames,
        clamped cosines, uniform triangle sampling, no emission double
        counting — the differentiable production path.
      - ``"reference"``: reproduces the reference estimator exactly
        (SURVEY.md §2.4 quirks 1-8) for the radiance-allclose gate.
    """

    mode: str = "fast"
    # Opt-in SDL field honoring (CLI --honor-sdl): miss lanes pay the
    # scene's parsed ``background`` color (× path throughput) instead of
    # black. The reference parses background but ignores it
    # (scene_reader.py:165-170); default off keeps reference semantics.
    use_background: bool = False
    # Boundary-aware gradients (diff/boundary.py): > 0 switches the fast
    # estimator to SOFT visibility with edge-coverage width ``beta`` in
    # world units — silhouettes blend over the surface behind them and
    # shadows use smooth coverage, making radiance differentiable w.r.t.
    # occluder vertex positions (the inverse-rendering fit path; converges
    # to the hard estimator as beta -> 0). 0 = hard visibility.
    soft_vis_beta: float = 0.0
    n_samples: int = 1        # rays per pixel (the reference CLI's -r)
    n_bounces: int = 1        # bounces      (the reference CLI's -b)
    n_light_samples: int = 3  # NEE samples  (main.py:23 default arg)
    tile: int = 128           # triangle-tile width of the XLA sweeps
    remat_bounces: bool = False  # jax.checkpoint each bounce (for deep grads)
    batch_samples: bool = False  # all spp in one wavefront (fewer
    #                              launches, n_samples x the live ray state)
    # Geometry-ring sharding (parallel/ring.py): when geom_axis names a mesh
    # axis the integrator is running under (via shard_map), the per-triangle
    # buffers are shard-local and intersection sweeps ppermute them around
    # the ring. geom_axis_size must match the mesh axis size (it has to be
    # static — ppermute permutations are compile-time).
    geom_axis: str | None = None
    geom_axis_size: int = 0

    def __post_init__(self):
        assert self.mode in ("fast", "reference"), self.mode
        assert self.soft_vis_beta >= 0.0
        assert not (self.soft_vis_beta > 0.0 and self.mode == "reference"), (
            "soft visibility is a fast-mode (differentiable) feature"
        )
        assert self.n_samples >= 1 and self.n_bounces >= 1
        assert (self.geom_axis is None) == (self.geom_axis_size == 0)
