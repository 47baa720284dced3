"""pathtracerpython_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``thiagoald/pathtracerpython`` (a pure-Python CPU Cornell-box path tracer):

- ``scene``    — SDL + OBJ parsing into flat SoA ``SceneArrays`` pytrees
                 (replaces reference ``scene_reader.py`` / ``vector.py``).
- ``ops``      — jittable batched geometry / sampling primitives
                 (replaces reference ``utils.py`` hot loops).
- ``render``   — the wavefront integrator: per-bounce intersect → shade(NEE)
                 → scatter over a flat ray SoA (replaces ``main.py``'s
                 multiprocessing Pool phases).
- ``kernels``  — culled Triton (Pallas) kernels for the GPU nearest-hit /
                 any-hit sweeps.
- ``parallel`` — device-mesh sharding (pixels/samples DP, geometry ring).
- ``diff``     — differentiable rendering + finite-difference harnesses.
- ``utils``    — RNG, profiling, checkpointing helpers.

Two semantic modes are supported throughout (see ``render.config.RenderConfig``):

- ``reference``: reproduces the reference renderer's estimator bit-for-bit in
  spirit (plane+sign-test intersection with no t>0 check, fixed-y-axis tangent
  frames, unclamped NEE cosines, TAU=6.28, …) for the radiance-allclose gate.
- ``fast`` (default): numerically sane, differentiable, Möller–Trumbore based.
"""

__version__ = "0.1.0"

from pathtracerpython_tpu.scene import load_scene, SceneArrays  # noqa: F401
