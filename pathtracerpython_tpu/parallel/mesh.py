"""Device-mesh construction helpers.

One place decides how physical devices become logical mesh axes:

- ``dp``   — data parallel over rays/pixels/samples (the primary axis; the
  reference's per-ray pool fan-out, ``main.py:197-204``, maps here),
- ``geom`` — optional geometry axis for triangle buffers that exceed one
  device's memory, consumed by the ppermute ring in ``parallel.ring``.

The cards of one host are joined all to all (NVLink), so no axis order is
closer than another: the mesh follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    dp: int | None = None, geom: int = 1, pp: int = 1, devices=None,
) -> Mesh:
    """Build a ("dp", "geom") mesh — or ("pp", "dp", "geom") when
    ``pp > 1`` — over ``devices`` (default: all).

    ``dp=None`` uses every remaining device after the geom/pp split. The
    trailing (geom) axis varies fastest, the pp axis (bounce-stage
    pipeline, ``parallel/pipeline.py``) slowest.
    """
    all_devices = devices is None
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        assert n % (geom * pp) == 0, (n, geom, pp)
        dp = n // (geom * pp)
    assert dp * geom * pp <= n, (dp, geom, pp, n)
    if pp > 1:
        shape, names = (pp, dp, geom), ("pp", "dp", "geom")
    else:
        shape, names = (dp, geom), ("dp", "geom")
    if all_devices and dp * geom * pp == n:
        return jax.make_mesh(shape, names)
    devs = np.asarray(devices[: dp * geom * pp]).reshape(shape)
    return Mesh(devs, axis_names=names)
