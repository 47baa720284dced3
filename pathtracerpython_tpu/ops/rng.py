"""Dense counter-based RNG (Threefry-2x32) on lane-major arrays.

Why not ``jax.vmap(jax.random.fold_in)`` + per-ray key arrays: keys here
are scalar pairs and per-ray streams are generated by hashing dense [N]
uint32 counter vectors, so no [N, 2] key array is ever built and every
array touched is minor-dim-dense.

Stream identity: ``uniforms(key, salt, counters, D)`` draws D uniforms per
counter, where the counter is a GLOBAL id (pixel id); a sharded render
hashing its local slice of global ids draws exactly the numbers the
single-device render does — shard-invariance by construction.

Threefry-2x32 (Salmon et al. 2011, "Parallel random numbers: as easy as
1, 2, 3") with the standard 20 rounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
# plain int, converted at trace time: a module-level jnp constant would
# initialize the XLA backend at import, which must not happen before
# jax.distributed.initialize on multi-process runs (parallel/multihost.py)
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Hash counter vectors (x0, x1) under key (k0, k1); all uint32,
    broadcastable. Returns (y0, y1)."""
    k0 = jnp.uint32(k0) if not hasattr(k0, "dtype") else k0.astype(jnp.uint32)
    k1 = jnp.uint32(k1) if not hasattr(k1, "dtype") else k1.astype(jnp.uint32)
    x0 = x0.astype(jnp.uint32)
    x1 = x1.astype(jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))

    x0 = x0 + ks[0]
    x1 = x1 + ks[1]

    def rotl(x, r):
        return (x << r) | (x >> (32 - r))

    for block in range(5):
        rots = _ROT[0:4] if block % 2 == 0 else _ROT[4:8]
        for r in rots:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + jnp.uint32(block + 1)
    return x0, x1


def key_from_seed(seed) -> tuple[jax.Array, jax.Array]:
    """(k0, k1) scalar uint32 pair from an int seed or a jax PRNGKey.

    An int seed yields the same pair as ``jax.random.PRNGKey(seed)``
    ((seed >> 32, seed & 0xffffffff), jax's threefry_seed), so callers may
    mix the two forms freely without changing the stream.
    """
    if hasattr(seed, "dtype") and jnp.ndim(seed) == 0 \
            and jnp.issubdtype(seed.dtype, jnp.integer):
        if isinstance(seed, jax.core.Tracer):
            # traced scalar: no host value; uint64 is unavailable without
            # x64, so only the low 32 bits participate (documented limit —
            # matches PRNGKey for seeds < 2^32)
            return jnp.uint32(0), seed.astype(jnp.uint32)
        seed = int(seed)  # concrete numpy/jax scalar: exact 64-bit path
    if hasattr(seed, "dtype"):
        data = jax.random.key_data(seed)
        return data[0].astype(jnp.uint32), data[1].astype(jnp.uint32)
    s = int(seed)
    return (
        jnp.uint32((s >> 32) & 0xFFFFFFFF),
        jnp.uint32(s & 0xFFFFFFFF),
    )


def fold(k0, k1, salt: int | jax.Array):
    """Derive a sub-key: hash the salt under the parent key."""
    salt = jnp.asarray(salt, jnp.uint32)
    return threefry2x32(k0, k1, salt, jnp.uint32(0x736F6C74))


def _to_unit_interval(bits):
    """uint32 -> float32 in [0, 1): set mantissa, subtract 1."""
    f = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(f, jnp.float32) - 1.0


def uniforms(k0, k1, counters, n_draws: int):
    """[n_draws, *counters.shape] float32 uniforms in [0, 1).

    Draws 2k and 2k+1 for counter c are the (y0, y1) outputs of the single
    hash threefry(key, (c, k)) — every draw depends only on the key and
    the GLOBAL counter value, never on array position.
    """
    counters = counters.astype(jnp.uint32)
    out = []
    for d in range(0, n_draws, 2):
        y0, y1 = threefry2x32(k0, k1, counters, jnp.uint32(d >> 1))
        out.append(_to_unit_interval(y0))
        if d + 1 < n_draws:
            out.append(_to_unit_interval(y1))
    return jnp.stack(out, axis=0)
