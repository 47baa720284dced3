"""Row lookup as a gather or as a one-hot matrix product.

``take_rows`` and friends look up per-ray table rows (materials, triangle
attributes, light vertices) either with a plain gather or, for small
tables, as a one-hot ``[N, R] @ [R, C]`` product whose transpose (the
scatter-add of gradients into the table) is again a product. The plain
gather is the default; the packed one-hot path is the correctness
mechanism for shard-local attribute resolution (ring mode) and a knob for
gather-bound scenes.

Every one-hot product here runs at ``Precision.HIGHEST``: a 0/1 product
is only a gather if the data operand stays exact, and a default-precision
f32 product may run in a reduced format (TF32 on the GPU). Rounding the
gathered values is a real bug, not noise: the Cornell light's y=3.836
rounded to 3.84375 lies above the ceiling at 3.8416, which self-occludes
every NEE shadow ray. CPU products are exact, so only device runs see it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Max table rows for the one-hot path. Memory for the one-hot operand is
# N x rows x 4B (e.g. 262k rays x 128 rows = 134 MB, transient).
# Default 0 = always use real gathers, which XLA fuses into their
# consumers.
ONEHOT_ROWS = 0


def take_rows(table: jax.Array, idx: jax.Array,
              onehot_rows: int | None = None) -> jax.Array:
    """``table[idx]``, as a one-hot product for tables of at most
    ``onehot_rows`` rows.

    table: [R, ...c] float array; idx: integer array of any shape.
    Returns [*idx.shape, ...c]. Differentiable w.r.t. ``table`` (the
    one-hot transpose is the exact scatter-add a gather would need).
    """
    if onehot_rows is None:
        onehot_rows = ONEHOT_ROWS  # read at call time: tunable/testable
    r = table.shape[0]
    if r > onehot_rows:
        return table[idx]
    flat_idx = idx.reshape(-1)
    onehot = (
        flat_idx[:, None] == jnp.arange(r, dtype=flat_idx.dtype)[None, :]
    ).astype(table.dtype)
    flat_tab = table.reshape(r, -1)
    out = jnp.dot(onehot, flat_tab, preferred_element_type=table.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return out.reshape(idx.shape + table.shape[1:])


def cm_take(table_cm: jax.Array, idx: jax.Array,
            onehot_rows: int = 128) -> jax.Array:
    """Component-major lookup: table_cm [C, R] indexed by ``idx`` of any
    shape → [C, *idx.shape], minor-dim DENSE.

    For small R this is a [C, R] @ [R, K] one-hot product whose output is
    born component-major (a row-major gather would build a [K, C] result
    and transpose it); large R falls back to the gather. Which of the two
    is faster on the GPU has not been measured yet.
    """
    c, r = table_cm.shape
    flat = idx.reshape(-1)
    if r > onehot_rows:
        out = table_cm[:, flat]
    else:
        onehot = (
            flat[None, :] == jnp.arange(r, dtype=flat.dtype)[:, None]
        ).astype(table_cm.dtype)
        out = jnp.dot(table_cm, onehot,
                      preferred_element_type=table_cm.dtype,
                      precision=jax.lax.Precision.HIGHEST)
    return out.reshape((c,) + idx.shape)


def take_columns_packed(tables: list[jax.Array], idx: jax.Array,
                        onehot_rows: int | None = None) -> list[jax.Array]:
    """Look up the same rows of several [R, ...] float tables with ONE
    matmul: concatenates columns, takes rows, splits back.

    In gather mode (table too big / one-hot disabled) this does SEPARATE
    direct gathers — packing + re-slicing would materialize intermediates
    that XLA otherwise fuses straight into consumers."""
    if onehot_rows is None:
        onehot_rows = ONEHOT_ROWS
    if tables[0].shape[0] > onehot_rows:
        return [t[idx] for t in tables]
    cols = []
    shapes = []
    for t in tables:
        flat = t.reshape(t.shape[0], -1)
        shapes.append(t.shape[1:])
        cols.append(flat)
    packed = jnp.concatenate(cols, axis=1)
    taken = take_rows(packed, idx, onehot_rows)
    out = []
    start = 0
    for flat, shape in zip(cols, shapes):
        width = flat.shape[1]
        piece = taken[..., start:start + width]
        out.append(piece.reshape(idx.shape + shape))
        start += width
    return out
