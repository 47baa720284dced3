"""Radiance → image conversion.

Reference contract (``utils.py:150-161``): the flat pixel list is written
into the canvas as ``mat[height-1-j, i]`` with ``i = counter // width`` and
``j = counter % width`` — derived with *width* for both even though the
camera's inner loop runs over *height*, so the mapping is only correct for
square images (where it lands as x→column, y→row-flipped). Then the whole
canvas is globally min-max normalized (max taken AFTER the min subtraction)
and scaled to uint8. The SDL ``tonemapping`` value is ignored.

We reproduce that exactly for square images (mode="reference") and provide a
sane row-major mapping + selectable normalization as the default.
"""

from __future__ import annotations

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np


def radiance_to_canvas(radiance: jax.Array, width: int, height: int):
    """Flat x-outer/y-inner radiance [W*H, 3] → canvas [H, W, 3] (float).

    Equivalent to the reference's index math for square images; correct for
    non-square ones (which the reference garbles — SURVEY.md §2.4-7).
    """
    grid = jnp.reshape(radiance, (width, height, 3))  # [ix, iy, 3]
    return jnp.flip(jnp.transpose(grid, (1, 0, 2)), axis=0)  # [H-1-iy, ix]


def normalize_minmax(canvas):
    """The reference's global min-max auto-normalization (utils.py:158-159):
    subtract the min, then divide by the max of the SHIFTED canvas. A
    constant canvas (all-background render) maps to zeros rather than the
    0/0 NaNs the raw formula would produce."""
    shifted = canvas - jnp.min(canvas)
    peak = jnp.max(shifted)
    return shifted / jnp.where(peak == 0.0, 1.0, peak)


def radiance_to_image(
    radiance, width: int, height: int, normalization: str = "minmax",
    tonemapping: float | None = None,
) -> np.ndarray:
    """uint8 [H, W, 3] image. normalization: "minmax" (reference) | "clip".

    ``tonemapping``: opt-in gamma from the SDL's parsed-but-ignored
    ``tonemapping`` record (CLI --honor-sdl): the normalized canvas is
    raised to 1/tonemapping. The SDL value 1.0 is the identity, matching
    the reference's behavior of ignoring it.
    """
    canvas = radiance_to_canvas(radiance, width, height)
    if normalization == "minmax":
        canvas = normalize_minmax(canvas)
    elif normalization == "clip":
        canvas = jnp.clip(canvas, 0.0, 1.0)
    else:
        raise ValueError(normalization)
    if tonemapping is not None and tonemapping > 0.0 and tonemapping != 1.0:
        canvas = jnp.power(canvas, 1.0 / tonemapping)
    return np.asarray(canvas * 255.0).astype(np.uint8)


def png_bytes(image: np.ndarray) -> bytes:
    """Encode a uint8 [H, W, 3] image as an 8-bit RGB PNG (zlib only)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(image: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(image))
