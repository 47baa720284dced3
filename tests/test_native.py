"""Native C++ loader parity vs the Python reference parsers."""

import glob
import os

import numpy as np
import pytest

from pathtracerpython_tpu.scene.arrays import _morton_argsort
from pathtracerpython_tpu.scene.native import (
    load_obj_fast,
    load_obj_native,
    morton_argsort_native,
    native_available,
)
from pathtracerpython_tpu.scene import cornell_sdl
from pathtracerpython_tpu.scene.obj import load_obj

needs_native = pytest.mark.skipif(
    not native_available(), reason="native library not built"
)


@needs_native
@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(
        os.path.dirname(cornell_sdl()), "*.obj"
    ))),
)
def test_native_obj_parity(path):
    py = load_obj(path)
    nat = load_obj_native(path)
    np.testing.assert_allclose(nat.vertices, py.vertices)
    np.testing.assert_array_equal(nat.faces, py.faces)
    np.testing.assert_allclose(nat.normals, py.normals, atol=1e-12)
    np.testing.assert_allclose(nat.areas, py.areas, atol=1e-12)


@needs_native
def test_native_obj_quirks(tmp_path):
    """Negative indices, fan triangulation, v/vt/vn forms, comments."""
    p = str(tmp_path / "t.obj")
    with open(p, "w") as f:
        f.write(
            "# comment\n"
            "v 0 0 0\n"
            "v 1 0 0\n"
            "v 1 1 0  # inline comment\n"
            "v 0 1 0\n"
            "vn 0 0 1\n"
            "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
            "f -4 -3 -2\n"
        )
    py = load_obj(p)
    nat = load_obj_native(p)
    np.testing.assert_array_equal(nat.faces, py.faces)
    assert nat.faces.shape == (3, 3)  # quad fan-split + one tri


@needs_native
def test_native_morton_matches_python():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (4096, 3))
    np.testing.assert_array_equal(
        morton_argsort_native(pts), _morton_argsort(pts)
    )


@needs_native
def test_native_missing_file_error():
    with pytest.raises(RuntimeError, match="cannot open"):
        load_obj_native("/nope/missing.obj")


def test_fast_loader_always_works(tmp_path):
    p = str(tmp_path / "s.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mesh = load_obj_fast(p)
    assert mesh.num_triangles == 1


@needs_native
def test_native_rejects_malformed_like_python(tmp_path):
    p = str(tmp_path / "bad.obj")
    with open(p, "w") as f:
        f.write("v 1,5 2 3\nv 0 0 0\nv 1 0 0\nf 1 2 3\n")
    with pytest.raises(RuntimeError, match="malformed"):
        load_obj_native(p)
    with pytest.raises(ValueError):
        load_obj(p)


@needs_native
def test_native_zero_index_parity(tmp_path):
    """'f 0' stores -1 exactly like the Python parser (numpy wraps it to
    the last vertex at use time)."""
    p = str(tmp_path / "z.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n")
    py = load_obj(p)
    nat = load_obj_native(p)
    np.testing.assert_array_equal(nat.faces, py.faces)
    np.testing.assert_allclose(nat.normals, py.normals)


@needs_native
def test_native_morton_degenerate_span_parity():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (512, 3))
    pts[:, 2] = 1.0 + rng.uniform(0, 5e-13, 512)  # span <= 1e-12
    np.testing.assert_array_equal(
        morton_argsort_native(pts), _morton_argsort(pts)
    )
