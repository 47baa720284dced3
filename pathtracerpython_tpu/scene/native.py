"""ctypes bindings for the native (C++) scene data-loader.

``native/objparse.cpp`` reimplements the Python OBJ parser's semantics
at C++ speed for large meshes (identical on well-formed files; strtod
rejects a few exotic numeric forms Python ``float()`` accepts, e.g.
digit underscores — those fall back to the Python parser's behavior only
by erroring here). This module loads the shared library from
``native/build/`` (git-ignored), building it with ``make`` first whenever
it is missing or older than its source, and falls back to the pure-Python
parser when the toolchain is unavailable — callers never fail because the
native tier is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC_PATH = os.path.join(_NATIVE_DIR, "objparse.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libptpt_native.so")


def _stale() -> bool:
    """The library is missing or older than its source."""
    if not os.path.exists(_LIB_PATH):
        return True
    return (os.path.exists(_SRC_PATH)
            and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH))


_lib = None
_lib_tried = False


def _load_library():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if _stale() and os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True,
                capture_output=True, timeout=120,
            )
        except Exception as e:  # toolchain missing/broken: fall back
            warnings.warn(f"native loader build failed ({e}); "
                          "using the Python parser")
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.obj_parse.restype = ctypes.c_int
    lib.obj_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.obj_buffers_free.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.morton_argsort.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def load_obj_native(path: str):
    """Parse an OBJ with the native loader; returns an ObjMesh.

    Raises RuntimeError on parse errors; raises OSError if the native
    library is unavailable (use ``load_obj_fast`` for auto-fallback).
    """
    from pathtracerpython_tpu.scene.obj import mesh_from_arrays

    lib = _load_library()
    if lib is None:
        raise OSError("native loader unavailable")

    verts_p = ctypes.POINTER(ctypes.c_double)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int64()
    n_faces = ctypes.c_int64()
    err = ctypes.create_string_buffer(512)
    rc = lib.obj_parse(
        path.encode(), ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(faces_p), ctypes.byref(n_faces), err, len(err),
    )
    if rc != 0:
        raise RuntimeError(err.value.decode())
    try:
        nv, nf = n_verts.value, n_faces.value
        verts = np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() \
            if nv else np.zeros((0, 3))
        faces = np.ctypeslib.as_array(faces_p, shape=(nf, 3)).copy() \
            if nf else np.zeros((0, 3), np.int32)
    finally:
        lib.obj_buffers_free(verts_p, faces_p)
    return mesh_from_arrays(verts, faces, path=path)


def load_obj_fast(path: str):
    """Native OBJ parse when available, Python parser otherwise."""
    from pathtracerpython_tpu.scene.obj import load_obj

    if native_available():
        return load_obj_native(path)
    return load_obj(path)


def morton_argsort_native(points: np.ndarray) -> np.ndarray:
    """Native Z-order argsort of [N, 3] points (same permutation as
    ``scene.arrays._morton_argsort``)."""
    lib = _load_library()
    if lib is None:
        raise OSError("native loader unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    out = np.empty(pts.shape[0], dtype=np.int64)
    lib.morton_argsort(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out
