"""Scene I/O: SDL + OBJ parsing into flat SoA arrays.

Replaces the reference's ``scene_reader.py`` (object dicts of ``V``-tuples)
with numpy SoA buffers ready for device upload. The Cornell box ships with
the package (``cornell/``); ``cornell_sdl()`` returns its path.
"""

import os

from pathtracerpython_tpu.scene.obj import ObjMesh, load_obj  # noqa: F401
from pathtracerpython_tpu.scene.sdl import SceneDescription, load_sdl  # noqa: F401
from pathtracerpython_tpu.scene.arrays import (  # noqa: F401
    SceneArrays,
    SceneMeta,
    load_scene,
    pack_scene,
)


def cornell_sdl() -> str:
    """Path of the packaged Cornell box (``cornell/cornellroom.sdl``)."""
    return os.path.join(os.path.dirname(__file__), "cornell", "cornellroom.sdl")
