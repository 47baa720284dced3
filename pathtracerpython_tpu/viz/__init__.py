"""Offline debug visualization (replaces the reference's interactive
pyqtgraph/OpenGL viewer, ``plot.py`` — accelerator hosts have no
display)."""

from pathtracerpython_tpu.viz.plot import plot_scene

__all__ = ["plot_scene"]
