"""Hand-written GPU kernels for the hot intersection sweeps.

``intersect_triton`` holds the culled nearest-hit and any-hit sweeps
(Pallas on the Triton route). ``ops.geometry`` runs them for fast-mode
sweeps on CUDA devices and keeps its XLA sweeps as the reference
everywhere else.
"""
