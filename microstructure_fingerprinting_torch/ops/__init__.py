"""Operators of the fit path: rotation, double-float primitives, and the
three hand-written kernels (prep, row pass, re-scan) with their plain
PyTorch twins."""

from . import df32, dfscan, f32scan, interp, kernels, math3d  # noqa: F401
from . import nnls, prep, rescan  # noqa: F401
