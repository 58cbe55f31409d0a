"""Operators of the fit path: rotation, double-float primitives, and the
five hand-written kernels (prep; the row passes and the re-scans of the
[N1, N2, 1] and EAR configurations) with their plain PyTorch twins."""

from . import df32, dfscan, f32scan, interp, kernels, math3d  # noqa: F401
from . import nnls, prep, rescan  # noqa: F401
