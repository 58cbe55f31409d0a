"""Operators of the fit path: rotation, double-float primitives, the
seven hand-written kernels (prep; the row passes and the re-scans of the
[N1, N2, 1] and EAR configurations; the [N1, N2] df2 scan; the
double-float finalize) with their plain PyTorch twins, and
the host-side tensor/peak conversions."""

from . import df32, dfscan, dti, f32scan, interp, kernels, math3d  # noqa: F401
from . import nnls, prep, rescan  # noqa: F401
