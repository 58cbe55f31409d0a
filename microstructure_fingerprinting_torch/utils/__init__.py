"""Host utilities: I/O, NIfTI, schemes, input checks, stage timing."""

from . import checks, io, nifti, profiling, scheme  # noqa: F401
