"""Device meshes: voxel data parallelism over cards and processes, and
the atoms-axis split of the exhaustive candidate scan."""

from . import mesh  # noqa: F401
