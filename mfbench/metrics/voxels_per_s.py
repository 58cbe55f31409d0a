"""Masked voxels of every fit completed in the window over the host time
from the window's start to the last fit's synchronize."""


def read(ctx):
    return ctx.voxels_done / ctx.window_s
