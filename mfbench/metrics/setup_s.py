"""Seconds from the process's start to the window's: the volumes made,
the model built, the kernel library built or loaded and one warm fit
(the CUDA graphs' captures)."""


def read(ctx):
    return ctx.setup_s
