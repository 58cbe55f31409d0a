"""Share of the traced fit's kernel time spent in kernels that are not
the port's hand-written ones (``trace.PORT_KERNELS``): the chunk step's
torch code (``models/graphs.py`` replays of ``ops/interp``'s rotation,
``ops/prep``, ``ops/f32scan``, ``ops/rescan``, ``ops/dfscan`` glue) and
the eager overflow tiers, over all kernel time."""

from mfbench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    total = glue = 0.0
    for name, _ts, dur in ctx.trace.kernels():
        total += dur
        if trace.port_kernel(name) is None:
            glue += dur
    return 100.0 * glue / total if total > 0 else None
