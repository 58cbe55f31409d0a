"""Host seconds the traced fit spent in blocking reads from the card:
the union of the program's ``mf.pull`` spans (``models/fit.py``: the
general path's joined results, the fast path's overflow flags and
results). Nothing where no span ran."""

from mfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    pull = spans.named(ctx.trace, "pull")
    return spans.seconds(pull) if pull else None
