"""Idle seconds of the card inside the float64 re-score in the traced
fit: the trace's idle gaps intersected with the program's ``mf.refine``
spans, what the serial host re-score costs the card. Nothing where no
span ran."""

from mfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    refine = spans.named(ctx.trace, "refine")
    if not refine:
        return None
    return spans.seconds(spans.within(ctx.trace.gaps(), refine))
