"""Host seconds of the float64 re-score in the traced fit: the union of
the program's ``mf.refine`` spans (``models/refine.refine_candidates``
of the general path's buckets). Nothing where no span ran."""

from mfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    refine = spans.named(ctx.trace, "refine")
    return spans.seconds(refine) if refine else None
