"""Host seconds of the fast path's exact selection in the traced fit: the
union of the program's ``mf.certify`` spans (the float64 re-score of a
chunk's near-ties) and ``mf.certify fallback`` spans (the exhaustive
float64 solve of the voxels the re-score cannot take), both in
``models/fit.run_bucket_fast``. Nothing where no span ran (a program
without them, or a fit that re-scored nothing)."""

from mfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    got = (spans.named(ctx.trace, "certify")
           + spans.named(ctx.trace, "certify fallback"))
    return spans.seconds(got) if got else None
