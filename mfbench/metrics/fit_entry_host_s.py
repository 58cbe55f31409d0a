"""Host seconds of the fit entry in the traced fit: the program's
``mf.fit`` span (``MFModel.fit``) less the union of its ``mf.bucket
...`` spans inside it (each bucket's dispatch and pull), which leaves
marshalling, bucketing and the maps' assembly. Nothing where no span
ran."""

from mfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    fit = spans.named(ctx.trace, "fit")
    if not fit:
        return None
    buckets = spans.named(ctx.trace, "bucket ", prefix=True)
    return spans.seconds(fit) - spans.seconds(spans.within(buckets, fit))
