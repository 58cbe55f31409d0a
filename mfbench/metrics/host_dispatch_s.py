"""Host seconds from a fit's start to its "All .. dispatched" line
(``verbose=2``): marshalling, bucketing, the pushes and every chunk's
graph replay enqueued (``models/mf.py``, ``models/fit.run_bucket_fast``
with ``defer=True``). The median over the window's untraced fits, or the
traced fit's where it is the only one."""

import statistics


def read(ctx):
    fits = [f for f in ctx.fits if f["dispatch_s"] is not None]
    plain = [f["dispatch_s"] for f in fits if not f["traced"]]
    xs = plain or [f["dispatch_s"] for f in fits]
    return statistics.median(xs) if xs else None
