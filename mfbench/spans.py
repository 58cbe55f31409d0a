"""The program's own spans in the traced fit.

The port marks each layer boundary of its fit path with a span
(``microstructure_fingerprinting_torch/utils/profiling.stage``); under
the profiler a span is a host ``user_annotation`` event named ``"mf."``
and the span's name, on the clock of the device events. The readers of
``metrics/`` take them from ``trace.Trace.host`` and combine them with
the trace's idle gaps. Intervals are (start, end) in microseconds.
"""

PREFIX = "mf."


def named(tr, name, prefix=False):
    """The intervals of the spans ``name`` in the trace ``tr`` (with
    ``prefix``, of every span whose name starts with ``name``)."""
    want = PREFIX + name
    return [(ts, ts + dur) for ts, dur, n in tr.host
            if (n.startswith(want) if prefix else n == want)]


def union(intervals):
    """The intervals merged where they overlap, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def seconds(intervals):
    """Seconds covered by the intervals (overlaps counted once)."""
    return sum(b - a for a, b in union(intervals)) / 1e6


def within(intervals, bounds):
    """The parts of ``intervals`` that lie inside ``bounds``."""
    out = []
    for a, b in union(intervals):
        for lo, hi in union(bounds):
            if min(b, hi) > max(a, lo):
                out.append((max(a, lo), min(b, hi)))
    return out
