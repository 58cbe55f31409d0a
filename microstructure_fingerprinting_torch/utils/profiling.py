"""Stage timing with CUDA events.

``stage(name)`` marks a region of the fit path. It costs nothing unless a
``StageTimer`` is active; inside one, each region on a CUDA device is
bracketed by two ``torch.cuda.Event``s recorded on the current stream, so
the sums are device time between the events, without host
synchronisation inside the path. CPU regions are not timed. A region
also records the region it was opened in, so that a stage can be split
exactly into the regions nested in it (``StageTimer.inside``).
"""

import contextlib

import torch

_ACTIVE = []


class StageTimer:
    """Collects (stage, start event, end event, enclosing stage) while
    active."""

    def __init__(self):
        self.events = []
        self.open = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def totals_ms(self):
        """Milliseconds per stage, summed over its regions (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, s, e, _parent in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out

    def inside(self, parent):
        """{stage: (milliseconds, regions)} of the regions opened directly
        inside a region of stage ``parent`` (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, s, e, p in self.events:
            if p == parent:
                ms, n = out.get(name, (0.0, 0))
                out[name] = (ms + s.elapsed_time(e), n + 1)
        return out


@contextlib.contextmanager
def stage(name, device):
    if not _ACTIVE or torch.device(device).type != "cuda":
        yield
        return
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    timer = _ACTIVE[-1]
    parent = timer.open[-1] if timer.open else None
    timer.open.append(name)
    s.record()
    try:
        yield
    finally:
        timer.open.pop()
    e.record()
    timer.events.append((name, s, e, parent))
