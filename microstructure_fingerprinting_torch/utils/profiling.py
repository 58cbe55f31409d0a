"""Stage timing with CUDA events.

``stage(name)`` marks a region of the fit path. It costs nothing unless a
``StageTimer`` is active; inside one, each region on a CUDA device is
bracketed by two ``torch.cuda.Event``s recorded on the current stream, so
the sums are device time between the events, without host
synchronisation inside the path. CPU regions are not timed.
"""

import contextlib

import torch

_ACTIVE = []


class StageTimer:
    """Collects (stage, start event, end event) while active."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def totals_ms(self):
        """Milliseconds per stage, summed over its regions (synchronizes)."""
        torch.cuda.synchronize()
        out = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


@contextlib.contextmanager
def stage(name, device):
    if not _ACTIVE or torch.device(device).type != "cuda":
        yield
        return
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    yield
    e.record()
    _ACTIVE[-1].events.append((name, s, e))
