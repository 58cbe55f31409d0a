"""Stage timing with CUDA events.

``stage(name)`` marks a region of the fit path. It costs nothing unless a
``StageTimer`` is active; inside one, each region on a CUDA device is
bracketed by two ``torch.cuda.Event``s recorded on the current stream, so
the sums are device time between the events, without host
synchronisation inside the path. CPU regions are not timed. A region
also records the region it was opened in, so that a stage can be split
exactly into the regions nested in it (``StageTimer.inside``).

``device_trace(log_dir)`` captures a ``torch.profiler`` trace (the
counterpart of the JAX package's ``jax.profiler`` capture) and
``annotate(name)`` labels a function's work in it.
"""

import contextlib
import functools

import torch

_ACTIVE = []


def _synchronize():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


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
        """Milliseconds per stage, summed over its regions (synchronizes
        every card)."""
        _synchronize()
        out = {}
        for name, s, e, _parent in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out

    def inside(self, parent):
        """{stage: (milliseconds, regions)} of the regions opened directly
        inside a region of stage ``parent`` (synchronizes every card)."""
        _synchronize()
        out = {}
        for name, s, e, p in self.events:
            if p == parent:
                ms, n = out.get(name, (0.0, 0))
                out[name] = (ms + s.elapsed_time(e), n + 1)
        return out


@contextlib.contextmanager
def stage(name, device):
    """A region of stage ``name`` on ``device``: timed, under a
    ``StageTimer``, on that device's current stream."""
    dev = torch.device(device)
    if not _ACTIVE or dev.type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(dev)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    timer = _ACTIVE[-1]
    parent = timer.open[-1] if timer.open else None
    timer.open.append(name)
    s.record(stream)
    try:
        yield
    finally:
        timer.open.pop()
    e.record(stream)
    timer.events.append((name, s, e, parent))


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a ``torch.profiler`` trace of the host and, where CUDA is
    available, the card, written under ``log_dir`` as a Chrome trace
    (a ``*.pt.trace.json`` file, readable in Perfetto or
    TensorBoard). Yields the profiler.

    >>> with device_trace('traces'):
    ...     model.fit(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def annotate(name):
    """Decorator: label a function's work ``name`` in profiler traces."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
