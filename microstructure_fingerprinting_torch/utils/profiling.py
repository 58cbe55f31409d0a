"""Stage timing with CUDA events.

``stage(name)`` marks a region of the fit path. It costs nothing unless a
``StageTimer`` is active; inside one, each region on a CUDA device is
bracketed by two ``torch.cuda.Event``s recorded on the current stream, so
the sums are device time between the events, without host
synchronisation inside the path. CPU regions are not timed. A region
also records the region it was opened in, so that a stage can be split
exactly into the regions nested in it (``StageTimer.inside``).

``device_trace(log_dir)`` captures a ``torch.profiler`` trace (the
counterpart of the JAX package's ``jax.profiler`` capture),
``annotate(name)`` labels a function's work in it, and ``device_ms(fn)``
reads a call's device time from such a trace.
"""

import contextlib
import functools

import torch

_ACTIVE = []


def active():
    """Whether a ``StageTimer`` is active (its regions then need the
    fit's steps run eagerly: events cannot be recorded inside a CUDA
    graph's replay)."""
    return bool(_ACTIVE)


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


def device_ms(fn, reps=3, pattern=None, warm=2, tries=3):
    """Device milliseconds a call of ``fn()``: the kernels and copies it
    puts on the card, from a ``torch.profiler`` trace (CUPTI). The trace
    holds ``warm + reps`` calls, each after a marker kernel
    (``torch.cuda._sleep``), and the launches between the last ``reps +
    1`` markers, the markers themselves left out, are summed (only those
    whose name matches the regular expression ``pattern``, where one is
    given), so that events a trace loses at its start do not count. None
    where no trace of ``tries`` holds the markers, or none holds device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + reps):
                torch.cuda._sleep(1)
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        # the device events in time order, each with its device time (0
        # for the profiler's own spans)
        evs = sorted((e.time_range.start, e.name, e.device_time_total)
                     for e in prof.events()
                     if str(e.device_type).endswith("CUDA"))
        total = marked_us(evs, reps, pattern)
        if total is not None:
            return total / 1e3 / reps if total else None
    return None


def marked_us(evs, reps, pattern=None):
    """Device microseconds of the events ``evs`` ((start, name, us) each,
    in time order) between the last ``reps + 1`` markers
    (``torch.cuda._sleep``'s ``spin_kernel``), the markers left out and,
    where ``pattern`` is given, only the names that match it; None where
    ``evs`` holds ``reps`` markers or fewer."""
    import re
    marks = [i for i, e in enumerate(evs) if "spin_kernel" in e[1]]
    if len(marks) <= reps:
        return None
    return sum(us for _t, name, us in evs[marks[-reps - 1] + 1:marks[-1]]
               if "spin_kernel" not in name
               and (pattern is None or re.search(pattern, name)))


def annotate(name):
    """Decorator: label a function's work ``name`` in profiler traces."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
