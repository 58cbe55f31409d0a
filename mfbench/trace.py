"""One fit under ``torch.profiler``, and what its trace says.

The trace (host and device, a Chrome trace written under the run's
temporary directory, read back and deleted) holds the fit inside a host
range ``mfbench fit`` that ends after the fit's synchronize. From it:

* the device operations (kernels, copies, fills) inside that range;
* busy time: the union of their intervals; the idle share is 1 minus
  busy over the range (``chip_smoke.idle_share``'s arithmetic, with
  copies and fills counted as busy too);
* the breakdown: device time by operation name, and the longest idle
  gaps, each named by the innermost host event that covers its middle.

``PORT_KERNELS``: the ``__global__`` functions of the port's ``csrc``
kernels (a frozen list), which the per-layer readers tell apart from
the torch code around them.
"""

import bisect
import json
import os
import re
import tempfile

import torch

PORT_KERNELS = (
    "prep_kernel", "rowmin3_kernel", "rescan3_kernel", "rowmin4_kernel",
    "rescan4_kernel", "df2scan_kernel", "df2scan_narrow", "finalize_kernel",
    "df4vox_kernel", "df4hoist_kernel", "df2vox_kernel", "df2hoist_kernel",
    "df3vox_kernel", "df3hoist_kernel", "row4vox_kernel", "row4hoist_kernel",
    "row3vox_kernel", "row3hoist_kernel", "rhsnorm_kernel", "rhspack_kernel",
    "fold_min")
_PORT = re.compile(r"\b(%s)\b" % "|".join(PORT_KERNELS))
RANGE = "mfbench fit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def port_kernel(name):
    """The port's kernel that a device event's name is, or None."""
    m = _PORT.search(name)
    return m.group(1) if m else None


class Trace:
    """The events of one traced range: ``window`` (t0, t1) in us,
    ``device`` [(name, cat, ts, dur)] and ``host`` [(name, ts, dur)]
    inside it, sorted by start."""

    def __init__(self, events):
        (win,) = [e for e in events if e.get("name") == RANGE
                  and e.get("cat") == "user_annotation"]
        t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        self.window = (t0, t1)
        self.device = sorted(
            (e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
            for e in events if e.get("cat") in DEVICE_CATS
            and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0)
        self.host = sorted(
            (float(e["ts"]), float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS
            and e.get("name") != RANGE and "dur" in e
            and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self):
        return [(n, ts, d) for n, c, ts, d in self.device if c == "kernel"]

    def busy_intervals(self):
        t0, t1 = self.window
        out = []
        for _n, _c, ts, d in sorted(self.device, key=lambda e: e[2]):
            a, b = max(ts, t0), min(ts + d, t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self):
        """Idle intervals (a, b) in us inside the window."""
        t0, t1 = self.window
        out, last = [], t0
        for a, b in self.busy_intervals():
            if a > last:
                out.append((last, a))
            last = max(last, b)
        if t1 > last:
            out.append((last, t1))
        return out

    def host_at(self, t):
        """What the host was doing at time ``t``: the shortest host event
        that covers it or, where none does (Python between torch's
        calls), the last one that ended before it."""
        starts = [h[0] for h in self.host]
        best, last = None, None
        for ts, dur, name in self.host[:bisect.bisect_right(starts, t)]:
            if ts + dur >= t and (best is None or dur < best[0]):
                best = (dur, name)
            elif ts + dur < t and (last is None or ts + dur > last[0]):
                last = (ts + dur, name)
        if best:
            return best[1]
        return "python after " + last[1] if last else "python"

    def breakdown(self, top=10):
        """The ``top`` device operations by time (the port's kernels by
        their name, the others by the first 96 characters of theirs),
        and the ``top`` longest idle gaps, each named by ``host_at`` its
        middle; seconds each."""
        by_name = {}
        for n, _c, _ts, d in self.device:
            short = port_kernel(n) or n[:96]
            by_name[short] = by_name.get(short, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        idle = [[self.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def traced(fn):
    """Run ``fn()`` (which ends in a synchronize) under the profiler;
    returns (fn's result, ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(RANGE):
                out = fn()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace(events)
