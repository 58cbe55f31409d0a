"""Run one cell of the benchmark once.

    python3 -m mfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The cell
(``BENCHMARK.json``'s ``workloads``, or ``mfbench/held_out.json``'s for a
cell kept out of the benchmark) names a configuration
(``mfbench/configs/<config>.json``) and a traffic mix
(``mfbench/traffic/<traffic>.json``, whose ``fit`` keywords, if any, go
to every fit); each metric is read by ``mfbench/metrics/<metric>.py``,
found by its name.

Set-up (``setup_s``, from the process's start): the dictionary and two
volumes of the mix made from the seed on the card, ``MFModel``, and one
warm fit of up to two chunks of each bucket of the first volume, which
builds the kernel library (``build/mf_torch_kernels/`` in the checkout,
reused by later runs there) and captures each chunk step's CUDA graph.

The window: ``MFModel.fit`` as a user calls it (``peaks=``,
``pgse_scheme=``, ``csf_mask=``, ``ear_mask=``, the default chunk and
solver), on the two volumes in turn, back to back, one caller, each fit
ending in ``torch.cuda.synchronize()``; a fit starts while less than
``--seconds`` have passed since the window opened. With ``--trace 1``
the window's first fit runs under ``torch.profiler`` and every fit at
``verbose=2`` (its lines kept, not printed), and the per-layer metrics
are reported instead of the end-to-end ones.

After the window: the peak device memory, the program's state freed,
then the comparison (``judge.py``) of what the window's fits returned
against the plain reference (``reference.py``) on the card. The last
lines of standard error give each number compared beside its limit;
the last line of standard output is the result.

    python3 -m mfbench --workload <name> --seed <n> --control

reads the control instead (not a benchmark run): voxels drawn from the
seed's two volumes as a run draws them, fitted once by the program's
float32 path (``CONTROL_FIT``) and judged alike; its last line has
``correct`` and ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse                                                # noqa: E402
import contextlib                                              # noqa: E402
import gc                                                      # noqa: E402
import importlib.util                                          # noqa: E402
import io                                                      # noqa: E402
import json                                                    # noqa: E402
import os                                                      # noqa: E402
import re                                                      # noqa: E402
import subprocess                                              # noqa: E402
import sys                                                     # noqa: E402

import numpy as np                                             # noqa: E402

from . import dictionary, generator, judge, trace              # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "microstructure_fingerprinting_tpu")
#: warm-up: chunks of each bucket fitted before the window
WARM_CHUNKS = 2
#: the control's fit keywords: the general path's float32 scans, their
#: winner kept (no float64 re-score)
CONTROL_FIT = {"engine": "xla", "refine": False}
#: the fit's default fast-path chunk (``MFModel.fit``), for the counters
BATCH = 512
#: entry points of ``ops/kernels`` that launch one kernel each: the
#: kernel's name in a trace
TRACE_CHECKED = {"prep_block": "prep_kernel", "rowmin3": "rowmin3_kernel",
                 "rowmin4": "rowmin4_kernel", "finalize": "finalize_kernel"}
_DISPATCHED = re.compile(r"All \d+ bucket\(s\) dispatched in ([0-9.eE+-]+) "
                         r"second")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A workload with its configuration, traffic mix, the limits of its
    comparison (``limits/<workload>.json``) and metrics (the entries of
    ``end_to_end`` and ``per_layer`` it reports)."""

    def __init__(self, name, cfg, traffic, limits, end_to_end, per_layer,
                 chips=1):
        self.name, self.cfg, self.traffic = name, cfg, traffic
        self.limits = limits
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.chips = chips

    @classmethod
    def load(cls, name):
        """The workload ``name`` of the checkout's ``BENCHMARK.json``, or
        of ``held_out.json`` (a cell kept out of the benchmark, with its
        own per-layer metrics)."""
        bench = _json(ROOT, "BENCHMARK.json")
        held = _json(HERE, "held_out.json")
        here = lambda m: name in m.get("workloads", [name])
        per_layer = [m for m in bench["per_layer"] if here(m)]
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            found = [w for w in held["workloads"] if w["name"] == name]
            have = {m["name"] for m in per_layer}
            per_layer += [m for m in held["per_layer"]
                          if here(m) and m["name"] not in have]
        if not found:
            raise SystemExit("mfbench: no workload %r in BENCHMARK.json"
                             % name)
        wl = found[0]
        return cls(name, _json(HERE, "configs", wl["config"] + ".json"),
                   _json(HERE, "traffic", wl["traffic"] + ".json"),
                   _json(HERE, "limits", name + ".json"),
                   [m for m in bench["end_to_end"] if here(m)],
                   per_layer, wl["chips"])

    def fit_kw(self, extra=None):
        """Keyword arguments of every fit: the traffic mix's ``fit``,
        then ``extra``."""
        return dict(self.traffic.get("fit", {}), **(extra or {}))


def reader(name):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What the metric readers read: the cell, the window's fits
    (``fits``: vol, wall_s, launches, dispatch_s, traced), the traced
    fit's ``trace`` (``trace.Trace``), the bucket counts, the window's
    length and voxels, and the set-up time."""

    def __init__(self, cell, batch):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        #: every volume of a mix holds the same buckets
        self.bucket_counts = generator.bucket_counts(cell.traffic)
        self.batch = batch
        self.samples = None
        self.fits = []
        self.trace = None
        self.window_s = self.voxels_done = self.setup_s = None

    def kernel_roofline(self, kernel, bound_ms):
        """100 x ``bound_ms`` over the traced fit's device time of the
        port's kernel ``kernel``; None where it did not run."""
        if self.trace is None or bound_ms <= 0:
            return None
        ms = sum(d for name, _ts, d in self.trace.kernels()
                 if trace.port_kernel(name) == kernel) / 1e3
        return 100.0 * bound_ms / ms if ms > 0 else None


def _fit_args(vol, sch):
    kw = dict(peaks=vol["peaks"], pgse_scheme=sch, csf_mask=vol["csf_mask"])
    if vol["ear_mask"] is not None:
        kw["ear_mask"] = vol["ear_mask"]
    return (vol["data"], vol["mask"], vol["numfasc"]), kw


def _warm_volume(vol, chunks, batch):
    """Up to ``chunks`` chunks of each bucket of ``vol``."""
    keep = np.concatenate([
        np.flatnonzero(np.all(vol["bucket"] == b, axis=1))[:chunks * batch]
        for b in np.unique(vol["bucket"], axis=0)])
    keep.sort()
    return {k: (v[keep] if isinstance(v, np.ndarray) else v)
            for k, v in vol.items()}


def card_line():
    """The card's name and power limit (``nvidia-smi``), or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi: %s" % e
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run_cell(cell, seed, seconds, trace_on, device="cuda", t_start=None,
             fit_kw=None, log=sys.stderr):
    """One run of ``cell``: returns (result dict, [(number, reading,
    limit), ...]). ``fit_kw`` adds keyword arguments to every fit (the
    CPU tests' small chunk); ``t_start`` is when set-up began."""
    import torch
    from microstructure_fingerprinting_torch import MFModel
    from microstructure_fingerprinting_torch.models import graphs
    from microstructure_fingerprinting_torch.ops import kernels

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fit_kw = cell.fit_kw(fit_kw)
    batch = fit_kw.get("batch_size") or BATCH
    cfg, traffic = cell.cfg, cell.traffic
    ctx = Context(cell, batch)

    marks = [("start", t_start), ("imports", time.perf_counter())]
    vols = generator.volumes(cfg, traffic, seed, dev)
    sync()
    marks.append(("volumes", time.perf_counter()))
    sch, dic = dictionary.build(cfg)
    ctx.samples = sch.shape[0]
    with contextlib.redirect_stdout(log):
        model = MFModel(dic, device=device)
    args_kw = [_fit_args(v, sch) for v in vols]
    marks.append(("model", time.perf_counter()))
    warm_a, warm_kw = _fit_args(_warm_volume(vols[0], WARM_CHUNKS, batch),
                                sch)
    model.fit(*warm_a, verbose=0, **warm_kw, **fit_kw)
    sync()
    marks.append(("warm_fit", time.perf_counter()))
    ctx.setup_s = marks[-1][1] - t_start
    print("mfbench: %s seed %d set-up %.3f s (%s; %s)" % (
        cell.name, seed, ctx.setup_s, " ".join(
            "%s %.3f" % (n, t - t0) for (n, t), (_m, t0)
            in zip(marks[1:], marks)), card_line() if cuda else device),
        file=log)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    k = 0
    while True:
        v = k % len(vols)
        traced = bool(trace_on) and k == 0
        kernels.reset_counts()
        lines = io.StringIO()

        def one():
            with contextlib.redirect_stdout(lines):
                f = model.fit(*args_kw[v][0], verbose=2 if trace_on else 0,
                              **args_kw[v][1], **fit_kw)
            sync()
            return f

        ts = time.perf_counter()
        if traced:
            fit, ctx.trace = trace.traced(one)
        else:
            fit = one()
        te = time.perf_counter()
        m = _DISPATCHED.search(lines.getvalue())
        ctx.fits.append({"vol": v, "maps": judge.maps_of(fit),
                         "wall_s": te - ts, "traced": traced,
                         "launches": dict(kernels.LAUNCHES),
                         "dispatch_s": float(m.group(1)) if m else None})
        del fit
        k += 1
        if te - t0 >= seconds:
            break
    ctx.window_s = te - t0
    ctx.voxels_done = sum(int(np.sum(vols[f["vol"]]["mask"] > 0))
                          for f in ctx.fits)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print("mfbench: %d fits in %.3f s, walls %s" % (
        len(ctx.fits), ctx.window_s,
        " ".join("%.3f" % f["wall_s"] for f in ctx.fits)), file=log)
    if ctx.trace is not None:
        _check_trace(ctx, log)

    del model
    graphs.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, read, per_bucket = judge.judge(cfg, traffic, vols, ctx.fits,
                                            seed, dev)
    correct, failed, rows = judge.verdict(numbers, read, cell.limits)
    for key, nums in per_bucket.items():
        print("mfbench: bucket %s %s" % (key, " ".join(
            "%s %.6g" % kv for kv in nums.items())), file=log)

    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s()
        info["window_s"] = ctx.trace.window_s
    result = {"correct": correct,
              "attempted": ctx.voxels_done, "failed": failed,
              "metrics": metrics, "device": info}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {name: {"value": value, "limit": lim}
                        for name, value, lim in rows}
    return result, rows


def control_run(cell, seed, device="cuda", fit_kw=None, log=sys.stderr):
    """The control's readings for ``seed``: voxels drawn as a run's
    comparison draws them, from one fit of each of the cell's two
    volumes, each volume's drawn voxels fitted once by the program's float32 path
    (``CONTROL_FIT`` over the traffic's ``fit``, then ``fit_kw``) and
    judged as a run judges. Returns (correct, [(number, reading, limit),
    ...])."""
    import torch
    from microstructure_fingerprinting_torch import MFModel

    dev = torch.device(device)
    cfg, traffic = cell.cfg, cell.traffic
    vols = generator.volumes(cfg, traffic, seed, dev)
    sch, dic = dictionary.build(cfg)
    drawn = judge.sample(traffic, vols, [{"vol": v} for v in
                                         range(len(vols))], seed)
    with contextlib.redirect_stdout(log):
        model = MFModel(dic, device=device)
    kw = cell.fit_kw(dict(CONTROL_FIT, **(fit_kw or {})))
    subs, fits = [], []
    for v, vol in enumerate(vols):
        idx = np.sort([x for pairs in drawn.values() for i, x in pairs
                       if i == v]).astype(np.int64)
        if not idx.size:
            continue
        sub = {k: (a[idx] if isinstance(a, np.ndarray) else a)
               for k, a in vol.items()}
        a, fkw = _fit_args(sub, sch)
        with contextlib.redirect_stdout(log):
            fit = model.fit(*a, verbose=0, **fkw, **kw)
        fits.append({"vol": len(subs), "maps": judge.maps_of(fit)})
        subs.append(sub)
    every = dict(traffic, judge={k: len(p) for k, p in drawn.items()})
    numbers, read, per_bucket = judge.judge(cfg, every, subs, fits, seed,
                                            dev)
    for key, nums in per_bucket.items():
        print("mfbench: control bucket %s %s" % (key, " ".join(
            "%s %.6g" % kv for kv in nums.items())), file=log)
    correct, _failed, rows = judge.verdict(numbers, read, cell.limits)
    return correct, rows


def _check_trace(ctx, log):
    """Say on ``log`` how many launches of some of the port's kernels the
    trace holds against those the traced fit counted (a trace that lost
    events reads fewer)."""
    seen = {}
    for name, _ts, _d in ctx.trace.kernels():
        k = trace.port_kernel(name)
        seen[k] = seen.get(k, 0) + 1
    counted = [f for f in ctx.fits if f["traced"]][0]["launches"]
    pairs = " ".join("%s %d/%d" % (k, seen.get(g, 0), counted.get(k, 0))
                     for k, g in TRACE_CHECKED.items())
    print("mfbench: traced launches/counted: %s; %d device events, window "
          "%.3f s, busy %.3f s" % (pairs, len(ctx.trace.device),
                                   ctx.trace.window_s, ctx.trace.busy_s()),
          file=log)


def loaded_forbidden():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="read the control, not a benchmark run")
    args = ap.parse_args(argv)
    if args.seconds is None and not args.control:
        ap.error("--seconds is required")
    cell = Cell.load(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print("mfbench: %s needs %d CUDA device(s), found %d"
              % (cell.name, cell.chips, have), file=sys.stderr)
        return 2
    if args.control:
        correct, rows = control_run(cell, args.seed)
        result = {"control": True, "correct": correct}
    else:
        result, rows = run_cell(cell, args.seed, args.seconds, args.trace,
                                t_start=T_START)
    leaked = loaded_forbidden()
    if leaked:
        print("mfbench: the run loaded %s" % ", ".join(leaked),
              file=sys.stderr)
        return 3
    for name, value, lim in rows:
        print("check %s %r limit %r" % (name, value, lim), file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {name: {"value": value, "limit": lim}
                        for name, value, lim in rows}
    print(json.dumps(result), flush=True)
    return 0
