"""The port's span, ``utils/profiling.stage``, on the CPU.

Off (no profiler, no stage timer) a span is one check and the shared
no-op context. Under ``torch.profiler`` (``profiling.device_trace``) a
fit's spans land in the Chrome trace as ``user_annotation`` events named
``mf.<span>``, nested as the fit's layers nest, and the fit replays the
chunk steps' graphs exactly as it does without the profiler (the
stand-in card of ``tests/test_torch_graphs.py``), with the same maps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import graphs
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.utils import profiling
from test_torch_graphs import _StandInCard, _StandInGraph

torch.set_num_threads(2)
N_ATOM, BATCH, R = 72, 8, 16
#: the export's rounding of a time stamp and a duration (us)
ROUNDING_US = 0.01


@pytest.fixture(scope="module")
def volume():
    """32 voxels on a 40-sequence scheme, 72 atoms: CSF only, (1, CSF),
    (2, CSF) and (2, no CSF), the middle two in two chunks of BATCH; a
    dictionary, the fit's arguments and keywords."""
    wl = ttesting.make_fit_workload(num_atom=N_ATOM, n_vox=32, n_shells=3,
                                    dirs_per_shell=12, n_b0=4)
    mix = ttesting.make_mixed(wl, [(4, 0, True), (10, 1, True),
                                   (12, 2, True), (6, 2, False)], seed=3)
    shape, S = (8, 2, 2), wl["sch_mat"].shape[0]
    sig, dpar, _dperp = ttesting.make_dictionary(wl["sch_mat"], N_ATOM)
    dic = {"dictionary": sig, "sch_mat": wl["sch_mat"],
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": N_ATOM,
           "fasc_propnames": ["dpar"], "dpar": dpar, "T2_csf": 2.0,
           "DIFF_csf": 3.0e-9}
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"],
              csf_mask=mix["csf_mask"].reshape(shape).astype(float),
              verbose=0, batch_size=BATCH, device="cpu")
    return dic, args, kw


def _spans(log_dir):
    """The trace's spans: [(name, start, end)] in us, by start."""
    (path,) = log_dir.glob("*.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events if e.get("cat") == "user_annotation"
        and e["name"].startswith(profiling.PREFIX))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return (child[1] >= parent[1] - ROUNDING_US
            and child[2] <= parent[2] + ROUNDING_US)


def _traced_fit(model, args, kw, log_dir):
    with profiling.device_trace(str(log_dir)):
        fit = model.fit(*args, **kw)
    return fit, _spans(log_dir)


def _same_maps(a, b):
    for p in a.param_names:
        assert np.array_equal(getattr(a, p), getattr(b, p)), p


def test_off_span_is_the_shared_no_op(monkeypatch):
    """With no profiler and no stage timer a span is the one shared no-op
    context: no ``record_function``, no ``torch.device``, no CUDA
    event."""
    def trip(*a, **k):
        raise AssertionError("called while tracing is off")

    assert not torch._C._autograd._profiler_enabled()
    assert not profiling.active()
    monkeypatch.setattr(torch.profiler, "record_function", trip)
    monkeypatch.setattr(torch, "device", trip)
    monkeypatch.setattr(torch.cuda, "Event", trip)
    spans = [profiling.stage("kernel rowmin3", "cuda"),
             profiling.stage("bucket K=2 csf=1 ear=0", "cuda:0"),
             profiling.stage("pull")]
    assert all(s is profiling._OFF for s in spans)
    for s in spans:
        with s:
            pass


def test_general_fit_spans_nest(volume, tmp_path):
    """An ``engine="xla"``, ``refine=True`` fit under ``device_trace``:
    ``mf.fit`` holds ``mf.marshal``, each bucket's span and
    ``mf.assemble``; the general bucket's span holds ``mf.push``,
    ``mf.pull`` and one ``mf.refine`` a chunk, which holds
    ``mf.refine.columns`` and ``mf.refine.solve``; the CSF-only bucket's
    holds ``mf.trivial``. The maps are those of the fit without the
    profiler, bit for bit."""
    dic, args, kw = volume
    kw = dict(kw, engine="xla", refine=True)
    model = mft.MFModel(dic)
    want = model.fit(*args, **kw)
    got, spans = _traced_fit(model, args, kw, tmp_path)
    _same_maps(got, want)

    (fit,) = _named(spans, "mf.fit")
    assert all(_inside(s, fit) for s in spans)
    (marshal,) = _named(spans, "mf.marshal")
    assert _named(spans, "mf.assemble")
    buckets = [s for s in spans if s[0].startswith("mf.bucket ")]
    # the dispatch and the pull of the three buckets with fascicles, the
    # CSF-only bucket's pull
    assert len(buckets) == 2 * 3 + 1
    assert all(b[1] >= marshal[2] for b in buckets)
    general = _named(spans, "mf.bucket K=2 csf=1 ear=0")
    for name in ("mf.push", "mf.pull", "mf.refine"):
        for s in _named(spans, name):
            assert any(_inside(s, b) for b in buckets), name
    refines = _named(spans, "mf.refine")
    # a chunk of BATCH each: 2 + 2 + 1 of the three buckets with fascicles
    assert len(refines) == 5
    assert sum(_inside(s, general[0]) for s in refines) == 2
    for part in ("mf.refine.columns", "mf.refine.solve"):
        assert len(_named(spans, part)) == len(refines)
        for s in _named(spans, part):
            assert any(_inside(s, r) for r in refines), part
    (csf_only,) = _named(spans, "mf.bucket K=0 csf=1 ear=0")
    (trivial,) = _named(spans, "mf.trivial")
    assert _inside(trivial, csf_only)
    for s in _named(spans, "mf.assemble"):
        assert not any(_inside(s, b) for b in buckets)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph cache on the stand-in card, the two-pass at R = 16 rows
    (so that 72 atoms take it)."""
    graphs.clear()
    _StandInGraph.captures = 0
    monkeypatch.setattr(graphs, "_CARD", _StandInCard())
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=R))
    kernels.reset_counts()
    yield
    graphs.clear()
    kernels.reset_counts()


def _replayed_fit(model, args, kw, log_dir=None):
    """A fit on a fresh graph cache: (fit, graphs.stats() without the
    capture times, LAUNCHES, spans or None)."""
    graphs.clear()
    kernels.reset_counts()
    if log_dir is None:
        fit, spans = model.fit(*args, **kw), None
    else:
        fit, spans = _traced_fit(model, args, kw, log_dir)
    stats = [{k: v for k, v in r.items() if k != "capture_s"}
             for r in graphs.stats()]
    return fit, stats, dict(kernels.LAUNCHES), spans


def test_profiled_fit_replays_as_without(volume, stand_in, tmp_path):
    """A fast-path fit under the profiler captures and replays the chunk
    steps' graphs as the same fit without it (the same replays, the same
    launches, the same maps); its trace holds a ``mf.replay`` a replay
    and a ``mf.capture`` a new key, and a second traced fit, on the
    cached graphs, no ``mf.capture``."""
    dic, args, kw = volume
    model = mft.MFModel(dic)
    want, stats, launches, _ = _replayed_fit(model, args, kw)
    replays = sum(r["replays"] for r in stats)
    assert replays > 0 and len(stats) >= 3
    got, got_stats, got_launches, spans = _replayed_fit(
        model, args, kw, tmp_path / "first")
    assert got_stats == stats and got_launches == launches
    _same_maps(got, want)
    assert len(_named(spans, "mf.replay")) == replays
    assert len(_named(spans, "mf.capture")) == len(stats)
    (fit,) = _named(spans, "mf.fit")
    assert all(_inside(s, fit) for s in spans)

    again, spans = _traced_fit(model, args, kw, tmp_path / "again")
    _same_maps(again, want)
    assert not _named(spans, "mf.capture")
    assert len(_named(spans, "mf.replay")) == sum(
        r["replays"] for r in graphs.stats()) - replays
