"""The readers of the program's spans (``refine_host_s``,
``refine_idle_s``, ``pull_wait_s``, ``fit_entry_host_s``) on a made-up
trace: one idle gap lies half inside ``mf.refine``, two ``mf.bucket``
spans lie inside ``mf.fit``; each reader reads nothing where its span is
absent, and the breakdown names a gap by the innermost span."""

import pytest

from conftest import small_cell
from mfbench import run, spans, trace

READERS = ("refine_host_s", "refine_idle_s", "pull_wait_s",
           "fit_entry_host_s")


def _events(with_spans=True):
    """Window 0-1000 us; the card busy 0-100 and 300-700, so idle
    100-300 and 700-1000. Spans: fit 10-990; buckets 50-400 (its
    dispatch) and 500-800 (its pull), the second overlapping a nested
    bucket 600-650; pulls 380-400 and 790-800, nested pulls counted
    once; refine 600-800 (its columns 600-650), half of it over the gap
    700-1000."""
    ev = lambda name, ts, dur, cat="user_annotation": {
        "name": name, "cat": cat, "ts": ts, "dur": dur}
    out = [ev(trace.RANGE, 0, 1000),
           ev("void elementwise_kernel", 0, 100, "kernel"),
           ev("Memcpy HtoD", 300, 400, "gpu_memcpy"),
           ev("cudaGraphLaunch", 20, 5, "cuda_runtime")]
    if with_spans:
        out += [ev("mf.fit", 10, 980),
                ev("mf.marshal", 10, 40),
                ev("mf.bucket K=2 csf=1 ear=0", 50, 350),
                ev("mf.bucket K=2 csf=1 ear=0", 500, 300),
                ev("mf.bucket K=0 csf=1 ear=0", 600, 50),
                ev("mf.pull", 380, 20),
                ev("mf.pull", 790, 10),
                ev("mf.pull", 792, 5),
                ev("mf.refine", 600, 200),
                ev("mf.refine.columns", 600, 50),
                ev("mf.assemble", 800, 190)]
    return out


def _ctx(with_spans=True):
    ctx = run.Context(small_cell("wm_crossing_xla"), 128)
    ctx.trace = trace.Trace(_events(with_spans))
    return ctx


@pytest.mark.parametrize("name, want", [
    ("refine_host_s", 200e-6),
    ("refine_idle_s", 100e-6),
    ("pull_wait_s", 30e-6),
    ("fit_entry_host_s", (980 - 350 - 300) * 1e-6)])
def test_reader(name, want):
    assert run.reader(name)(_ctx()) == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_span(name):
    """Nothing to read in a trace without the program's spans (the
    parent's program), nor without a trace."""
    assert run.reader(name)(_ctx(with_spans=False)) is None
    ctx = _ctx()
    ctx.trace = None
    assert run.reader(name)(ctx) is None


def test_interval_arithmetic():
    assert spans.union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert spans.seconds([(0, 2e6), (1e6, 3e6)]) == 3.0
    assert spans.within([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10),
                                                             (20, 25)]


def test_breakdown_names_a_gap_by_its_span():
    """The gap 700-1000 has its middle, 850, inside ``mf.fit`` and
    ``mf.assemble`` only: the shorter names it."""
    gaps = dict((round(s * 1e6), n) for n, s in
                _ctx().trace.breakdown()["idle_gaps"])
    assert gaps[300] == "mf.assemble"
    assert gaps[200] == "mf.bucket K=2 csf=1 ear=0"
