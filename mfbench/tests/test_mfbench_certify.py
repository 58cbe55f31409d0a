"""The cell ``brain_mix_auto`` and the readers of the fast path's exact
selection (``certify_host_s``, ``rescored_voxels_per_fit``) on a
made-up trace and counter, each reading nothing where the program has
nothing for it."""

import json
import os

import pytest

from conftest import PKG, ROOT, small_cell
from mfbench import run, trace


def test_brain_mix_auto_loads():
    """The cell names the EAR configuration, the brain mix unchanged
    (``engine`` at its default) and limits no looser than the held-out
    ``brain_mix``'s; it reports the new readers and the row passes'
    rooflines, each of which has its file."""
    cell = run.Cell.load("brain_mix_auto")
    assert cell.cfg["name"] == "dense552_2fasc_csf_ear10"
    assert cell.cfg["dicsizes"] == [782, 782, 1, 10]
    assert cell.traffic == run._json(PKG, "traffic", "brain_mix.json")
    assert "engine" not in cell.fit_kw()
    with open(os.path.join(PKG, "limits", "brain_mix.json")) as f:
        held = json.load(f)
    assert set(cell.limits) == set(held)
    assert all(cell.limits[k] <= held[k] for k in held)
    names = {m["name"] for m in cell.per_layer}
    assert {"certify_host_s", "rescored_voxels_per_fit", "roofline.rowmin3",
            "roofline.rowmin4", "device_idle_share"} <= names
    for name in names:
        assert os.path.exists(os.path.join(PKG, "metrics", name + ".py"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = [c for c in bench["configs"]
           if c["name"] == "dense552_2fasc_csf_ear10"][0]
    assert cfg["reduced"] == ["volume_voxels_max"]
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))


def _ctx(events, workload="brain_mix_auto"):
    ctx = run.Context(small_cell(workload), 512)
    ctx.trace = trace.Trace(events)
    return ctx


def _events(with_spans=True):
    """Window 0-1000 us; spans certify 100-300 and 250-400 (overlapping,
    counted once), certify fallback 600-650; a refine nested in the
    first certify adds nothing."""
    ev = lambda name, ts, dur, cat="user_annotation": {
        "name": name, "cat": cat, "ts": ts, "dur": dur}
    out = [ev(trace.RANGE, 0, 1000),
           ev("void elementwise_kernel", 0, 100, "kernel")]
    if with_spans:
        out += [ev("mf.certify", 100, 200), ev("mf.certify", 250, 150),
                ev("mf.refine", 120, 50),
                ev("mf.certify fallback", 600, 50),
                ev("mf.certificate", 700, 100)]
    return out


def test_certify_host_s():
    assert run.reader("certify_host_s")(_ctx(_events())) == pytest.approx(
        350e-6, abs=1e-12)


def test_certify_host_s_reads_nothing_without_its_spans():
    assert run.reader("certify_host_s")(_ctx(_events(False))) is None
    ctx = _ctx(_events())
    ctx.trace = None
    assert run.reader("certify_host_s")(ctx) is None


@pytest.fixture
def counter(monkeypatch):
    from microstructure_fingerprinting_torch.models import fit
    counts = dict(certified=900, rescored=80, fallback=20)
    monkeypatch.setattr(fit, "CERTIFY", counts)
    return counts


def test_rescored_voxels_per_fit(counter):
    """The counter's share of re-scored and fallback voxels (100 of
    1000) times the fast-path voxels of one fit of the cell (every
    bucket but the CSF-only one)."""
    ctx = _ctx(_events())
    fast = sum(n for k, n in ctx.bucket_counts.items()
               if not k.startswith("0,"))
    assert fast == ctx.traffic["voxels"] - ctx.bucket_counts["0,1,0"]
    assert run.reader("rescored_voxels_per_fit")(ctx) == pytest.approx(
        0.1 * fast)


def test_rescored_voxels_per_fit_reads_nothing_without_counts(monkeypatch):
    """Nothing where the program counted no voxel (a fit with no
    fast-path bucket), or has no such counter (the parent's program)."""
    from microstructure_fingerprinting_torch.models import fit
    read = run.reader("rescored_voxels_per_fit")
    monkeypatch.setattr(fit, "CERTIFY", dict(certified=0, rescored=0,
                                             fallback=0))
    assert read(_ctx(_events())) is None
    monkeypatch.delattr(fit, "CERTIFY")
    assert read(_ctx(_events())) is None
