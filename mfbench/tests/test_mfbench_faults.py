"""The comparison fails what it has to fail: the control (the program's
own float32 path, ``run.CONTROL_FIT``, in the timed path's place), and
runs whose timed path is broken underneath (a fit that returns set-up's
answers, half of a bucket left out, an answer altered where it is
produced, and a wrong atom whose weights, MSE and R^2 are re-solved for
it, so that only the atom's selection is wrong). On the CPU at a small
size, and on the card at the real widths (``cuda``)."""

import io

import numpy as np
import pytest
import torch

from conftest import CPU_BATCH, bench, small_cell
from mfbench import dictionary, reference, run

#: a cell of the benchmark (the general path) and the held-out cells of
#: the fast path
FAULT_CELLS = ["wm_crossing_xla", "brain_mix", "ear_wm"]


def _resolved(cfg, out, peaks, y, K, csf_on, ear_on):
    """``out`` with each voxel's first atom moved by one and its weights,
    MSE and R^2 solved again for the moved atom, on the reference's
    columns: a consistent answer that picks a wrong atom."""
    from scipy.optimize import nnls
    w, ind, obj, mse, r2 = out
    sch, dic = dictionary.build(cfg)
    rot = reference.Rotation(dic["dictionary"], sch, dic["orientation"],
                             "cpu")
    csf = dictionary.csf_signature(cfg, sch)
    ear = dictionary.ear_signatures(cfg, sch)
    peaks = np.asarray(peaks, dtype=np.float64).reshape(len(w), -1, 3)
    y = np.asarray(y, dtype=np.float64)
    ind[:, 0] = (ind[:, 0] + 1) % cfg["num_atom"]
    for v in range(len(w)):
        cols = [rot(peaks[v, k][None])[0, :, int(ind[v, k])].numpy()
                for k in range(K)]
        if csf_on:
            cols.append(csf)
        if ear_on:
            cols.append(ear[:, int(ind[v, K + 1])])
        A = np.stack(cols, axis=1)
        w[v], _rn = nnls(A, y[v])
        res, r2_v = reference.claimed(torch.as_tensor(y[v:v + 1]),
                                      torch.as_tensor(A[None]),
                                      torch.as_tensor(w[v:v + 1]))
        mse[v] = float(res[0]) / y.shape[1]
        r2[v] = float(r2_v[0])
    return w, ind, obj, mse, r2


def _broken(kind, cfg, monkeypatch):
    """Break both bucket runners (fast and general) underneath the fit."""
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    first = {}

    def breaker(real, parts):
        def wrapped(*a, **kw):
            finish = real(*a, **kw)
            peaks, y, K, csf_on, ear_on = parts(a, kw)
            key = (real.__name__, K, csf_on, ear_on)

            def broken(res=None):
                out = [np.array(x) for x in (res if res is not None
                                             else finish())]
                w, ind = out[0], out[1]
                n = w.shape[0]
                if kind == "stale":        # set-up's answers, ever after
                    kept = first.setdefault(key, out)
                    return tuple(np.take(x, np.arange(n) % x.shape[0],
                                         axis=0) for x in kept)
                if kind == "half_left_out":
                    w[1::2] = 0.0
                if kind == "altered":
                    ind[:, 0] = (ind[:, 0] + 1) % cfg["num_atom"]
                if kind == "wrong_atom_resolved":
                    out = _resolved(cfg, out, peaks, y, K, csf_on, ear_on)
                return tuple(out)

            if callable(finish):           # deferred (the fast path)
                return broken
            return broken(finish)
        return wrapped

    fast = lambda a, kw: (a[3], a[4], a[6], a[7], kw.get("ear_on", False))
    general = lambda a, kw: (a[2], a[3], a[6], a[7], a[8])
    monkeypatch.setattr(fit_mod, "run_bucket_fast",
                        breaker(fit_mod.run_bucket_fast, fast))
    monkeypatch.setattr(fit_mod, "run_bucket",
                        breaker(fit_mod.run_bucket, general))


def _run(cell, device, **fit_kw):
    log = io.StringIO()
    res, rows = run.run_cell(cell, 2 ** 31 + 99, 0.0, 0, device=device,
                             fit_kw=fit_kw, log=log)
    return res, rows, log.getvalue()


@pytest.mark.parametrize("workload", FAULT_CELLS)
def test_sound_run_is_correct(workload):
    res, rows, log = _run(small_cell(workload), "cpu",
                          batch_size=CPU_BATCH)
    assert res["correct"] and res["failed"] == 0, (rows, log)


@pytest.mark.parametrize("workload", FAULT_CELLS)
@pytest.mark.parametrize("kind", ["stale", "half_left_out", "altered",
                                  "wrong_atom_resolved"])
def test_broken_path_is_not_correct(kind, workload, monkeypatch):
    cell = small_cell(workload, voxels=120)
    _broken(kind, cell.cfg, monkeypatch)
    # more voxels than set-up's warm fit holds, so that its answers are
    # not the window's
    res, rows, log = _run(cell, "cpu", batch_size=CPU_BATCH)
    assert not res["correct"] and res["failed"] > 0, (rows, log)
    if kind == "wrong_atom_resolved":
        # the reported objective and R^2 are the wrong atom's own: only
        # the atom's selection can fail
        checks = res["checks"]
        assert checks["mse_gap"]["value"] <= checks["mse_gap"]["limit"]
        assert checks["r2_gap"]["value"] <= checks["r2_gap"]["limit"]
        assert checks["obj_gap"]["value"] > checks["obj_gap"]["limit"]


@pytest.mark.parametrize("workload", FAULT_CELLS)
def test_control_is_not_correct(workload):
    cell = small_cell(workload)
    correct, rows = run.control_run(cell, 2 ** 31 + 99, device="cpu",
                                    fit_kw={"batch_size": CPU_BATCH},
                                    log=io.StringIO())
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in bench()["workloads"]])
def test_on_card(card, workload):
    """The real widths, 1024 voxels a volume: the program is correct,
    its float32 path (the control) is not."""
    cell = small_cell(workload, voxels=1024, judge_all=False)
    cell.cfg = run.Cell.load(workload).cfg
    res, rows, log = _run(cell, card)
    assert res["correct"], (rows, log)
    correct, rows = run.control_run(cell, 2 ** 31 + 99, device=card,
                                    log=io.StringIO())
    assert not correct, rows
