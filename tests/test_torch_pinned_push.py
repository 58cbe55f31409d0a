"""The bucket pushes of ``models/fit.py`` do not wait for the card.

A push to a card casts the host array into pinned memory and copies it
with ``non_blocking=True`` (``fit._push``): a pageable copy would wait
for every kernel already queued, so the dispatch of a bucket would wait
for the bucket before it. The pinned buffer stays referenced until the
bucket's results are pulled. Here, on the CPU, the CUDA calls are
stubbed: ``pin_memory`` by a recorder that returns a copy, the copy to
the card by one that records its arguments; a fit whose every push takes
that branch (``fit._pinned`` forced) gives the CPU route's maps bit for
bit, and the CPU route itself never pins."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import interp as tinterp

torch.set_num_threads(2)
N_ATOM, N_VOX, BATCH = 72, 16, 8


@pytest.fixture(scope="module")
def wl():
    w = ttesting.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    w["sig_ear"], w["y_ear"] = ttesting.make_ear(w, 6)
    return w


class _Pins:
    """Stand-ins for ``Tensor.pin_memory`` (a copy, recorded by weak
    reference) and ``Tensor.to``: a call that names ``non_blocking`` (a
    push's copy) is recorded and returns a copy on the CPU, so that only
    the pusher's ``held`` list keeps the pinned buffer; other calls are
    torch's."""

    def __init__(self, monkeypatch):
        self.pinned, self.copies = [], []
        to = torch.Tensor.to

        def pin_memory(t):
            p = t.clone()
            self.pinned.append(weakref.ref(p))
            return p

        def to_(t, *a, **k):
            if "non_blocking" in k:
                self.copies.append((a[0] if a else k["device"],
                                    k["non_blocking"], t))
                return t.clone()
            return to(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
        monkeypatch.setattr(torch.Tensor, "to", to_)


def test_push_to_a_card_pins_and_does_not_wait(monkeypatch):
    """``_push`` to a CUDA device: the array cast to the dtype on the host
    (float64 to float32 as ``torch.as_tensor`` rounds it), pinned, held
    in ``held`` and copied with ``non_blocking=True``; to the CPU a plain
    ``torch.as_tensor`` that pins nothing."""
    pins = _Pins(monkeypatch)
    a = np.random.RandomState(0).randn(5, 3) * 1e3
    held = []
    got = tfit._push(a, torch.device("cuda", 0), torch.float32, held)
    assert len(held) == 1 and len(pins.pinned) == 1
    assert pins.pinned[0]() is held[0]
    dev, non_blocking, src = pins.copies[0]
    assert torch.device(dev) == torch.device("cuda", 0) and non_blocking
    assert src is held[0]
    want = torch.as_tensor(a, dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    idx = tfit._push(np.arange(4), "cuda:0", held=held)
    assert idx.dtype == torch.int64 and len(held) == 2
    cpu = tfit._push(a, torch.device("cpu"), torch.float32, held)
    assert len(held) == 2 and len(pins.pinned) == 2
    assert torch.equal(cpu, want)


def _bucket(wl, K, csf, ear):
    mt = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    y = wl["y_ear"] if ear else wl["y"]
    return tfit.run_bucket_fast(
        mt, wl["plan"], ys_t, wl["peaks"][:, :K].reshape(N_VOX, 3 * K), y,
        wl["sig_csf"], K, csf, batch=BATCH, sig_ear=wl["sig_ear"],
        ear_on=ear, defer=True)


@pytest.mark.parametrize("K,csf,ear", [(2, True, False), (2, True, True),
                                       (1, True, False)])
def test_pinned_pushes_keep_the_maps(wl, monkeypatch, K, csf, ear):
    """``run_bucket_fast`` with every push through the card's branch
    (stubbed) returns the CPU route's results bit for bit; every pinned
    buffer is held until the deferred pull has run, and released with
    it; the CPU route pins nothing."""
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=16, twopass_rows_ear=16))
    want = _bucket(wl, K, csf, ear)()
    pins = _Pins(monkeypatch)
    assert not pins.pinned
    monkeypatch.setattr(tfit, "_pinned", lambda device: True)
    pull = _bucket(wl, K, csf, ear)
    # directions and signals of the chunks, the fixed columns
    assert len(pins.pinned) == len(pins.copies) == 2 + csf + ear
    assert all(nb for _d, nb, _t in pins.copies)
    pins.copies.clear()
    gc.collect()
    assert all(r() is not None for r in pins.pinned)
    got = pull()
    pins.copies.clear()   # the overflow tiers' pushes, made in the pull
    gc.collect()
    assert all(r() is None for r in pins.pinned)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))


def test_general_path_pushes_pin(wl, monkeypatch):
    """``run_bucket`` (the general path) pushes its fixed columns and
    chunks through the card's branch too, with the CPU route's results
    bit for bit."""
    ms = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    tables = ms.device_tables("cpu", torch.float32)
    plan = tfit.plan_tensors(wl["plan"], torch.float32, "cpu")
    args = (tables, plan, wl["peaks"][:, :1].reshape(N_VOX, 3), wl["y"],
            wl["sig_csf"], wl["sig_ear"], 1, False, False)
    want = tfit.run_bucket(*args, batch=BATCH)
    pins = _Pins(monkeypatch)
    monkeypatch.setattr(tfit, "_pinned", lambda device: True)
    got = tfit.run_bucket(*args, batch=BATCH)
    assert len(pins.pinned) == len(pins.copies) == 4
    assert all(nb for _d, nb, _t in pins.copies)
    for a, b in zip(got, want):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
