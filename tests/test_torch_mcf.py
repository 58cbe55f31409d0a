"""The port's MCF simulators (``models/mcf.py``) vs the JAX package on the
CPU: the generated eigenbases bit for bit, ``MCF_PGSE`` in both input
modes and ``MCF_DDE`` in float64 to rtol 1e-10, and the same errors with
the same messages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_tpu.models import mcf as jmcf
from microstructure_fingerprinting_tpu import testing as jtesting

from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import mcf as tmcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: pore sizes of the cylinder checks [m]
SIZES = (2e-6, 5e-6, 8e-6)


@pytest.mark.parametrize("domain", ["cylinder", "sphere", "planes"])
def test_mcf_basis_matches_jax(domain):
    """The generated Laplace eigenbasis at the reference's 60 modes
    equals the JAX module's bit for bit, and is cached."""
    lam_j, B_j = jmcf.mcf_basis(domain, 60)
    lam_t, B_t = tmcf.mcf_basis(domain, 60)
    assert lam_t.shape == (60,) and B_t.shape == (60, 60)
    assert np.array_equal(lam_t, lam_j) and np.array_equal(B_t, B_j)
    assert tmcf.mcf_basis(domain[0], 60)[1] is B_t
    assert tconfig.DEFAULTS["mcf"].max_modes == 60 == tmcf._MAX_MODES


@pytest.mark.parametrize("L", SIZES)
def test_mcf_pgse_scheme_matches_jax(L):
    """Scheme mode on the suite's 40-sequence protocol (b0 rows included,
    where E = 1): float64, rtol 1e-10."""
    sch = jtesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    want = jmcf.MCF_PGSE("cylinder", L, 2e-9, scheme=sch)
    got = tmcf.MCF_PGSE("cylinder", L, 2e-9, scheme=sch, device="cpu")
    assert got.dtype == np.float64 and got.shape == (sch.shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert np.all(got[:4] == 1.0)


def test_mcf_pgse_arrays_matches_jax():
    """G/Delta/delta mode (gradient along x, cylinder along z, and a
    tilted cylinder): float64, rtol 1e-10."""
    G = np.array([0.0, 0.05, 0.1, 0.2, 0.3])
    Delta, delta = np.full(5, 0.02), np.full(5, 0.005)
    for envdir in (np.array([0, 0, 1]), np.array([1.0, 0.5, 2.0])):
        want = jmcf.MCF_PGSE("cylinder", 5e-6, 2e-9, G=G, Delta=Delta,
                             delta=delta, envdir=envdir)
        got = tmcf.MCF_PGSE("cylinder", 5e-6, 2e-9, G=G, Delta=Delta,
                            delta=delta, envdir=envdir, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert got[0] == 1.0 and np.all(np.diff(got) < 0)


@pytest.mark.parametrize("L", SIZES)
def test_mcf_dde_matches_jax(L):
    """A 16-row DDE scheme: float64, rtol 1e-10."""
    sch = ttesting.make_dde_scheme(16)
    want = jmcf.MCF_DDE("cylinder", L, 2e-9, sch)
    got = tmcf.MCF_DDE("cylinder", L, 2e-9, sch, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert got[0] == 1.0 and np.all((got > 0) & (got <= 1))


def test_mcf_encode_block_float32_is_complex64():
    """float32 inputs run the exponentials in complex64, as the JAX code
    chooses, and agree with the complex128 blocks to float32 accuracy."""
    lam, B = tmcf.mcf_basis("cylinder")
    args = [np.array([0.08, 0.02]), np.array([400.0, 900.0]),
            np.array([0.005, 0.01]), np.array([0.015, 0.01])]
    f64 = tmcf._mcf_encode_block(*(torch.as_tensor(a) for a in
                                   [lam, B] + args))
    f32 = tmcf._mcf_encode_block(*(torch.as_tensor(a).float() for a in
                                   [lam, B] + args))
    assert f64.dtype == torch.complex128 and f32.dtype == torch.complex64
    assert f32.shape == (2, 60, 60)
    assert float((f32.cdouble() - f64).abs().max()) < 1e-5


def _error(fn, *a, **k):
    try:
        fn(*a, **k)
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return type(e), str(e)
    return None


_DDE3 = ttesting.make_dde_scheme(3)
_BAD_DDE = {
    "columns": np.zeros((2, 7)),
    "unit": _DDE3 * np.r_[np.full(3, 2.0), np.ones(11)],
    "first_delta": _DDE3 * np.r_[np.ones(5), 0.1, np.ones(8)],
    "second_delta": _DDE3 * np.r_[np.ones(12), 0.1, np.ones(1)],
    "te": _DDE3 * np.r_[np.ones(13), 0.5],
    "type": [1.0] * 14,
}
_BAD_DDE["first_delta"][:, 5] = _BAD_DDE["first_delta"][:, 4] + 0.01
_BAD_DDE["second_delta"][:, 12] = _BAD_DDE["second_delta"][:, 11] + 0.01

_G1 = dict(G=np.array([0.05]), Delta=np.array([0.02]),
           delta=np.array([0.005]))
_BAD_PGSE = {
    "truncation": ("cylinder", 1e-4, 1e-10, dict(
        G=np.array([0.5]), Delta=np.array([0.05]), delta=np.array([0.02]))),
    "sphere": ("sphere", 5e-6, 2e-9, _G1),
    "planes": ("p", 5e-6, 2e-9, _G1),
    "domain": ("torus", 5e-6, 2e-9, _G1),
    "no_inputs": ("cylinder", 5e-6, 2e-9, {}),
    "partial": ("cylinder", 5e-6, 2e-9, dict(G=np.array([0.05]))),
    "sizes": ("cylinder", 5e-6, 2e-9, dict(
        G=np.array([0.05, 0.1]), Delta=np.array([0.02]),
        delta=np.array([0.005]))),
    "delta": ("cylinder", 5e-6, 2e-9, dict(
        G=np.array([0.05]), Delta=np.array([0.002]),
        delta=np.array([0.005]))),
    "envdir": ("cylinder", 5e-6, 2e-9, dict(_G1, envdir=np.zeros(3))),
}


@pytest.mark.parametrize("case", sorted(_BAD_PGSE))
def test_mcf_pgse_errors_match_jax(case):
    """Invalid PGSE inputs, the truncation guard and the unimplemented
    domains raise what the JAX module raises, with its message."""
    domain, L, diff, kw = _BAD_PGSE[case]
    want = _error(jmcf.MCF_PGSE, domain, L, diff, **kw)
    got = _error(tmcf.MCF_PGSE, domain, L, diff, device="cpu", **kw)
    assert want is not None and got == want


@pytest.mark.parametrize("case", sorted(_BAD_DDE))
def test_import_dde_scheme_errors_match_jax(case):
    """import_DDE_scheme (and MCF_DDE through it) raise what the JAX
    module raises, with its message; a valid scheme passes through."""
    bad = _BAD_DDE[case]
    want = _error(jmcf.import_DDE_scheme, bad)
    assert want is not None
    assert _error(tmcf.import_DDE_scheme, bad) == want
    assert _error(tmcf.MCF_DDE, "cylinder", 5e-6, 2e-9, bad,
                  device="cpu") == want
    ok = ttesting.make_dde_scheme(3)
    assert tmcf.import_DDE_scheme(ok) is ok


def test_mcf_runs_on_the_card_by_default(monkeypatch):
    """Without a device argument the simulators ask for the card and
    raise when CUDA is absent (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((tmcf.MCF_PGSE, ("cylinder", 5e-6, 2e-9)),
                     (tmcf.MCF_DDE, ("cylinder", 5e-6, 2e-9,
                                     ttesting.make_dde_scheme(2)))):
        kw = _G1 if fn is tmcf.MCF_PGSE else {}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args, **kw)


def test_mcf_resolves_lazily():
    """``mft.mcf`` is the module, loaded on first access (importing the
    package does not load it)."""
    code = ("import sys\n"
            "import microstructure_fingerprinting_torch as m\n"
            "name = 'microstructure_fingerprinting_torch.models.mcf'\n"
            "before = name in sys.modules\n"
            "mod = m.mcf\n"
            "print(before, mod is sys.modules[name], "
            "callable(mod.MCF_PGSE), callable(mod.MCF_DDE))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["False", "True", "True", "True"]
