"""The port's peak cleanup (``cleanup_2fascicles``) and the ``cleanup``
sub-command of its command line vs the JAX package, in float64: the
same arrays bit for bit for the three peak modes, with the fractions
given apart or as one ``frac12`` volume, and the same files written.

Inputs come from a seeded NumPy generator: two directions a voxel, a
third of the pairs within the 15-degree merge angle, fractions over
[0, 0.6] (so that the dominance rule fires), a sixth of the voxels with
both fractions under 0.06 (faint), a mask with holes.
"""

import gzip

import numpy as np
import pytest

from microstructure_fingerprinting_tpu import cli as jcli
from microstructure_fingerprinting_tpu.models.mf import (
    cleanup_2fascicles as jcleanup)
from microstructure_fingerprinting_tpu.ops import dti as jdti

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import cli as tcli
from microstructure_fingerprinting_torch.utils import nifti as tnifti

SHAPE = (6, 5, 4)


def _inputs(rng, peakmode, fracs):
    """(frac1, frac2, mu1, mu2, mask, frac12) of the cleanup."""
    n = int(np.prod(SHAPE))
    d1 = rng.randn(n, 3)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.randn(n, 3)
    near = rng.rand(n) < 1 / 3
    d2[near] = d1[near] + 0.15 * rng.randn(int(near.sum()), 3)
    d2[near & (rng.rand(n) < 0.5)] *= -1.0                  # antipodal pairs
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    if peakmode == "peaks":
        mu = [d.reshape(SHAPE + (3,)) for d in (d1, d2)]
    elif peakmode == "colat_longit":
        mu = [np.stack([np.arccos(d[:, 2]), np.arctan2(d[:, 1], d[:, 0])],
                       axis=1).reshape(SHAPE + (2,)) for d in (d1, d2)]
    else:  # tensors of the directions, with a singleton axis
        mu = [jdti.peaks_to_DT_vec(d.reshape(SHAPE + (1, 3)), "column")[0]
              [..., None, :] for d in (d1, d2)]
    frac = 0.6 * rng.rand(*SHAPE, 2)
    frac.reshape(n, 2)[::6] *= 0.1                         # faint voxels
    mask = (rng.rand(*SHAPE) > 0.2).astype(float)
    if fracs == "apart":
        return frac[..., 0], frac[..., 1], mu[0], mu[1], mask, None
    if fracs == "frac12_singleton":
        frac = frac[..., None, :]
    return None, None, mu[0], mu[1], mask, frac


@pytest.mark.parametrize("fracs", ["apart", "frac12", "frac12_singleton"])
@pytest.mark.parametrize("peakmode", ["colat_longit", "peaks", "tensor"])
def test_cleanup_matches_jax(rng, peakmode, fracs):
    """cleanup_2fascicles: peaks and fascicle counts equal to the JAX
    package's bit for bit, every rule having fired on some voxel."""
    f1, f2, mu1, mu2, mask, f12 = _inputs(rng, peakmode, fracs)
    pj, nj = jcleanup(f1, f2, peakmode, mu1, mu2, mask, frac12=f12)
    pt, nt = mft.cleanup_2fascicles(f1, f2, peakmode, mu1, mu2, mask,
                                    frac12=f12)
    assert pt.dtype == pj.dtype and nt.dtype == nj.dtype
    assert np.array_equal(pt, pj) and np.array_equal(nt, nj)
    counts = np.bincount(nt[mask > 0].astype(int), minlength=3)
    assert np.all(counts > 0), counts


@pytest.mark.parametrize("call", [
    dict(frac1=None, frac2=None, frac12=None),
    dict(peakmode="dirs"),
    dict(frac12=np.zeros(SHAPE + (1,))),
    dict(mu2=np.zeros(SHAPE + (4,))),
])
def test_cleanup_errors_match_jax(rng, call):
    """Missing fractions, an unknown peak mode, a one-wide frac12 and a
    wrong direction width raise the JAX package's ValueError."""
    f1, f2, mu1, mu2, mask, _ = _inputs(rng, "peaks", "apart")
    kw = dict(frac1=f1, frac2=f2, peakmode="peaks", mu1=mu1, mu2=mu2,
              mask=mask, frac12=None)
    kw.update(call)
    msgs = []
    for fn in (jcleanup, mft.cleanup_2fascicles):
        with pytest.raises(ValueError) as err:
            fn(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("peakmode,fracs,ext", [
    ("peaks", "apart", ".nii.gz"), ("tensor", "frac12", ".nii")])
def test_cleanup_cli_matches_jax(rng, tmp_path, peakmode, fracs, ext):
    """The cleanup sub-command of both command lines, on the same NIfTI
    inputs, writes the same _peaks and _numfasc files (same bytes once
    decompressed), equal to an in-process cleanup of the arrays."""
    f1, f2, mu1, mu2, mask, f12 = _inputs(rng, peakmode, fracs)
    aff = np.diag([2.0, 2.0, 2.5, 1.0])
    args = ["cleanup", "--peakmode", peakmode]
    for name, arr in (("mu1", mu1), ("mu2", mu2), ("mask", mask),
                      ("frac1", f1), ("frac2", f2), ("frac12", f12)):
        if arr is not None:
            path = str(tmp_path / (name + ".nii.gz"))
            tnifti.save(tnifti.Nifti1Image(arr, aff), path)
            args += ["--" + name, path]
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        assert cli.main(args + ["--out", str(tmp_path / name) + ext]) == 0
        out[name] = [str(tmp_path / name) + "_%s%s" % (s, ext)
                     for s in ("peaks", "numfasc")]
    for pj, pt in zip(out["jax"], out["torch"]):
        assert _read(pj) == _read(pt)
    pk, nf = mft.cleanup_2fascicles(f1, f2, peakmode, mu1, mu2, mask,
                                    frac12=f12)
    img = tnifti.load(out["torch"][0])
    assert np.array_equal(img.get_fdata(), pk)
    assert np.array_equal(img.affine, aff)
    assert np.array_equal(tnifti.load(out["torch"][1]).get_fdata(), nf)
