"""The port's diffusion-tensor conversions (``ops/dti.py``) and the
``colat_longit=`` / ``tensors=`` orientation inputs of ``MFModel.fit``
vs the JAX package, in float64: bit for bit, with the same error texts;
and a ``tensors=`` fit against the ``peaks=`` fit of its principal
eigenvectors.
"""

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_tpu import MFModel as JMFModel
from microstructure_fingerprinting_tpu.ops import dti as jdti

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models.mf import MFModel
from microstructure_fingerprinting_torch.ops import dti as tdti
from microstructure_fingerprinting_torch.utils import nifti as tnifti

torch.set_num_threads(2)


@pytest.mark.parametrize("order", ["row", "column", "diagonal"])
def test_dti_conversions_match_jax(rng, order):
    """peaks -> tensor vectors -> 3 x 3 arrays -> vectors -> peaks, and
    the principal eigenvectors of random symmetric tensors (zero tensors
    -> zero peaks), equal to the JAX functions bit for bit."""
    pk = rng.randn(4, 5, 2, 3)
    pk[0, 0, 1] = 0.0
    vj, vt = jdti.peaks_to_DT_vec(pk, order), tdti.peaks_to_DT_vec(pk, order)
    assert len(vt) == 2
    for a, b in zip(vj, vt):
        assert np.array_equal(a, b)
    arr_j = jdti.DT_vec_to_2Darray(vj[1], order)
    arr_t = tdti.DT_vec_to_2Darray(vt[1], order)
    assert np.array_equal(arr_j, arr_t)
    assert np.array_equal(jdti.DT_array_to_vec(arr_j, order),
                          tdti.DT_array_to_vec(arr_t, order))
    mask = rng.rand(4, 5) > 0.3
    for m in (None, mask):
        assert np.array_equal(jdti.DT_vec_to_peaks(vj[0], order, m),
                              tdti.DT_vec_to_peaks(vt[0], order, m))
    assert np.array_equal(jdti.DT_vec_to_peaks(vj[0][1, 2], order),
                          tdti.DT_vec_to_peaks(vt[0][1, 2], order))
    M = rng.randn(30, 3, 3)
    M = M + np.swapaxes(M, 1, 2)
    M[3] = 0.0
    ej, et = jdti.principal_eigenvectors(M), tdti.principal_eigenvectors(M)
    assert np.array_equal(ej, et) and not et[3].any()


@pytest.mark.parametrize("fn,args", [
    ("DT_array_to_vec", (np.zeros(3),)),
    ("DT_array_to_vec", (np.zeros((2, 3)),)),
    ("DT_array_to_vec", (np.zeros((3, 3)), "up")),
    ("DT_vec_to_2Darray", (np.zeros(5), "row")),
    ("DT_vec_to_2Darray", (np.zeros(6), "up")),
    ("DT_vec_to_peaks", (np.zeros((2, 5)), "row")),
    ("DT_vec_to_peaks", (np.zeros((2, 6)), "row", np.ones((2, 1)))),
    ("peaks_to_DT_vec", (np.zeros(3), "row")),
    ("peaks_to_DT_vec", (np.zeros((2, 4)), "row")),
    ("peaks_to_DT_vec", (np.zeros((2, 3)), "row", 1e-3, 2e-3)),
    ("peaks_to_DT_vec", (np.zeros((2, 3)), "up")),
])
def test_dti_errors_match_jax(fn, args):
    """Each argument check raises the JAX package's ValueError text."""
    with pytest.raises(ValueError) as ej:
        getattr(jdti, fn)(*args)
    with pytest.raises(ValueError) as et:
        getattr(tdti, fn)(*args)
    assert str(et.value) == str(ej.value)


def _volume(rng, shape=(3, 2, 2)):
    mask = (rng.rand(*shape) > 0.2).astype(float)
    pk = rng.randn(*shape, 2, 3)
    th = np.arccos(np.clip(rng.rand(*shape, 2) * 2 - 1, -1, 1))
    ph = rng.rand(*shape, 2) * 2 * np.pi
    cl = [np.stack([th[..., k], ph[..., k]], axis=-1) for k in range(2)]
    ten = tdti.peaks_to_DT_vec(pk, "column")
    return mask, cl, ten


def _marshal(model, kind, arg, mask, maxfasc):
    in_mask = mask > 0
    kw = {"peaks": None, "colat_longit": None, "tensors": None}
    kw[kind] = arg
    return model._marshal_peaks(
        kw["peaks"], kw["colat_longit"], kw["tensors"], in_mask, mask.shape,
        mask, maxfasc, int(in_mask.sum()), 0)


@pytest.mark.parametrize("case", ["colat_longit", "colat_longit list",
                                  "tensors", "tensors (..., 1, 6)",
                                  "tensors list", "tensors paths",
                                  "tensors, more than fascicles"])
def test_marshal_orientations_match_jax(rng, tmp_path, case):
    """The colat_longit= and tensors= branches of _marshal_peaks give the
    JAX package's (ROI, 3 * maxfasc) peaks bit for bit: one volume, a list
    of one per fascicle, the (..., 1, 6) tensor layout, NIfTI paths (and
    their affine)."""
    mask, cl, ten = _volume(rng)
    kind = case.split()[0].rstrip(",")
    maxfasc = 2
    if case == "colat_longit":
        arg, maxfasc = cl[0], 1
    elif case == "colat_longit list":
        arg = cl
    elif case == "tensors":
        arg, maxfasc = ten[0], 1
    elif case == "tensors (..., 1, 6)":
        arg, maxfasc = ten[1][..., None, :], 1
    elif case == "tensors list":
        arg = ten
    elif case == "tensors paths":
        arg = []
        for k, t in enumerate(ten):
            arg.append(str(tmp_path / ("t%d.nii.gz" % k)))
            tnifti.save(tnifti.Nifti1Image(t, np.diag([2.0, 2, 2, 1])),
                        arg[-1])
    else:
        arg, maxfasc = ten, 1
    jm = JMFModel.__new__(JMFModel)
    pj, aj = _marshal(jm, kind, arg, mask, maxfasc)
    pt, at = _marshal(MFModel, kind, arg, mask, maxfasc)
    assert pt.shape == (int((mask > 0).sum()), 3 * maxfasc)
    assert np.array_equal(pj, pt)
    if case == "tensors paths":
        assert np.array_equal(at, aj) and at is not None
    else:
        assert at is None and aj is None


def test_marshal_orientation_errors_match_jax(rng):
    """A wrongly shaped orientation argument, and no orientation argument
    at all, raise the JAX package's errors and texts."""
    mask, cl, ten = _volume(rng)
    jm = JMFModel.__new__(JMFModel)
    for kind, arg in (("colat_longit", [cl[0], cl[1][:2]]),
                      ("tensors", ten[0][..., :5]), ("peaks", None)):
        errors = []
        for model in (jm, MFModel):
            with pytest.raises((ValueError, RuntimeError)) as e:
                _marshal(model, kind, arg, mask, 2)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


def test_tensors_fit_equals_peaks_fit():
    """A fit given diffusion tensors (a list of one (..., 6) volume per
    fascicle, NIfTI column order) gives the same maps as the fit given
    their principal eigenvectors as peaks; a 1- and 2-fascicle + CSF
    volume of the 72-atom workload."""
    wl = ttesting.make_fit_workload(num_atom=72, n_vox=8, n_shells=3,
                                    dirs_per_shell=12, n_b0=4)
    mix = ttesting.make_mixed(wl, [(4, 1, True), (4, 2, True)])
    sig, dpar, dperp = ttesting.make_dictionary(wl["sch_mat"], 72)
    dic = {"dictionary": sig, "sch_mat": wl["sch_mat"],
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": 72,
           "fasc_propnames": ["dpar"], "dpar": dpar, "T2_csf": 2.0,
           "DIFF_csf": 3.0e-9}
    shape = (2, 2, 2)
    S = wl["sch_mat"].shape[0]
    pk = mix["peaks"].reshape(shape + (2, 3))
    ten = tdti.peaks_to_DT_vec(pk, "column")
    eig = np.concatenate([tdti.DT_vec_to_peaks(t, "column") for t in ten],
                         axis=-1)
    assert np.allclose(np.abs(np.sum(eig.reshape(8, 2, 3)
                                     * mix["peaks"].reshape(8, 2, 3), -1)),
                       np.linalg.norm(mix["peaks"].reshape(8, 2, 3), axis=-1))
    model = mft.MFModel(dic, device="cpu")
    kw = dict(pgse_scheme=wl["sch_mat"], csf_mask=1, verbose=0,
              batch_size=8)
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    by_tensors = model.fit(*args, tensors=ten, **kw)
    by_peaks = model.fit(*args, peaks=eig, **kw)
    assert by_tensors.param_names == by_peaks.param_names
    for p in by_peaks.param_names:
        assert np.array_equal(getattr(by_tensors, p), getattr(by_peaks, p)), p
    got = by_peaks.dpar_f0.reshape(-1)
    assert np.array_equal(got, dpar[mix["gt_ids"][:, 0]])
