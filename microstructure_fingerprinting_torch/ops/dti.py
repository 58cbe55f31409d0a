"""Diffusion-tensor <-> vector <-> peak conversions (NumPy, host side).

Counterpart of ``DT_array_to_vec``, ``DT_vec_to_2Darray``,
``principal_eigenvectors``, ``DT_vec_to_peaks`` and ``peaks_to_DT_vec``
in ``microstructure_fingerprinting_tpu/ops/dti.py`` (reference
mf_utils.py:865-1135). The JAX package takes the batched
eigendecomposition through ``jax.numpy.linalg.eigh``; here it is
``numpy.linalg.eigh``, the same LAPACK symmetric solver on the host.

Element orderings refer to the upper triangle of the symmetric tensor:
  'row'      [xx xy xz yy yz zz]   (NRRD convention)
  'column'   [xx xy yy xz yz zz]   (NIfTI convention)
  'diagonal' [xx yy zz xy yz xz]
"""

import numpy as np

from .math3d import get_perp_vector

_ORDER_INDEX = {
    "row": ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]),
    "column": ([0, 0, 1, 0, 1, 2], [0, 1, 1, 2, 2, 2]),
    "diagonal": ([0, 1, 2, 0, 1, 0], [0, 1, 2, 1, 2, 2]),
}


def DT_array_to_vec(DT, order="row"):
    """(..., 3, 3) symmetric tensors -> (..., 6) vectors."""
    DT = np.asarray(DT)
    if DT.ndim < 2:
        raise ValueError('DT should have at least 2 dimensions. Detected'
                         ' %d.' % DT.ndim)
    if DT.shape[-2:] != (3, 3):
        raise ValueError('Last 2 dimensions of DT should be (3, 3). Detected'
                         ' (%d, %d).' % DT.shape[-2:])
    if order not in _ORDER_INDEX:
        raise ValueError('Unknown order "%s".' % order)
    ix, iy = _ORDER_INDEX[order]
    return DT[..., ix, iy]


def DT_vec_to_2Darray(DT_vec, order):
    """(..., 6) vectors -> (..., 3, 3) symmetric tensors."""
    DT_vec = np.asarray(DT_vec)
    if DT_vec.shape[-1] != 6:
        raise ValueError("Last dimension of input should have size 6,"
                         " detected %d." % DT_vec.shape[-1])
    if order not in _ORDER_INDEX:
        raise ValueError('Unknown order option "%s".' % order)
    ix, iy = _ORDER_INDEX[order]
    out = np.zeros(DT_vec.shape[:-1] + (3, 3), dtype=DT_vec.dtype)
    for k in range(6):
        out[..., ix[k], iy[k]] = DT_vec[..., k]
        out[..., iy[k], ix[k]] = DT_vec[..., k]
    return out


def principal_eigenvectors(tensors):
    """Batched principal (largest-eigenvalue) unit eigenvectors.

    ``tensors``: (..., 3, 3) symmetric. Returns (..., 3); zero tensors map
    to zero peaks (``eigh`` would otherwise return an arbitrary unit
    basis). An eigenvector's sign is the solver's choice, as in the JAX
    package: a peak and its opposite give the same fit.
    """
    eigval, eigvec = np.linalg.eigh(np.asarray(tensors))
    nnz = (np.abs(eigval)[..., -1] > 0)[..., np.newaxis]
    return eigvec[..., -1] * nnz


def DT_vec_to_peaks(DT_vec, order, mask=None):
    """Convert (..., 6) tensor vectors to unit-norm principal peaks (..., 3)."""
    DT_vec = np.asarray(DT_vec)
    DT_ndim = DT_vec.ndim
    if DT_vec.ndim < 2:
        DT_vec = np.atleast_2d(DT_vec)
    if DT_vec.shape[-1] != 6:
        raise ValueError('DT_vec should have size 6 along last dimension.'
                         ' Detected %d.' % (DT_vec.shape[-1],))
    if mask is None:
        mask = np.full(DT_vec.shape[:-1], True, dtype=bool)
    if mask.ndim != DT_vec.ndim - 1:
        raise ValueError('mask should have %d dimension(s) since DT_vec has '
                         '%d, detected %d instead.' %
                         (DT_vec.ndim - 1, DT_vec.ndim, mask.ndim))
    peaks_sel = principal_eigenvectors(
        DT_vec_to_2Darray(DT_vec[mask > 0, :], order=order))
    peaks = np.zeros(mask.shape + (3,))
    peaks[mask > 0] = peaks_sel
    if DT_ndim == 1:
        peaks = np.squeeze(peaks)
    return peaks


def peaks_to_DT_vec(peaks, order, lam_par=2e-3, lam_perp=0.1e-3):
    """Convert peaks to stick-like diffusion-tensor 6-vectors.

    Mainly for visualization in tensor-based viewers. Returns a list of
    length ``n_peaks`` of arrays shaped like ``peaks[..., 0, :6]``.
    """
    peaks = np.array(peaks, dtype=np.float64)  # copy: normalized in place
    if peaks.ndim < 2:
        raise ValueError('peaks array should have at least 2 dimensions. '
                         'Detected %d.' % peaks.ndim)
    if peaks.shape[-1] != 3:
        raise ValueError('Last dimension of peaks should have size 3,'
                         ' detected %d.' % (peaks.shape[-1]))
    if lam_par < lam_perp:
        raise ValueError('Parallel diffusivity should be greater than or'
                         ' equal to perpendicular diffusivity.')
    if order not in _ORDER_INDEX:
        raise ValueError('Unknown order "%s".' % order)
    ix, iy = _ORDER_INDEX[order]

    n_peaks = peaks.shape[-2]
    peak_norm = np.sqrt(np.sum(peaks ** 2, axis=-1))
    nnz = peak_norm > 0
    peaks[nnz, :] = peaks[nnz, :] / peak_norm[nnz][:, np.newaxis]

    pdir_1 = np.swapaxes(get_perp_vector(np.swapaxes(peaks[nnz, :], 0, 1)),
                         0, 1)
    pdir_2 = np.cross(peaks[nnz, :], pdir_1, axis=1)

    # M = lam_par v v' + lam_perp (p1 p1' + p2 p2')
    DT = (lam_par * peaks[nnz, :][..., np.newaxis]
          * peaks[nnz, :][:, np.newaxis, :]
          + lam_perp * pdir_1[..., np.newaxis] * pdir_1[:, np.newaxis, :]
          + lam_perp * pdir_2[..., np.newaxis] * pdir_2[:, np.newaxis, :])
    tens = np.zeros(peaks.shape[:-1] + (6,))
    tens[nnz, :] = DT[:, ix, iy]
    return [tens[..., k, :] for k in range(n_peaks)]
