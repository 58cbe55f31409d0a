"""PGSE acquisition-scheme import, validation and construction (host side).

A PGSE scheme matrix has one row per sequence:
``[gx, gy, gz, G, Delta, delta, TE]`` in SI units, with ``[gx, gy, gz]`` a
unit-norm (or zero) gradient direction.

Behavioral parity targets (reference file:line cited per function):
  - ``import_PGSE_scheme``        mf_utils.py:2128-2192
  - ``get_PGSE_scheme_from_bval_bvec_dense``  mf_utils.py:2197-2300
  - ``project_PGSE_scheme_xy_plane``          mf_utils.py:2088-2125
  - ``get_gyromagnetic_ratio``                mf_utils.py:1138-1150

These run once per fit on the host; all heavy per-voxel work happens in the
device kernels (see ops/).
"""

import numpy as np

TWO_PI = 2.0 * np.pi

_GYROMAGNETIC = {
    "hydrogen": TWO_PI * 42.577480e6,
    "H": TWO_PI * 42.577480e6,
    "proton": TWO_PI * 42.577480e6,
    "carbon": TWO_PI * 10.7084e6,
    "C": TWO_PI * 10.7084e6,
    "phosphorus": TWO_PI * 17.235e6,
    "P": TWO_PI * 17.235e6,
}


def get_gyromagnetic_ratio(element="H"):
    """Gyromagnetic ratio [rad/s/T] for H, C or P nuclei."""
    try:
        return _GYROMAGNETIC[element]
    except KeyError:
        raise ValueError("Gyromagnetic ratio for nucleus of element %s"
                         "unknown." % element)


def b_values(sch_mat):
    """b = (gamma*G*delta)^2 * (Delta - delta/3) for each scheme row [SI]."""
    gam = get_gyromagnetic_ratio("H")
    G = sch_mat[:, 3]
    Delta = sch_mat[:, 4]
    delta = sch_mat[:, 5]
    return (gam * G * delta) ** 2 * (Delta - delta / 3)


def load_scheme_text(path):
    """Load a scheme text file, skipping a one-line 'VERSION' header if any."""
    with open(path, "r") as f:
        first_line = f.readline()
    rows_to_skip = 1 if "version" in first_line.lower() else 0
    return np.loadtxt(path, skiprows=rows_to_skip)


def import_PGSE_scheme(scheme):
    """Import and validate a PGSE scheme file or matrix.

    Accepts a path to a text file (one optional 'VERSION' header line) or an
    array with 7 entries per row; always returns a 2-D (Nseq, 7) array.
    """
    if isinstance(scheme, str):
        sch_mat = load_scheme_text(scheme)
    elif isinstance(scheme, np.ndarray):
        sch_mat = scheme
    else:
        raise TypeError("Unable to import a PGSE scheme matrix from input")
    if sch_mat.ndim == 1:
        sch_mat = sch_mat[np.newaxis, :]
    if sch_mat.shape[1] != 7:
        raise RuntimeError("Detected %s instead of expected 7 columns in"
                           " PGSE scheme matrix." % sch_mat.shape[1])
    grad_norm = np.sqrt(np.sum(sch_mat[:, :3] ** 2, axis=1))
    num_bad_norms = np.sum(np.abs(1 - grad_norm[grad_norm > 0]) > 1e-4)
    if num_bad_norms > 0:
        raise ValueError("Detected %d non-zero gradients which did not have"
                         " unit norm. Please normalize." % num_bad_norms)
    G = sch_mat[:, 3]
    Delta = sch_mat[:, 4]
    delta = sch_mat[:, 5]
    TE = sch_mat[:, 6]
    if np.any(G < 0):
        raise ValueError('Detected %d sequence(s) with negative gradient '
                         'intensity (4th column).' % np.sum(G < 0))
    if np.any(Delta < 0):
        raise ValueError('Detected %d sequence(s) with negative gradient '
                         'separation Delta (5th column).' % np.sum(Delta < 0))
    if np.any(delta < 0):
        raise ValueError('Detected %d sequence(s) with negative gradient '
                         'duration delta (6th column).' % np.sum(delta < 0))
    if np.any(TE < 0):
        raise ValueError('Detected %d sequence(s) with negative echo time '
                         'TE (7th column).' % np.sum(TE < 0))
    if np.any(delta > Delta):
        raise ValueError('Detected %d sequence(s) in which delta (6th column)'
                         ' was greater than Delta (5th column).' %
                         np.sum(delta > Delta))
    if np.any(TE < (Delta + delta) * 0.999):
        # 0.999 guard absorbs round-off in user-provided TE values
        raise ValueError('Detected %d sequence(s) in which TE (7th column)'
                         ' was lower than Delta+delta.' %
                         np.sum(TE < (Delta + delta)))
    return sch_mat


def get_PGSE_scheme_from_bval_bvec_dense(sch_mat_dense, bvals, bvecs,
                                         Gtol=1e-3):
    """Build a subject PGSE scheme from bvals/bvecs + a dense reference scheme.

    ``bvals`` are in s/mm^2; Delta/delta/TE are copied from the dense scheme
    (which must have a unique (Delta, delta) pair); each implied gradient
    intensity is snapped to the nearest G of the dense scheme within ``Gtol``
    (T/m), erroring out if any b-value cannot be mapped.
    """
    sch_mat_ref = import_PGSE_scheme(sch_mat_dense)

    if isinstance(bvals, str):
        bvals = np.loadtxt(bvals)
    if isinstance(bvecs, str):
        bvecs = np.atleast_2d(np.loadtxt(bvecs))
    bvals = np.asarray(bvals, dtype=np.float64) * 1e6  # s/mm^2 -> s/m^2

    if np.ndim(bvecs) != 2:
        raise ValueError("bvecs array should have 2 dimensions,"
                         " detected %d." % np.ndim(bvecs))
    if bvecs.shape[0] != bvals.size and bvecs.shape[1] != bvals.size:
        raise ValueError("Number of b-vectors does not match number"
                         " of b-values (%d)" % bvals.size)
    is_eq_to_first = np.all(sch_mat_ref[0, 4:6] == sch_mat_ref[:, 4:6],
                            axis=1)
    if not np.all(is_eq_to_first):
        raise ValueError('Detected different pairs of (Delta, delta) values'
                         ' in reference scheme matrix (note that zeros '
                         'count as values),'
                         ' which is currently not supported.')

    sch_mat = np.zeros((bvals.size, 7))
    if bvecs.shape[0] == 3:
        sch_mat[:, :3] = bvecs.transpose()
    elif bvecs.shape[1] == 3:
        sch_mat[:, :3] = bvecs
    else:
        raise ValueError("Vectors in bvecs should be 3-dimensional."
                         " However, detected no dimension with size 3.")

    gnorm = np.sqrt(np.sum(sch_mat[:, :3] ** 2, axis=1))
    nz = gnorm > 0
    sch_mat[nz, :3] = sch_mat[nz, :3] / gnorm[nz][:, np.newaxis]

    gam = get_gyromagnetic_ratio("H")
    Del_prot = sch_mat_ref[0, 4]
    del_prot = sch_mat_ref[0, 5]
    TE_prot = sch_mat_ref[0, 6]
    G = np.sqrt(bvals / (Del_prot - del_prot / 3)) / (gam * del_prot)
    Geff = np.zeros(bvals.shape[0])

    G_target = np.unique(sch_mat_ref[:, 3])
    grads_per_shell = np.zeros(G_target.size)
    for ig in range(G_target.size):
        i_shell = np.where(np.abs(G_target[ig] - G) < Gtol)[0]
        grads_per_shell[ig] = i_shell.size
        Geff[i_shell] = G_target[ig]

    if G.size != np.sum(grads_per_shell):
        raise ValueError(
            'Mismatch between reference scheme matrix and bvals. '
            ' Could only map %d/%d b-values (equivalently, gradient'
            ' intensities G) from the specified bvals to the b-values'
            ' contained in the reference scheme matrix. You may want to'
            ' change the tolerance on gradient intensity G (currently '
            '%g T/m).' % (np.sum(grads_per_shell), G.size, Gtol))
    sch_mat[:, 3] = Geff
    sch_mat[:, 4:7] = np.array([Del_prot, del_prot, TE_prot])
    return sch_mat


def project_PGSE_scheme_xy_plane(sch_mat):
    """Zero the z gradient component, renormalizing direction and intensity.

    Output satisfies gz' = 0, unit-norm [gx', gy'] and
    (gz*G)^2 + G'^2 = G^2.
    """
    if isinstance(sch_mat, str):
        sch_mat = load_scheme_text(sch_mat)
    if sch_mat.ndim == 1:
        sch_mat = sch_mat[np.newaxis, :]
    gxy = np.sqrt(sch_mat[:, 0] ** 2 + sch_mat[:, 1] ** 2)

    sch_mat_xy = np.zeros(sch_mat.shape)
    sch_mat_xy[:, 3] = sch_mat[:, 3] * gxy
    gxy_safe = np.where(gxy == 0, 1.0, gxy)
    sch_mat_xy[:, :2] = sch_mat[:, :2] / gxy_safe[:, np.newaxis]
    sch_mat_xy[sch_mat[:, 3] == 0, :4] = 0
    sch_mat_xy[:, 4:] = sch_mat[:, 4:]

    Gz = np.abs(sch_mat[:, 2]) * sch_mat[:, 3]
    G_chk_sq = sch_mat_xy[:, 3] ** 2 + Gz ** 2
    msg = ("Inconsistency with gradient intensities during"
           " projection in xy plane")
    assert np.all(np.abs(np.sqrt(G_chk_sq) - sch_mat[:, 3])
                  <= 1e-4 * sch_mat[:, 3]), msg
    return sch_mat_xy
