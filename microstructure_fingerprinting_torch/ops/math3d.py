"""3-D vector / rotation utilities shared by the DW-MRI ops.

Parity targets in the reference:
  - ``get_perp_vector``    mf_utils.py:769-811
  - ``rotate_vector``      mf_utils.py:814-839
  - ``vrrotvec2mat``       mf_utils.py:842-858
  - ``rotate_scheme_mat``  mf_utils.py:1153-1202

These are small host-side helpers (scheme preparation, dictionary
generation); the batched per-voxel geometry used by the fit path lives in
ops/interp.py and runs on device.
"""

import numpy as np

_EPS = 2.2204e-16


def get_perp_vector(v):
    """Unit vector(s) perpendicular to ``v`` along its first dimension.

    For every slice ``v[:, i2, ..., iN]``, the returned array satisfies a
    zero dot product and unit Euclidean norm along axis 0.
    """
    v = np.asarray(v, dtype=np.float64)
    v_perp = np.zeros(v.shape)
    is_zero = np.abs(v) < (10 * _EPS)
    num_zeros_v = np.sum(is_zero, axis=0)
    is_nonzero_vect = num_zeros_v == 0

    # Any zero entry of v lets us place a 1 there for a zero dot product.
    v_perp[is_zero] = 1

    # Fully non-zero vectors: ones everywhere except the last entry, chosen
    # to cancel the dot product.
    v_perp[:-1, is_nonzero_vect] = 1
    v_perp[-1, is_nonzero_vect] = (
        -np.sum(v[:-1, is_nonzero_vect], axis=0) / v[-1, is_nonzero_vect])

    norm_v_perp = np.sqrt(np.sum(v_perp ** 2, axis=0))
    return v_perp / norm_v_perp


def rotate_vector(v, rot_axis, theta):
    """Rodrigues rotation of 3-vector ``v`` around unit axis by ``theta``."""
    norm_sq_axis = np.sum(rot_axis ** 2)
    if not np.isclose(1, norm_sq_axis):
        raise ValueError("rotation axis should have unit norm,"
                         " detected %g" % np.sqrt(norm_sq_axis))
    costh = np.cos(theta)
    return (costh * v + np.sin(theta) * np.cross(rot_axis, v)
            + (1 - costh) * (np.dot(rot_axis, v) * rot_axis))


def vrrotvec2mat(rotax, theta):
    """Rotation matrix from (axis, angle)."""
    rotax = np.asarray(rotax, dtype=np.float64)
    if rotax.size != 3:
        raise ValueError("rotation axis should be a 3-element NumPy array")
    if not np.isclose(np.sum(rotax ** 2), 1):
        raise ValueError("rotation axis should have unit norm")
    s = np.sin(theta)
    c = np.cos(theta)
    t = 1 - c
    x, y, z = rotax
    return np.array([[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                     [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                     [t * x * z - s * y, t * y * z + s * x, t * z * z + c]])


def rotate_scheme_mat(sch_mat, cyldir1, cyldir2):
    """Rotate gradient directions so a fascicle along ``cyldir2`` under
    ``sch_mat`` is equivalent to a fascicle along ``cyldir1`` under the
    returned scheme (invariant: DWI(fasc(dir2); sch) = DWI(fasc(dir1);
    sch_eff)).
    """
    cyldir1 = np.asarray(cyldir1, dtype=np.float64)
    cyldir2 = np.asarray(cyldir2, dtype=np.float64)
    if cyldir1.size != 3 or cyldir2.size != 3:
        raise ValueError("cyldir1 and cyldir2 should be 3-elements NumPy"
                         " arrays.")
    if (not np.isclose(np.sum(cyldir1 ** 2), 1)
            or not np.isclose(np.sum(cyldir2 ** 2), 1)):
        raise ValueError("cyldir1 and cyldir2 should have unit norm.")
    rot_ax = np.cross(cyldir1, cyldir2)
    sch_mat_eff = sch_mat
    rot_ax_sqrd = np.sum(rot_ax ** 2)
    if rot_ax_sqrd > 0:
        rot_ax = rot_ax / np.sqrt(rot_ax_sqrd)
        rot_ang = np.arccos(np.clip(np.dot(cyldir1, cyldir2), -1.0, 1.0))
        rot_mat = vrrotvec2mat(rot_ax, -rot_ang)
        rot_gdir = sch_mat[:, :3] @ rot_mat.T
        # a rotated direction could be [eps, eps, ~1]; flush tiny components
        rot_gdir[np.abs(rot_gdir) <= np.finfo(float).eps] = 0
        rot_gdir_norm = np.sqrt(np.sum(rot_gdir ** 2, axis=1, keepdims=True))
        nnz_g = np.squeeze(rot_gdir_norm > 0)
        rot_gdir[nnz_g, :] = rot_gdir[nnz_g, :] / rot_gdir_norm[nnz_g, :]
        sch_mat_eff = rot_gdir
        if sch_mat.shape[1] > 3:
            sch_mat_eff = np.hstack((sch_mat_eff, sch_mat[:, 3:]))
    return sch_mat_eff
