"""Host-side I/O helpers: Matlab .mat loading and environment probes.

Behavioral parity targets:
  - ``loadmat`` reproduces the semantics of the reference loader
    (the upstream microstructure_fingerprinting/mf_utils.py:3026-3087):
    ``scipy.io.loadmat(..., struct_as_record=False, squeeze_me=True)`` with
    recursive conversion of Matlab structs into nested Python dicts.
  - ``from_ipython`` detects an IPython session
    (reference mf_utils.py:3090-3100).
"""

import numpy as np
import scipy.io


def _mat_struct_types():
    """Return the tuple of scipy mat_struct classes across scipy versions."""
    types = []
    try:  # scipy >= 1.8 public location
        from scipy.io.matlab import mat_struct
        types.append(mat_struct)
    except ImportError:
        try:  # legacy location (pre-1.8)
            from scipy.io.matlab.mio5_params import mat_struct as _ms_legacy
            types.append(_ms_legacy)
        except ImportError:
            pass
    return tuple(set(types))


_MAT_STRUCT_TYPES = _mat_struct_types()


def _is_mat_struct(obj):
    if isinstance(obj, _MAT_STRUCT_TYPES):
        return True
    # Defensive string check for exotic import paths (mirrors the reference's
    # class-identity workaround, mf_utils.py:3041-3044).
    return "mat_struct" in str(type(obj))


def _todict(matobj):
    d = {}
    for name in matobj.__dict__.keys():
        elem = matobj.__dict__[name]
        if _is_mat_struct(elem):
            d[name] = _todict(elem)
        else:
            d[name] = elem
    return d


def loadmat(filename):
    """Load a Matlab .mat file with nested structs converted to dicts.

    Use instead of plain ``scipy.io.loadmat``: Matlab structs (including
    nested ones) come back as plain Python dictionaries.
    """
    data = scipy.io.loadmat(filename, struct_as_record=False, squeeze_me=True)
    for key in data:
        if _is_mat_struct(data[key]):
            data[key] = _todict(data[key])
    return data


def savemat(filename, d):
    """Thin wrapper over scipy.io.savemat (convenience for round-trips)."""
    scipy.io.savemat(filename, d)


def from_ipython():
    """Return True when running under IPython, False otherwise."""
    try:
        __IPYTHON__  # noqa: F821
        return True
    except NameError:
        return False


def as_float_array(x, dtype=np.float64):
    """Coerce path-free array-like input to a float ndarray."""
    return np.asarray(x, dtype=dtype)
