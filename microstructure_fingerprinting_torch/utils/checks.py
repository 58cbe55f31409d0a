"""Input sanity guards.

The reference validates shapes and value ranges eagerly with detailed
messages (dozens of raise sites, SURVEY.md section 5 "failure detection")
but lets NaN/Inf signal values flow silently into the solver, where a single
bad voxel can poison a whole batch on an accelerator (NaN residuals are
masked per-candidate, but an all-NaN voxel returns zeros without warning).
These helpers make data hygiene explicit at the fit boundary.
"""

import numpy as np


def check_finite_signals(y_roi, name="data", raise_on_bad=False):
    """Detect voxels with non-finite DWI signals.

    Returns a boolean (ROI_size,) mask of bad voxels; raises instead when
    ``raise_on_bad``.
    """
    bad = ~np.isfinite(y_roi).all(axis=-1)
    n_bad = int(bad.sum())
    if n_bad and raise_on_bad:
        idx = np.where(bad)[0][:10]
        raise ValueError(
            "Detected %d masked voxel(s) with NaN/Inf values in %s "
            "(first offenders: %s). Clean or re-mask the data."
            % (n_bad, name, ", ".join(str(i) for i in idx)))
    return bad


def check_nonnegative(y_roi, name="data"):
    """Magnitude DWI data should be non-negative; returns count of
    offending voxels (a warning-level signal, not an error)."""
    return int(np.sum((y_roi < 0).any(axis=-1)))
