"""Float64 host re-scoring of top-M device candidates.

PyTorch-port counterpart of ``interp_columns``, ``interp_columns_np``,
``_solve_support``, ``_solve_support_ear`` and ``refine_candidates`` in
``microstructure_fingerprinting_tpu/models/refine.py`` (NumPy, as
there). The float32 device scan resolves normalized-residual gaps down
to ~1e-7; real fingerprint dictionaries contain atom pairs more
correlated than that, so the scan returns its top-M candidates per
voxel (ops/nnls.exhaustive_*_candidates) and this module re-solves the
small NNLS exactly in float64 on the host for just those candidates.
The closed-form subproblems are the device scans' own bodies
(ops/nnls.lsqnonneg_* with ``xp=np``), so the decision rules (Cramer
sign tests, fallback chains, tie-breaking by candidate rank) are the
same. Spans (``utils/profiling.stage``): "refine" (``refine_candidates``),
in it "refine.columns" (the columns' interpolation) and "refine.solve"
(the solves and the selection).
"""

import numpy as np

from ..ops import nnls as mfn
from ..utils import native
from ..utils.profiling import stage


def interp_columns(ms, plan, newdir, atom_ids, out=None):
    """Rotated columns in float64, candidate-major (B, M, Nseq): native C++
    kernel when available (utils/native.py), NumPy otherwise. ``out`` lets
    the caller provide a preallocated destination (no copy)."""
    if native.available():
        return native.interp_columns_f64(
            ms.xs, ms.cnt, ms.ys, plan.gdir, plan.shell_lo, plan.shell_hi,
            plan.wG, np.ascontiguousarray(newdir, np.float64),
            np.ascontiguousarray(atom_ids, np.int32), out=out)
    cols = interp_columns_np(ms, plan, newdir, atom_ids).transpose(0, 2, 1)
    if out is not None:
        out[...] = cols
        return out
    return np.ascontiguousarray(cols)


def interp_columns_np(ms, plan, newdir, atom_ids):
    """Rotated dictionary columns in float64 on the host.

    ms: MultiShellInterp (numpy tables); plan: TargetSchemePlan;
    newdir (B, 3); atom_ids (B, M). Returns (B, Nseq, M).
    Mirrors ops/interp.eval_rotation exactly (same clamped-segment lerp).
    """
    B, M = atom_ids.shape
    x = np.abs(np.einsum("sd,bd->bs", plan.gdir, newdir))   # (B, Nseq)

    seq = np.arange(plan.gdir.shape[0])

    def shell_eval(s_idx):
        xs_r = ms.xs[s_idx]                                  # (Nseq, Kmax)
        cnt_r = ms.cnt[s_idx]
        j = np.clip((x[:, :, None] >= xs_r[None]).sum(axis=2) - 1,
                    0, (cnt_r - 2)[None])                    # (B, Nseq)
        x0 = xs_r[seq[None, :], j]
        x1 = xs_r[seq[None, :], j + 1]
        denom = x1 - x0
        t = np.where(denom > 0,
                     (x - x0) / np.where(denom > 0, denom, 1.0),
                     0.0)                                    # (B, Nseq)
        s_b = np.broadcast_to(s_idx[None, :, None], (B, s_idx.size, M))
        j_b = j[:, :, None]
        a_b = atom_ids[:, None, :]
        y0 = ms.ys[s_b, j_b, a_b]                            # (B, Nseq, M)
        y1 = ms.ys[s_b, j_b + 1, a_b]
        return y0 + t[:, :, None] * (y1 - y0)

    lo = shell_eval(plan.shell_lo)
    hi = shell_eval(plan.shell_hi)
    return lo + plan.wG[None, :, None] * (hi - lo)


def _solve_support(cols, y):
    """Exact f64 NNLS over per-candidate column sets.

    cols: (K, B, M, Nseq) C-contiguous stack — one selected column per
    sub-dictionary per candidate (candidate-major); y: (B, Nseq).
    Returns (w (B, M, K), res (B, M)).
    """
    K = cols.shape[0]
    y_sq = np.sum(y * y, axis=1)[:, None]                    # (B, 1)
    if native.available():
        Gn, Yn = native.candidate_grams_f64(cols, y)
        Y = [Yn[i] for i in range(K)]
        G = [[Gn[i, j] for j in range(K)] for i in range(K)]
    else:
        Y = [np.einsum("bms,bs->bm", c, y) for c in cols]
        G = [[np.einsum("bms,bms->bm", cols[i], cols[j]) for j in range(K)]
             for i in range(K)]
    if K == 1:
        w, res = mfn.lsqnonneg_1var(y_sq, G[0][0], Y[0], xp=np)
        return w[:, :, None], res
    if K == 2:
        w1, w2, res = mfn.lsqnonneg_2var(y_sq, G[0][0], G[0][1], G[1][1],
                                         Y[0], Y[1], xp=np)
        return np.stack([w1, w2], axis=2), res
    if K == 3:
        w1, w2, w3, res = mfn.lsqnonneg_3var(
            y_sq, G[0][0], G[1][1], G[2][2], G[0][1], G[0][2], G[1][2],
            Y[0], Y[1], Y[2], xp=np)
        return np.stack([w1, w2, w3], axis=2), res
    if K == 4:
        w1, w2, w3, w4, res = mfn.lsqnonneg_4var(
            y_sq, tuple(tuple(G[i][j] for j in range(4)) for i in range(4)),
            tuple(Y), xp=np)
        return np.stack([w1, w2, w3, w4], axis=2), res
    raise NotImplementedError("refine supports up to 4 sub-dictionaries")


def _solve_support_ear(cols, y, sig_ear):
    """Exact f64 NNLS per candidate with the EAR atom enumerated.

    cols: (C0, B, M, Nseq) non-EAR column stack (fascicles + CSF); sig_ear:
    (Nseq, E). The f32 device scan keeps only its best (i3, i4) per (i1, i2)
    grid point, so near-ties along the small EAR axis must be re-decided in
    float64 here: the full (C0+1)-variable NNLS is solved for EVERY ear atom
    and reduced with a first-minimum (reference product order puts the ear
    axis innermost). Returns (w (B, M, C0+1), e_idx (B, M), res (B, M)).
    """
    C0, B, M, Nseq = cols.shape
    E = sig_ear.shape[1]
    y_sq = np.sum(y * y, axis=1)[:, None, None]              # (B, 1, 1)
    if native.available():
        Gn, Yn = native.candidate_grams_f64(cols, y)
        Yb = [Yn[i][:, :, None] for i in range(C0)]
        Gb = [[Gn[i, j][:, :, None] for j in range(C0)] for i in range(C0)]
    else:
        Yb = [np.einsum("bms,bs->bm", c, y)[:, :, None] for c in cols]
        Gb = [[np.einsum("bms,bms->bm", cols[i], cols[j])[:, :, None]
               for j in range(C0)] for i in range(C0)]
    Ge = [np.einsum("bms,se->bme", cols[i], sig_ear) for i in range(C0)]
    Gee = np.sum(sig_ear * sig_ear, axis=0)[None, None, :]   # (1, 1, E)
    Ye = (y @ sig_ear)[:, None, :]                           # (B, 1, E)

    C = C0 + 1
    if C == 2:
        w1, we, res = mfn.lsqnonneg_2var(y_sq, Gb[0][0], Ge[0], Gee,
                                         Yb[0], Ye, xp=np)
        w = np.stack([w1, we], axis=3)
    elif C == 3:
        w1, w2, we, res = mfn.lsqnonneg_3var(
            y_sq, Gb[0][0], Gb[1][1], Gee, Gb[0][1], Ge[0], Ge[1],
            Yb[0], Yb[1], Ye, xp=np)
        w = np.stack([w1, w2, we], axis=3)
    elif C == 4:
        G = ((Gb[0][0], Gb[0][1], Gb[0][2], Ge[0]),
             (Gb[0][1], Gb[1][1], Gb[1][2], Ge[1]),
             (Gb[0][2], Gb[1][2], Gb[2][2], Ge[2]),
             (Ge[0], Ge[1], Ge[2], Gee))
        w1, w2, w3, we, res = mfn.lsqnonneg_4var(
            y_sq, G, (Yb[0], Yb[1], Yb[2], Ye), xp=np)
        w = np.stack([w1, w2, w3, we], axis=3)
    else:
        raise NotImplementedError("refine supports up to 4 sub-dictionaries")
    res = np.where(np.isnan(res), np.inf, res)               # (B, M, E)
    e_idx = np.argmin(res, axis=2)                           # first minimum
    res_m = np.take_along_axis(res, e_idx[:, :, None], axis=2)[:, :, 0]
    w_m = np.take_along_axis(w, e_idx[:, :, None, None], axis=2)[:, :, 0, :]
    return w_m, e_idx.astype(np.int32), res_m


def refine_candidates(ms, plan, peaks, y, sig_csf, sig_ear,
                      cand_ids, K, csf_on, ear_on, cols=None):
    """Select the exact winner among device candidates, in float64.

    Args:
      ms, plan: host interpolation tables and target-scheme plan.
      peaks (B, K, 3), y (B, Nseq) float64.
      sig_csf (Nseq,), sig_ear (Nseq, E) or None.
      cand_ids (B, M, C) int32 per-sub-dictionary candidate indices
        (C = K + csf_on + ear_on). With an EAR block, the ear slot of
        cand_ids is advisory only: the ear atom is re-enumerated exactly.
      cols: None, or a C-contiguous float64 (K + csf_on, B, M, Nseq)
        buffer for the columns whose CSF plane (index K) already holds
        ``sig_csf`` (``fit.run_bucket`` reuses one across a bucket's
        chunks); None allocates one.
    Returns (w (B, C), ind (B, C) int32, min_obj (B,), y_rec (B, Nseq)).
    """
    with stage("refine"):
        B, M = cand_ids.shape[:2]
        y = np.asarray(y, dtype=np.float64)
        Nseq = y.shape[1]
        C0 = K + int(csf_on)
        with stage("refine.columns"):
            if cols is None:
                cols = np.empty((C0, B, M, Nseq), dtype=np.float64)
                if csf_on:
                    cols[K] = sig_csf[None, None, :]
            for k in range(K):
                interp_columns(ms, plan, peaks[:, k, :], cand_ids[:, :, k],
                               out=cols[k])
        with stage("refine.solve"):
            return _select(cols, y, sig_ear, cand_ids, ear_on)


def _select(cols, y, sig_ear, cand_ids, ear_on):
    """The exact float64 solve of every candidate of ``cand_ids`` on its
    columns ``cols`` (C0, B, M, Nseq), and the winner: what
    ``refine_candidates`` returns."""
    C0, C = cols.shape[0], cand_ids.shape[2]
    if ear_on:
        sig_ear64 = np.asarray(sig_ear, dtype=np.float64)
        w, e_idx, res = _solve_support_ear(cols, y, sig_ear64)
    else:
        w, res = _solve_support(cols, y)                     # (B,M,C), (B,M)
        res = np.where(np.isnan(res), np.inf, res)
    # winner: min residual, ties -> lowest candidate rank (device candidates
    # are ordered by (f32 residual, reference candidate rank))
    best = np.argmin(res, axis=1)                            # first minimum
    w_best = np.take_along_axis(w, best[:, None, None], axis=1)[:, 0, :]
    ind_best = np.take_along_axis(cand_ids, best[:, None, None],
                                  axis=1)[:, 0, :].copy()
    obj = np.take_along_axis(res, best[:, None], axis=1)[:, 0]
    y_rec = np.zeros_like(y)
    for j in range(C0):
        col = np.take_along_axis(
            cols[j], best[:, None, None], axis=1)[:, 0, :]
        y_rec += w_best[:, j][:, None] * col
    if ear_on:
        e_best = np.take_along_axis(e_idx, best[:, None], axis=1)[:, 0]
        ind_best[:, C - 1] = e_best
        y_rec += w_best[:, C - 1][:, None] * sig_ear64[:, e_best].T
    return w_best, ind_best.astype(np.int32), obj, y_rec
