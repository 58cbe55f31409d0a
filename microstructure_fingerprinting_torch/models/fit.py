"""Bucket fit steps.

PyTorch counterpart of ``_finalize_top1`` (``_r_squared`` and its body
are ``ops/dfscan.r_squared`` and ``finalize_top1``),
``_twopass_step3``, ``_twopass_step4``, ``run_bucket_fast``,
``run_bucket_trivial``, ``fit_step``, ``_build_blocks``,
``fit_step_candidates`` and ``run_bucket`` in
``microstructure_fingerprinting_tpu/models/fit.py``. Three routes:

``run_bucket_fast`` covers the JAX package's fast-path buckets, each by
the scan the JAX package runs for it, with an exact double-float scan and
a double-float finalize of the winner on the device:

  * 2 fascicles + CSF: two-pass scan (kernels 1-3) or, for N <= 2R, the
    full-grid re-scan (kernel 3);
  * 2 fascicles + CSF + EAR: the 4-block two-pass scan (kernels 1, 4, 5)
    for at most 13 EAR atoms, or the full-grid re-scan (kernels 8, 5):
    for N <= 2R, and for 14-16 EAR atoms, whose 1 + 1 + E rhs columns
    kernel 1's Grams do not hold;
  * 1 fascicle + CSF: ``dfscan.df2_candidates`` (kernel 6) with the CSF
    column as the second axis;
  * 1 fascicle + CSF + EAR: kernel 3 on the full [N, E, 1] grid, the EAR
    atoms as the second axis and CSF the fixed third block;
  * 2 fascicles without CSF: ``dfscan.df2_candidates`` (kernel 6) on
    [N, N];

and every one ends in ``dfscan.finalize_top1`` (kernel 7): the winner's
columns, ``df_nnls_cols`` and R^2.

``run_bucket`` is the general path (the JAX package's ``engine='xla'``)
for any bucket of 1-4 blocks: the gather-and-lerp rotation
(``interp.eval_rotation_batch``), the tiled exhaustive scans of
``ops/nnls.py`` in the tables' dtype (plain torch on the device, as they
are plain XLA there), and, with ``refine``, their top-M candidates
re-scored exactly in float64 on the host (``models/refine.py``).

``run_bucket_trivial`` solves the fascicle-free (CSF and/or EAR) voxels
in closed form on the host.

``run_bucket_fast`` and ``run_bucket`` take a device mesh
(``parallel/mesh.py``): whole chunks are dealt to its data rows, so
every voxel's result is the serial fit's.

Each chunk step (``_chunk_step``: rotation, scan and finalize of a
fast-path chunk; ``fit_step`` / ``fit_step_candidates`` on the general
path) runs through ``graphs.run``: on a card, one captured CUDA graph a
step and shape, replayed for every chunk, as the JAX package jits each
step; eagerly on the CPU and under a stage timer. The overflow tiers
and the atoms-split scan stay eager.
"""

import math

import numpy as np
import torch

from .. import config
from ..ops import dfscan
from ..ops import f32scan as f32
from ..ops import interp as mfi
from ..ops import nnls as mfn
from ..ops import rescan
from ..utils.profiling import stage
from . import graphs
from . import refine as refine_mod


def _finalize_top1(D, sig_csf, sig_ear, y, cand, csf_on=False,
                   ear_on=False, K=2):
    """Double-float finalize of the scan winner: ``dfscan.finalize_top1``
    (kernel 7 alone on a card). D (B, K, S, N) rotated fascicle blocks
    (raw scale); sig_csf (S,) and sig_ear (S, E), each used only when its
    flag is set; y (B, S) raw; cand (B, C') winner, the fascicle indices
    first and, with ``ear_on``, the EAR atom last. Returns (w (B, C), obj
    (B,), r2 (B,)) for the columns (fascicle 1[, fascicle 2][, CSF][,
    EAR]), C = K + csf_on + ear_on."""
    return dfscan.finalize_top1(D, sig_csf, sig_ear, y, cand, csf_on, ear_on,
                                K)


def _finalized(D, csf_d, ear_d, y, cand, K, csf_on, ear_on, ok=None):
    """The finalize stage of a chunk step: (cand, w, obj, r2, ok), ``ok``
    all true where the scan has no row budget to overflow."""
    with stage("finalize", y.device):
        w, obj, r2 = _finalize_top1(D, csf_d, ear_d, y, cand, csf_on,
                                    ear_on, K)
    if ok is None:
        ok = torch.ones(y.shape[0], dtype=torch.bool, device=y.device)
    return cand, w, obj, r2, ok


def _twopass_step3(D, csf_d, y, R):
    """One chunk of the production path: interval row pass -> row
    selection -> df re-scan -> winner finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    cand, _vals, _ysq, ok = f32.df3_twopass(D[:, 0], D[:, 1], csf_blk, y,
                                            R=R)
    return _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False, ok)


def _onepass_step3(D, csf_d, y):
    """Full-grid df scan (dictionaries with N <= 2R) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    with stage("re-scan", y.device):
        rr, ri, _ysq = rescan.row_scan_df3(D[:, 0], D[:, 1], csf_blk, y)
        cand, _v = rescan.candidates_from_rows(
            rr, ri, segments=rescan.n_segments(D.shape[3]))
    return _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False)


def _twopass_step4(D, csf_d, ear_d, y, R):
    """One chunk of the EAR production path: 4-block interval row pass ->
    row/column selection -> df4 re-scan -> winner finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    ear_blk = ear_d[None].expand(B, S, ear_d.shape[1])
    cand, _vals, _ysq, ok = f32.df4_twopass(D[:, 0], D[:, 1], csf_blk,
                                            ear_blk, y, R=R)
    return _finalized(D, csf_d, ear_d, y, cand[:, 0], 2, True, True, ok)


def _onepass_step4(D, csf_d, ear_d, y):
    """Full-grid df4 scan (dictionaries with N <= 2R) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    ear_blk = ear_d[None].expand(B, S, ear_d.shape[1])
    N2, E = D.shape[3], ear_d.shape[1]
    with stage("re-scan", y.device):
        rr, rf, _ysq = rescan.row_scan_df4(D[:, 0], D[:, 1], csf_blk,
                                           ear_blk, y)
        cand, _v = rescan.candidates_from_rows_df4(
            rr, rf, E, E, N2, segments_total=rescan.n_segments_df4(N2))
    return _finalized(D, csf_d, ear_d, y, cand[:, 0], 2, True, True)


def _scan12_step(D, csf_d, y):
    """One fascicle + CSF: the [N, 1] df2 scan (the CSF column as the
    second axis) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    with stage("df2 scan", y.device):
        cand, _v, _ysq = dfscan.df2_candidates(D[:, 0], csf_blk, y, M=1)
    return _finalized(D, csf_d, None, y, cand[:, 0], 1, True, False)


def _scan13_step(D, csf_d, ear_d, y):
    """One fascicle + CSF + EAR: kernel 3 on the full [N, E, 1] grid (the
    EAR atoms as the second axis, CSF the fixed third block; first
    minimum in (i1, e) order, E <= one segment of columns) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    E = ear_d.shape[1]
    ear_blk = ear_d[None].expand(B, S, E)
    with stage("re-scan", y.device):
        rr, ri, _ysq = rescan.row_scan_df3(D[:, 0], ear_blk, csf_blk, y)
        cand, _v = rescan.candidates_from_rows(
            rr, ri, segments=rescan.n_segments(E))
    return _finalized(D, csf_d, ear_d, y, cand[:, 0], 1, True, True)


def _scan22_step(D, y):
    """Two fascicles without CSF: the [N, N] df2 scan + finalize."""
    with stage("df2 scan", y.device):
        cand, _v, _ysq = dfscan.df2_candidates(D[:, 0], D[:, 1], y, M=1)
    return _finalized(D, None, None, y, cand[:, 0], 2, False, False)


def _chunk_step(rotate, tables_ys, csf_d, ear_d, pk, y, *, K, csf_on,
                ear_on, R):
    """One chunk of a fast-path bucket: the rotation of its voxels'
    directions ``pk`` (B, K, 3), then its bucket's scan and finalize
    (two-pass at row budget R, or with R None the full grid where the
    bucket has one). Returns (cand, w, obj, r2, ok)."""
    with stage("rotation", y.device):
        D = rotate(tables_ys, pk)
    if K == 1:
        if ear_on:
            return _scan13_step(D, csf_d, ear_d, y)
        return _scan12_step(D, csf_d, y)
    if not csf_on:
        return _scan22_step(D, y)
    if ear_on:
        if R is None:
            return _onepass_step4(D, csf_d, ear_d, y)
        return _twopass_step4(D, csf_d, ear_d, y, R)
    if R is None:
        return _onepass_step3(D, csf_d, y)
    return _twopass_step3(D, csf_d, y, R)


def _pinned(device):
    """Whether pushes to ``device`` go through pinned host memory (a
    card's)."""
    return torch.device(device).type == "cuda"


def _push(a, device, dtype=None, held=None):
    """The host array ``a`` on ``device`` as ``dtype``. To a card it is
    cast into pinned host memory and copied with ``non_blocking=True``
    on the device's current stream, so the push does not wait for the
    kernels queued there before it; the pinned buffer is appended to
    ``held``, which the caller keeps until it has pulled results that
    follow the copy on that stream. Elsewhere ``torch.as_tensor``. Both
    round float64 to float32 alike."""
    if not _pinned(device):
        return torch.as_tensor(a, dtype=dtype, device=device)
    host = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).pin_memory()
    held.append(host)
    return host.to(device, non_blocking=True)


def _deal(n_pad, batch, n_rows):
    """Chunk c of ``batch`` voxels runs on data row c % n_rows. Returns
    each row's share (the voxel indices of its chunks, in order) and, for
    each chunk, (row, its slice of the row's share)."""
    n_chunks = n_pad // batch
    shares = [np.concatenate([np.arange(c * batch, (c + 1) * batch)
                              for c in range(j, n_chunks, n_rows)])
              for j in range(min(n_rows, n_chunks))]
    where = [(c % n_rows, slice((c // n_rows) * batch,
                                (c // n_rows + 1) * batch))
             for c in range(n_chunks)]
    return shares, where


def _sharded_step3(devices, D, csf_d, y):
    """Two fascicles + CSF on one data row of a mesh: the [N, N, 1] df
    scan with the second block's atoms split over the row's ``devices``
    (``parallel/mesh.atoms_df3_candidates``) + finalize."""
    from ..parallel import mesh as pmesh
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    with stage("atoms scan", y.device):
        cand, _v, _ysq = pmesh.atoms_df3_candidates(
            devices, D[:, 0], D[:, 1], csf_blk, y, M=1)
    return _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False)


def run_bucket_fast(ms_host, plan_host, tables_ys, peaks, y, sig_csf,
                    K, csf_on, batch=128, rotator=None, sig_ear=None,
                    ear_on=False, mesh=None, defer=False):
    """One fast-path bucket with fascicles: rotation, exact scan and the
    double-float finalize, in ``batch``-voxel chunks on
    ``tables_ys.device``.

    ``tables_ys`` (S_shells, Kmax, N) float32 knot tables; peaks (n, 3K);
    y (n, S); sig_csf (S,) with ``csf_on``; sig_ear (S, E) with
    ``ear_on``. K is 1 or 2; one fascicle needs the CSF block and EAR
    needs it too, as in the JAX package (see the module docstring for
    each bucket's scan). The two-pass scans (K = 2 + CSF, with EAR at
    most ``f32scan.ROW4_HOIST_MAX_E`` EAR atoms) run at R =
    ``twopass_rows`` (``twopass_rows_ear`` with EAR); voxels whose row
    band overflows R are re-solved at 2R (batch ``min(batch, 64)``), then
    at R = N, so exact selection is unconditional. The other buckets
    scan their whole grid.

    With a ``mesh`` (``parallel/mesh.Mesh``) the chunks, and then the
    overflow batches, are dealt to its data rows in turn, each row's
    share pushed once and the tables and fixed columns replicated on its
    device, and every chunk is enqueued before any result is pulled: the
    chunks are the serial fit's, so every voxel's result is too. Where
    the mesh's 'atoms' axis is longer than 1 and divides N, the 2
    fascicles + CSF bucket scans instead with the second block's atoms
    split over the row (``_sharded_step3``), as in the JAX package.

    Every chunk is enqueued (``graphs.run``: a CUDA graph replay on a
    card) before any result is pulled; on a card the bucket's host arrays
    are pushed from pinned memory without waiting for the stream
    (``_push``), so a bucket's pushes do not wait for the kernels of the
    buckets enqueued before it. Returns NumPy (w (n, C), ind (n,
    C), min_obj, mse, r2), C = K + csf_on + ear_on, in the canonical
    index layout [fascicles..., csf=0 (with CSF), ie (with EAR)]; with
    ``defer`` a closure that pulls the results, runs the overflow tiers
    and returns them, so that a caller can enqueue every bucket first
    (the JAX package's ``defer``).
    """
    if K not in (1, 2) or (K == 1 and not csf_on) or (ear_on and not csf_on):
        raise NotImplementedError(
            "the fast path covers 1 and 2 fascicles; one fascicle and the "
            "EAR block need the CSF block (got K=%d, csf=%d, ear=%d): the "
            "general path, ROADMAP.md (Queue 1, item 4)"
            % (K, csf_on, ear_on))
    cfg = config.DEFAULTS["solver"]
    rows_R = cfg.twopass_rows_ear if ear_on else cfg.twopass_rows
    n_atom = tables_ys.shape[2]
    n_at_ax = 1 if mesh is None else mesh.shape["atoms"]
    sharded = (K == 2 and csf_on and not ear_on and n_at_ax > 1
               and n_atom % n_at_ax == 0)
    # the EAR two-pass packs 1 + 1 + E rhs columns into kernel 1's Grams
    # (ops/prep.MAX_RHS): wider EAR blocks take the full-grid re-scan, as
    # the JAX package's one-pass df4 scan takes them
    twopass = (K == 2 and csf_on and n_atom > 2 * cfg.twopass_rows
               and not (ear_on and np.shape(sig_ear)[1]
                        > f32.ROW4_HOIST_MAX_E))
    if rotator is None:
        rotator = mfi.make_grouped_rotation_paired(ms_host, plan_host)
    rotate, perm = rotator
    dev, dt = tables_ys.device, tables_ys.dtype
    rows = [[dev]] if mesh is None else mesh.devices
    slots = [row[0] for row in rows]
    n, S = y.shape
    held = []   # pinned host buffers of the pushes, held until the pull
    # the rotation emits sequences in group order: permute the signal and
    # the fixed columns alike (every result is permutation-invariant)
    csf_d = ear_d = E = None
    if csf_on:
        csf_d = _push(np.asarray(sig_csf)[perm], dev, dt, held)
    if ear_on:
        ear_d = _push(np.asarray(sig_ear)[perm], dev, dt, held)
        E = ear_d.shape[1]
    # the read-only blocks on every data row's device
    put = lambda t, d: None if t is None else t.to(d)
    consts = {d: (tables_ys.to(d), put(csf_d, d), put(ear_d, d))
              for d in slots}

    n_pad = int(math.ceil(n / batch) * batch)
    pk = np.zeros((n_pad, K, 3))
    pk[:n] = np.asarray(peaks).reshape(n, K, 3)
    y_all = np.zeros((n_pad, S))
    y_all[:n] = np.asarray(y)[:, perm]
    if n_pad > n:  # pad rows replicate voxel 0 to keep the kernels finite
        pk[n:] = pk[0]
        y_all[n:] = y_all[0]

    def pushed(idx, j):
        """Directions and signals of the voxels ``idx`` on row j."""
        return (_push(pk[idx], slots[j], dt, held),
                _push(y_all[idx], slots[j], dt, held))

    def solved(j, pk_c, yy, R, graph=True):
        """Chunk (pk_c, yy) on row j, through ``graphs.run`` or, for an
        overflow tier, eagerly."""
        tables_j, csf_j, ear_j = consts[slots[j]]
        if sharded:
            with stage("rotation", slots[j]):
                D = rotate(tables_j, pk_c)
            return _sharded_step3(rows[j], D, csf_j, yy)
        args = (rotate, tables_j, csf_j, ear_j, pk_c, yy)
        kw = dict(K=K, csf_on=bool(csf_on), ear_on=bool(ear_on), R=R)
        if graph:
            return graphs.run(_chunk_step, *args, **kw)
        return _chunk_step(*args, **kw)

    # each row's chunks pushed at once, every chunk enqueued before a pull
    n_rows = len(slots)
    shares, where = _deal(n_pad, batch, n_rows)
    pushes = [pushed(idx, j) for j, idx in enumerate(shares)]
    outs = [solved(j, pushes[j][0][sl], pushes[j][1][sl],
                   rows_R if twopass and not sharded else None)
            for j, sl in where]

    def finish():
        """The pull: the chunks' results joined, the overflow tiers run
        (eagerly), the index layout made canonical."""
        cand, w, obj, r2, ok = (torch.cat([t.to(dev) for t in x])[:n]
                                for x in zip(*outs))

        bad = torch.nonzero(~ok).flatten().cpu().numpy()
        if bad.size:
            # row-budget overflow (heavily tied voxels): re-solve at 2R,
            # then with every row and column (R = N), where ok cannot fail
            fb = min(batch, 64)
            tiers = ([2 * rows_R] if 2 * rows_R < n_atom else []) + [n_atom]
            for R in tiers:
                sels = [bad[st:st + fb] for st in range(0, bad.size, fb)]
                res = []
                for i, sel in enumerate(sels):
                    idx = np.concatenate([sel, np.full(fb - sel.size,
                                                       sel[0])])
                    res.append(solved(i % n_rows, *pushed(idx, i % n_rows),
                                      R, graph=False))
                still = []
                for sel, (c_f, w_f, o_f, r_f, ok_f) in zip(sels, res):
                    m = sel.size
                    good = ok_f[:m].cpu().numpy() | (R == n_atom)
                    done = _push(sel[good], dev, held=held)
                    keep = _push(np.flatnonzero(good), c_f.device,
                                 held=held)
                    cand[done] = c_f[keep].to(dev)
                    w[done] = w_f[keep].to(dev)
                    obj[done] = o_f[keep].to(dev)
                    r2[done] = r_f[keep].to(dev)
                    still.extend(sel[~good])
                bad = np.asarray(still, dtype=np.int64)
                if not bad.size:
                    break

        # the df quadratic form can round a noiseless voxel's residual a
        # few ulp below zero; a reported objective is never negative
        obj_b = np.maximum(obj.double().cpu().numpy(), 0.0)
        w_b = w.double().cpu().numpy()
        ind = cand.cpu().numpy().astype(np.int32)
        held.clear()   # every copy is done: its results are on the host
        # clip the fascicle (and CSF) columns to the atom range and the
        # EAR column to its own
        n_fix = ind.shape[1] - int(ear_on)
        ind[:, :n_fix] = np.clip(ind[:, :n_fix], 0, n_atom - 1)
        if ear_on:
            ind[:, -1] = np.clip(ind[:, -1], 0, E - 1)
            # an unused EAR block leaves the residual independent of the
            # ear atom: report the first index, as the reference's
            # first-minimum enumeration does
            ind[w_b[:, -1] <= 0, -1] = 0
        # canonical (fascicles..., csf, ear) index layout
        zero = np.zeros((n, 1), np.int32)
        if K == 1 and ear_on:                 # [i1, ie] -> [i1, csf=0, ie]
            ind = np.concatenate([ind[:, :1], zero, ind[:, 1:]], axis=1)
        elif K == 2 and csf_on and not ear_on:  # [i1, i2] -> + csf=0
            ind = np.concatenate([ind, zero], axis=1)
        return w_b, ind, obj_b, obj_b / S, r2.double().cpu().numpy()

    return finish if defer else finish()


def run_bucket_trivial(y, sig_csf, sig_ear, csf_on, ear_on):
    """Closed-form float64 host solve for fascicle-free voxels: the CSF
    column and/or the EAR block, by the 1- and 2-variable NNLS case
    analysis vectorized over voxels (the first minimum over EAR atoms
    wins). Returns NumPy (w, ind, min_obj, mse, r2) with
    C = csf_on + ear_on columns."""
    if not (csf_on or ear_on):
        raise ValueError("Empty configuration: no compartments to fit.")
    y64 = np.asarray(y, dtype=np.float64)
    n, S = y64.shape
    y_sq = np.einsum("ns,ns->n", y64, y64)
    if csf_on:
        csf64 = np.asarray(sig_csf, dtype=np.float64)
    if ear_on:
        ear64 = np.asarray(sig_ear, dtype=np.float64)
    rows = np.arange(n)
    if csf_on and ear_on:
        A11 = float(csf64 @ csf64)
        A22 = np.einsum("se,se->e", ear64, ear64)          # (E,)
        A12 = csf64 @ ear64                                # (E,)
        Y1 = y64 @ csf64                                   # (n,)
        Y2 = y64 @ ear64                                   # (n, E)
        w1, w2, res = mfn.lsqnonneg_2var(
            y_sq[:, None], A11, A12[None, :], A22[None, :], Y1[:, None],
            Y2)                                            # (n, E)
        ie = np.argmin(res, axis=1)
        w_b = np.stack([w1[rows, ie], w2[rows, ie]], axis=1)
        ind_b = np.stack([np.zeros(n, np.int32), ie.astype(np.int32)],
                         axis=1)
        obj_b = res[rows, ie]
        y_rec = w_b[:, :1] * csf64[None, :] + w_b[:, 1:] * ear64[:, ie].T
    elif csf_on:
        w, res = mfn.lsqnonneg_1var(y_sq, float(csf64 @ csf64), y64 @ csf64)
        w_b = w[:, None]
        ind_b = np.zeros((n, 1), np.int32)
        obj_b = res
        y_rec = w_b * csf64[None, :]
    else:  # EAR only
        a_sq = np.einsum("se,se->e", ear64, ear64)
        w, res = mfn.lsqnonneg_1var(y_sq[:, None], a_sq[None, :],
                                    y64 @ ear64)           # (n, E)
        ie = np.argmin(res, axis=1)
        w_b = w[rows, ie][:, None]
        ind_b = ie.astype(np.int32)[:, None]
        obj_b = res[rows, ie]
        y_rec = w_b * ear64[:, ie].T
    obj_b = np.maximum(obj_b, 0.0)
    return w_b, ind_b, obj_b, obj_b / S, _r2_np(y64, y_rec)


def _r2_np(y, y_rec):
    n = y.shape[-1]
    yc = y - y.mean(axis=-1, keepdims=True)
    rc = y_rec - y_rec.mean(axis=-1, keepdims=True)
    num = np.sum(yc * rc, axis=-1)
    den = np.sqrt(np.sum(yc * yc, axis=-1) * np.sum(rc * rc, axis=-1))
    ok = (den > 0) & (n > 1)
    r = np.where(ok, num / np.where(ok, den, 1.0), 0.0)
    return r * r


# ---------------------------------------------------------------------------
# The general path (engine='xla'): gather-and-lerp rotation, tiled
# exhaustive scans, float64 host refine
# ---------------------------------------------------------------------------

def plan_tensors(plan, dtype, device):
    """(gdir, shell_lo, shell_hi, wG) of a ``TargetSchemePlan`` as tensors
    on ``device``: the directions and blend weights in ``dtype``, the
    shell indices int64."""
    return (torch.as_tensor(plan.gdir, dtype=dtype, device=device),
            torch.as_tensor(plan.shell_lo, dtype=torch.int64, device=device),
            torch.as_tensor(plan.shell_hi, dtype=torch.int64, device=device),
            torch.as_tensor(plan.wG, dtype=dtype, device=device))


def _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                  peaks, y, sig_csf, sig_ear, K, csf_on, ear_on):
    """The voxel batch's sub-dictionaries: K rotated fascicle blocks
    (B, S, N), then the CSF column (B, S, 1) and the EAR block (B, S, E),
    each broadcast over the voxels (no copy)."""
    B, S = y.shape
    blocks = []
    if K > 0:
        with stage("rotation", y.device):
            D = mfi.eval_rotation_batch(xs, ys, cnt, gdir, shell_lo,
                                        shell_hi, wG, peaks)
        blocks.extend(D[:, k] for k in range(K))
    if csf_on:
        blocks.append(sig_csf[None, :, None].expand(B, S, 1))
    if ear_on:
        blocks.append(sig_ear[None].expand(B, S, sig_ear.shape[1]))
    if not blocks:
        raise ValueError("Empty configuration: no compartments to fit.")
    return blocks


def fit_step(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
             peaks, y, sig_csf, sig_ear, *, K, csf_on, ear_on):
    """One fit step for a (K, csf_on, ear_on) voxel bucket: rotation,
    exhaustive scan and quality metrics, on the tensors' device.

    Args:
      xs, ys, cnt: dictionary knot tables (``device_tables``).
      gdir, shell_lo, shell_hi, wG: target-scheme plan tensors.
      peaks: (B, K, 3) fascicle directions (zero-size K axis allowed).
      y: (B, S) measured DWI signals.
      sig_csf: (S,) CSF fingerprint; sig_ear: (S, E) EAR fingerprints
        (read only when their compartment is on).

    Returns dict with w (B, C), ind (B, C), min_obj (B,), mse (B,), r2 (B,)
    where C = K + csf_on + ear_on is the number of compartments.
    """
    S = y.shape[1]
    blocks = _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                           peaks, y, sig_csf, sig_ear, K, csf_on, ear_on)
    with stage("scan", y.device):
        w, ind, min_obj = mfn.exhaustive_nnls_blocks(tuple(blocks), y)

    # y_hat = sum_k w_k * block_k[:, :, ind_k]
    y_rec = torch.zeros_like(y)
    for j, blk in enumerate(blocks):
        col = torch.gather(blk, 2, ind[:, j].long()[:, None, None].expand(
            -1, S, 1))[:, :, 0]
        y_rec = y_rec + w[:, j][:, None] * col
    return {"w": w, "ind": ind, "min_obj": min_obj, "mse": min_obj / S,
            "r2": dfscan.r_squared(y, y_rec)}


def fit_step_candidates(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                        peaks, y, sig_csf, sig_ear, *,
                        K, csf_on, ear_on, M=8):
    """Top-M candidate indices per voxel for the float64 host re-scoring
    (models/refine.py). Returns (B, M, C) int32."""
    blocks = _build_blocks(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                           peaks, y, sig_csf, sig_ear, K, csf_on, ear_on)
    with stage("candidates", y.device):
        return mfn.exhaustive_candidates_blocks(tuple(blocks), y, M=M)


def run_bucket(tables, plan, peaks, y, sig_csf, sig_ear,
               K, csf_on, ear_on, batch=128, dtype=None,
               refine=False, ms_host=None, plan_host=None, topm=8,
               mesh=None):
    """Run the general path's fit step over a bucket of voxels in
    ``batch``-voxel chunks on the tables' device.

    ``tables`` (xs, ys, cnt) from ``MultiShellInterp.device_tables`` and
    ``plan`` (gdir, shell_lo, shell_hi, wG) tensors on one device;
    ``peaks`` (n, 3*K) and ``y`` (n, S) NumPy arrays of one bucket.
    ``dtype`` (the tables' by default) is the scan's arithmetic. The
    bucket is pushed to the device once, its results are pulled once,
    and pad rows replicate voxel 0. With ``refine`` the scan keeps its
    ``topm`` best candidates per voxel and the float64 host re-scorer
    picks among them (``ms_host``, ``plan_host``: the host tables and
    plan). With a ``mesh`` the chunks are dealt to its data rows in
    turn, tables, plan and fixed columns replicated on each row's device
    (as in ``run_bucket_fast``: every voxel's result is the serial
    fit's). Returns NumPy (w, ind, min_obj, mse, r2); objectives are
    clipped at 0.
    """
    dev = tables[1].device
    if dtype is None:
        dtype = tables[0].dtype
    n, S = y.shape
    slots = [dev] if mesh is None else mesh.data_devices
    held = []   # pinned host buffers of the pushes, held until the pull
    sig_csf_d = _push(sig_csf if csf_on else np.zeros(S), dev, dtype, held)
    sig_ear_d = _push(sig_ear if ear_on else np.zeros((S, 1)), dev, dtype,
                      held)
    # the read-only tables, plan and fixed columns on each row's device
    consts = {d: tuple(t.to(d) for t in tuple(tables) + tuple(plan)
                       + (sig_csf_d, sig_ear_d)) for d in slots}

    n_pad = int(math.ceil(n / batch) * batch)
    # float64 peaks for the host refine; the device copy in the scan dtype
    pk64 = np.zeros((n_pad, max(K, 1), 3), dtype=np.float64)
    y_all = np.zeros((n_pad, S), dtype=np.float64)
    if K > 0:
        pk64[:n] = np.asarray(peaks).reshape(n, K, 3)
    y_all[:n] = y
    if n_pad > n:  # pad rows replicate voxel 0 to keep the scans NaN-free
        pk64[n:] = pk64[0]
        y_all[n:] = y_all[0]
    # each row's chunks pushed at once
    shares, where = _deal(n_pad, batch, len(slots))
    pushes = [(_push(pk64[idx, :K], slots[j], dtype, held),
               _push(y_all[idx], slots[j], dtype, held))
              for j, idx in enumerate(shares)]

    step = fit_step_candidates if refine else fit_step
    extra = dict(M=topm) if refine else {}
    chunks = []
    for j, sl in where:
        xs, ys, cnt, gdir, lo, hi, wG, csf_j, ear_j = consts[slots[j]]
        chunks.append(graphs.run(
            step, xs, ys, cnt, gdir, lo, hi, wG, pushes[j][0][sl],
            pushes[j][1][sl], csf_j, ear_j, K=K, csf_on=bool(csf_on),
            ear_on=bool(ear_on), **extra))

    if refine:
        # float32 device scan -> top-M candidates -> exact float64 re-score
        cand = torch.cat([c.to(dev) for c in chunks]).cpu().numpy()[:n]
        y64 = np.asarray(y, dtype=np.float64)
        w_b, ind_b, obj_b, y_rec = refine_mod.refine_candidates(
            ms_host, plan_host, pk64[:n, :K], y64,
            np.asarray(sig_csf, dtype=np.float64) if csf_on else None,
            np.asarray(sig_ear, dtype=np.float64) if ear_on else None,
            cand, K, bool(csf_on), bool(ear_on))
        obj_b = np.maximum(obj_b, 0.0)   # never report a negative residual
        return w_b, ind_b, obj_b, obj_b / S, _r2_np(y64, y_rec)

    stacked = {k: torch.cat([c[k].to(dev) for c in chunks]).cpu().numpy()[:n]
               for k in ("w", "ind", "min_obj", "mse", "r2")}
    return (stacked["w"], stacked["ind"],
            np.maximum(stacked["min_obj"], 0.0),
            np.maximum(stacked["mse"], 0.0), stacked["r2"])
