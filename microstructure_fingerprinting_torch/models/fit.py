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
re-scored exactly in float64 on the host (``models/refine.py``), a
chunk's as soon as its copy has reached the host, while the device runs
the chunks queued after it (``RESCORES`` counts how often).

``run_bucket_trivial`` solves the fascicle-free (CSF and/or EAR) voxels
in closed form on the host.

With ``refine`` (``MFModel.fit``'s default) ``run_bucket_fast`` makes
its selection exact against the float64 optimum too: each chunk step
certifies its voxels' winners against the float32 rotation's error
bound (``models/certify.py``); the voxels it cannot certify are
re-scored on the host among their near-ties (``_Exact``), the few left
certified again wider and then solved by the general path's scan in
float64. ``CERTIFY`` counts the voxels of each kind.

``run_bucket_fast`` and ``run_bucket`` take a device mesh
(``parallel/mesh.py``): whole chunks are dealt to its data rows, so
every voxel's result is the serial fit's.

Each chunk step (``_chunk_step``: rotation, scan and finalize of a
fast-path chunk; ``fit_step`` / ``fit_step_candidates`` on the general
path) runs through ``graphs.run``: on a card, one captured CUDA graph a
step and shape, replayed for every chunk, as the JAX package jits each
step; eagerly on the CPU and under a stage timer. The overflow tiers
and the atoms-split scan stay eager.

Spans (``utils/profiling.stage``) of the bucket runners: "push" (a
bucket's pushes), "pull" (each blocking read from the card), "overflow
2R" and "overflow N" (a tier's batches), "certify" (a chunk's host
re-score of its near-ties), "certify fallback" (the wide pass and the
exhaustive float64 solve), "trivial" (``run_bucket_trivial``); the chunk
steps' stages ("rotation", "scan", ..., "certificate" and in it
"certificate bound") as before.
"""

import contextlib
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
from . import certify
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


def _certified(out, cells, D, csf_d, ear_d, y, cert, winner, ok=None,
               **grid):
    """A chunk step's result ``out`` (cand, w, obj, r2, ok) followed, with
    a ``cert`` (``_Cert``), by its certificate packed in one (B, 2 + 3 M)
    int32 tensor: status, the count of candidates, the candidates
    (``models/certify.certify``). ``ok``: the row pass's budget flags
    where rows were pruned (their voxels read ``certify.OVERFLOW``)."""
    if cert is None:
        return out
    grid.update(cells, ok=ok)
    grid["q"] *= cert.wide
    with stage("certificate", y.device):
        with stage("certificate bound", y.device):
            eta = cert.bound.eta(cert.pk, cert.pk64)
        status, cand, n = certify.certify(D, y, csf_d, ear_d, eta,
                                          grid.pop("cellv"), grid, winner)
        pack = torch.cat([status[:, None], n[:, None],
                          cand.reshape(y.shape[0], -1)], dim=1)
    return out + (pack,)


def _twopass_step3(D, csf_d, y, R, cert=None):
    """One chunk of the production path: interval row pass -> row
    selection -> df re-scan -> winner finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    cand, _vals, _ysq, ok, *cells = f32.df3_twopass(
        D[:, 0], D[:, 1], csf_blk, y, R=R, cells=cert is not None)
    out = _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False, ok)
    return _certified(out, *cells[:1] or [{}], D, csf_d, None, y, cert,
                      cand[:, 0], ok if R < D.shape[3] else None,
                      inner="fasc", fixed=3, q=certify.Q_CELLS)


def _onepass_step3(D, csf_d, y, cert=None):
    """Full-grid df scan (dictionaries with N <= 2R) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    N2 = D.shape[3]
    with stage("re-scan", y.device):
        rr, ri, _ysq = rescan.row_scan_df3(D[:, 0], D[:, 1], csf_blk, y)
        n_seg = rescan.n_segments(N2)
        cand, _v = rescan.candidates_from_rows(rr, ri, segments=n_seg)
    out = _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False)
    return _certified(
        out, dict(cellv=rr, n1p=rr.shape[1] // n_seg, n2=N2, rows=None,
                  cols=None, segw=rescan.col_blocks(N2)[1]
                  // rescan._SEGMENTS),
        D, csf_d, None, y, cert, cand[:, 0], inner="fasc", fixed=3,
        q=certify.Q_CELLS)


def _twopass_step4(D, csf_d, ear_d, y, R, cert=None):
    """One chunk of the EAR production path: 4-block interval row pass ->
    row/column selection -> df4 re-scan -> winner finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    ear_blk = ear_d[None].expand(B, S, ear_d.shape[1])
    cand, _vals, _ysq, ok, *cells = f32.df4_twopass(
        D[:, 0], D[:, 1], csf_blk, ear_blk, y, R=R, cells=cert is not None)
    out = _finalized(D, csf_d, ear_d, y, cand[:, 0], 2, True, True, ok)
    return _certified(out, *cells[:1] or [{}], D, csf_d, ear_d, y, cert,
                      cand[:, 0], ok if R < D.shape[3] else None,
                      inner="fasc", ear_axis=True, fixed=4,
                      q=certify.Q_CELLS_EAR)


def _onepass_step4(D, csf_d, ear_d, y, cert=None):
    """Full-grid df4 scan (dictionaries with N <= 2R) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    ear_blk = ear_d[None].expand(B, S, ear_d.shape[1])
    N2, E = D.shape[3], ear_d.shape[1]
    segs = rescan.df4_cell_segments(N2) if cert is not None else 1
    with stage("re-scan", y.device):
        rr, rf, _ysq = rescan.row_scan_df4(D[:, 0], D[:, 1], csf_blk,
                                           ear_blk, y, segments=segs)
        n_seg = rescan.n_segments_df4(N2, segs)
        cand, _v = rescan.candidates_from_rows_df4(
            rr, rf, E, E, N2, segments_total=n_seg)
    out = _finalized(D, csf_d, ear_d, y, cand[:, 0], 2, True, True)
    return _certified(
        out, dict(cellv=rr, n1p=rr.shape[1] // n_seg, n2=N2, rows=None,
                  cols=None, segw=rescan.col_blocks(N2, 256, 16)[1] // segs),
        D, csf_d, ear_d, y, cert, cand[:, 0], inner="fasc", ear_axis=True,
        fixed=4, q=certify.Q_CELLS_EAR)


def _scan12_step(D, csf_d, y, cert=None):
    """One fascicle + CSF: the [N, 1] df2 scan (the CSF column as the
    second axis) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    with stage("df2 scan", y.device):
        if cert is None:
            cand, _v, _ysq = dfscan.df2_candidates(D[:, 0], csf_blk, y, M=1)
        else:
            cand, _v, _ysq, rv = dfscan.df2_row_minima(D[:, 0], csf_blk, y)
    out = _finalized(D, csf_d, None, y, cand[:, 0], 1, True, False)
    if cert is None:
        return out
    return _certified(
        out, dict(cellv=rv, n1p=rv.shape[1], n2=1, rows=None, cols=None,
                  segw=1), D, csf_d, None, y, cert, cand[:, 0],
        inner="csf", fixed=2, q=certify.Q_CELLS_ONE)


def _scan13_step(D, csf_d, ear_d, y, cert=None):
    """One fascicle + CSF + EAR: kernel 3 on the full [N, E, 1] grid (the
    EAR atoms as the second axis, CSF the fixed third block; first
    minimum in (i1, e) order, E <= one segment of columns) + finalize."""
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    E = ear_d.shape[1]
    ear_blk = ear_d[None].expand(B, S, E)
    with stage("re-scan", y.device):
        rr, ri, _ysq = rescan.row_scan_df3(D[:, 0], ear_blk, csf_blk, y)
        n_seg = rescan.n_segments(E)
        cand, _v = rescan.candidates_from_rows(rr, ri, segments=n_seg)
    out = _finalized(D, csf_d, ear_d, y, cand[:, 0], 1, True, True)
    return _certified(
        out, dict(cellv=rr, n1p=rr.shape[1] // n_seg, n2=E, rows=None,
                  cols=None, segw=rescan.col_blocks(E)[1] // rescan._SEGMENTS),
        D, csf_d, ear_d, y, cert, cand[:, 0], inner="ear", fixed=3,
        q=certify.Q_CELLS)


def _scan22_step(D, y, cert=None):
    """Two fascicles without CSF: the [N, N] df2 scan + finalize."""
    with stage("df2 scan", y.device):
        if cert is None:
            cand, _v, _ysq = dfscan.df2_candidates(D[:, 0], D[:, 1], y, M=1)
        else:
            cand, _v, _ysq, rv = dfscan.df2_row_minima(D[:, 0], D[:, 1], y)
    out = _finalized(D, None, None, y, cand[:, 0], 2, False, False)
    if cert is None:
        return out
    return _certified(
        out, dict(cellv=rv, n1p=rv.shape[1], n2=D.shape[3], rows=None,
                  cols=None, segw=D.shape[3]), D, None, None, y, cert,
        cand[:, 0], inner="full", fixed=2, q=certify.Q_CELLS_ROW)


class _Cert:
    """What a chunk step's certificate reads besides the scan: the
    rotation's error bound, the chunk's directions in float32 (as the
    rotation read them) and in float64, and how many times the usual
    cells it evaluates (``wide``)."""

    def __init__(self, bound, pk, pk64, wide=1):
        self.bound, self.pk, self.pk64, self.wide = bound, pk, pk64, wide


def _chunk_step(rotate, tables_ys, csf_d, ear_d, pk, y, bound=None,
                pk64=None, *, K, csf_on, ear_on, R, wide=1):
    """One chunk of a fast-path bucket: the rotation of its voxels'
    directions ``pk`` (B, K, 3), then its bucket's scan and finalize
    (two-pass at row budget R, or with R None the full grid where the
    bucket has one). Returns (cand, w, obj, r2, ok); with a ``bound``
    (``models/certify.Bound``) and the directions in float64 ``pk64``,
    a sixth item, the chunk's certificate (``_certified``) over
    ``wide`` times its usual cells."""
    with stage("rotation", y.device):
        D = rotate(tables_ys, pk)
    cert = None if bound is None else _Cert(bound, pk, pk64, wide)
    if K == 1:
        if ear_on:
            return _scan13_step(D, csf_d, ear_d, y, cert)
        return _scan12_step(D, csf_d, y, cert)
    if not csf_on:
        return _scan22_step(D, y, cert)
    if ear_on:
        if R is None:
            return _onepass_step4(D, csf_d, ear_d, y, cert)
        return _twopass_step4(D, csf_d, ear_d, y, R, cert)
    if R is None:
        return _onepass_step3(D, csf_d, y, cert)
    return _twopass_step3(D, csf_d, y, R, cert)


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


def _sharded_step3(devices, D, csf_d, y, cert=None):
    """Two fascicles + CSF on one data row of a mesh: the [N, N, 1] df
    scan with the second block's atoms split over the row's ``devices``
    (``parallel/mesh.atoms_df3_candidates``) + finalize. With a ``cert``
    the scan keeps its ``certify.Q_CELLS_ONE`` best combinations, each a
    cell of the certificate (the first is the top-1's)."""
    from ..parallel import mesh as pmesh
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    m = 1 if cert is None else certify.Q_CELLS_ONE
    with stage("atoms scan", y.device):
        cand, vals, _ysq = pmesh.atoms_df3_candidates(
            devices, D[:, 0], D[:, 1], csf_blk, y, M=m)
    out = _finalized(D, csf_d, None, y, cand[:, 0], 2, True, False)
    if cert is None:
        return out
    return _certified(
        out, dict(cellv=vals, n1p=m, n2=D.shape[3], segw=1,
                  rows=cand[:, :, 0].long(), cols=None,
                  inner_of_cell=cand[:, :, 1].long()),
        D, csf_d, None, y, cert, cand[:, 0], inner="fasc", fixed=3,
        q=certify.Q_CELLS_ONE - 1)


#: the fast path's voxels since the process started, by how their atoms
#: were decided (``refine``): certified by the scan alone, re-scored in
#: float64 on the host among their near-ties, or solved by the
#: exhaustive float64 fallback
CERTIFY = {"certified": 0, "rescored": 0, "fallback": 0}
#: voxels a chunk of the fallback's exhaustive float64 solve
FALLBACK_BATCH = 16
#: the host re-score's groups of voxels by their count of candidates
_GROUPS = (1, 2, 4, 8, 16, 32, 64)
#: the certificate's wide pass over the voxels it first hands to the
#: fallback: this many times the usual cells, in batches of this many
#: voxels (a chunk's where the chunk is smaller)
WIDE = 8
WIDE_BATCH = 64


def _refine_layout(cand3, K, csf_on, ear_on):
    """``certify.certify``'s candidates (n, M, 3) [i1, second axis, EAR
    atom] in ``refine_candidates``' layout (n, M, C) [fascicles..., csf=0,
    ear]."""
    c = cand3.astype(np.int32)
    zero = np.zeros_like(c[..., :1])
    if K == 1:
        if ear_on:                                     # [i1, csf, e]
            return np.concatenate([c[..., :1], zero, c[..., 1:2]], axis=-1)
        return np.concatenate([c[..., :1], zero], axis=-1)
    if not csf_on:
        return c[..., :2]
    if ear_on:
        return np.concatenate([c[..., :2], zero, c[..., 2:]], axis=-1)
    return np.concatenate([c[..., :2], zero], axis=-1)


class _Exact:
    """The host side of the fast path's exact selection for one bucket:
    each chunk's certificate (``_certified``'s pack) is copied to pinned
    host memory behind its step and read once it has landed, in chunk
    order; the voxels it leaves to a re-score have their candidates
    solved in float64 (``refine_candidates``: the general path's
    function and native columns), the voxels it hands to the fallback
    wait for ``fallback``. ``apply`` writes both into a bucket's
    results."""

    def __init__(self, n, batch, ms_host, plan_host, pk64, y64, sig_csf,
                 sig_ear, K, csf_on, ear_on, device):
        self.n, self.batch = n, batch
        self.ms, self.plan = ms_host, plan_host
        self.pk64, self.y64 = pk64, y64
        self.K, self.csf_on, self.ear_on = K, csf_on, ear_on
        self.csf = np.asarray(sig_csf, np.float64) if csf_on else None
        self.ear = np.asarray(sig_ear, np.float64) if ear_on else None
        self.host = _PULLS.host((pk64.shape[0], 2 + 3 * certify.M),
                                torch.int32, device)
        self.events = []
        self.next = 0
        self.fixed = []         # (voxels, (w, ind, obj, r2)) re-solved
        self.pending = []       # voxels awaiting the wide pass
        self.fallen = []        # voxels for the exhaustive solve
        self.wide = None        # wide(voxels) -> their wide certificates

    def add(self, pack):
        """Enqueue the copy of the next chunk's certificate to the host."""
        c = len(self.events)
        rows = slice(c * self.batch, (c + 1) * self.batch)
        self.events.append(_PULLS.copy(self.host[rows], pack))

    def drain(self):
        """Wait for the remaining chunks in order and read each; then
        run the wide pass of every voxel still waiting for it."""
        while self.next < len(self.events):
            with stage("pull"):
                _PULLS.wait(self.events[self.next])
            self._chunk()
        self.flush(everything=True)

    def _chunk(self):
        c, b = self.next, self.batch
        lo, hi = c * b, min((c + 1) * b, self.n)
        self.take(np.arange(lo, hi), self.host[lo:hi].numpy())
        self.next += 1
        self.flush()

    def flush(self, everything=False):
        """The wide pass of the voxels waiting for it, a full batch at a
        time (``everything``: the last one too); what it leaves
        undecided goes to the exhaustive solve."""
        wait = np.unique(np.concatenate(self.pending or
                                        [np.zeros(0, int)]))
        size = WIDE_BATCH if self.batch >= WIDE_BATCH else self.batch
        while wait.size >= size or (everything and wait.size):
            sel, wait = wait[:size], wait[size:]
            packs = self.wide(sel)
            # a lone candidate here is re-scored too: the chunk's own
            # winner came from a narrower scan
            packs[packs[:, 0] == certify.CERTIFIED, 0] = certify.RESCORE
            self.take(sel, packs, final=True)
        self.pending = [wait]

    def take(self, idx, packs, final=False):
        """Read the certificates ``packs`` (k, 2 + 3 M) of voxels ``idx``:
        re-score those it leaves to the host, note those for the wide
        pass (``final``: for the exhaustive solve); a voxel that
        overflowed its row budget waits for its tier's certificate."""
        status = packs[:, 0]
        (self.fallen if final else self.pending).append(
            idx[status == certify.FALLBACK])
        sel = status == certify.RESCORE
        if not sel.any():
            return
        n = packs[:, 1]
        with stage("certify"):
            # voxels grouped by their count of candidates, each group
            # handed that many (at most twice its voxels' own)
            lo = 0
            for hi in _GROUPS:
                grp = sel & (n > lo) & (n <= hi)
                lo = hi
                if not grp.any():
                    continue
                vox = idx[grp]
                m = int(n[grp].max())
                cand = _refine_layout(
                    packs[grp, 2:].reshape(-1, certify.M, 3)[:, :m], self.K,
                    self.csf_on, self.ear_on)
                y = self.y64[vox]
                w, ind, obj, y_rec = refine_mod.refine_candidates(
                    self.ms, self.plan, self.pk64[vox, :self.K], y, self.csf,
                    self.ear, cand, self.K, self.csf_on, self.ear_on)
                self.fixed.append((vox, (w, ind, obj, _r2_np(y, y_rec))))

    def fallback(self, dev):
        """The exhaustive float64 solve of every voxel handed to the
        fallback: the general path's scan in float64 on ``dev``."""
        vox = np.unique(np.concatenate(self.fallen or [np.zeros(0, int)]))
        self.fallen = vox
        if not vox.size:
            return
        # on a card, a stream of its own (its copies too): the solve need
        # not wait for the chunks of the buckets queued after this one
        side = (torch.cuda.stream(torch.cuda.Stream(dev))
                if dev.type == "cuda" else contextlib.nullcontext())
        with stage("certify fallback"), graphs.eager(), side:
            tables = self.ms.device_tables(dev, torch.float64)
            plan = plan_tensors(self.plan, torch.float64, dev)
            w, ind, obj, _mse, r2 = run_bucket(
                tables, plan, self.pk64[vox, :self.K].reshape(vox.size, -1),
                self.y64[vox], self.csf, self.ear, self.K, self.csf_on,
                self.ear_on, batch=FALLBACK_BATCH, dtype=torch.float64)
        self.fixed.append((vox, (w, ind, obj, r2)))

    def apply(self, w, ind, obj, r2):
        """Write the re-scored and fallback voxels into the bucket's (w,
        ind, obj, r2), in the order they were solved (a voxel of an
        overflow tier, or of the fallback, last), and count every
        voxel."""
        moved = set()
        for vox, (w_v, ind_v, obj_v, r2_v) in self.fixed:
            w[vox], ind[vox], r2[vox] = w_v, ind_v, r2_v
            obj[vox] = np.maximum(obj_v, 0.0)
            moved.update(vox.tolist())
        n_fb = len(self.fallen)
        CERTIFY["fallback"] += n_fb
        CERTIFY["rescored"] += len(moved) - n_fb
        CERTIFY["certified"] += self.n - len(moved)


def run_bucket_fast(ms_host, plan_host, tables_ys, peaks, y, sig_csf,
                    K, csf_on, batch=128, rotator=None, sig_ear=None,
                    ear_on=False, mesh=None, defer=False, refine=False,
                    bound=None):
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

    With ``refine`` the selection is exact against the float64 optimum
    too (``models/certify``): each chunk step also certifies its
    voxels' winners against the float32 rotation's error bound
    (``bound``, a ``certify.Bound`` of ``ms_host`` and ``plan_host``,
    built here when None); a chunk's certificate is copied to the host
    behind its step and, once it has landed, the voxels whose near-ties
    it cannot decide have them re-scored in float64 on the host, span
    "certify", while the card runs the chunks queued after it; the few
    voxels with too many near-ties are solved by the exhaustive float64
    fallback after the bucket's pull, span "certify fallback".
    ``CERTIFY`` counts the voxels of each kind. A certified voxel's
    result is the scan's, bit for bit.

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
    if refine and bound is None:
        bound = certify.Bound(ms_host, plan_host)
    if not refine:
        bound = None
    rotate, perm = rotator
    dev, dt = tables_ys.device, tables_ys.dtype
    rows = [[dev]] if mesh is None else mesh.devices
    slots = [row[0] for row in rows]
    n, S = y.shape
    held = []   # pinned host buffers of the pushes, held until the pull
    n_pad = int(math.ceil(n / batch) * batch)
    n_rows = len(slots)
    shares, where = _deal(n_pad, batch, n_rows)

    def pushed(idx, j):
        """Directions and signals of the voxels ``idx`` on row j (and,
        with the certificate, the directions in float64)."""
        got = (_push(pk[idx], slots[j], dt, held),
               _push(y_all[idx], slots[j], dt, held))
        if bound is None:
            return got
        return got + (_push(pk[idx], slots[j], torch.float64, held),)

    def solved(j, pk_c, yy, R, pk64_c=None, graph=True, wide=1):
        """Chunk (pk_c, yy) on row j, through ``graphs.run`` or, for an
        overflow tier and the certificate's wide pass, eagerly."""
        tables_j, csf_j, ear_j = consts[slots[j]]
        cert = None if bound is None else _Cert(bound, pk_c, pk64_c, wide)
        if sharded:
            with stage("rotation", slots[j]):
                D = rotate(tables_j, pk_c)
            return _sharded_step3(rows[j], D, csf_j, yy, cert)
        args = (rotate, tables_j, csf_j, ear_j, pk_c, yy)
        if bound is not None:
            args += (bound, pk64_c)
        kw = dict(K=K, csf_on=bool(csf_on), ear_on=bool(ear_on), R=R)
        if wide > 1:
            kw["wide"] = wide
        if graph:
            return graphs.run(_chunk_step, *args, **kw)
        return _chunk_step(*args, **kw)

    with stage("push"):
        # the rotation emits sequences in group order: permute the signal
        # and the fixed columns alike (every result is
        # permutation-invariant)
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

        pk = np.zeros((n_pad, K, 3))
        pk[:n] = np.asarray(peaks).reshape(n, K, 3)
        y_all = np.zeros((n_pad, S))
        y_all[:n] = np.asarray(y)[:, perm]
        if n_pad > n:  # pad rows replicate voxel 0 to keep the kernels finite
            pk[n:] = pk[0]
            y_all[n:] = y_all[0]
        # each row's chunks pushed at once
        pushes = [pushed(idx, j) for j, idx in enumerate(shares)]
    exact = None
    if bound is not None:
        exact = _Exact(n, batch, ms_host, plan_host, pk,
                       np.asarray(y, dtype=np.float64), sig_csf, sig_ear, K,
                       bool(csf_on), bool(ear_on), dev)

        def wide(sel):
            """The certificates of voxels ``sel`` over their whole grid (no
            row pruned) and ``WIDE`` times the cells, eagerly, on a stream
            of the card's own: the chunks queued on its stream need not
            finish first."""
            size = WIDE_BATCH if batch >= WIDE_BATCH else batch
            idx = np.concatenate([sel, np.full(size - sel.size, sel[0])])
            side = (torch.cuda.stream(torch.cuda.Stream(slots[0]))
                    if _pinned(slots[0]) else contextlib.nullcontext())
            with stage("certify fallback"), side:
                got = pushed(idx, 0)
                out = solved(0, *got[:2], n_atom if twopass else None,
                             *got[2:], graph=False, wide=WIDE)
                with stage("pull"):
                    return out[5][:sel.size].cpu().numpy()

        exact.wide = wide
    # every chunk enqueued before a pull; with the certificate, each
    # chunk's copied to the host behind it (read in ``finish``, while the
    # card runs what was queued after it)
    outs = []
    for j, sl in where:
        outs.append(solved(j, *(p[sl] for p in pushes[j][:2]),
                           rows_R if twopass and not sharded else None,
                           *(p[sl] for p in pushes[j][2:])))
        if exact is not None:
            exact.add(outs[-1][5])

    def finish():
        """The pull: the chunks' results joined, the overflow tiers run
        (eagerly), the index layout made canonical."""
        if exact is not None:
            exact.drain()
        cand, w, obj, r2, ok = (torch.cat([t.to(dev) for t in x])[:n]
                                for x in list(zip(*outs))[:5])

        fb = min(batch, 64)
        with stage("pull"):
            bad = torch.nonzero(~ok).flatten().cpu().numpy()
        if bad.size:
            # row-budget overflow (heavily tied voxels): re-solve at 2R,
            # then with every row and column (R = N), where ok cannot fail
            tiers = ([2 * rows_R] if 2 * rows_R < n_atom else []) + [n_atom]
            for R in tiers:
                with stage("overflow N" if R == n_atom else "overflow 2R"):
                    sels = [bad[st:st + fb] for st in range(0, bad.size, fb)]
                    res = []
                    for i, sel in enumerate(sels):
                        idx = np.concatenate([sel, np.full(fb - sel.size,
                                                           sel[0])])
                        j = i % n_rows
                        got = pushed(idx, j)
                        res.append(solved(j, *got[:2], R, *got[2:],
                                          graph=False))
                    still = []
                    for sel, (c_f, w_f, o_f, r_f, ok_f, *pack_f) in zip(
                            sels, res):
                        m = sel.size
                        with stage("pull"):
                            good = ok_f[:m].cpu().numpy() | (R == n_atom)
                        done = _push(sel[good], dev, held=held)
                        keep = _push(np.flatnonzero(good), c_f.device,
                                     held=held)
                        cand[done] = c_f[keep].to(dev)
                        w[done] = w_f[keep].to(dev)
                        obj[done] = o_f[keep].to(dev)
                        r2[done] = r_f[keep].to(dev)
                        if exact is not None:
                            with stage("pull"):
                                packs = pack_f[0][:m].cpu().numpy()
                            exact.take(sel[good], packs[good])
                        still.extend(sel[~good])
                    bad = np.asarray(still, dtype=np.int64)
                if not bad.size:
                    break

        # the df quadratic form can round a noiseless voxel's residual a
        # few ulp below zero; a reported objective is never negative
        with stage("pull"):
            obj_b = np.maximum(obj.double().cpu().numpy(), 0.0)
            w_b = w.double().cpu().numpy()
            ind = cand.cpu().numpy().astype(np.int32)
            r2_b = r2.double().cpu().numpy()
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
        if exact is not None:
            exact.flush(everything=True)     # the overflow tiers' voxels
            exact.fallback(dev)
            exact.apply(w_b, ind, obj_b, r2_b)
        return w_b, ind, obj_b, obj_b / S, r2_b

    if exact is not None:
        finish.drain = exact.drain
    return finish if defer else finish()


def run_bucket_trivial(y, sig_csf, sig_ear, csf_on, ear_on):
    """Closed-form float64 host solve for fascicle-free voxels: the CSF
    column and/or the EAR block, by the 1- and 2-variable NNLS case
    analysis vectorized over voxels (the first minimum over EAR atoms
    wins). Returns NumPy (w, ind, min_obj, mse, r2) with
    C = csf_on + ear_on columns."""
    with stage("trivial"):
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
            w, res = mfn.lsqnonneg_1var(y_sq, float(csf64 @ csf64),
                                        y64 @ csf64)
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


class _Pulls:
    """What the general path's chunk pulls ask of the device, in one place
    (the tests hand in a stand-in, as for ``graphs._CARD``). On a card a
    chunk's copy to the host is enqueued on the current stream of the
    chunk's own device, into pinned memory, and an event recorded there
    after it says when it has landed; on the CPU a copy is done when it
    returns, and its event is None."""

    def host(self, shape, dtype, device):
        """An empty host tensor for the copies from ``device``."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=torch.device(device).type == "cuda")

    def copy(self, dst, src):
        """Enqueue ``dst.copy_(src)``; returns its completion event."""
        if src.device.type != "cuda":
            dst.copy_(src)
            return None
        dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(src.device))
        return event

    def done(self, event):
        return event is None or event.query()

    def wait(self, event):
        if event is not None:
            event.synchronize()


_PULLS = _Pulls()

#: chunks of the general path re-scored on the host before their bucket's
#: last chunk step was enqueued ("overlapped", in the shadow of the steps
#: queued after them) and after it ("tail"), since the process started
RESCORES = {"overlapped": 0, "tail": 0}


class _Rescore:
    """The float64 host re-score of a bucket's chunks, one chunk at a time,
    as each chunk's top-M candidates reach the host, in chunk order; every
    chunk's columns are written into one reused (C0, batch, M, S) buffer
    whose CSF plane is written once."""

    def __init__(self, n, batch, M, ms_host, plan_host, pk64, y_all,
                 sig_csf, sig_ear, K, csf_on, ear_on, device):
        n_pad, S = y_all.shape
        C = K + csf_on + ear_on
        self.n, self.batch, self.K = n, batch, K
        self.ms, self.plan = ms_host, plan_host
        self.pk64, self.y_all = pk64, y_all
        self.csf = np.asarray(sig_csf, dtype=np.float64) if csf_on else None
        self.ear = np.asarray(sig_ear, dtype=np.float64) if ear_on else None
        self.host = _PULLS.host((n_pad, M, C), torch.int32, device)
        self.cols = np.empty((K + csf_on, batch, M, S))
        if csf_on:
            self.cols[K] = self.csf
        self.w = np.empty((n, C))
        self.ind = np.empty((n, C), dtype=np.int32)
        self.obj = np.empty(n)
        self.r2 = np.empty(n)
        self.events = []
        self.next = 0

    def add(self, cand):
        """Enqueue the copy of the next chunk's (batch, M, C) candidates
        to the host."""
        c = len(self.events)
        rows = slice(c * self.batch, (c + 1) * self.batch)
        self.events.append(_PULLS.copy(self.host[rows], cand))

    def ready(self):
        """Re-score the chunks at the head of the queue whose copies have
        landed, without waiting for the others."""
        while (self.next < len(self.events)
               and _PULLS.done(self.events[self.next])):
            self._one("overlapped")

    def finish(self):
        """Wait for the remaining chunks in order and re-score each; the
        bucket's (w, ind, min_obj, mse, r2), pad rows dropped."""
        while self.next < len(self.events):
            with stage("pull"):
                _PULLS.wait(self.events[self.next])
            self._one("tail")
        obj = np.maximum(self.obj, 0.0)  # never report a negative residual
        return self.w, self.ind, obj, obj / self.y_all.shape[1], self.r2

    def _one(self, when):
        c, b = self.next, self.batch
        rows = slice(c * b, (c + 1) * b)
        keep = slice(c * b, min((c + 1) * b, self.n))
        real = keep.stop - keep.start
        y = self.y_all[rows]
        w, ind, obj, y_rec = refine_mod.refine_candidates(
            self.ms, self.plan, self.pk64[rows, :self.K], y, self.csf,
            self.ear, self.host[rows].numpy(), self.K, self.csf is not None,
            self.ear is not None, cols=self.cols)
        self.w[keep], self.ind[keep], self.obj[keep] = (
            w[:real], ind[:real], obj[:real])
        self.r2[keep] = _r2_np(y[:real], y_rec[:real])
        self.next += 1
        RESCORES[when] += 1


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
    plan): each chunk's candidates are copied to the host as its step is
    enqueued, and after each enqueue the chunks whose copies have landed
    are re-scored, in chunk order, without waiting; the rest after the
    last enqueue (``_Rescore``). With a ``mesh`` the chunks are dealt to
    its data rows in turn, tables, plan and fixed columns replicated on each row's device
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
    n_pad = int(math.ceil(n / batch) * batch)
    shares, where = _deal(n_pad, batch, len(slots))
    with stage("push"):
        sig_csf_d = _push(sig_csf if csf_on else np.zeros(S), dev, dtype,
                          held)
        sig_ear_d = _push(sig_ear if ear_on else np.zeros((S, 1)), dev,
                          dtype, held)
        # the read-only tables, plan and fixed columns on each row's device
        consts = {d: tuple(t.to(d) for t in tuple(tables) + tuple(plan)
                           + (sig_csf_d, sig_ear_d)) for d in slots}

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
        pushes = [(_push(pk64[idx, :K], slots[j], dtype, held),
                   _push(y_all[idx], slots[j], dtype, held))
                  for j, idx in enumerate(shares)]

    step = fit_step_candidates if refine else fit_step
    extra = dict(M=topm) if refine else {}
    if refine:
        # float32 device scan -> top-M candidates -> exact float64 re-score,
        # a chunk's while the card runs the chunks queued after it
        rescore = _Rescore(n, batch, topm, ms_host, plan_host, pk64, y_all,
                           sig_csf, sig_ear, K, bool(csf_on), bool(ear_on),
                           dev)
    chunks = []
    for c, (j, sl) in enumerate(where):
        xs, ys, cnt, gdir, lo, hi, wG, csf_j, ear_j = consts[slots[j]]
        chunks.append(graphs.run(
            step, xs, ys, cnt, gdir, lo, hi, wG, pushes[j][0][sl],
            pushes[j][1][sl], csf_j, ear_j, K=K, csf_on=bool(csf_on),
            ear_on=bool(ear_on), **extra))
        if refine:
            rescore.add(chunks[-1])
            if c < len(where) - 1:
                rescore.ready()

    if refine:
        return rescore.finish()

    with stage("pull"):
        stacked = {k: torch.cat([c[k].to(dev) for c in chunks]).cpu()
                   .numpy()[:n] for k in ("w", "ind", "min_obj", "mse", "r2")}
    return (stacked["w"], stacked["ind"],
            np.maximum(stacked["min_obj"], 0.0),
            np.maximum(stacked["mse"], 0.0), stacked["r2"])
