"""Exact selection on the fast path: a certificate for each voxel's atom
choice, and the near-ties that the certificate cannot decide.

The fast path's scans (kernels 3, 5 and 6) rank every combination of one
atom a block exactly, but on the dictionary rotated and stored in float32
(``ops/interp.make_grouped_rotation_paired``) and on a float32 signal,
while the reference rotates in float64. Two combinations whose float64
objectives lie closer than that rounding can trade places. This module
bounds the gap and decides, per voxel, whether the scan's winner is the
float64 optimum.

The bound. Objectives are in units of ||y||^2 (F = min_{w >= 0}
||y - A w||^2 / ||y||^2). Let A be the float64 columns of a support of C
columns and A' = A + E the columns a scan ranks, y' = y + e its signal.
With ||E_j|| <= eta ||A_j|| for every column j and ||e|| <= eta_y ||y||:

  * every entry of a fingerprint is positive, so A_i'A_j >= 0 and, for
    w >= 0, sum_j w_j ||A_j|| <= sqrt(C) ||A w||;
  * at the NNLS optimum r'A w = 0, so ||A w|| <= ||y||;

hence |sqrt(F') - sqrt(F)| <= tau = eta_y + sqrt(C) eta (1 + eta_y) /
(1 - eta), and |F' - F| <= eps(F') = tau (2 sqrt(F') + tau).

eta of a rotated column comes from the rotation's own arithmetic, per
voxel (``Bound.eta``). Each rotated entry is sum_k W_k T_k over the two
knots of a shell's interval (and of the next shell, blended in G): the
tables T rounded to float32 (u = 2^-24 of each entry), the weights
(1 - t) and t rounded, the products and the sum of at most 4 terms
(gamma_4): at most c u (|1 - t| + |t|) max(T_k, T_k+1), c = 4 with one
shell, 7 with two, plus 2 u of the blend weight's own rounding. The
lerp position t is computed in float32 from x = |g . n| in float32 on
float32 knots; this module computes the same t and, in float64, the
reference's t on the same interval: the difference dt moves the entry
by |dt| |T_k+1 - T_k|, and where x64 falls outside the interval by the
overshoot times the neighbouring intervals' jumps (table ``Lam``). The
squares of each term are summed per (shell, interval), so the column
norms of every atom come from three small matmuls a voxel. The fixed
columns (CSF, EAR) and the signal are float32 roundings of float64
values: eta = eta_y = u. The scans' own normalization rounds once more
(tau_k = tau + (sqrt(C) + 1) u), and their double-float values are
rounded to float32 (``KERNEL_ARITH``).

The certificate (``certify``). The scans return the least objective of
each cell of their grid (a row segment, or a row). The Q cells of least
value are evaluated again in float64 on the same float32 columns (V),
so each of their combinations is known to within eps; every other
combination is bounded below by the next cell's value, and, where the
two-pass row pass pruned rows or columns, by its interval lower bounds.
With hi = V* + eps(V*) an upper bound of the float64 optimum, a
combination stays a candidate while its lower bound is <= hi. A voxel
is

  * certified (``CERTIFIED``) when the scan's winner is the only
    candidate: its result is the scan's, bit for bit;
  * re-scored (``RESCORE``) when at most ``M`` candidates remain and
    every unevaluated combination lies above hi: the candidates are
    solved exactly in float64 on the host (``models/refine``), the EAR
    atoms enumerated there;
  * handed to the fallback (``FALLBACK``) otherwise: ``models/fit``
    certifies it again over its whole grid and more cells, then solves
    what is still undecided by an exhaustive float64 scan of that voxel
    alone.
"""

import math

import numpy as np
import torch

from ..ops import nnls as mfn

#: unit roundoff of float32 (round to nearest)
U = 2.0 ** -24
#: the scans' own arithmetic, an allowance (relative, absolute) on a
#: value the scans return (a quotient of compensated sums rounded to
#: float32) against the float64 objective of the columns they read. Its
#: error grows with the support's conditioning, which the certificate
#: does not see: at the real widths kernel 3 reads within 3.5 U of the
#: value, kernels 5 and 6 within 1.1e-5 of it on supports whose columns
#: meet at cos 0.99; 2^-15 is three times that
KERNEL_ARITH = (2.0 ** -15, 2.0 ** -32)
#: the float64 re-evaluation's own arithmetic (relative, absolute)
F64_ARITH = (1e-14, 2.0 ** -40)
#: candidates re-scored on the host per voxel at most
M = 32
#: cells of least value evaluated in float64 a voxel
Q_CELLS = 8
#: with an EAR axis (each cell holds its columns times every EAR atom)
Q_CELLS_EAR = 4
#: where a cell is one combination (one fascicle + CSF)
Q_CELLS_ONE = 32
#: where a cell is a whole row of the second block (two fascicles
#: without CSF)
Q_CELLS_ROW = 8
#: the voxel status codes of ``certify``; OVERFLOW marks a voxel whose
#: row pass overflowed its budget (the overflow tiers decide it)
CERTIFIED, RESCORE, FALLBACK, OVERFLOW = 0, 1, 2, 3


def eps(F, tau):
    """tau (2 sqrt(F) + tau): the objective's error bound at value F
    (a voxel's tau (B,) against its values (B, ...))."""
    tau = tau.reshape(tau.shape + (1,) * (F.dim() - tau.dim()))
    return tau * (2.0 * torch.sqrt(torch.clamp(F, min=0.0)) + tau)


def tau_of(eta, eta_y, C):
    """tau of a support of C columns whose relative column error is at
    most ``eta`` (a tensor) and the signal's ``eta_y``."""
    return eta_y + math.sqrt(C) * eta * (1.0 + eta_y) / (1.0 - eta)


class Bound:
    """The rotation's error bound for one dictionary (``ms``, a
    ``MultiShellInterp``) on one target scheme (``plan``, a
    ``TargetSchemePlan``): host tables, and their device copies."""

    def __init__(self, ms, plan):
        xs = np.asarray(ms.xs, np.float64)             # (n_sh, Kmax)
        ys = np.asarray(ms.ys, np.float64)             # (n_sh, Kmax, N)
        cnt = np.asarray(ms.cnt, np.int64)
        n_sh, kmax, N = ys.shape
        self.kmax, self.n_atom = kmax, N
        lam = np.zeros((n_sh, kmax, N))
        mx = np.zeros((n_sh, kmax, N))
        mn = np.zeros((n_sh, kmax, N))
        for s in range(n_sh):
            c = int(cnt[s])
            h = np.diff(xs[s, :c])                      # (c - 1,)
            jump = np.abs(np.diff(ys[s, :c], axis=0))   # (c - 1, N)
            nb = np.zeros_like(jump)
            for k in range(c - 1):
                for o in (k - 1, k + 1):
                    if 0 <= o < c - 1:
                        ratio = h[k] / h[o] if h[o] > 0 else np.inf
                        nb[k] = np.maximum(nb[k], jump[o] * ratio)
            bad = (h <= 0)[:, None]
            lam[s, :c - 1] = np.where(bad, np.inf, jump + nb)
            mx[s, :c - 1] = np.maximum(np.abs(ys[s, :c - 1]),
                                       np.abs(ys[s, 1:c]))
            mn[s, :c - 1] = np.clip(np.minimum(ys[s, :c - 1], ys[s, 1:c]),
                                    0.0, None)
        flat = lambda a: (a * a).reshape(n_sh * kmax, N)
        self.lam2, self.mx2, self.mn2 = flat(lam), flat(mx), flat(mn)
        self.xs32 = xs.astype(np.float32)
        self.xs64 = xs
        self.cnt = cnt
        self.gdir = np.asarray(plan.gdir, np.float64)
        wG = np.asarray(plan.wG, np.float64)
        w32 = wG.astype(np.float32)
        # the roles of ``make_grouped_rotation_paired``: the lower shell
        # at 1 - wG, the upper at wG, each computed in float32 there
        self.roles = []
        for shell, sig64, sig32 in (
                (plan.shell_lo, 1.0 - wG, np.float32(1.0) - w32),
                (plan.shell_hi, wG, w32)):
            on = sig32 != 0
            if not on.any():
                continue
            one = sig32 == 1
            c = np.where(one, 4.0, 7.0) * sig64 + np.where(one, 0.0, 2.0)
            self.roles.append(dict(shell=np.asarray(shell, np.int64),
                                   sig=np.where(on, sig64, 0.0),
                                   c=np.where(on, c, 0.0)))
        self._dev = {}

    def device(self, dev):
        """The tables on ``dev`` (built once a device)."""
        got = self._dev.get(dev)
        if got is None:
            f64 = dict(dtype=torch.float64, device=dev)
            got = dict(
                lam2=torch.as_tensor(self.lam2, **f64),
                mx2=torch.as_tensor(self.mx2, **f64),
                mn2=torch.as_tensor(self.mn2, **f64),
                g32=torch.as_tensor(self.gdir, dtype=torch.float32,
                                    device=dev),
                g64=torch.as_tensor(self.gdir, **f64),
                roles=[dict(
                    xs32=torch.as_tensor(self.xs32[r["shell"]], device=dev),
                    xs64=torch.as_tensor(self.xs64[r["shell"]], **f64),
                    top=torch.as_tensor(self.cnt[r["shell"]] - 2,
                                        device=dev),
                    base=torch.as_tensor(r["shell"] * self.kmax,
                                         device=dev),
                    sig=torch.as_tensor(r["sig"], **f64),
                    c=torch.as_tensor(r["c"], **f64))
                    for r in self.roles])
            self._dev[dev] = got
        return got

    def eta(self, pk32, pk64):
        """(B,) the largest relative error ||E_j|| / ||A_j|| over every
        atom of the voxels' rotated blocks: pk32 (B, K, 3) the directions
        the rotation used, pk64 (B, K, 3) the same in float64."""
        d = self.device(pk32.device)
        B, K, _ = pk32.shape
        n32 = pk32.reshape(-1, 3).to(torch.float32)
        n64 = pk64.reshape(-1, 3).to(torch.float64)
        g32, g64 = d["g32"], d["g64"]
        # x = |g . n| as the rotation computes it (ops/interp._abs_gdotn)
        x32 = torch.abs(n32[:, None, 0] * g32[None, :, 0]
                        + n32[:, None, 1] * g32[None, :, 1]
                        + n32[:, None, 2] * g32[None, :, 2])
        x64 = torch.abs(n64 @ g64.T)
        width = d["lam2"].shape[0]
        BK = x32.shape[0]
        num = torch.zeros((BK, self.n_atom), dtype=torch.float64,
                          device=x32.device)
        den2 = torch.zeros_like(num)
        inside = torch.ones_like(x64, dtype=torch.bool)
        per_role = []
        for r in d["roles"]:
            xs32, xs64 = r["xs32"], r["xs64"]                # (S, Kmax)
            # the interval and t of ops/interp._lerp_weights (its count of
            # knots <= x, the rows sorted and padded with +inf)
            j = torch.searchsorted(xs32, x32.T.contiguous(), right=True).T
            j = torch.minimum(torch.clamp(j - 1, min=0), r["top"])
            x0 = torch.gather(xs32.expand(BK, -1, -1), 2, j[..., None])[..., 0]
            x1 = torch.gather(xs32.expand(BK, -1, -1), 2,
                              (j + 1)[..., None])[..., 0]
            den = x1 - x0
            pos = den > 0
            t32 = torch.where(pos, (x32 - x0) / torch.where(
                pos, den, torch.ones_like(den)), torch.zeros_like(x32))
            X0 = torch.gather(xs64.expand(BK, -1, -1), 2, j[..., None])[..., 0]
            X1 = torch.gather(xs64.expand(BK, -1, -1), 2,
                              (j + 1)[..., None])[..., 0]
            D64 = X1 - X0
            t64 = torch.where(D64 > 0, (x64 - X0) / torch.where(
                D64 > 0, D64, torch.ones_like(D64)), torch.zeros_like(x64))
            # x64 outside the interval float32 chose (not at an end, where
            # both extrapolate alike): the neighbouring interval's value
            ov = (torch.where((t64 < 0) & (j > 0), -t64, 0.0)
                  + torch.where((t64 > 1) & (j < r["top"]), t64 - 1, 0.0))
            t = t32.double()
            dt = torch.abs(t - t64) + ov
            idx = r["base"][None, :] + j
            w_t = (dt * r["sig"]) ** 2
            rho = U * (torch.abs(1.0 - t) + torch.abs(t)) * r["c"]
            w_r = rho * rho
            inside &= (t64 >= 0) & (t64 <= 1)
            per_role.append((idx, r["sig"]))
            for w, tab in ((w_t, d["lam2"]), (w_r, d["mx2"])):
                om = torch.zeros((BK, width), dtype=torch.float64,
                                 device=x32.device).scatter_add_(1, idx, w)
                num = num + torch.sqrt(om @ tab)
        # ||A_j|| from below: rows that interpolate in every shell they
        # read, each shell's part at least its interval's lower knot
        for idx, sig in per_role:
            w_in = torch.where(inside, (sig * sig)[None, :], 0.0)
            om = torch.zeros((BK, width), dtype=torch.float64,
                             device=x32.device).scatter_add_(1, idx, w_in)
            den2 = den2 + om @ d["mn2"]
        eta = torch.where(den2 > 0, num / torch.sqrt(
            torch.where(den2 > 0, den2, torch.ones_like(den2))), math.inf)
        eta = torch.nan_to_num(eta, nan=math.inf)
        return torch.maximum(eta.amax(dim=1).reshape(B, K).amax(dim=1),
                             torch.full((B,), U, dtype=torch.float64,
                                        device=x32.device))


# ---------------------------------------------------------------------------
# the float64 re-evaluation of a voxel's best cells
# ---------------------------------------------------------------------------

def _dot(a, b, spec):
    return torch.einsum(spec, a, b)


def _gather_cols(A, idx):
    """A (B, S, N) float32, idx (B, P) -> (B, S, P) float64."""
    return torch.gather(A, 2, idx[:, None, :].expand(-1, A.shape[1], -1)
                        ).double()


def cell_values(D, y, csf, ear, i1, inner, valid, grid):
    """float64 objectives (over ||y||^2) of the combinations of the
    chosen cells on the scan's own float32 columns.

    D (B, K, S, N) rotated blocks; y (B, S); csf (S,) or None; ear (S, E)
    or None; i1 (B, Q) each cell's first-block atom; ``inner`` (B, Q, W)
    the cell's second-axis indices (second fascicle's atoms, or EAR
    atoms where ``grid["inner"]`` is "ear"), or None where each cell is
    a whole row of the second block (``grid["inner"]`` "full") or the
    CSF column ("csf"); ``valid`` (B, Q, W) which of them exist. Returns
    V (B, Q, W[, E]) with +inf where not valid, and yy (B,)."""
    kind = grid["inner"]
    y64 = y.double()
    B, S = y.shape
    yy = (y64 * y64).sum(1)
    a = _gather_cols(D[:, 0], i1)                          # (B, S, Q)
    aa = (a * a).sum(1)[:, :, None]                        # (B, Q, 1)
    ya = _dot(y64, a, "bs,bsq->bq")[:, :, None]
    f = None if csf is None or kind == "csf" else csf.double()
    if kind == "fasc":
        Q, W = inner.shape[1:]
        b = _gather_cols(D[:, 1], inner.reshape(B, -1))   # (B, S, Q W)
        bb = (torch.linalg.vector_norm(b, dim=1) ** 2).reshape(B, Q, W)
        # one product for every entry a cell's columns need: its row's
        # column, the signal and the CSF column against its columns
        lhs = [a, y64[:, :, None]] + ([] if f is None else [
            f[None, :, None].expand(B, S, 1)])
        G = torch.bmm(torch.cat(lhs, dim=2).transpose(1, 2), b)
        ab = torch.diagonal(G[:, :Q].reshape(B, Q, Q, W), dim1=1,
                            dim2=2).transpose(1, 2)
        yb = G[:, Q].reshape(B, Q, W)
        bf_g = None if f is None else G[:, Q + 1].reshape(B, Q, W)
        b = b.reshape(B, S, Q, W)
    elif kind == "ear":
        e64 = ear.double()
        b = e64[:, inner.reshape(-1)].reshape(S, *inner.shape)  # (S,B,Q,W)
        b = b.permute(1, 0, 2, 3)
        bb = (b * b).sum(1)
        ab = _dot(a, b, "bsq,bsqw->bqw")
        yb = _dot(y64, b, "bs,bsqw->bqw")
    elif kind == "csf":
        c64 = csf.double()
        bb = (c64 * c64).sum().expand(B, 1, 1)
        ab = _dot(a, c64, "bsq,s->bq")[:, :, None]
        yb = _dot(y64, c64, "bs,s->b")[:, None, None]
    else:  # "full": every cell a whole row of the second block
        bb = torch.empty((B, 1, D.shape[3]), dtype=torch.float64,
                         device=y.device)
        ab = torch.empty((B, i1.shape[1], D.shape[3]), dtype=torch.float64,
                         device=y.device)
        yb = torch.empty_like(bb)
        step = 128
        for v0 in range(0, B, step):
            sl = slice(v0, v0 + step)
            b = D[sl, 1].double()                          # (b, S, N2)
            bb[sl, 0] = torch.linalg.vector_norm(b, dim=1) ** 2
            ab[sl] = torch.bmm(a[sl].transpose(1, 2), b)
            yb[sl, 0] = _dot(y64[sl], b, "bs,bsn->bn")
            del b
    yyb = yy[:, None, None]
    T = mfn.TORCH
    if f is None:
        _w1, _w2, res = mfn.lsqnonneg_2var(yyb, aa, ab, bb, ya, yb, xp=T)
    elif grid.get("ear_axis"):
        e64 = ear.double()
        ae = _dot(a, e64, "bsq,se->bqe")[:, :, None, :]
        if kind == "full":
            raise NotImplementedError("an EAR axis needs cells of columns")
        be = torch.matmul(b.reshape(B, S, -1).transpose(1, 2), e64
                          ).reshape(B, b.shape[2], b.shape[3], -1)
        fe = (f @ e64)[None, None, None, :]
        ee = (e64 * e64).sum(0)[None, None, None, :]
        ye = (y64 @ e64)[:, None, None, :]
        af = _dot(a, f, "bsq,s->bq")[:, :, None, None]
        bf = bf_g[..., None]
        ff = (f * f).sum()
        yf = (y64 @ f)[:, None, None, None]
        x4 = lambda t: t[..., None]
        G = ((x4(aa), x4(ab), af, ae), (x4(ab), x4(bb), bf, be),
             (af, bf, ff, fe), (ae, be, fe, ee))
        *_w, res = mfn.lsqnonneg_4var(yyb[..., None],
                                      tuple(tuple(g for g in row)
                                            for row in G),
                                      (x4(ya), x4(yb), yf, ye), xp=T)
        valid = valid[..., None]
    else:
        af = _dot(a, f, "bsq,s->bq")[:, :, None]
        bf = bf_g if kind == "fasc" else _dot(b, f, "bsqw,s->bqw")
        ff = (f * f).sum()
        yf = (y64 @ f)[:, None, None]
        *_w, res = mfn.lsqnonneg_3var(yyb, aa, bb, ff, ab, af, bf, ya, yb,
                                      yf, xp=T)
    V = res / yy.reshape((B,) + (1,) * (res.dim() - 1))
    V = torch.where(valid, V, math.inf)
    return torch.nan_to_num(V, nan=math.inf), yy


def _above(x, tau, arith, hi):
    """Whether every objective whose scan value (or scan lower bound) is
    at least ``x`` lies above ``hi`` in float64: x - eps(x) - arith > hi
    (+inf always; NaN never)."""
    low = x - eps(x, tau) - arith[0] * x - arith[1]
    return (x == math.inf) | (low > hi)


def certify(D, y, csf, ear, eta, cellv, grid, winner):
    """The certificate of a chunk (see the module docstring).

    ``cellv`` (B, L) float32: the scan's least objective of each cell
    (normalized; +inf for padding), cell l = segment * n1p + row;
    ``grid``: {"n1p", "segw", "n2" (valid second-axis entries), "rows"
    (B, R) the scanned rows' atoms or None, "cols" (B, n2) the scanned
    columns' atoms or None, "inner_of_cell" (B, L) where each cell is
    one combination of a top-M list (optional; its first-block atom
    from "rows"), "inner" ("fasc", "ear", "csf" or "full"),
    "ear_axis", "fixed" (C, the support's columns), "q" (cells
    evaluated), "lo_out" (B,) the least lower bound of every pruned row
    and column or None, "ok" (B,) whether the row pass kept its budget
    or None}; ``eta`` (B,) ``Bound.eta``; ``winner`` (B, c) the scan's
    winner in its native layout [i1, second-axis index(, EAR atom)].
    Returns (status (B,) int32, cand (B, M, 3) int32 [i1, second-axis
    index, EAR atom] ordered by V, n (B,) int32 candidates)."""
    B = y.shape[0]
    dev = y.device
    C = grid["fixed"]
    tau = tau_of(eta, U, C)
    tau_k = tau + (math.sqrt(C) + 1.0) * U * (1.0 + 1e-6)
    q = grid["q"]
    n1p, segw = grid["n1p"], grid["segw"]
    L = cellv.shape[1]
    k = min(q + 1, L)
    top_v, top_l = torch.topk(cellv.float(), k, dim=1, largest=False)
    q = min(q, L)
    cells = top_l[:, :q]
    r, s = cells % n1p, cells // n1p
    i1 = r if grid["rows"] is None else torch.gather(grid["rows"], 1, r)
    kind = grid["inner"]
    if grid.get("inner_of_cell") is not None:
        # each cell one combination of a top-M list
        inner = torch.gather(grid["inner_of_cell"], 1, cells)[:, :, None]
        valid = torch.ones_like(inner, dtype=torch.bool)
    elif kind in ("fasc", "ear"):
        p = s[:, :, None] * segw + torch.arange(segw, device=dev)
        valid = p < grid["n2"]
        p = torch.clamp(p, max=grid["n2"] - 1)
        inner = (p if grid["cols"] is None else torch.gather(
            grid["cols"], 1, p.reshape(B, -1)).reshape(p.shape))
    elif kind == "csf":
        inner = torch.zeros((B, q, 1), dtype=torch.int64, device=dev)
        valid = torch.ones((B, q, 1), dtype=torch.bool, device=dev)
    else:
        n2 = D.shape[3]
        inner = torch.arange(n2, device=dev).expand(B, q, n2)
        valid = torch.ones((B, q, n2), dtype=torch.bool, device=dev)
    valid = valid & torch.isfinite(top_v[:, :q])[:, :, None]
    V, _yy = cell_values(D, y, csf, ear, i1, None if kind == "full" else
                         inner, valid, grid)
    vstar = V.reshape(B, -1).amin(dim=1)
    hi = vstar + eps(vstar, tau) + F64_ARITH[0] * vstar + F64_ARITH[1]
    low = V - eps(V, tau) - F64_ARITH[0] * V - F64_ARITH[1]
    band = low <= hi.reshape((B,) + (1,) * (V.dim() - 1))
    n_all = band.reshape(B, -1).sum(dim=1)
    # every combination not evaluated lies above hi
    nxt = (top_v[:, q].double() if k > q
           else torch.full((B,), math.inf, dtype=torch.float64, device=dev))
    clear = _above(nxt, tau_k, KERNEL_ARITH, hi) & torch.isfinite(vstar)
    if grid.get("lo_out") is not None:
        clear &= _above(grid["lo_out"].double(), tau_k, (0.0, 0.0), hi)
    # a candidate is what the host re-score is handed: it enumerates the
    # EAR atoms itself, so combinations that differ in them alone are one
    e_i = torch.zeros((B, q, inner.shape[2]), dtype=torch.int64, device=dev)
    if grid.get("ear_axis"):
        e_i = V.argmin(dim=3)
        V, band = V.amin(dim=3), band.any(dim=3)
    elif kind == "ear":
        w_best = V.argmin(dim=2, keepdim=True)
        inner = torch.gather(inner, 2, w_best)
        e_i = e_i[:, :, :1]
        V, band = V.amin(dim=2, keepdim=True), band.any(dim=2, keepdim=True)
    n = band.reshape(B, -1).sum(dim=1)
    # candidates by V, then decoded into [i1, second axis, EAR atom]
    flat = V.reshape(B, -1)
    m = min(M, flat.shape[1])
    _cv, ci = torch.topk(flat, m, dim=1, largest=False)
    W = V.shape[2]
    q_i = ci // W
    c1 = torch.gather(i1, 1, q_i)
    c2 = torch.gather(inner.reshape(B, -1), 1, ci)
    c3 = torch.gather(e_i.reshape(B, -1), 1, ci)
    cand = torch.stack([c1, c2, c3], dim=2)
    if m < M:
        cand = torch.cat([cand, cand[:, :1].expand(B, M - m, 3)], dim=1)
    # the scan's winner is the lone candidate
    win = winner.long()
    lone = (n_all == 1) & (cand[:, 0, 0] == win[:, 0]) & (cand[:, 0, 1]
                                                         == win[:, 1])
    if grid.get("ear_axis"):
        lone &= cand[:, 0, 2] == win[:, -1]
    status = torch.where(clear & (n <= M),
                         torch.where(lone, CERTIFIED, RESCORE), FALLBACK)
    if grid.get("ok") is not None:
        status = torch.where(grid["ok"], status, OVERFLOW)
    return (status.to(torch.int32), cand.to(torch.int32),
            n.to(torch.int32))
