"""The plain reference: the dictionary rotated to a voxel's fascicle
directions, and the exhaustive non-negative least squares over every
combination of one atom a block, in plain PyTorch.

Written from the reference's definitions (Rensonnet et al., reference
mf_utils.py), independent of the program under test:

* rotation (reference ``init_PGSE_multishell_interp`` and
  ``interp_PGSE_from_multishell``, mf_utils.py:1959-2085 and
  :1812-1839): per G-shell of the dictionary's dense scheme, the knots
  |g . n_dic| made unique (the first row of each value kept) and the
  near-perpendicular cluster (knots within 1e-3 of the first) replaced
  by its mean, then scipy's ``interp1d(kind='linear',
  fill_value='extrapolate')`` at |g . n_voxel|; b0 rows are constant;
* fit: for a voxel whose compartments are blocks of columns (fascicle
  1, fascicle 2, CSF, EAR), the least residual ||y - A w||^2, w >= 0,
  over every choice of one column a block. Each choice's NNLS optimum
  is the least residual among the supports whose unconstrained least
  squares solution is positive, so the choices are solved all at once,
  support by support, by elimination on their Gram entries.

Everything runs in float64 on the device of its inputs; it reads
nothing the program made.
"""

import itertools

import numpy as np
import torch

#: knots within this |g . n| of the first are averaged into one
#: (reference mf_utils.py:2057-2072)
PERP_CLUSTER_TOL = 1e-3


def _shell_knots(dot, sig_rows):
    """Sorted knots (k,) and signals (k, N) of one shell."""
    xs, first = np.unique(dot, return_index=True)
    ys = sig_rows[first]
    near = np.abs(xs - xs[0]) < PERP_CLUSTER_TOL
    n = int(near.sum())
    if n > 1:
        xs = np.concatenate(([xs[near].mean()], xs[n:]))
        ys = np.concatenate((ys[near].mean(axis=0, keepdims=True), ys[n:]))
    return xs, ys


class Rotation:
    """The dictionary ``sig`` (S, N) of scheme ``sch`` along ``ori``,
    rotated onto the same scheme for any fascicle direction."""

    def __init__(self, sig, sch, ori, device):
        sig = np.asarray(sig, dtype=np.float64)
        g = sch[:, :3]
        dot = np.abs(g @ np.asarray(ori, dtype=np.float64))
        G = sch[:, 3]
        self.S, self.N = sig.shape
        self.device = device
        put = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                        device=device)
        self.b0 = np.flatnonzero(G == 0)
        self.b0_row = put(sig[self.b0[:1]]) if self.b0.size else None
        self.shells = []
        for Gs in np.unique(G[G > 0]):
            rows = np.flatnonzero(G == Gs)
            xs, ys = _shell_knots(dot[rows], sig[rows])
            self.shells.append((torch.as_tensor(rows, device=device),
                                put(g[rows]), put(xs), put(ys)))

    def __call__(self, dirs):
        """(B, S, N) columns for unit directions ``dirs`` (B, 3)."""
        dirs = torch.as_tensor(dirs, dtype=torch.float64, device=self.device)
        B = dirs.shape[0]
        out = torch.empty((B, self.S, self.N), dtype=torch.float64,
                          device=self.device)
        if self.b0_row is not None:
            out[:, torch.as_tensor(self.b0, device=self.device)] = \
                self.b0_row
        for rows, g, xs, ys in self.shells:
            x = torch.abs(dirs @ g.T)                          # (B, q)
            hi = torch.clamp(torch.searchsorted(xs, x), 1, xs.numel() - 1)
            lo = hi - 1
            slope = (ys[hi] - ys[lo]) / (xs[hi] - xs[lo])[..., None]
            out[:, rows] = slope * (x - xs[lo])[..., None] + ys[lo]
        return out


def _supports(C):
    return [T for m in range(1, C + 1)
            for T in itertools.combinations(range(C), m)]


def _least_over_supports(yy, gram, rhs, tol):
    """Least NNLS residual over the supports of C columns, element by
    element: ``gram[p][q]`` and ``rhs[p]`` broadcastable tensors (the
    Gram entries and A'y of each choice), ``yy`` y'y. A support counts
    where its elimination's pivots stay above ``tol`` times their
    diagonal entries and its solution is positive."""
    best = None
    C = len(rhs)
    for T in _supports(C):
        m = len(T)
        M = [[gram[min(p, q)][max(p, q)] for q in T] for p in T]
        r = [rhs[p] for p in T]
        ok = None
        for k in range(m):
            piv = M[k][k]
            good = piv > tol * gram[T[k]][T[k]]
            ok = good if ok is None else ok & good
            piv = torch.where(good, piv, torch.ones_like(piv))
            for i in range(k + 1, m):
                f = M[i][k] / piv
                M[i] = [M[i][j] - f * M[k][j] if j > k else M[i][j]
                        for j in range(m)]
                r[i] = r[i] - f * r[k]
            M[k] = [M[k][j] if j != k else piv for j in range(m)]
        w = [None] * m
        for k in range(m - 1, -1, -1):
            acc = r[k]
            for j in range(k + 1, m):
                acc = acc - M[k][j] * w[j]
            w[k] = acc / M[k][k]
        obj = yy
        for k in range(m):
            ok = ok & (w[k] > 0)
            obj = obj - w[k] * rhs[T[k]]
        obj = torch.where(ok, obj, torch.full_like(obj, float("inf")))
        best = obj if best is None else torch.minimum(best, obj)
    return best


def best_objective(y, blocks, max_elems=1 << 24):
    """The least residual ||y - A w||^2, w >= 0, over every choice of
    one column from each block, for each voxel.

    y (B, S); blocks: a list of C <= 4 tensors (B, S, n_c) on y's device
    and dtype. Voxels are taken a group at a time and the last block's
    columns a slice at a time, so that a grid holds at most about
    ``max_elems`` entries. Returns (B,)."""
    B = y.shape[0]
    C = len(blocks)
    sizes = [b.shape[2] for b in blocks]
    tol = 100 * torch.finfo(y.dtype).eps
    inner = int(np.prod(sizes[:-1]))
    n_last = max(1, min(sizes[-1], max_elems // max(inner, 1)))
    per = max(1, max_elems // (inner * n_last))
    out = torch.empty(B, dtype=y.dtype, device=y.device)
    for v0 in range(0, B, per):
        sl = slice(v0, min(v0 + per, B))
        yv = y[sl]
        bv = [b[sl] for b in blocks]
        yy = (yv * yv).sum(-1)
        best = yy.clone()
        for e0 in range(0, sizes[-1], n_last):
            parts = bv[:-1] + [bv[-1][:, :, e0:e0 + n_last]]
            shape = [p.shape[2] for p in parts]

            def at(t, axes):
                """t (b, n_a[, n_b]) placed on grid axes ``axes``."""
                view = [t.shape[0]] + [1] * C
                for a in axes:
                    view[1 + a] = shape[a]
                return t.reshape(view)

            gram = [[None] * C for _ in range(C)]
            for p in range(C):
                for q in range(p, C):
                    g = torch.einsum("bsi,bsj->bij", parts[p], parts[q])
                    gram[p][q] = (at(torch.diagonal(g, dim1=1, dim2=2),
                                     (p,)) if p == q else at(g, (p, q)))
            rhs = [at(torch.einsum("bsi,bs->bi", parts[p], yv), (p,))
                   for p in range(C)]
            grid = _least_over_supports(at(yy, ()), gram, rhs, tol)
            best = torch.minimum(best, grid.reshape(grid.shape[0], -1)
                                 .amin(dim=1))
        out[sl] = best
    return out


def claimed(y, cols, w):
    """What a claimed solution gives: residual ||y - cols w||^2, and the
    R^2 of the reference (squared correlation of y and cols w). y (B, S),
    cols (B, S, C), w (B, C)."""
    rec = torch.einsum("bsc,bc->bs", cols, w)
    res = ((y - rec) ** 2).sum(-1)
    yc = y - y.mean(-1, keepdim=True)
    rc = rec - rec.mean(-1, keepdim=True)
    num = (yc * rc).sum(-1)
    den = torch.sqrt((yc * yc).sum(-1) * (rc * rc).sum(-1))
    r = torch.where(den > 0, num / torch.where(den > 0, den,
                                               torch.ones_like(den)),
                    torch.zeros_like(den))
    return res, r * r
