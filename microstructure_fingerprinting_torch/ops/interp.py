"""Dictionary rotation / resampling via interpolation tables.

PyTorch counterpart of ``microstructure_fingerprinting_tpu/ops/interp.py``.
The host-side table construction (shell discovery, knot dedup,
near-perpendicular cluster smoothing, virtual edge knots, G-shell
bracketing) is the JAX package's NumPy code, carried over unchanged, so
both packages build bitwise-equal tables for the same dictionary. The
device side has two rotations: the fast path's grouped rotation
(``make_grouped_rotation_paired``: per (shell_lo, shell_hi) group of
target sequences one float32 matmul of lerp weights against the stacked
knot tables, TF32 off), and the general path's gather-and-lerp
(``eval_rotation_batch``, the JAX package's ``eval_rotation``).

The reference-compatible functions of the JAX module are here too:
``eval_rotation`` (one direction) and ``make_grouped_rotation`` (the
unpaired per-shell matmul rotation), torch on the device of their
inputs; ``interp_PGSE_from_multishell`` (float64 on ``device``, the card
by default); ``rotate_atom`` and ``rotate_atom_2Dprotocol``, NumPy on
the host as in the JAX package.

Interpolation semantics match scipy's ``interp1d(kind='linear',
fill_value='extrapolate', assume_sorted=True)``.
"""

import dataclasses
from functools import partial

import numpy as np
import torch

from .. import config
from ..utils.scheme import get_gyromagnetic_ratio
from .math3d import rotate_scheme_mat

_PERP_CLUSTER_TOL = 1e-3  # dot-product width of the near-perpendicular cluster


# ---------------------------------------------------------------------------
# Host-side knot-table construction
# ---------------------------------------------------------------------------

def _lerp_eval_np(xs, ys, q):
    """NumPy linear interp with edge-segment extrapolation.

    xs (K,) strictly increasing, ys (K, N), q (M,) -> (M, N).
    """
    j = np.clip(np.searchsorted(xs, q, side="right") - 1, 0, len(xs) - 2)
    x0, x1 = xs[j], xs[j + 1]
    denom = x1 - x0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom > 0, (q - x0) / np.where(denom > 0, denom, 1.0),
                     0.0)[:, None]
    return ys[j] + t * (ys[j + 1] - ys[j])


def _build_shell_knots(dot, sig_rows):
    """Sorted unique knots + signals for one shell, with the reference's
    near-perpendicular cluster smoothing (mf_utils.py:2057-2072).

    dot: (n,) |g.n| values; sig_rows: (n, Nsubs). Returns (xs, ys).

    ``np.unique`` (no extra tolerance) matches the reference's FAST-mode
    initializer bit-for-bit: the |g.n| of near-antipodal direction pairs
    differ by ~1 ulp and are KEPT as distinct knots, so scipy's
    ``fill_value='extrapolate'`` edge slope (y1-y0)/(1 ulp) can be a real
    amplified quantity the reference pipeline genuinely produces.

    To reproduce that extrapolation in EVERY evaluator — including the
    grouped-rotation MATMUL form (1-t)*y0 + t*y1, which is catastrophically
    cancellative when |t| ~ 1e13 — the table is extended with VIRTUAL EDGE
    KNOTS at x = -1 and x = 2 lying exactly on scipy's extrapolation lines
    (computed here in float64 from the first/last real segment). Every
    query |g.n| in [0, 1] is then an interior lerp on a well-conditioned
    segment, and the value equals scipy's to the last ulp (verified by
    tests/test_reference_parity.py::test_ref_interp_* and
    test_ref_fit_end_to_end).
    """
    xs, first_idx = np.unique(dot, return_index=True)
    ys = sig_rows[first_idx, :]
    almost_perp = np.abs(xs - xs[0]) < _PERP_CLUSTER_TOL
    cluster_size = int(np.sum(almost_perp))
    if cluster_size > 1:
        xs = np.concatenate(([np.mean(xs[almost_perp])], xs[cluster_size:]))
        ys = np.concatenate((np.mean(ys[almost_perp, :], axis=0,
                                     keepdims=True),
                             ys[cluster_size:, :]), axis=0)
    if xs.size >= 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            slope_lo = (ys[1] - ys[0]) / (xs[1] - xs[0])
            slope_hi = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
        slope_lo = np.where(np.isfinite(slope_lo), slope_lo, 0.0)
        slope_hi = np.where(np.isfinite(slope_hi), slope_hi, 0.0)
        y_lo = ys[0] + slope_lo * (-1.0 - xs[0])
        y_hi = ys[-1] + slope_hi * (2.0 - xs[-1])
        xs = np.concatenate(([-1.0], xs, [2.0]))
        ys = np.concatenate((y_lo[None, :], ys, y_hi[None, :]), axis=0)
    return xs, ys


@dataclasses.dataclass
class MultiShellInterp:
    """Device-resident multi-shell interpolator (static padded tables).

    Plays the role of the reference's ``msinterp`` dict
    (mf_utils.py:2081-2085); the per-shell scipy interpolators become the
    padded (xs, ys, cnt) arrays consumed by :func:`eval_rotation`.
    """
    scheme_DeldelTE: np.ndarray   # (3,) common (Delta, delta, TE)
    num_subs: int                 # number of atoms/substrates
    Gms_un: np.ndarray            # (S,) unique dense-sampling G values
    xs: np.ndarray                # (S, Kmax) padded knot positions
    ys: np.ndarray                # (S, Kmax, num_subs) padded knot signals
    cnt: np.ndarray               # (S,) valid knots per shell (>= 2)

    # dict-style access for reference-compatible call sites
    def __getitem__(self, key):
        if key in ("scheme_DeldelTE", "num_subs", "Gms_un"):
            return getattr(self, key)
        if key == "interpolators":
            return [partial(_lerp_eval_np,
                            self.xs[s, :self.cnt[s]],
                            self.ys[s, :self.cnt[s], :])
                    for s in range(self.Gms_un.size)]
        raise KeyError(key)

    def device_tables(self, device="cpu", dtype=torch.float32):
        """(xs, ys, cnt) as torch tensors on ``device``.

        Cached per (device, dtype): the tables are large
        (S x Kmax x num_atom) and must not be re-uploaded on every call.
        """
        cache = self.__dict__.setdefault("_dev_cache", {})
        key = (str(torch.device(device)), dtype)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(self.xs, dtype=dtype, device=device),
                torch.as_tensor(self.ys, dtype=dtype, device=device),
                torch.as_tensor(self.cnt, dtype=torch.int32, device=device))
        return cache[key]

    def save(self, path):
        """Persist the precomputed tables (.npz) for instant model re-init.

        Addresses the reference's TODO of pickling the interpolator
        (mf.py:504-505) with a portable array format instead of pickle.
        """
        np.savez_compressed(path,
                            scheme_DeldelTE=self.scheme_DeldelTE,
                            num_subs=np.int64(self.num_subs),
                            Gms_un=self.Gms_un, xs=self.xs, ys=self.ys,
                            cnt=self.cnt)
        return path

    @classmethod
    def load(cls, path):
        """Tables from a ``.npz`` written by ``save`` (either package's)."""
        with np.load(path) as z:
            return cls.from_numpy(z)

    @classmethod
    def from_numpy(cls, fields):
        """Build from a mapping (or object) holding the numpy fields
        ``scheme_DeldelTE``, ``num_subs``, ``Gms_un``, ``xs``, ``ys`` and
        ``cnt`` — e.g. the JAX package's ``MultiShellInterp``."""
        get = (fields.__getitem__ if hasattr(fields, "keys")
               else lambda k: getattr(fields, k))
        return cls(scheme_DeldelTE=np.asarray(get("scheme_DeldelTE")),
                   num_subs=int(get("num_subs")),
                   Gms_un=np.asarray(get("Gms_un")),
                   xs=np.asarray(get("xs")), ys=np.asarray(get("ys")),
                   cnt=np.asarray(get("cnt")))


def _validate_dense_inputs(sig_ms, sch_mat_ms, ordir):
    if ordir.size != 3:
        raise ValueError("Direction of dictionary computed with dense"
                         " sampling (ordir) should have 3 entries.")
    ordir = np.squeeze(np.asarray(ordir, dtype=np.float64))
    chk_ms = np.isclose(sch_mat_ms[0, 4:7], sch_mat_ms[:, 4:7])
    if not np.all(chk_ms):
        raise ValueError("Delta, delta and TE values should all be "
                         "identical in multi-shell sampling.")
    if sig_ms.ndim == 1:
        sig_ms = sig_ms.reshape((sig_ms.size, 1))
    ordirnorm = np.sqrt((ordir ** 2).sum())
    if np.abs(1 - ordirnorm) > 1e-3:
        raise ValueError("Orientation vector of the multi-shell signal "
                         "must have unit norm. Detected %g." % (ordirnorm,))
    Gdir_norm_ms = np.sqrt(np.sum(sch_mat_ms[:, 0:3] ** 2, axis=1))
    if np.any(np.abs(1 - Gdir_norm_ms[Gdir_norm_ms > 0]) > 1e-3):
        raise ValueError("Gradient directions in multi-shell scheme matrix"
                         " should all either have zero or unit norm.")
    if sch_mat_ms.shape[0] != sig_ms.shape[0]:
        raise ValueError("Number of lines in dense multishell scheme"
                         " (%d) does not match number of signal values"
                         " per substrate (%d)." %
                         (sch_mat_ms.shape[0], sig_ms.shape[0]))
    return sig_ms, ordir


def init_PGSE_multishell_interp(sig_ms, sch_mat_ms, ordir):
    """Precompute the multi-shell interpolation tables (host, once).

    Equivalent of reference mf_utils.py:1959-2085 with scipy interpolator
    objects replaced by padded device tables.
    """
    sch_mat_ms = np.asarray(sch_mat_ms, dtype=np.float64)
    sig_ms = np.asarray(sig_ms, dtype=np.float64)
    sig_ms, ordir = _validate_dense_inputs(sig_ms, sch_mat_ms, ordir)
    num_subs = sig_ms.shape[1]

    orcyldotG_all = np.abs(np.dot(sch_mat_ms[:, 0:3], ordir))
    Gms_un, i_Gms = np.unique(sch_mat_ms[:, 3], return_inverse=True)

    shell_xs, shell_ys = [], []
    for i in range(Gms_un.shape[0]):
        ind_sh = np.where(i_Gms == i)[0]
        if Gms_un[i] == 0:
            # b0 shell: all signals must be identical per substrate; the
            # "interpolator" is the constant function over [0, 1].
            chk = np.all(np.isclose(sig_ms[ind_sh, :], sig_ms[ind_sh[0], :]),
                         axis=0)
            if np.any(~chk):
                bad_subs = np.where(~chk)[0]
                raise ValueError('Distinct signal values in provided multi-'
                                 'shell sampling for zero gradients '
                                 '(b0 acquistions), for '
                                 '%d substrate(s) [%s]' %
                                 (bad_subs.shape[0],
                                  " ".join("{:d}".format(b)
                                           for b in bad_subs)))
            shell_xs.append(np.array([0.0, 1.0]))
            shell_ys.append(np.repeat(sig_ms[ind_sh[0:1], :], 2, axis=0))
            continue
        xs, ys = _build_shell_knots(orcyldotG_all[ind_sh], sig_ms[ind_sh, :])
        if xs.size < 2:
            raise ValueError(
                "Shell %d/%d (G=%g) reduces to fewer than 2 interpolation "
                "knots; cannot build a linear interpolator."
                % (i + 1, Gms_un.shape[0], Gms_un[i]))
        shell_xs.append(xs)
        shell_ys.append(ys)

    Kmax = max(x.size for x in shell_xs)
    S = Gms_un.shape[0]
    xs_pad = np.full((S, Kmax), np.inf)
    ys_pad = np.zeros((S, Kmax, num_subs))
    cnt = np.zeros(S, dtype=np.int32)
    for s in range(S):
        k = shell_xs[s].size
        xs_pad[s, :k] = shell_xs[s]
        ys_pad[s, :k, :] = shell_ys[s]
        cnt[s] = k
    return MultiShellInterp(scheme_DeldelTE=sch_mat_ms[0, 4:7].copy(),
                            num_subs=num_subs, Gms_un=Gms_un,
                            xs=xs_pad, ys=ys_pad, cnt=cnt)


@dataclasses.dataclass
class TargetSchemePlan:
    """Static per-sequence shell mapping for a target acquisition scheme."""
    gdir: np.ndarray      # (Nseq, 3)
    shell_lo: np.ndarray  # (Nseq,) int32 index into dense shells
    shell_hi: np.ndarray  # (Nseq,) int32
    wG: np.ndarray        # (Nseq,) blend weight between lo and hi shells


def plan_target_scheme(msinterp, sch_mat):
    """Map every target sequence to its (pair of) dense G-shells (host).

    Reproduces the G-bracketing of the reference
    (mf_utils.py:1812-1839) including the no-extrapolation error.
    """
    sch_mat = np.asarray(sch_mat, dtype=np.float64)
    chk_new = np.isclose(msinterp.scheme_DeldelTE, sch_mat[:, 4:7])
    if not np.all(chk_new):
        raise ValueError("Delta, delta and TE values should all be "
                         "identical to those in the multi-shell sampling.")
    Gdir_norm_new = np.sqrt(np.sum(sch_mat[:, 0:3] ** 2, axis=1))
    if np.any(np.abs(1 - Gdir_norm_new[Gdir_norm_new > 0]) > 1e-3):
        raise ValueError("Gradient directions in multi-shell scheme matrix"
                         " should all either have zero or unit norm.")
    Gms_un = msinterp.Gms_un
    G_un, i_G = np.unique(sch_mat[:, 3], return_inverse=True)
    lo_of_un = np.zeros(G_un.size, dtype=np.int32)
    hi_of_un = np.zeros(G_un.size, dtype=np.int32)
    w_of_un = np.zeros(G_un.size)
    for k, Gnew in enumerate(G_un):
        i = np.where(Gnew == Gms_un)[0]
        if i.size > 0:
            lo_of_un[k] = hi_of_un[k] = i[0]
            w_of_un[k] = 0.0
        else:
            i_high = int(np.argmax(Gms_un > Gnew))
            if i_high == 0:
                raise ValueError("Gradient intensity %g is not in the"
                                 " [%g, %g] range spanned by the multi-shell"
                                 " sampling. Extrapolation not supported." %
                                 (Gnew, Gms_un[0], Gms_un[-1]))
            lo_of_un[k] = i_high - 1
            hi_of_un[k] = i_high
            w_of_un[k] = ((Gnew - Gms_un[i_high - 1])
                          / (Gms_un[i_high] - Gms_un[i_high - 1]))
    return TargetSchemePlan(gdir=sch_mat[:, 0:3].copy(),
                            shell_lo=lo_of_un[i_G],
                            shell_hi=hi_of_un[i_G],
                            wG=w_of_un[i_G])

# ---------------------------------------------------------------------------
# Device rotation
# ---------------------------------------------------------------------------

def _abs_gdotn(gdir, newdirs, dt, dev):
    """|g . n| (B*K, Nseq) of the target directions ``gdir`` (Nseq, 3)
    and the directions ``newdirs`` (B, K, 3), as a fixed-order three-term
    sum (no reduction kernel)."""
    nd = newdirs.reshape(-1, 3).to(dt)
    g = torch.as_tensor(gdir, dtype=dt, device=dev)
    return torch.abs(nd[:, None, 0] * g[None, :, 0]
                     + nd[:, None, 1] * g[None, :, 1]
                     + nd[:, None, 2] * g[None, :, 2])


def _lerp_weights(msinterp, s, xq, kiota):
    """One-hot lerp weights (..., q, Kmax) of the queries ``xq`` (..., q)
    on dense shell ``s``'s knots, in ``xq``'s dtype and device."""
    xs_s = torch.as_tensor(msinterp.xs[s], dtype=xq.dtype, device=xq.device)
    j = torch.clamp((xq[..., None] >= xs_s).sum(-1) - 1,
                    0, int(msinterp.cnt[s]) - 2)
    x0 = xs_s[j]
    x1 = xs_s[j + 1]
    denom = x1 - x0
    pos = denom > 0
    t = torch.where(pos, (xq - x0) / torch.where(
        pos, denom, torch.ones_like(denom)), torch.zeros_like(xq))
    return ((1.0 - t)[..., None] * (kiota == j[..., None])
            + t[..., None] * (kiota == (j[..., None] + 1)))


def make_grouped_rotation(msinterp, plan):
    """Per-shell grouped rotation (the JAX package's unpaired variant).

    Target sequences are grouped by dense shell: each shell's
    contribution is one matmul of one-hot lerp weights W_s (q_s, Kmax)
    against ys[s], once for the lower and once for the upper bracketing
    shell, and two inverse permutations put the sequences back in the
    plan's order before the blend in G. Equal to :func:`eval_rotation`
    up to matmul rounding. Returns ``rotate(tables_ys (S, Kmax, N),
    newdirs (B, K, 3)) -> (B, K, Nseq, N)``.
    """
    S = msinterp.Gms_un.size
    Kmax = msinterp.xs.shape[1]
    groups, inv = {}, {}
    for role, shell in (("lo", plan.shell_lo), ("hi", plan.shell_hi)):
        groups[role] = [(s, np.flatnonzero(shell == s)) for s in range(S)
                        if np.any(shell == s)]
        inv[role] = np.argsort(np.concatenate(
            [ids for _s, ids in groups[role]]))

    def rotate(tables_ys, newdirs):
        B, K, _ = newdirs.shape
        dt, dev = tables_ys.dtype, tables_ys.device
        x = _abs_gdotn(plan.gdir, newdirs, dt, dev)           # (BK, Nseq)
        kiota = torch.arange(Kmax, device=dev)
        R = {}
        for role, grp in groups.items():
            outs = [torch.matmul(_lerp_weights(
                msinterp, s, x[:, torch.as_tensor(ids, device=dev)], kiota),
                tables_ys[s]) for s, ids in grp]
            R[role] = torch.cat(outs, dim=1)[
                :, torch.as_tensor(inv[role], device=dev)]
        w = torch.as_tensor(plan.wG, dtype=dt, device=dev)[None, :, None]
        D = R["lo"] + w * (R["hi"] - R["lo"])
        return D.reshape(B, K, plan.gdir.shape[0], -1)

    return rotate


def make_grouped_rotation_paired(msinterp, plan):
    """Permutation-free grouped rotation.

    Target sequences are grouped by their (shell_lo, shell_hi) pair and
    each group is evaluated with ONE matmul
    [(1-wG)*W_lo | wG*W_hi] @ [ys[lo]; ys[hi]], so the output is the
    concatenation of the groups. Returns ``(rotate, perm)``:
    ``rotate(tables_ys (S, Kmax, N), newdirs (B, K, 3)) -> (B, K, Nseq, N)``
    in group order, and ``perm`` (Nseq,) int32 with
    ``rotate(...)[..., q, :] == standard[..., perm[q], :]``. Consumers
    permute the measured signal and the fixed compartment columns with
    the same ``perm``; residuals, weights, R^2 and atom selections are
    permutation-invariant.
    """
    Kmax = msinterp.xs.shape[1]
    pair_ids = {}
    for q in range(plan.gdir.shape[0]):
        key = (int(plan.shell_lo[q]), int(plan.shell_hi[q]))
        pair_ids.setdefault(key, []).append(q)
    pairs = [(sl, sh, np.asarray(ids, np.int64))
             for (sl, sh), ids in sorted(pair_ids.items())]
    perm = np.concatenate([ids for _sl, _sh, ids in pairs]).astype(np.int32)
    wG_h = plan.wG

    def rotate(tables_ys, newdirs):
        B, K, _ = newdirs.shape
        dt, dev = tables_ys.dtype, tables_ys.device
        x = _abs_gdotn(plan.gdir, newdirs, dt, dev)           # (BK, Nseq)
        kiota = torch.arange(Kmax, device=dev)

        def weights(xq, s, scale):
            return (_lerp_weights(msinterp, s, xq, kiota)
                    * scale[None, :, None])

        outs = []
        for sl, sh, ids in pairs:
            ids_d = torch.as_tensor(ids, device=dev)
            xq = x[:, ids_d]                                  # (BK, q)
            wq = torch.as_tensor(wG_h[ids], dtype=dt, device=dev)
            W = torch.cat([weights(xq, sl, 1.0 - wq),
                           weights(xq, sh, wq)], dim=2)
            T = torch.cat([tables_ys[sl], tables_ys[sh]], dim=0)
            outs.append(torch.matmul(W, T))
        D = torch.cat(outs, dim=1)
        return D.reshape(B, K, perm.size, -1)

    return rotate, perm


def _shell_lerp(xs, ys, cnt, s_idx, x):
    """Per-sequence shell interpolation, as the JAX package's
    ``_shell_lerp``, batched over the leading axes of ``x``.

    xs (S, Kmax), ys (S, Kmax, N), cnt (S,), s_idx (Q,), x (..., Q)
    -> (..., Q, N).
    """
    xs_r = xs[s_idx]                                      # (Q, Kmax)
    cnt_r = cnt[s_idx].long()                             # (Q,)
    j = torch.minimum(torch.clamp((x[..., None] >= xs_r).sum(-1) - 1,
                                  min=0), cnt_r - 2)      # (..., Q)
    q = torch.arange(s_idx.shape[0], device=x.device)
    x0 = xs_r[q, j]
    x1 = xs_r[q, j + 1]
    denom = x1 - x0
    pos = denom > 0
    t = torch.where(pos, (x - x0) / torch.where(pos, denom, 1.0), 0.0)
    y0 = ys[s_idx, j]                                     # (..., Q, N)
    y1 = ys[s_idx, j + 1]
    return y0 + t[..., None] * (y1 - y0)


def eval_rotation_batch(xs, ys, cnt, gdir, shell_lo, shell_hi, wG, newdirs):
    """Rotated/resampled fascicle dictionaries for a batch of directions.

    The gather-and-lerp rotation of the JAX package's ``eval_rotation``
    (vmapped there into ``eval_rotation_batch``): per sequence, linear
    interpolation at x = |g . n| on the bracketing dense shells, blended
    linearly in G. Tables (xs, ys, cnt) as ``MultiShellInterp.
    device_tables`` gives them, plan arrays (gdir (Nseq, 3), shell_lo,
    shell_hi (Nseq,), wG (Nseq,)) on the same device; newdirs (B, K, 3).
    Returns (B, K, Nseq, N) in the plan's sequence order.
    """
    nd = newdirs.to(gdir.dtype)
    # |g . n| as a fixed-order three-term sum (no reduction kernel)
    x = torch.abs(nd[..., None, 0] * gdir[:, 0] + nd[..., None, 1]
                  * gdir[:, 1] + nd[..., None, 2] * gdir[:, 2])
    lo = _shell_lerp(xs, ys, cnt, shell_lo, x)
    hi = _shell_lerp(xs, ys, cnt, shell_hi, x)
    return lo + wG[:, None] * (hi - lo)


def eval_rotation(xs, ys, cnt, gdir, shell_lo, shell_hi, wG, newdir):
    """Rotated/resampled single-fascicle dictionary for one direction
    ``newdir`` (3,): (Nseq, N), as :func:`eval_rotation_batch` gives it
    for a batch of one, on the device and in the dtype of its inputs."""
    return eval_rotation_batch(xs, ys, cnt, gdir, shell_lo, shell_hi, wG,
                               newdir.reshape(1, 1, 3))[0, 0]


# ---------------------------------------------------------------------------
# Reference-compatible wrappers
# ---------------------------------------------------------------------------

def interp_PGSE_from_multishell(sch_mat, newdir,
                                sig_ms=None, sch_mat_ms=None, ordir=None,
                                msinterp=None, device="cuda"):
    """Single-fascicle PGSE signal interpolated from a dense multi-HARDI
    sampling (reference mf_utils.py:1693-1956).

    FAST mode (``msinterp`` given) and one-shot mode (the tables built
    from ``sig_ms``, ``sch_mat_ms`` and ``ordir`` on every call) share
    :func:`eval_rotation`, in float64 on ``device``: the card unless the
    caller asks for the CPU.
    """
    dev = config.resolve_device(device)
    if msinterp is None:
        if sig_ms is None or sch_mat_ms is None or ordir is None:
            raise ValueError("If msinterp is not specified, sig_ms, "
                             "sch_mat_ms and ordir must all be specified.")
        msinterp = init_PGSE_multishell_interp(sig_ms, sch_mat_ms, ordir)
    newdir = np.squeeze(np.asarray(newdir, dtype=np.float64))
    if newdir.size != 3:
        raise ValueError("Direction of fascicle for new signal (newdir)"
                         " should have 3 entries.")
    newdirnorm = np.sqrt((newdir ** 2).sum())
    if np.abs(1 - newdirnorm) > 1e-3:
        raise ValueError("Orientation vector of the new signal must have"
                         " unit norm. Detected %g." % (newdirnorm,))
    plan = plan_target_scheme(msinterp, sch_mat)
    xs, ys, cnt = msinterp.device_tables(dev, torch.float64)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    sig_new = eval_rotation(xs, ys, cnt, f64(plan.gdir),
                            torch.as_tensor(plan.shell_lo, device=dev),
                            torch.as_tensor(plan.shell_hi, device=dev),
                            f64(plan.wG), f64(newdir))
    return np.squeeze(sig_new.cpu().numpy())


def rotate_atom(sig, sch_mat, ordir, newdir, DIFF, S0, warnings=True):
    """Rotate HARDI single-fascicle signals to a new fascicle direction.

    Behavioral equivalent of reference mf_utils.py:1205-1437: per unique
    (G, Delta, delta) shell, re-express the signal as a function of |g.n|,
    append the free-diffusion anchor point (1, exp(-b*DIFF)*S0) when absent,
    smooth the near-perpendicular cluster, then linearly interpolate at the
    new direction's dot products. b0 shells pass through unchanged.

    Host-level utility (used for dictionary generation and tests); the fit
    hot path uses the precomputed-table kernel instead.
    """
    assert isinstance(sig, np.ndarray), "Input sig should be a NumPy ndarray"
    assert isinstance(sch_mat, np.ndarray), ("Input sch_mat should be a "
                                             "NumPy ndarray")
    assert isinstance(ordir, np.ndarray), ("Input ordir should be a NumPy "
                                           "ndarray")
    assert isinstance(newdir, np.ndarray), ("Input newdir should be a "
                                            "NumPy ndarray")
    sig_shape = sig.shape
    if sig.ndim == 1:
        sig = sig.reshape((sig.size, 1))
    DIFF = float(np.asarray(DIFF).reshape(-1)[0])
    assert isinstance(S0, np.ndarray), "Input S0 should be a NumPy ndarray"
    if S0.ndim == 1:
        S0 = S0[:, np.newaxis]
    if sch_mat.shape[1] < 6:
        raise ValueError('sch_mat must be a N-by-6 or7 matrix')
    if sch_mat.shape[0] != sig.shape[0]:
        raise ValueError('sch_mat and sig must have the same number of rows')
    assert sig.shape == S0.shape, ("The S0 matrix should have the same size "
                                   "as the signal matrix")

    gam = get_gyromagnetic_ratio('H')
    ordir_u = ordir / np.sqrt((ordir ** 2).sum())
    newdir_u = newdir / np.sqrt((newdir ** 2).sum())

    Gdir_norm = np.sqrt((sch_mat[:, 0:3] ** 2).sum(axis=1, keepdims=True))
    Gdir_norm[Gdir_norm == 0] = np.inf  # b0 rows -> zero dot products
    orcyldotG_all = np.abs(np.dot(sch_mat[:, 0:3] / Gdir_norm, ordir_u))
    newcyldotG_all = np.abs(np.dot(sch_mat[:, 0:3] / Gdir_norm, newdir_u))

    bvals = ((gam * sch_mat[:, 3] * sch_mat[:, 5]) ** 2
             * (sch_mat[:, 4] - sch_mat[:, 5] / 3))
    sig_rot = np.zeros(sig.shape)
    GdD_un, i_un = np.unique(sch_mat[:, 3:6], return_inverse=True, axis=0)
    num_shells = GdD_un.shape[0]

    for i in range(num_shells):
        ind_sh = np.where(i_un == i)[0]
        bval = bvals[ind_sh[0]]
        if bval == 0:
            sig_rot[ind_sh, :] = sig[ind_sh, :]
            continue
        if ind_sh.size < 2:
            raise ValueError("Fewer than 2 identical (G, Del, del) triplets "
                             "detected for triplet %d/%d (%g, %g, %g), b=%g"
                             " s/mm^2, probably not a HARDI shell." %
                             (i + 1, num_shells, GdD_un[i, 0], GdD_un[i, 1],
                              GdD_un[i, 2], bval / 1e6))
        if ind_sh.size < 10 and warnings:
            print("WARNING: rotate_atom: fewer than 10 data points detected"
                  " for acquisition parameters (G, Del, del) %d/%d "
                  "(%g, %g, %g), b=%g s/mm^2.\n"
                  "Quality of approximation may be poor."
                  % (i + 1, num_shells, GdD_un[i, 0], GdD_un[i, 1],
                     GdD_un[i, 2], bval / 1e6))
        # S0 must be constant within the shell for each substrate
        S0_sh_ok = np.all(np.isclose(S0[ind_sh, :], S0[ind_sh[0], :]), axis=0)
        if np.any(~S0_sh_ok):
            bad_subs = np.where(~S0_sh_ok)[0]
            raise ValueError('Distinct values in provided S0 image '
                             'for shell  %d/%d (b=%g s/mm^2) '
                             'for %d substrate(s) [%s]' %
                             (i + 1, num_shells, bval / 1e6,
                              bad_subs.shape[0],
                              " ".join("{:d}".format(b) for b in bad_subs)))

        xs, first_idx = np.unique(orcyldotG_all[ind_sh], return_index=True)
        ys = sig[ind_sh, :][first_idx, :]

        # free-diffusion anchor at |g.n| = 1 stabilizes the interpolation
        if not np.any(xs == 1):
            xs = np.append(xs, [1.0])
            free_diff = np.exp(-bval * DIFF) * S0[ind_sh[0], :]
            ys = np.concatenate([ys, free_diff[np.newaxis, :]], axis=0)

        almost_perp = np.abs(xs - xs[0]) < _PERP_CLUSTER_TOL
        cluster_size = int(np.sum(almost_perp))
        if cluster_size > 1:
            xs = np.concatenate(([np.mean(xs[almost_perp])],
                                 xs[cluster_size:]))
            ys = np.concatenate((np.mean(ys[almost_perp, :], axis=0,
                                         keepdims=True),
                                 ys[cluster_size:, :]), axis=0)
        if xs.size != ys.shape[0] and warnings:
            print("WARNING: rotate_atom: problem with shapes and/or sizes"
                  " before 1D interpolation at shell %d/%d "
                  "(G=%g Del=%g del=%g)" %
                  (i + 1, num_shells,
                   GdD_un[i, 0], GdD_un[i, 1], GdD_un[i, 2]))

        sig_rot[ind_sh, :] = _lerp_eval_np(xs, ys, newcyldotG_all[ind_sh])
        if np.any(np.isnan(sig_rot[ind_sh, :])):
            sub_has_nan = np.any(np.isnan(sig_rot[ind_sh, :]), axis=0)
            bad_subs = np.where(sub_has_nan)[0]
            raise ValueError('Nan detected after rotation of substrate(s) '
                             'for sequence(s) {%d...%d} (bval=%g s/mm^2) '
                             'for %d substrate(s): [%s]' %
                             (ind_sh[0], ind_sh[-1], bval / 1e6,
                              bad_subs.shape[0],
                              " ".join("%d" % b for b in bad_subs)))
    return np.reshape(sig_rot, sig_shape)


def rotate_atom_2Dprotocol(sig, sch_mat, refdir, newdir, DIFF):
    """Rotate signals acquired with a 2D AxCaliber-like protocol.

    Behavioral equivalent of reference mf_utils.py:1440-1690. The signal is
    factorized as S = S_par * S_perp with analytic free diffusion along the
    fascicle (S_par = exp(-b_par * DIFF)); per (Delta, delta) pair the two
    opposite-polarity acquisition "lines" are identified in the plane
    perpendicular to each fascicle, and S_perp is linearly interpolated over
    *signed* gradient intensity along the closest reference line.
    """
    sig_shape = sig.shape
    if sig.ndim == 1:
        sig = sig[:, np.newaxis]
    if np.any(sch_mat[:, 2] != 0):
        raise ValueError("Use the original schemefile with zeros for gz.\n"
                         "Specify the reference and new orientations "
                         "separately.")
    if sig_shape[0] != sch_mat.shape[0]:
        raise ValueError("Signal and scheme matrix must have the same "
                         "number of elements (sequences) along their first"
                         " dimension. Detected %d and %d." %
                         (sig_shape[0], sch_mat.shape[0]))
    zdir = np.array([0, 0, 1.0])
    gam = get_gyromagnetic_ratio('H')
    G = sch_mat[:, 3]
    Delta = sch_mat[:, 4]
    delta = sch_mat[:, 5]
    is_b0 = G == 0
    is_b = G != 0

    def _perp_par(direction):
        """Perpendicular unit dirs, perpendicular and parallel G components
        in the frame of a fascicle along ``direction``."""
        sm_eff = rotate_scheme_mat(sch_mat, zdir, direction)
        g_perp = sm_eff[:, 0:2].copy()
        g_norm = np.sqrt(np.sum(g_perp ** 2, axis=1))
        nnz = g_norm > 0
        g_perp[nnz, :] = sm_eff[nnz, 0:2] / g_norm[nnz][:, np.newaxis]
        G_perp = G * g_norm
        G_par = np.abs(sm_eff[:, 2]) * G
        assert np.all(np.isclose(G ** 2, G_perp ** 2 + G_par ** 2)), (
            "Inconsistency in parallel and perpendicular gradient"
            " components.")
        return g_perp, G_perp, G_par, nnz

    g_perp_ref, G_perp_ref, G_par_ref, nnz_gref = _perp_par(refdir)
    b_par_ref = (gam * delta * G_par_ref) ** 2 * (Delta - delta / 3)
    S_par_ref = np.exp(-b_par_ref * DIFF)
    S_perp_ref = sig / S_par_ref[:, np.newaxis]
    assert np.all(np.isclose(S_par_ref[is_b0], 1)), (
        "Reference fascicle: parallel signal should be one in b0 sequences.")

    g_perp_new, G_perp_new, G_par_new, nnz_gnew = _perp_par(newdir)
    b_par_new = (gam * delta * G_par_new) ** 2 * (Delta - delta / 3)
    S_par_new = np.exp(-b_par_new * DIFF)[:, np.newaxis] * np.ones(
        (1, sig.shape[1]))
    S_perp_new = np.zeros(sig.shape)
    S_perp_new[is_b0, :] = sig[is_b0, :]
    assert np.all(np.isclose(S_par_new[is_b0, :], 1)), (
        "New fascicle: parallel signal should be equal to 1 in b0"
        " sequences.")

    Deldel_un, i_un = np.unique(sch_mat[:, 4:6], return_inverse=True, axis=0)
    num_Deldels = Deldel_un.shape[0]

    for idel in range(num_Deldels):
        is_shell = i_un == idel
        ind_del = np.where(is_shell)[0]

        # unique perpendicular directions (pairs of opposite polarities plus
        # the zero direction): 3 or 5 expected
        gdir_ref_un, ig_ref_un = np.unique(g_perp_ref[ind_del, :],
                                           return_inverse=True, axis=0)
        assert gdir_ref_un.shape[0] in (3, 5), (
            "Problem at delta pair %d/%d: found %d unique gradient"
            " directions in plane perpendicular to reference fascicle"
            " (including b0 zero dirs)."
            % (idel + 1, num_Deldels, gdir_ref_un.shape[0]))
        cross_dp = gdir_ref_un @ gdir_ref_un.T
        ig, ig_op = np.where(np.isclose(cross_dp, -1))
        assert ig.size in (2, 4), (
            "Problem at delta pair %d/%d: found %d instead of 4 (2x2,"
            " redundant) pairs of opposite directions in plane perpendicular"
            " to reference fascicle." % (idel + 1, num_Deldels, ig.size))

        gdir_new_un, ig_new_un = np.unique(g_perp_new[ind_del, :],
                                           return_inverse=True, axis=0)
        assert gdir_new_un.shape[0] in (3, 5), (
            "Problem at delta pair %d/%d: found %d unique gradient"
            " directions in plane perpendicular to new fascicle (including"
            " b0 zero dirs)." % (idel + 1, num_Deldels,
                                 gdir_new_un.shape[0]))
        cross_dp_new = gdir_new_un @ gdir_new_un.T
        ipairs_new, ig_op_new = np.where(np.isclose(cross_dp_new, -1))
        is_upper = ipairs_new < ig_op_new
        ipairs_new = ipairs_new[is_upper]
        ig_op_new = ig_op_new[is_upper]
        assert ipairs_new.size in (1, 2), (
            "Problem at delta pair %d/%d: found %d instead of 2 pairs of"
            " opposite directions, in plane perpendicular to new fascicle."
            % (idel + 1, num_Deldels, ipairs_new.size))

        # sequences whose perpendicular gradient vanishes for the new
        # fascicle see free diffusion: use the shell's b0 level
        is_vanished_new = ~nnz_gnew & is_b & is_shell
        is_sh_b0_ref = is_b0 & is_shell
        if np.sum(is_vanished_new) > 0:
            assert np.sum(is_sh_b0_ref) > 0, (
                "Shell %d/%d: some new line directions are completely"
                " parallel to new fascicle, implying free diffusion. However,"
                " no b0 measurements in the reference signal are available"
                " for this shell." % (idel + 1, num_Deldels))
            S_perp_new[is_vanished_new, :] = np.mean(
                sig[is_sh_b0_ref, :], axis=0)

        for i_line in range(ipairs_new.size):
            linedir_new = gdir_new_un[ipairs_new[i_line], :]
            ind_new = ind_del[(ig_new_un == ipairs_new[i_line])
                              | (ig_new_un == ig_op_new[i_line])]
            assert np.all(is_b[ind_new]), (
                "Problem at delta pair %d/%d, new line direction %d/%d:"
                " trying to interpolate b0 sequences."
                % (idel + 1, num_Deldels, i_line, ipairs_new.size))
            G_signed_new = (G_perp_new[ind_new] *
                            np.sign(g_perp_new[ind_new, :] @ linedir_new))
            # closest reference line to the new line
            i_max = np.argmax(gdir_ref_un @ linedir_new)
            line_ref = gdir_ref_un[i_max, :]
            idirref = np.where(i_max == ig)[0]
            ind_ref = ind_del[(ig_ref_un == ig[idirref])
                              | (ig_ref_un == ig_op[idirref])]
            G_signed_ref = (G_perp_ref[ind_ref] *
                            np.sign(g_perp_ref[ind_ref, :] @ line_ref))
            order = np.argsort(G_signed_ref)
            S_perp_new[ind_new, :] = _lerp_eval_np(
                G_signed_ref[order], S_perp_ref[ind_ref, :][order, :],
                G_signed_new)
    S_par_new = np.reshape(S_par_new, sig_shape)
    S_perp_new = np.reshape(S_perp_new, sig_shape)
    return S_par_new * S_perp_new
