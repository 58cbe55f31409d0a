"""Synthetic workload generators (smoke runs and tests), the rule that
holds a CUDA kernel against its plain version, the plain versions'
float64 sums in the orders of the hoist kernels (8-12), and kernel 7's
lane reduction.

Same generators as ``microstructure_fingerprinting_tpu/testing.py``: an
HCP-like dense multi-shell PGSE scheme, a smooth single-fascicle
fingerprint dictionary (zeppelins with per-atom diffusivities), and the
flagship 2-fascicle + CSF fit workload, whose noiseless signals are
synthesized through this package's grouped rotation, its EAR
(UK-Biobank) variant, volumes that mix buckets, and a DDE scheme for
the MCF simulators. The
random draws of the workload are the JAX package's, in the same order,
for the same seed.
"""

import numpy as np
import torch

from .ops import interp as mfi
from .utils.scheme import b_values


#: a kernel against its plain version: float32 ulp of max|value|, and
#: the share of entries that may differ in any bit
KERNEL_ULPS = 2
KERNEL_DIFF_SHARE = 1e-5


def kernel_agreement(k, p, exact=False):
    """Hold a kernel's output ``k`` against its plain version's ``p``.

    Both sum the same exact products in float64 and round once, so they
    agree bit for bit except where the two summation orders round a
    float64 sum of float32 products (column norms, the re-scan's cross
    products) to neighbouring float32 values: a handful of entries per
    chunk, each off by ulps. So:
      * at most KERNEL_DIFF_SHARE of the entries differ in any bit (none
        where ``exact``), which fails a kernel that drops or mis-sums a
        term anywhere;
      * float32 outputs have inf/NaN at the same entries, and finite
        values agree to KERNEL_ULPS float32 ulp of the largest |value|,
        below the row pass's smallest error radius (8 eps).
    Returns (ok, entries that differ, entries, max|k - p|, its limit)."""
    if k.shape != p.shape or k.dtype != p.dtype:
        return False, k.numel(), k.numel(), float("inf"), 0.0
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if k.dtype in bits:
        n_diff = int((k.view(bits[k.dtype]) != p.view(bits[p.dtype])).sum())
    else:
        n_diff = int((k != p).sum())
    ok = n_diff == 0 if exact else n_diff <= KERNEL_DIFF_SHARE * k.numel()
    err, tol = 0.0, 0.0
    if k.dtype == torch.float32:
        fin, inf = torch.isfinite(p), torch.isinf(p)
        ok = ok and (torch.equal(torch.isfinite(k), fin)
                     and torch.equal(torch.isnan(k), torch.isnan(p))
                     and torch.equal(k[inf], p[inf]))
        if fin.any():
            kf, pf = k[fin].double(), p[fin].double()
            err = float((kf - pf).abs().max())
            tol = KERNEL_ULPS * float(np.finfo(np.float32).eps) * float(
                pf.abs().max())
            ok = ok and err <= tol
    return ok, n_diff, k.numel(), err, tol


def fdot_sample_order(contract, x, y):
    """``ops/dfscan.fdot`` (a float64 sum of exact float32 products,
    rounded once) summed as kernel 8 sums its atoms' Grams with
    themselves: from +0, one sample after the other (the sample axis is
    axis 1 of both operands). Patch it over ``dfscan.fdot`` to run a plain
    version in the kernel's order."""
    x, y = x.double(), y.double()
    acc = None
    for s in range(x.shape[1]):
        t = torch.einsum(contract, x[:, s:s + 1], y[:, s:s + 1])
        acc = (torch.zeros_like(t) if acc is None else acc) + t
    return acc.float()


def fdot_parts_order(parts):
    """``ops/dfscan.fdot`` summed as the voxel launches of kernels 8, 11
    and 12 sum the voxel's small Grams: the samples split into ``parts``
    parts, part p the samples s = p mod ``parts``, each part summed from
    +0 one sample after the other, then the parts' sums added in part
    order and rounded once. Patch it over ``dfscan.fdot`` to run a plain
    version in that order."""
    def fdot(contract, x, y):
        x, y = x.double(), y.double()
        total = None
        for p in range(parts):
            acc = torch.einsum(contract, x[:, :0], y[:, :0])   # zeros
            for s in range(p, x.shape[1], parts):
                acc = acc + torch.einsum(contract, x[:, s:s + 1],
                                         y[:, s:s + 1])
            total = acc if total is None else total + acc
        return total.float()
    return fdot


def fdot_mma_order(contract, x, y, chunk=32, step=8):
    """``ops/dfscan.fdot`` as the tensor cores sum kernel 8's Grams of an
    atom with the small columns: the samples padded with zeros to whole
    chunks of ``chunk``, ``step`` at a time (an mma's depth) onto one
    float64 accumulator, chunk after chunk, rounded once."""
    x, y = x.double(), y.double()
    pad = -x.shape[1] % chunk
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    y = torch.nn.functional.pad(y, (0, 0) * (y.dim() - 2) + (0, pad))
    acc = torch.einsum(contract, x[:, :0], y[:, :0])
    for s in range(0, x.shape[1], step):
        acc = acc + torch.einsum(contract, x[:, s:s + step],
                                 y[:, s:s + step])
    return acc.float()


def fdot_kernel8_order(atom_widths, parts):
    """``ops/dfscan.fdot`` in kernel 8's orders: an atom block's (its width
    in ``atom_widths``) Gram with itself sample after sample
    (``fdot_sample_order``), with the small columns on the tensor cores
    (``fdot_mma_order``); the Grams among the small columns in the voxel
    launch's ``parts`` parts (``fdot_parts_order``). Patch it over
    ``dfscan.fdot`` to run ``rescan.df4_hoist_twin`` in that order."""
    small = fdot_parts_order(parts)

    def fdot(contract, x, y):
        if x.dim() < 3 or x.shape[2] not in atom_widths:
            return small(contract, x, y)
        if contract == "bsn,bsn->bn":
            return fdot_sample_order(contract, x, y)
        return fdot_mma_order(contract, x, y)
    return fdot


def fdot_hoist_order(atom_widths, atom_parts, vox_parts):
    """``ops/dfscan.fdot`` in the orders of kernels 9 and 10: the Grams of
    an atom block (its width in ``atom_widths``) as their atom launch sums
    them, in ``atom_parts`` strided parts; the voxel's small Grams (among
    the signal, the CSF column and kernel 9's [N, 1] column) as their voxel
    launch sums them, in ``vox_parts`` (``fdot_parts_order`` both; the
    kernels take ``dfscan.HOIST_PARTS`` for each). ``None`` keeps a group in
    the einsum order. Patch it over ``dfscan.fdot`` to run
    ``rescan.df3_hoist_twin`` or ``dfscan.df2_hoist_twin`` in that order."""
    atoms = fdot_parts_order(atom_parts) if atom_parts else None
    small = fdot_parts_order(vox_parts) if vox_parts else None
    einsum = lambda contract, x, y: torch.einsum(
        contract, x.double(), y.double()).float()

    def fdot(contract, x, y):
        order = atoms if x.dim() == 3 and x.shape[2] in atom_widths else small
        return (order or einsum)(contract, x, y)
    return fdot


def df_lanes_first_min(hi, lo):
    """Kernel 7's choice among the 4-column NNLS's supports (``csrc/
    finalize.cu`` ``first_min``): slot l < 16 of the last axis holds the
    residual (``hi``, ``lo``) of the support of mask l (slot 0 the empty
    support's y'y), one a lane; a butterfly over the offsets 1, 2, 4, 8
    keeps, of two neighbouring blocks of slots, the lower block's value
    unless the upper block's is strictly less under ``dfscan._df_lt``.
    Returns the winning slot (int64, the last axis reduced). Where no
    residual but y'y holds a NaN, this is the slot that ``_df_nnls4``'s
    sequential fold (strict improvement from y'y on) keeps."""
    hi, lo = hi.clone(), lo.clone()
    idx = torch.arange(16).expand(hi.shape).clone()
    lane = torch.arange(16)
    for off in (1, 2, 4, 8):
        o = lane ^ off
        upper = (lane & off) != 0
        o_hi, o_lo, o_idx = hi[..., o], lo[..., o], idx[..., o]
        l_hi = torch.where(upper, o_hi, hi)
        l_lo = torch.where(upper, o_lo, lo)
        l_idx = torch.where(upper, o_idx, idx)
        u_hi = torch.where(upper, hi, o_hi)
        u_lo = torch.where(upper, lo, o_lo)
        u_idx = torch.where(upper, idx, o_idx)
        take = (u_hi < l_hi) | ((u_hi == l_hi) & (u_lo < l_lo))
        hi = torch.where(take, u_hi, l_hi)
        lo = torch.where(take, u_lo, l_lo)
        idx = torch.where(take, u_idx, l_idx)
    return idx[..., 0]


def fibonacci_sphere(n):
    """n roughly-uniform unit directions (golden-angle spiral)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1)


def make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40,
                      G_max=0.28, Delta=0.0431, delta=0.0106, TE=0.057):
    """Dense multi-HARDI scheme: n_shells G-shells + b0 block (7 cols, SI)."""
    rows = [np.zeros((n_b0, 7))]
    rows[0][:, 4:7] = [Delta, delta, TE]
    for s in range(n_shells):
        G = G_max * (s + 1) / n_shells
        sh = np.zeros((dirs_per_shell, 7))
        sh[:, :3] = fibonacci_sphere(dirs_per_shell)
        sh[:, 3] = G
        sh[:, 4:7] = [Delta, delta, TE]
        rows.append(sh)
    return np.concatenate(rows, axis=0)


def make_dde_scheme(n, seed=0):
    """A double-diffusion-encoding scheme of n rows (14 columns, the
    layout of ``models/mcf.import_DDE_scheme``): random unit gradient
    pairs, G up to 0.08 T/m, Delta >= delta in each block, TE 10 ms above
    the total diffusion time; the first row has no gradient."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n, 2, 3)
    g /= np.linalg.norm(g, axis=2, keepdims=True)
    sch = np.zeros((n, 14))
    sch[:, 0:3], sch[:, 7:10] = g[:, 0], g[:, 1]
    sch[:, 3], sch[:, 10] = rng.uniform(0, 0.08, (2, n))
    sch[0, 3] = sch[0, 10] = 0.0
    sch[:, 5], sch[:, 12] = rng.uniform(0.003, 0.008, (2, n))
    sch[:, 4] = sch[:, 5] + rng.uniform(0.005, 0.02, n)
    sch[:, 11] = sch[:, 12] + rng.uniform(0.005, 0.02, n)
    sch[:, 6] = rng.uniform(0.0, 0.03, n)
    sch[:, 13] = (sch[:, 4] + sch[:, 5] + sch[:, 6] + sch[:, 11]
                  + sch[:, 12] + 0.01)
    return sch


def make_dictionary(sch_mat, num_atom=782, seed=0):
    """Smooth synthetic fingerprint dictionary along e_z: zeppelins
    S = exp(-b (d_par - d_perp) (g.n)^2 - b d_perp) on a (d_par, d_perp)
    grid — highly correlated columns, like Monte-Carlo dictionaries.
    Returns (sig (S, num_atom), d_par, d_perp)."""
    del seed  # the grid is deterministic (kept for the JAX signature)
    b = b_values(sch_mat)
    gnorm = np.sqrt(np.sum(sch_mat[:, :3] ** 2, axis=1))
    gnorm[gnorm == 0] = np.inf
    dotz = np.abs(sch_mat[:, 2] / gnorm)
    d_par = np.linspace(1.0e-9, 2.4e-9, int(np.ceil(np.sqrt(num_atom))))
    d_perp = np.linspace(0.05e-9, 0.9e-9, int(np.ceil(np.sqrt(num_atom))))
    dp, dq = np.meshgrid(d_par, d_perp, indexing="ij")
    dp, dq = dp.ravel()[:num_atom], dq.ravel()[:num_atom]
    sig = np.exp(-b[:, None] * (dq[None, :]
                                + (dp - dq)[None, :] * dotz[:, None] ** 2))
    return sig, dp, dq


def make_fit_workload(num_atom=782, n_vox=64, seed=0,
                      n_shells=8, dirs_per_shell=64, n_b0=40,
                      device="cpu"):
    """The flagship 2-fascicle + CSF workload (dicsizes
    [num_atom, num_atom, 1] on a 552-sequence protocol by default):
    tables, plan, peaks and noiseless mixtures 400 * (nu1 D[:, i1] +
    nu2 D[:, i2] + nu3 csf), synthesized in float64 through the grouped
    rotation on ``device``."""
    rng = np.random.RandomState(seed)
    sch = make_dense_scheme(n_shells, dirs_per_shell, n_b0)
    sig, _dp, _dq = make_dictionary(sch, num_atom, seed)
    ms = mfi.init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)

    peaks = rng.randn(n_vox, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    TE = sch[:, 6]
    b = b_values(sch)
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)

    gt_ids = rng.randint(0, num_atom, size=(n_vox, 2))
    gt_nu = rng.rand(n_vox, 3) + 0.25
    gt_nu /= gt_nu.sum(axis=1, keepdims=True)
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    ys = torch.as_tensor(ms.ys, dtype=torch.float64, device=device)
    inv = np.argsort(perm)
    cols = np.zeros((n_vox, 2, sch.shape[0]))
    chunk = 128
    for st in range(0, n_vox, chunk):
        en = min(st + chunk, n_vox)
        D = rotate(ys, torch.as_tensor(peaks[st:en], device=device))
        ids = torch.as_tensor(gt_ids[st:en], device=device)
        g = torch.gather(D, 3, ids[:, :, None, None].expand(
            -1, -1, D.shape[2], 1))[..., 0]               # (b, 2, S) perm'd
        cols[st:en] = g.cpu().numpy()[:, :, inv]
    y = 400 * (gt_nu[:, 0, None] * cols[:, 0]
               + gt_nu[:, 1, None] * cols[:, 1]
               + gt_nu[:, 2, None] * sig_csf[None, :])
    return {"sch_mat": sch, "msinterp": ms, "plan": plan, "peaks": peaks,
            "y": y, "sig_csf": sig_csf, "gt_ids": gt_ids, "gt_nu": gt_nu,
            "dictionary": sig, "cols": cols}


def make_ear(wl, n_ear=10):
    """The EAR block of the UK-Biobank configuration (dicsizes
    [N, N, 1, n_ear]) for a ``make_fit_workload`` workload, as the JAX
    package's benchmark builds it: n_ear diffusivities linspace(0.8e-9,
    2.6e-9) at T2 = 0.8, and the signals with 35 times EAR atom 4 added.
    Returns (sig_ear (S, n_ear), y_ear (n_vox, S))."""
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, n_ear)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])
    y_ear = wl["y"] + 35 * sig_ear[:, 4][None, :]
    return sig_ear, y_ear


def make_mixed(wl, groups, sig_ear=None, ear_atom=4, ear_amp=35.0,
               seed=0):
    """Voxels of several buckets from a ``make_fit_workload`` workload.

    ``groups``: a sequence of (count, K, csf) or (count, K, csf, ear):
    that many voxels with K in {0, 1, 2} planted fascicles, with (csf) or
    without the CSF compartment, and with (ear) or without the EAR
    compartment (with it wherever ``sig_ear`` is given, when the group
    does not say); the groups are shuffled over the voxels (``seed``).
    Voxel v takes the workload's voxel v (directions, planted atoms,
    weights): its noiseless signal is 400 * (nu1 D[:, i1] [+ nu2 D[:, i2]]
    [+ nu3 csf]), plus ``ear_amp`` times EAR atom ``ear_atom`` of
    ``sig_ear`` (S, E) with EAR. Directions of absent fascicles are zero.
    Returns a dict: y (n, S), peaks (n, 6), numfasc (n,), csf_mask and
    ear_mask (n,) bool, gt_ids (n, 2) (-1 where absent), and buckets:
    {a group without its count: its voxel indices}.
    """
    counts = [g[0] for g in groups]
    n = int(sum(counts))
    if n > wl["y"].shape[0]:
        raise ValueError("%d voxels asked of a %d-voxel workload"
                         % (n, wl["y"].shape[0]))
    label = np.repeat(np.arange(len(groups)), counts)
    np.random.RandomState(seed).shuffle(label)
    K = np.array([g[1] for g in groups])[label]
    csf = np.array([bool(g[2]) for g in groups])[label]
    ear = np.array([bool(g[3]) if len(g) > 3 else sig_ear is not None
                    for g in groups])[label]
    nu = wl["gt_nu"][:n]
    cols = wl["cols"][:n]
    y = (nu[:, 0, None] * cols[:, 0] * (K >= 1)[:, None]
         + nu[:, 1, None] * cols[:, 1] * (K == 2)[:, None]
         + nu[:, 2, None] * wl["sig_csf"][None] * csf[:, None])
    y = 400 * y
    if sig_ear is not None:
        y = y + ear_amp * sig_ear[:, ear_atom][None, :] * ear[:, None]
    present = np.arange(2)[None, :] < K[:, None]              # (n, 2)
    peaks = wl["peaks"][:n] * present[:, :, None]
    gt_ids = np.where(present, wl["gt_ids"][:n], -1)
    buckets = {}
    for i, g in enumerate(groups):
        key = (int(g[1]),) + tuple(bool(x) for x in g[2:])
        buckets[key] = np.sort(np.concatenate(
            [buckets.get(key, np.zeros(0, np.int64)),
             np.flatnonzero(label == i)]))
    return {"y": y, "peaks": peaks.reshape(n, 6), "numfasc": K,
            "csf_mask": csf, "ear_mask": ear, "gt_ids": gt_ids,
            "buckets": dict(sorted(buckets.items()))}
