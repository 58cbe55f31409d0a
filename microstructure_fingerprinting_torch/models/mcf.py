"""Multiple Correlation Function (MCF) analytic DW-MRI simulators.

PyTorch counterpart of ``microstructure_fingerprinting_tpu/models/mcf.py``:
intracellular PGSE / double-diffusion-encoding (DDE) signal attenuation
in simple geometries by the matrix formalism of Grebenkov (Conc. Magn.
Reson. A 32:277-301, 2008).

The Laplace eigenbases (eigenvalues ``L`` and the gradient-perturbation
matrix ``B`` in that basis: Neumann modes of the disk, the ball and the
unit interval) are generated on the host by the JAX package's NumPy /
SciPy code, copied here as it is, so they equal its output bit for bit;
so do ``_check_truncation``, ``_perp_par_components`` and
``import_DDE_scheme``. The per-sequence matrix exponentials run as one
batched ``torch.linalg.matrix_exp`` on an (n, M, M) complex tensor
(complex128 for float64 inputs, complex64 for float32) on the card
unless the caller asks for the CPU: the JAX package pins them to its CPU
backend only because its TPU runtime has no complex expm.

Only the 'cylinder' domain has a signal formula (as in the reference,
sphere and planes raise NotImplementedError after the accuracy check);
all three domains expose their eigenbasis.
"""

import numpy as np
from scipy.special import jnp_zeros, spherical_jn, jv
from scipy.optimize import brentq
from scipy.integrate import fixed_quad
import torch

from .. import config
from ..utils.scheme import (import_PGSE_scheme, load_scheme_text,
                            get_gyromagnetic_ratio)

#: the reference's truncation (mcf.py:326), ``MCFConfig.max_modes``
_MAX_MODES = config.DEFAULTS["mcf"].max_modes
_BASIS_CACHE = {}


# ---------------------------------------------------------------------------
# Eigenbasis generation (host, cached)
# ---------------------------------------------------------------------------

def _disk_basis(M):
    """Neumann Laplace eigenbasis of the unit disk, cosine sector.

    Modes u_nk = c_nk J_n(a_nk r) cos(n phi) with J_n'(a_nk) = 0, sorted by
    eigenvalue a^2; only the cos sector couples to the x = r cos(phi)
    perturbation. Returns (lam (M,), B (M, M)).
    """
    n_max, k_max = 40, 30
    modes = [(0, 0.0)]  # ground (constant) mode
    for n in range(0, n_max + 1):
        for a in jnp_zeros(n, k_max):
            modes.append((n, float(a)))
    modes.sort(key=lambda m: m[1] ** 2)
    modes = modes[:M]
    lam = np.array([a * a for (_n, a) in modes])

    # normalization over the disk: c^2 * I_n(a) * (2pi if n==0 else pi) = 1
    def radial_sq(n, a):
        if a == 0.0:
            return 0.5
        val, _ = fixed_quad(lambda r: r * jv(n, a * r) ** 2, 0.0, 1.0, n=200)
        return val

    c = np.array([
        1.0 / np.sqrt(radial_sq(n, a) * (2 * np.pi if n == 0 else np.pi))
        for (n, a) in modes])

    # B_ij = <u_i | r cos(phi) | u_j>, angular part couples |n_i - n_j| = 1
    B = np.zeros((M, M))
    for i, (ni, ai) in enumerate(modes):
        for j_ in range(i, M):
            nj, aj = modes[j_]
            if abs(ni - nj) != 1:
                continue
            ang = np.pi if min(ni, nj) == 0 else np.pi / 2
            rad, _ = fixed_quad(
                lambda r: r * r * jv(ni, ai * r) * jv(nj, aj * r),
                0.0, 1.0, n=200)
            B[i, j_] = B[j_, i] = c[i] * c[j_] * ang * rad
    return lam, B


def _sphere_jnp_roots(n, k_max, x_max=120.0):
    """First positive roots of d/dx j_n(x) = 0."""
    xs = np.linspace(1e-3, x_max, 24000)
    d = spherical_jn(n, xs, derivative=True)
    sign = np.sign(d)
    idx = np.where(sign[:-1] * sign[1:] < 0)[0]
    roots = []
    for i in idx[:k_max]:
        r = brentq(lambda x: spherical_jn(n, x, derivative=True),
                   xs[i], xs[i + 1])
        if r > 1e-6:
            roots.append(r)
    return roots


def _sphere_basis(M):
    """Neumann Laplace eigenbasis of the unit ball, m = 0 sector.

    Modes u_nk = c_nk j_n(a_nk r) P_n(cos th) with j_n'(a_nk) = 0; the
    z = r cos(th) perturbation couples n' = n +- 1.
    """
    from numpy.polynomial.legendre import leggauss
    n_max, k_max = 30, 20
    modes = [(0, 0.0)]
    for n in range(0, n_max + 1):
        for a in _sphere_jnp_roots(n, k_max):
            modes.append((n, float(a)))
    modes.sort(key=lambda m: m[1] ** 2)
    modes = modes[:M]
    lam = np.array([a * a for (_n, a) in modes])

    def radial_sq(n, a):
        if a == 0.0:
            return 1.0 / 3.0
        val, _ = fixed_quad(
            lambda r: r * r * spherical_jn(n, a * r) ** 2, 0.0, 1.0, n=200)
        return val

    # angular: 2*pi * int P_n^2 dmu = 4*pi/(2n+1)
    c = np.array([1.0 / np.sqrt(radial_sq(n, a) * 4 * np.pi / (2 * n + 1))
                  for (n, a) in modes])

    # <P_n mu P_n'> couples n' = n +- 1:
    # int_{-1}^{1} P_n mu P_{n+1} dmu = 2(n+1) / ((2n+1)(2n+3))
    B = np.zeros((M, M))
    for i, (ni, ai) in enumerate(modes):
        for j_ in range(i, M):
            nj, aj = modes[j_]
            if abs(ni - nj) != 1:
                continue
            nlo = min(ni, nj)
            ang = 2 * np.pi * 2.0 * (nlo + 1) / ((2 * nlo + 1) * (2 * nlo + 3))
            rad, _ = fixed_quad(
                lambda r: r ** 3 * spherical_jn(ni, ai * r)
                * spherical_jn(nj, aj * r), 0.0, 1.0, n=200)
            B[i, j_] = B[j_, i] = c[i] * c[j_] * ang * rad
    return lam, B


def _interval_basis(M):
    """Neumann Laplace eigenbasis of [0, 1] (parallel planes), closed form.

    u_0 = 1, u_k = sqrt(2) cos(k pi x); lam_k = (k pi)^2; B = <u_j x u_k>.
    """
    lam = (np.arange(M) * np.pi) ** 2
    B = np.zeros((M, M))
    for j_ in range(M):
        for k in range(j_, M):
            if j_ == k:
                B[j_, k] = 0.5
            elif j_ == 0:
                B[j_, k] = B[k, j_] = (np.sqrt(2)
                                       * ((-1) ** k - 1) / (k * np.pi) ** 2)
            elif (j_ + k) % 2 == 1:
                v = (1.0 / ((j_ - k) * np.pi) ** 2
                     + 1.0 / ((j_ + k) * np.pi) ** 2)
                B[j_, k] = B[k, j_] = -2.0 * v
    return lam, B


_DOMAINS = {
    "c": ("cylinder", _disk_basis), "cylinder": ("cylinder", _disk_basis),
    "s": ("sphere", _sphere_basis), "sphere": ("sphere", _sphere_basis),
    "p": ("interval", _interval_basis),
    "planes": ("interval", _interval_basis),
}


def mcf_basis(domain, M=_MAX_MODES):
    """(eigenvalues (M,), B matrix (M, M)) for 'cylinder'/'sphere'/'planes'.

    Generated once per (domain, M) and cached.
    """
    if domain not in _DOMAINS:
        raise ValueError('Unknown domain %s.' % (domain,))
    domtype, builder = _DOMAINS[domain]
    M = int(np.min([M, _MAX_MODES]))
    key = (domtype, M)
    if key not in _BASIS_CACHE:
        _BASIS_CACHE[key] = builder(M)
    return _BASIS_CACHE[key]


def _check_truncation(M, Lamvec, gamma, L, diff, Gall, Tall):
    """Truncation-accuracy guard (reference mcf.py:358-386): the damping
    factor p*lam_M must exceed the oscillating component q."""
    p = diff * Tall / L ** 2
    q = gamma * Tall * L * Gall
    q_over_p = (gamma * L) * (L ** 2 / diff) * Gall
    idx_bad = np.where(q_over_p >= Lamvec[-1])[0]
    if idx_bad.size > 0:
        badlist = " ".join("%d" % (idx,) for idx in idx_bad)
        bad1 = idx_bad[0]
        raise ValueError(
            'Number of eigenvalues and eigenfunctions M=%d too small'
            ' to ensure accuracy of final DW-MRI signal for the'
            ' physical parameters provided in the following %d '
            'sequence(s):\n%s\n'
            'In seq. %d for instance, detected lambda_M=%g <'
            ' q/p=%g, with p=D*T/L^2=%g and q=gam*T*L*G=%g.'
            'This code is only reliable for a smaller L, a smaller G '
            'or a higher diff. Otherwise you may want to try to '
            'approximate the DW-MRI signal with a formula based '
            'on the Gaussian phase distribution (GPD) for instance.' %
            (M, idx_bad.size, badlist, bad1, Lamvec[-1],
             q_over_p[bad1], p[bad1], q[bad1]))


# ---------------------------------------------------------------------------
# Batched matrix exponentials on the device
# ---------------------------------------------------------------------------

def _perp_par_components(gdir, G, envdir):
    gpar = (gdir @ envdir)[:, None] * envdir[None, :]
    gperp = gdir - gpar
    Gpar = G * np.sqrt(np.sum(gpar ** 2, axis=1))
    Gperp = G * np.sqrt(np.sum(gperp ** 2, axis=1))
    return Gperp, Gpar


def _mcf_encode_block(Lam, B, p_over_T, q_over_T, dur, sep):
    """E-matrix of one PGSE encoding block, batched over sequences.

    block = expm(-(p*Lam - i q*B) dur/T) @ diag(exp(-Lam*p*sep/T))
            @ expm(-(p*Lam + i q*B) dur/T)
    expressed directly with per-second rates: p/T = D/L^2, q/T = gam*L*G.
    Tensors on one device: p_over_T, q_over_T, dur, sep (n,); Lam (M,),
    B (M, M). Returns (n, M, M) complex.
    """
    cdtype = (torch.complex128 if Lam.dtype == torch.float64
              else torch.complex64)
    A = ((p_over_T[:, None, None] * torch.diag(Lam)).to(cdtype)
         - 1j * (q_over_T[:, None, None] * B).to(cdtype))
    du = dur[:, None, None]
    Eplus = torch.linalg.matrix_exp(-A * du)
    Eminus = torch.linalg.matrix_exp(-A.conj() * du)
    mid = torch.exp(-Lam[None, :] * p_over_T[:, None]
                    * sep[:, None]).to(cdtype)
    return Eplus @ (mid[:, :, None] * Eminus)


def _putter(device):
    dev = config.resolve_device(device)
    return lambda a: torch.as_tensor(np.asarray(a), device=dev)


def MCF_PGSE(domain, L, diff, *,
             scheme=None, envdir=np.array([0, 0, 1]),
             G=None, Delta=None, delta=None,
             L2=None,
             gamma=get_gyromagnetic_ratio('hydrogen'), M=_MAX_MODES,
             device="cuda"):
    """Intracellular PGSE signal attenuation via the MCF formalism.

    Args mirror the reference (mcf.py:237-276): ``domain`` in
    {'c'/'cylinder', 's'/'sphere', 'p'/'planes'}, pore size ``L`` [m],
    diffusivity ``diff`` [m^2/s], and either a scheme (file/array) or
    G/Delta/delta arrays. ``device`` runs the matrix exponentials
    (``"cuda"`` by default; raises when CUDA is absent). Returns E
    (n_seq,), the normalized attenuation, as NumPy. Only the cylinder
    signal model is implemented (sphere/planes raise NotImplementedError
    after the accuracy check, as in the reference).
    """
    if scheme is not None:
        sch_mat = import_PGSE_scheme(scheme)
        n_seq = sch_mat.shape[0]
        gdirall = sch_mat[:, :3]
        Gall = sch_mat[:, 3]
        Delall = sch_mat[:, 4]
        delall = sch_mat[:, 5]
    else:
        if (G is None) and (Delta is None) and (delta is None):
            raise ValueError('Either provide a scheme matrix or specify'
                             ' G, Delta and delta.')
        if (G is None) or (Delta is None) or (delta is None):
            raise ValueError('Without a scheme matrix provided (non-scheme'
                             ' mode), G, Delta and delta are all required.')
        Gall = np.atleast_1d(np.asarray(G, dtype=np.float64))
        Delall = np.atleast_1d(np.asarray(Delta, dtype=np.float64))
        delall = np.atleast_1d(np.asarray(delta, dtype=np.float64))
        if not (Gall.size == Delall.size == delall.size):
            raise ValueError('G, Delta and delta should contain the same'
                             ' number of elements. Detected %d, %d and '
                             '%d, respectively.' %
                             (Gall.size, Delall.size, delall.size))
        n_seq = Gall.size
        # default: environment along z, gradient along x
        gdirall = np.tile(np.array([1.0, 0, 0]), (n_seq, 1))
    Tall = Delall + delall
    n_bad_del = int(np.sum(Delall < delall))
    if n_bad_del > 0:
        raise ValueError('Detected %d sequence(s) with big Delta smaller'
                         ' than small delta. In a PGSE sequence, '
                         'Delta>=delta should always be enforced.'
                         % (n_bad_del,))
    dir_norm = np.sqrt(np.sum(np.asarray(envdir, dtype=np.float64) ** 2))
    if dir_norm == 0:
        raise ValueError('Direction (orientation) of environment cannot'
                         ' be a zero vector.')
    envdir = np.asarray(envdir, dtype=np.float64) / dir_norm

    gdirnorm = np.sqrt(np.sum(gdirall ** 2, axis=1))
    bad = (Gall > 0) & (np.abs(1 - gdirnorm) > 1e-4)
    if np.any(bad):
        i = int(np.where(bad)[0][0])
        raise ValueError('Sequence %d: gradient direction not normalized'
                         ' (found %g)' % (i, gdirnorm[i]))

    domtype = _DOMAINS.get(domain, (None,))[0]
    Lamvec, B = mcf_basis(domain, M)
    M = Lamvec.size
    _check_truncation(M, Lamvec, gamma, L, diff, Gall, Tall)
    if domtype != 'cylinder':
        raise NotImplementedError()

    Gperp, Gpar = _perp_par_components(gdirall, Gall, envdir)
    p_over_T = np.full(n_seq, diff / L ** 2)
    q_over_T = gamma * L * Gperp
    put = _putter(device)
    blocks = _mcf_encode_block(put(Lamvec), put(B), put(p_over_T),
                               put(q_over_T), put(delall),
                               put(Delall - delall))
    Eperp = np.abs(blocks[:, 0, 0].cpu().numpy())
    bpar = (gamma * delall * Gpar) ** 2 * (Delall - delall / 3)
    E = Eperp * np.exp(-bpar * diff)
    return np.where(Gall == 0, 1.0, E)


def import_DDE_scheme(schemefile):
    """Import a double-diffusion-encoding scheme (14 columns per row):
    [g1(3), G1, Del1, del1, tau_mix, g2(3), G2, Del2, del2, TE].
    Validation mirrors reference mcf.py:24-81.
    """
    if isinstance(schemefile, str):
        sch_mat = load_scheme_text(schemefile)
    elif isinstance(schemefile, np.ndarray):
        sch_mat = schemefile
    else:
        raise TypeError("Unable to import a DDE scheme matrix from input")
    if sch_mat.ndim == 1:
        sch_mat = sch_mat[np.newaxis, :]
    if sch_mat.shape[1] != 14:
        raise RuntimeError("Detected %s instead of expected 14 columns in"
                           " PGSE scheme matrix." % sch_mat.shape[1])
    for (st, blk) in ((0, "first"), (7, "second")):
        gn = np.sqrt(np.sum(sch_mat[:, st:st + 3] ** 2, axis=1))
        nbad = int(np.sum(np.abs(1 - gn[gn > 0]) > 1e-4))
        if nbad > 0:
            raise ValueError("Detected %d non-zero gradients in the %s "
                             "encoding module which did not have"
                             " unit norm. Please normalize." % (nbad, blk))
    Del1, del1 = sch_mat[:, 4], sch_mat[:, 5]
    Del2, del2 = sch_mat[:, 11], sch_mat[:, 12]
    tau_mix, TE = sch_mat[:, 6], sch_mat[:, 13]
    T = Del1 + del1 + tau_mix + Del2 + del2
    if np.sum(Del1 < del1) > 0:
        raise ValueError("Detected %d sequences in first encoding module"
                         " where gradient separation Delta was less than"
                         " gradient duration delta." % np.sum(Del1 < del1))
    if np.sum(Del2 < del2) > 0:
        raise ValueError("Detected %d sequences in second encoding module"
                         " where gradient separation Delta was less than"
                         " gradient duration delta." % np.sum(Del2 < del2))
    if np.sum(T > TE) > 0:
        raise ValueError("Detected %d sequences in which the total "
                         "diffusion time (Delta1+delta1+tau_mix+Delta2"
                         "+delta2) exceeded the echo time TE."
                         % np.sum(T > TE))
    return sch_mat


def MCF_DDE(domain, L, diff, scheme,
            envdir=np.array([0, 0, 1]),
            gamma=get_gyromagnetic_ratio('hydrogen'),
            M=_MAX_MODES, device="cuda"):
    """Double-diffusion-encoding signal via MCF (reference mcf.py:84-234).

    Two PGSE encoding blocks separated by a mixing-time free-diffusion
    interval: R = E2 @ diag(exp(-Lam p tau)) @ E1, E = |R[0,0]| * E_par.
    ``device`` runs the matrix exponentials (``"cuda"`` by default).
    Returns E (n_seq,) as NumPy.
    """
    sch_mat = import_DDE_scheme(scheme)
    n_seq = sch_mat.shape[0]
    gdir1, Gall1 = sch_mat[:, :3], sch_mat[:, 3]
    Del1, del1 = sch_mat[:, 4], sch_mat[:, 5]
    tau = sch_mat[:, 6]
    gdir2, Gall2 = sch_mat[:, 7:10], sch_mat[:, 10]
    Del2, del2 = sch_mat[:, 11], sch_mat[:, 12]
    Tall = Del1 + del1 + tau + Del2 + del2

    dir_norm = np.sqrt(np.sum(np.asarray(envdir, dtype=np.float64) ** 2))
    if dir_norm == 0:
        raise ValueError('Direction (orientation) of environment cannot'
                         ' be a zero vector.')
    envdir = np.asarray(envdir, dtype=np.float64) / dir_norm

    domtype = _DOMAINS.get(domain, (None,))[0]
    Lamvec, B = mcf_basis(domain, M)
    M = Lamvec.size
    Gmax = np.maximum(Gall1, Gall2)
    _check_truncation(M, Lamvec, gamma, L, diff, Gmax, Tall)
    if domtype != 'cylinder':
        raise NotImplementedError()

    Gperp1, Gpar1 = _perp_par_components(gdir1, Gall1, envdir)
    Gperp2, Gpar2 = _perp_par_components(gdir2, Gall2, envdir)
    p_over_T = np.full(n_seq, diff / L ** 2)
    put = _putter(device)
    Lam_d = put(Lamvec)
    B_d = put(B)
    R1 = _mcf_encode_block(Lam_d, B_d, put(p_over_T),
                           put(gamma * L * Gperp1),
                           put(del1), put(Del1 - del1))
    R2 = _mcf_encode_block(Lam_d, B_d, put(p_over_T),
                           put(gamma * L * Gperp2),
                           put(del2), put(Del2 - del2))
    mix = np.exp(-Lamvec[None, :] * (diff / L ** 2) * tau[:, None])
    R = torch.einsum('nij,nj,njk->nik', R2, put(mix).to(R2.dtype), R1)
    Eperp = np.abs(R[:, 0, 0].cpu().numpy())
    bpar = ((gamma * del1 * Gpar1) ** 2 * (Del1 - del1 / 3)
            + (gamma * del2 * Gpar2) ** 2 * (Del2 - del2 / 3))
    E = Eperp * np.exp(-bpar * diff)
    return np.where((Gall1 == 0) & (Gall2 == 0), 1.0, E)
