"""The port's three kernel modules vs the JAX package on the CPU.

Each kernel's plain PyTorch version (what a wrapper runs for CPU
tensors) is held against the JAX function with its Pallas kernel in
interpret mode, as the JAX suite runs it; the two-pass composition is
held against the JAX two-pass (XLA row pass) and one-pass scans. The
CUDA kernels themselves are held against these plain versions on the
card (``cuda``-marked tests below, and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan
from microstructure_fingerprinting_tpu.ops import f32scan as jf32scan
from microstructure_fingerprinting_tpu.ops import pallas_dfscan as jpdf
from microstructure_fingerprinting_tpu.ops import pallas_prep as jprep

from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import prep as tprep
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_problem(rng, B, S, N1, N2, corr=0.9, positive=True):
    """tests/test_f32scan.py's problem family."""
    A1 = rng.randn(B, S, N1)
    A2 = rng.randn(B, S, N2)
    if positive:
        A1, A2 = np.abs(A1) + 0.05, np.abs(A2) + 0.05
    if corr > 0:
        base = (np.abs(rng.randn(B, S, 1)) if positive
                else rng.randn(B, S, 1))
        A1 = corr * base + (1 - corr) * A1
        A2 = corr * base + (1 - corr) * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = rng.randn(B, S)
    if positive:
        y = np.abs(y)
    f = np.float32
    return f(A1), f(A2), f(a3), f(y)


# ---------------------------------------------------------------------------
# kernel 1: prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,tile,planes", [(200, 128, "xr"),
                                           (700, 512, "ra")])
def test_prep_matches_jax(rng, N, tile, planes):
    """prep twin vs JAX prep_block(interpret=True), N padded to the tile.

    Tolerances: the port's levels and r plane split its normalized
    columns exactly. The port accumulates ||x||^2 in float64 and the JAX
    package in float32, so the norms differ by 1 ulp in part of the
    columns; a 1-ulp shift of x moves the finest level in ~1/8 of those
    entries, hence q123 agreement >= 99% (not bitwise) and decoded
    quantized parts within two 2^-15 steps; bf16 x planes equal; gram rows
    0-2 to atol 4 eps."""
    B, S = 2, 36
    A = np.float32(np.abs(rng.randn(B, S, N)) + 0.05)
    y = np.float32(np.abs(rng.randn(B, S)))
    c = np.float32(np.abs(rng.randn(B, S)) + 0.05)
    yh = y / np.linalg.norm(y, axis=1, keepdims=True)
    ch = c / np.linalg.norm(c, axis=1, keepdims=True)

    rq, rr, ra, _ = jprep.pack_rhs([jnp.asarray(yh), jnp.asarray(ch)])
    Ap, Np = jprep.pad_block(jnp.asarray(A), tile)
    oj = jprep.prep_block(Ap, rq, rr, ra, tile, interpret=True,
                          planes=planes)
    rqt, rrt, rat, _ = tprep.pack_rhs([_t(yh), _t(ch)])
    assert np.array_equal(np.asarray(rq), rqt.numpy())
    assert np.array_equal(np.asarray(rr, np.float32), rrt.float().numpy())
    Apt, Npt = tprep.pad_block(_t(A), tile)
    assert Npt == Np
    ot = tprep.prep_block(Apt, rqt, rrt, rat, tile, planes=planes, n_rhs=2)

    qj, qt = np.asarray(oj[0]), ot[0].numpy()
    assert qj.shape == qt.shape == (B, Np // tile, S, 3 * tile)

    def levels(q):   # (B, nt, S, 3T) -> (3, B, S, Np) float64
        nt, T = q.shape[1], q.shape[3] // 3
        return np.stack([q[..., l * T:(l + 1) * T].transpose(0, 2, 1, 3)
                         .reshape(B, S, nt * T) for l in range(3)]
                        ).astype(np.float64)

    # the port's levels split its own normalized columns exactly
    X = np.asarray(Ap, np.float32)
    n_t = np.sqrt(np.float32((X.astype(np.float64) ** 2).sum(
        1, keepdims=True)))
    xh_t = X * np.where(n_t > 0, np.float32(1) / np.where(n_t > 0, n_t, 1),
                        0).astype(np.float32)
    scales = np.array([2.0 ** -7, 2.0 ** -15, 2.0 ** -23])[:, None, None,
                                                            None]
    lj, lt = levels(qj), levels(qt)
    a = np.sum(lt * scales, axis=0)                       # exact in f64
    assert np.array_equal(np.float32(a), a)               # a is f32-exact
    R = np.float32(xh_t - np.float32(a))
    assert np.array_equal(a + R.astype(np.float64), xh_t)
    r_plane = torch.from_numpy(R).to(torch.bfloat16).float().numpy()
    r_plane = r_plane.reshape(B, S, -1, tile).transpose(0, 2, 1, 3)
    assert np.array_equal(ot[2].float().numpy(), r_plane)
    # a 1-ulp norm difference moves x by 1 ulp, which moves the finest
    # level (rarely the middle one, then the finest one the other way):
    # the decoded quantized parts stay within two middle-level steps
    # (the finest level clips at +-127 when the middle one moves)
    a_j = np.sum(lj * scales, axis=0)
    assert np.max(np.abs(a_j - a)) <= 2.0 ** -14
    assert (qj == qt).mean() >= 0.99
    if "x" in planes:
        assert np.array_equal(np.asarray(oj[1], np.float32),
                              ot[1].float().numpy())
    gj, gt = np.asarray(oj[4]), ot[4].numpy()
    np.testing.assert_allclose(gt[:, :3], gj[:, :3], rtol=0, atol=4 * EPS32)
    assert np.array_equal(gt[:, 3:], gj[:, 3:])           # zero rhs rows


# ---------------------------------------------------------------------------
# kernel 2: the f32 interval row pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N2", [96, 700])
def test_rowmin3_matches_jax(rng, N2):
    """rowmin_3 (prep + row-pass twin) vs JAX rowmin_3(pallas=True,
    interpret=True, colmin=True); N2 = 700 runs two column blocks.
    Tolerance of tests/test_f32scan.py: finite pattern >= 99%, atol 1e-5
    on lo/up/upf/lo_col."""
    args = _rand_problem(rng, B=2, S=36, N1=160, N2=N2)
    rj = jf32scan.rowmin_3(*[jnp.asarray(x) for x in args], pallas=True,
                           interpret=True, colmin=True)
    rt = tf32scan.rowmin_3(*[_t(x) for x in args], colmin=True)
    for x0, x1 in zip(rj, rt):
        x0, x1 = np.asarray(x0), x1.numpy()
        assert x0.shape == x1.shape
        pat = np.isfinite(x0) == np.isfinite(x1)
        assert pat.mean() >= 0.99, "support pattern diverged"
        m = pat & np.isfinite(x0)
        np.testing.assert_allclose(x1[m], x0[m], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 3: the double-float re-scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,N1,N2", [(3, 40, 70, 60), (2, 24, 140, 600)])
def test_rescan_matches_jax(rng, B, S, N1, N2):
    """row_scan_df3 twin vs JAX row_scan_df3(interpret=True) (the shapes
    of tests/test_dfscan.py): same segment layout, top-1 (i1, i2) equal,
    values to rtol 1e-5 atol 1e-7."""
    A1 = np.float32(rng.randn(B, S, N1))
    A2 = np.float32(rng.randn(B, S, N2))
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(rng.randn(B, S))
    rr, ri, ysq = jpdf.row_scan_df3(*[jnp.asarray(x) for x in
                                      (A1, A2, a3, y)], interpret=True)
    cj, vj = jpdf.candidates_from_rows(rr, ri, 1,
                                       segments=jpdf.n_segments(N2))
    assert trescan.n_segments(N2) == jpdf.n_segments(N2)
    rrt, rit, ysqt = trescan.row_scan_df3(*[_t(x) for x in (A1, A2, a3, y)])
    assert rrt.shape == tuple(rr.shape)
    ct, vt = trescan.candidates_from_rows(
        rrt, rit, segments=trescan.n_segments(N2))
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ysqt.numpy(), np.asarray(ysq), rtol=1e-6)


# ---------------------------------------------------------------------------
# the two-pass composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N2,R,corr,positive", [
    (60, 64, 0.0, False), (60, 64, 0.95, True), (140, 64, 0.9, True)])
def test_df3_twopass_matches_jax(rng, N2, R, corr, positive):
    """Port two-pass (kernel-path row pass, df re-scan) vs JAX
    df3_twopass(fused=False) and the JAX one-pass df3_candidates:
    cand index-exact and ok equal on in-budget voxels, values rtol 1e-5.
    N2 = 140 > R prunes columns."""
    A1, A2, a3, y = _rand_problem(rng, B=4, S=40, N1=150, N2=N2, corr=corr,
                                  positive=positive)
    ja = [jnp.asarray(x) for x in (A1, A2, a3, y)]
    cj, vj, _ysq, okj = jf32scan.df3_twopass(*ja, M=1, R=R, fused=False)
    c1, v1, _ = jdfscan.df3_candidates(*ja, M=1)
    ct, vt, _ysqt, okt = tf32scan.df3_twopass(*[_t(x) for x in
                                                (A1, A2, a3, y)], R=R)
    okj, okt = np.asarray(okj), okt.numpy()
    assert np.array_equal(okj, okt)
    assert okt.any()
    ct, vt = ct.numpy(), vt.numpy()
    assert np.array_equal(ct[okt], np.asarray(cj)[okt])
    assert np.array_equal(ct[okt], np.asarray(c1)[okt])
    np.testing.assert_allclose(vt[okt], np.asarray(vj)[okt], rtol=1e-5)
    np.testing.assert_allclose(vt[okt], np.asarray(v1)[okt], rtol=1e-5)


def test_finalize_matches_jax(rng):
    """df_nnls_cols (the double-float finalize) vs the JAX function on
    float32 columns: the same supports (zero pattern), weights to rtol
    1e-5, residuals to 1e-9 ||y||^2. Voxel 2's exact solution has a third
    weight of -1e-6: its Cramer numerator sits between the float64-eps
    tolerance of the 3-variable case logic and a float32-eps one, so the
    full support must be rejected."""
    B, S = 6, 40
    cols = np.float32(np.abs(rng.randn(B, S, 3)) + 0.05)
    w0 = np.float32(rng.rand(B, 3))
    w0[1, 0] = 0.0
    y = np.float32(np.einsum("bsc,bc->bs", cols, w0)
                   + 0.01 * rng.randn(B, S))
    y[2] = np.float32(cols[2].astype(np.float64)
                      @ np.array([1.0, 0.5, -1e-6]))
    wj, rj = jdfscan.df_nnls_cols(jnp.asarray(cols), jnp.asarray(y))
    wt, rt = tdfscan.df_nnls_cols(_t(cols), _t(y))
    wj, wt = np.asarray(wj), wt.numpy()
    assert np.array_equal(wt == 0, wj == 0) and np.all(wt >= 0)
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-6)
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-9 * ysq.max())


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on a card only)
# ---------------------------------------------------------------------------

def _one_ulp_up(x):
    x = x.clone()
    x[7] = torch.nextafter(x[7], torch.tensor(np.inf, dtype=x.dtype))
    return x


def _minus_radius(x):
    return x - np.float32(8 * EPS32)


def _one_inf(x):
    x = x.clone()
    x[3] = np.inf
    return x


@pytest.mark.parametrize("change,exact,ok", [
    (lambda x: x.clone(), False, True),
    (_one_ulp_up, False, True),          # a summation-order neighbour
    (_one_ulp_up, True, False),
    (_minus_radius, False, False),       # a kernel that drops the radius
    (lambda x: x.half().float(), False, False),   # a lost low-order term
    (_one_inf, False, False),            # a guard that flipped
    (lambda x: x[:-1], False, False),
])
def test_kernel_agreement_rule(rng, change, exact, ok):
    """The rule that holds a CUDA kernel against its plain version
    (on the card) accepts rare ulp neighbours and fails a kernel that
    drops or mis-sums a term, flips a guard or mis-shapes its output."""
    p = _t(np.float32(rng.rand(200_000)))
    assert ttesting.kernel_agreement(change(p), p, exact)[0] is ok
    i = _t(rng.randint(0, 700, size=1000).astype(np.int32))
    j = i.clone()
    j[5] += 1
    assert ttesting.kernel_agreement(i.clone(), i, exact=True)[0]
    assert not ttesting.kernel_agreement(j, i, exact=True)[0]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(rng):
    """Each kernel against its plain version on the card, small shapes,
    by ``testing.kernel_agreement``: all but a 1e-5 share of the entries
    bit for bit, inf/NaN at the same entries, finite values to 2 float32
    ulp of max|value|; the re-scan's first-minimum i2 and top-1 equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from microstructure_fingerprinting_torch.ops import nnls as mfn
    agree = ttesting.kernel_agreement
    A1, A2, a3, y = (_t(x).cuda() for x in
                     _rand_problem(rng, B=2, S=36, N1=160, N2=700))
    yh, _, _ = mfn._normalize_y(y)
    a3h, _ = mfn._normalize_block(a3)
    rq, rr, ra, _ = tprep.pack_rhs([yh, a3h[:, :, 0]])
    Ap, _ = tprep.pad_block(A1, 128)
    k = tprep.prep_block(Ap.contiguous(), rq, rr, ra, 128, "xr", n_rhs=2)
    p = tprep.prep_block_twin(Ap, rq, rr, ra, 128, "xr", n_rhs=2)
    for x1, x0 in zip(k, p):
        if x0 is not None:
            assert agree(x1, x0)[0], agree(x1, x0)
    ops, _ = tf32scan.rowmin_3_operands(A1, A2, a3, y)
    for x0, x1 in zip(tf32scan.rowmin3_twin(*ops, n1=160, n2=700),
                      tf32scan.rowmin3_rows(*ops, n1=160, n2=700)):
        assert agree(x1, x0)[0], agree(x1, x0)
    ops, segw, _ = trescan.row_scan_df3_operands(A1, A2, a3, y)
    rk, ik = trescan.rescan3_rows(*ops, n2=700, segw=segw)
    rp, ip = trescan.rescan3_twin(*ops, n2=700, segw=segw)
    assert agree(rk, rp)[0], agree(rk, rp)
    assert agree(ik, ip, exact=True)[0], agree(ik, ip, exact=True)
    seg = trescan.n_segments(700)
    ck, _ = trescan.candidates_from_rows(rk.reshape(2, -1),
                                         ik.reshape(2, -1), segments=seg)
    cp, _ = trescan.candidates_from_rows(rp.reshape(2, -1),
                                         ip.reshape(2, -1), segments=seg)
    assert torch.equal(ck, cp)
