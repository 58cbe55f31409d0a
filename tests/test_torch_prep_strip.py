"""Kernel 1's strip design (``csrc/prep.cu``), as far as the CPU sees it.

The CUDA kernel gives a column to many threads, each summing a slice of
the samples, and joins the partial sums; it stages a strip of W columns
in shared memory, W picked from the sample count. Here: the plain version
does not depend on how S is sliced at the resolution of the rule that
holds the kernel to it, the strip widths divide every tile the callers
use, and the wrapper's copy of the launcher's width rule is the
source's."""

import os
import re

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import prep as tprep
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
CU = os.path.join(os.path.dirname(mft.__file__), "csrc", "prep.cu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sliced_sum(rng, n_slices):
    """sum over the sample axis (dim 1) of a float64 tensor as the kernel
    takes it: a partial sum per slice s = k, k + n, ..., the partials
    joined in a shuffled order."""
    def ssum(x):
        parts = [x[:, k::n_slices].sum(dim=1) for k in range(n_slices)]
        acc = torch.zeros_like(parts[0])
        for k in rng.permutation(n_slices):
            acc = acc + parts[k]
        return acc
    return ssum


@pytest.mark.parametrize("n_slices", [2, 8, 23])
def test_gram_does_not_depend_on_how_samples_are_sliced(rng, monkeypatch,
                                                        n_slices):
    """The squared norm, cdiag, c1 and c2 as float64 partial sums over
    2, 8 and 23 slices of S joined in shuffled order: the plain version's
    gram (and its packs, which hang on the norm) by
    ``testing.kernel_agreement``."""
    B, S, Np, n_rhs = 2, 46, 128, 5
    A = _t(np.float32(np.abs(rng.randn(B, S, Np)) + 0.05))
    cols = np.float32(np.abs(rng.randn(n_rhs, B, S)) + 0.05)
    cols /= np.linalg.norm(cols, axis=2, keepdims=True)
    rq, rr, ra, _ = tprep.pack_rhs([_t(c) for c in cols])
    plain = tprep.prep_block_twin(A, rq, rr, ra, 128, "xra", n_rhs=n_rhs)
    ssum = _sliced_sum(rng, n_slices)

    def sumsq(x, dim):
        assert dim == 1
        return ssum(x.double() * x.double()).float()

    def fdot(contract, x, y):
        assert contract == "bsj,bsn->bjn"
        return ssum(x.double()[:, :, :, None]
                    * y.double()[:, :, None, :]).float()

    # cdiag, the one sum the plain version takes inline
    Xh = A * (1.0 / torch.sqrt(tprep.sumsq_f32(A, 1)))[:, None, :]
    _q1, _q2, _q3, R, a = tdfscan.quantize3(Xh)
    terms = ((2.0 * a + R) * R).double()
    ok, n_diff, _n, err, tol = ttesting.kernel_agreement(
        ssum(terms).float(), terms.sum(dim=1).float())
    assert ok, (n_diff, err, tol)

    monkeypatch.setattr(tprep, "sumsq_f32", sumsq)
    monkeypatch.setattr(tdfscan, "fdot", fdot)
    sliced = tprep.prep_block_twin(A, rq, rr, ra, 128, "xra", n_rhs=n_rhs)
    for k, p in zip(sliced, plain):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(k, p)
        assert ok, (n_diff, err, tol)
    assert float(plain[4][:, :1 + n_rhs].abs().min()) > 0


def _source():
    with open(CU) as f:
        text = f.read()
    # the launcher tries the instantiated widths in the order written
    widths = tuple(int(w) for w in re.findall(r"return launch<(\d+)>\(",
                                              text))
    assert widths == tuple(int(w) for w in re.findall(r"if \(fits\((\d+)\)\)",
                                                      text))
    limit = eval(re.search(r"kSmemLimit = ([\d *]+);", text).group(1))
    threads = int(re.search(r"kThreads = (\d+)", text).group(1))
    rhs_tile = int(re.search(r"kRhsTile = (\d+)", text).group(1))
    return text, widths, limit, threads, rhs_tile


def test_strip_widths_divide_every_tile():
    """W divides the row tile and every column block ``col_blocks`` gives
    (the tiles of both row passes and both re-scans' callers), and the
    wrapper's constants are the source's."""
    _text, widths, limit, threads, rhs_tile = _source()
    assert widths == tprep.STRIP_WIDTHS == (32, 16, 8)
    assert (limit, threads, rhs_tile) == (
        tprep.SMEM_LIMIT, tprep._THREADS, tprep._RHS_TILE)
    for W in widths:
        assert tf32scan._PTILE % W == 0 and threads % (W // 4) == 0
    for N in range(1, 2049):
        for cap, nb in ((512, 8), (512, 16), (256, 16), (128, 16)):
            N2B = trescan.col_blocks(N, cap, nb)[1]
            assert all(N2B % W == 0 for W in widths), (N, cap, nb, N2B)


def test_smem_rule_is_the_sources():
    """``strip_smem_bytes`` against the source's ``smem_bytes``, its C
    text evaluated as Python."""
    text, _w, _l, threads, rhs_tile = _source()
    body = re.search(r"int smem_bytes\(.*?\n}\n", text, re.S).group(0)
    env = {"kThreads": threads, "kRhsTile": rhs_tile}
    env.update({k: eval(v, {}, env) for k, v in re.findall(
        r"(kJoin\w+) = ([\w *]+)[,;]", text)})
    env["rhs_padded"] = lambda n: -(-n // rhs_tile) * rhs_tile

    def c_eval(expr, loc):
        """A C integer expression with ``a ? b : c`` (in parentheses
        without nesting, or as the whole expression) as Python."""
        expr = re.sub(r"\(([^()?]+) \? ([^()?:]+) : ([^()]+)\)",
                      r"((\2) if (\1) else (\3))", " ".join(expr.split()))
        if " ? " in expr:
            cond, rest = expr.split(" ? ", 1)
            yes, no = rest.rsplit(" : ", 1)
            expr = "(%s) if (%s) else (%s)" % (yes, cond, no)
        return eval(expr, {}, dict(env, **loc))

    planes, join, total = re.findall(r"(?:= |return )(.+?);", body, re.S)
    for S, W, n_rhs in ((552, 32, 2), (552, 32, 12), (40, 16, 0),
                        (9, 8, 15), (2000, 8, 1)):
        loc = {"S": S, "W": W, "n_rhs": n_rhs}
        loc["planes"] = c_eval(planes, loc)
        loc["join"] = c_eval(join, loc)
        assert c_eval(total, loc) == tprep.strip_smem_bytes(S, W, n_rhs)
    assert c_eval(total, {"S": 552, "W": 32, "n_rhs": 12, "planes": 141312,
                          "join": 73728}) == 194304


def test_strip_width_rule():
    """32 columns at the main paths' 552 samples (2, 12 and 15 rhs
    columns), 16 and 8 where the strip, its x/r plane and the staged rhs
    no longer fit, a ``ValueError`` naming the limit beyond; a tile that
    32 does not divide takes the next width."""
    for n_rhs in (0, 2, 12, 15):
        assert tprep.strip_width(552, 128, n_rhs) == 32
    assert tprep.strip_width(900, 128, 12) == 16
    assert tprep.strip_width(1200, 128, 12) == 8
    assert tprep.strip_width(2000, 512, 2) == 8
    assert tprep.strip_width(552, 48, 2) == 16
    assert tprep.strip_width(6400, 128, 0) == 8
    with pytest.raises(ValueError, match=str(tprep.SMEM_LIMIT)):
        tprep.strip_width(7000, 128, 0)
    with pytest.raises(ValueError, match="fit no strip"):
        tprep.strip_width(2000, 128, 12)
    # every width is reachable, and the rule is monotone in S
    got = [tprep.strip_width(S, 128, 2) for S in range(8, 2700, 8)]
    assert set(got) == {32, 16, 8} and got == sorted(got, reverse=True)
