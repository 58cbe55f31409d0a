"""Kernel 1: operand prep of the interval row pass.

Counterpart of ``microstructure_fingerprinting_tpu/ops/pallas_prep.py``
(``prep_block`` -> ``_prep_kernel``/``_quant3``). One pass over each
voxel's rotated (S, Np) block emits:

  * q123   (B, nt, S, 3T) int8 — [Q1 | Q2 | Q3] per tile of T columns
  * x/r/a  (B, nt, S, T) bf16 — normalized columns, ~2^-24 quantization
                                residuals, quantized part a = x - r
                                (the subset named by ``planes``)
  * gram   (B, 16, Np) f32    — row 0: exact-rounded <x, x>;
                                row 1+j: exact-rounded <x, rhs_j>

Columns are l2-normalized as ``X * (1 / ||x||)`` (a multiply by the
reciprocal, as the TPU kernel does); zero columns have zero norm and
quantize to zero. Level products are exact integers; the bf16 corrections
are exact bf16 x bf16 products. Both are summed so that the order does
not matter (integers exactly, the corrections and the squared norm in
float64 rounded once to float32), so the CUDA kernel
(``csrc/prep.cu``) and the plain version here agree bit for bit, up to
the rounding of a float64 sum taken in another order
(``testing.kernel_agreement``).

``prep_block`` dispatches on the device of ``A``: CUDA tensors launch the
kernel (or raise), CPU tensors run ``prep_block_twin``.

Kernel 13 (``csrc/rhsprep.cu``, ``rhs_prep``; plain version
``rhs_prep_twin``) builds the rhs operands: the signal and the fixed
columns normalized (``nnls._normalize_y`` / ``_normalize_block``) and
packed as ``pack_rhs`` packs them.
"""

import math

import torch
import torch.nn.functional as F

from . import df32
from . import dfscan
from . import kernels
from .nnls import _normalize_block, _normalize_y, sqrt_f32, sumsq_f32

_LANE = 128
#: rhs columns (signal + fixed compartments): gram rows 1..15
MAX_RHS = 15
#: entries a voxel of kernel 13's scratch of column divisors
#: (csrc/rhsprep.cu kNormPad): its norms launch writes them, its packs
#: launch reads them
RHS_NORM_PAD = 16
#: csrc/prep.cu: a block stages a strip of W columns of one voxel, the
#: widest of these that divides the tile and fits the shared-memory limit
STRIP_WIDTHS = (32, 16, 8)
SMEM_LIMIT = 212 * 1024
_THREADS, _RHS_TILE = 256, 2


def strip_smem_bytes(S, W, n_rhs):
    """Dynamic shared memory of a block of ``csrc/prep.cu`` (its
    ``smem_bytes``): the (S, W) strip and, with rhs columns, the x/r
    plane, 4 bytes an element each (the scratch that joins the product
    phase's partial sums lies over them and counts where it is larger),
    and the staged rhs columns, padded to whole thread tiles, 8 bytes a
    sample."""
    planes = S * W * 4 * (2 if n_rhs > 0 else 1)
    join = _THREADS * 4 * _RHS_TILE * (5 + 2 * 2) * 4 if n_rhs > 0 else 0
    return max(planes, join) + S * (-(-n_rhs // _RHS_TILE) * _RHS_TILE) * 8


def strip_width(S, tile, n_rhs):
    """The strip width the kernel's launcher picks for S samples; raises
    ``ValueError`` where no width fits (the kernel has no second path)."""
    for W in STRIP_WIDTHS:
        if tile % W == 0 and strip_smem_bytes(S, W, n_rhs) <= SMEM_LIMIT:
            return W
    raise ValueError(
        "prep_block: S=%d samples with %d rhs columns at tile %d fit no "
        "strip of %s columns in %d bytes of shared memory (the narrowest "
        "needs %d)" % (S, n_rhs, tile, STRIP_WIDTHS, SMEM_LIMIT,
                       strip_smem_bytes(S, STRIP_WIDTHS[-1], n_rhs)))


def pack_rhs(cols):
    """Quantize + lane-align the rhs columns for ``prep_block``.

    cols: list of already-normalized (B, S) tensors (signal first, then
    fixed-compartment columns), at most ``MAX_RHS``. Returns
    (rhs_q (B, S, 3*128) int8, rhs_r (B, S, 128) bf16,
    rhs_a (B, S, 128) bf16, q3s) where q3s are the quantize3 tuples (for
    the small Grams among the rhs columns themselves)."""
    if len(cols) > MAX_RHS:
        raise ValueError("prep_block takes at most %d rhs columns" % MAX_RHS)
    q3s = [dfscan.quantize3(c.float()) for c in cols]

    def stackp(xs, dtype):
        z = torch.stack([x.to(dtype) for x in xs], dim=2)
        return F.pad(z, (0, _LANE - len(xs)))

    rhs_q = torch.cat([stackp([q[lvl] for q in q3s], torch.int8)
                       for lvl in range(3)], dim=2)       # (B, S, 384)
    rhs_r = stackp([q[3] for q in q3s], torch.bfloat16)
    rhs_a = stackp([q[4] for q in q3s], torch.bfloat16)
    return rhs_q, rhs_r, rhs_a, q3s


def rhs_prep_twin(y, a3, a4=None):
    """Plain version of kernel 13 (``csrc/rhsprep.cu``): the row passes'
    rhs columns normalized (``nnls._normalize_y`` / ``_normalize_block``)
    and packed (``pack_rhs``). y (B, S), a3 (B, S, N3) and a4 (B, S, N4)
    or None: 1 + N3 + N4 <= MAX_RHS raw columns, the signal first.
    Returns (rhs_q, rhs_r, rhs_a, yh (B, S), A3h (B, S, N3), A4h
    (B, S, N4) or None)."""
    yh = _normalize_y(y.float())[0]
    A3h = _normalize_block(a3.float())[0]
    A4h = None if a4 is None else _normalize_block(a4.float())[0]
    cols = [yh] + [A3h[:, :, i] for i in range(A3h.shape[2])]
    if A4h is not None:
        cols += [A4h[:, :, i] for i in range(A4h.shape[2])]
    rhs_q, rhs_r, rhs_a, _q3s = pack_rhs(cols)
    return rhs_q, rhs_r, rhs_a, yh, A3h, A4h


def _voxel_contiguous(x):
    """x itself if each voxel's block x[b] is contiguous (any batch
    stride: 0 for a column every voxel shares), else a contiguous
    copy."""
    want = 1
    for size, stride in reversed(list(zip(x.shape[1:], x.stride()[1:]))):
        if size > 1 and stride != want:
            return x.contiguous()
        want *= size
    return x


def _rhs_prep_cuda(y, a3, a4):
    B, S = y.shape
    N3 = a3.shape[2]
    N4 = 0 if a4 is None else a4.shape[2]
    if 1 + N3 + N4 > MAX_RHS or N3 < 1:
        raise ValueError("rhs_prep takes the signal and 1 .. %d fixed "
                         "columns, got %d + %d" % (MAX_RHS - 1, N3, N4))
    ins = [_voxel_contiguous(x) for x in (y, a3, a4) if x is not None]
    for x, name, shape in zip(ins, ("y", "a3", "a4"),
                              ((B, S), (B, S, N3), (B, S, N4))):
        if not x.is_cuda or x.dtype != torch.float32:
            raise TypeError("%s must be a float32 CUDA tensor" % name)
        if tuple(x.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(x.shape)))
    y, a3, a4 = (ins + [None])[:3]
    new = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device=y.device)
    yh, A3h = new(B, S), new(B, S, N3)
    A4h = None if a4 is None else new(B, S, N4)
    rhs_q = new(B, S, 3 * _LANE, dtype=torch.int8)
    rhs_r = new(B, S, _LANE, dtype=torch.bfloat16)
    rhs_a = new(B, S, _LANE, dtype=torch.bfloat16)
    safe = new(B, RHS_NORM_PAD)
    stride0 = lambda x: 0 if x is None else x.stride(0)
    kernels.launch("rhsprep", y, a3, a4, safe, yh, A3h, A4h, rhs_q, rhs_r,
                   rhs_a, B, S, N3, N4, stride0(y), stride0(a3), stride0(a4))
    return rhs_q, rhs_r, rhs_a, yh, A3h, A4h


def rhs_prep(y, a3, a4=None):
    """Kernel 13 dispatch on the device of ``y``: CUDA tensors launch
    ``csrc/rhsprep.cu`` (or raise), CPU tensors run ``rhs_prep_twin``."""
    fn = _rhs_prep_cuda if y.is_cuda else rhs_prep_twin
    return fn(y, a3, a4)


def pad_block(A, tile):
    """Pad the atom axis of (B, S, N) to a multiple of ``tile`` with zero
    columns. Returns (A_padded, Np)."""
    N = A.shape[2]
    Np = int(math.ceil(N / tile) * tile)
    if Np > N:
        A = F.pad(A, (0, Np - N))
    return A, Np


def _planes(planes):
    return "".join(p for p in "xra" if p in planes)


def _tiles(X, tile):
    """(B, S, Np) -> (B, nt, S, tile)."""
    B, S, Np = X.shape
    return X.reshape(B, S, Np // tile, tile).permute(0, 2, 1, 3).contiguous()


def prep_block_twin(A, rhs_q, rhs_r, rhs_a, tile, planes="xra", n_rhs=None):
    """Plain PyTorch version of the prep kernel (same arithmetic)."""
    B, S, Np = A.shape
    if n_rhs is None:
        n_rhs = MAX_RHS
    X = A.float()
    nrm = sqrt_f32(sumsq_f32(X, 1))[:, None, :]
    ok = nrm > 0
    inv = torch.where(ok, 1.0 / torch.where(ok, nrm, torch.ones_like(nrm)),
                      torch.zeros_like(nrm))
    Xh = X * inv
    Q1, Q2, Q3, R, a = dfscan.quantize3(Xh)
    bf = torch.bfloat16
    emitted = {"x": Xh.to(bf), "r": R.to(bf), "a": a.to(bf)}
    q123 = torch.cat([_tiles(Q, tile) for Q in (Q1, Q2, Q3)], dim=3)
    outs = {p: _tiles(emitted[p], tile) for p in _planes(planes)}

    # exact-rounded diagonal <x, x>: integer level sums + the correction
    # x^2 = a^2 + (2a + r) r
    red = lambda u, v: dfscan.idot("bsn,bsn->bn", u, v).float()
    s11, s12, s13 = red(Q1, Q1), red(Q1, Q2), red(Q1, Q3)
    s22, s23, s33 = red(Q2, Q2), red(Q2, Q3), red(Q3, Q3)
    cdiag = ((2.0 * a + R) * R).double().sum(dim=1).float()
    d = df32.df_from_sum(
        s11 * 2.0 ** -14, (2.0 * s12) * 2.0 ** -22,
        (s22 + 2.0 * s13) * 2.0 ** -30, cdiag,
        (2.0 * s23) * 2.0 ** -38, s33 * 2.0 ** -46)[0]

    # exact-rounded <x, rhs_j>: level products grouped by scale
    L = _LANE
    rq = [rhs_q[:, :, lvl * L:lvl * L + n_rhs] for lvl in range(3)]
    ei = lambda i, Q: dfscan.idot("bsj,bsn->bjn", rq[i], Q)
    v14 = ei(0, Q1).float()
    v22 = (ei(0, Q2) + ei(1, Q1)).float()
    v30 = (ei(0, Q3) + ei(1, Q2) + ei(2, Q1)).float()
    v38 = (ei(1, Q3) + ei(2, Q2)).float()
    v46 = ei(2, Q3).float()
    c1 = dfscan.fdot("bsj,bsn->bjn", rhs_r[:, :, :n_rhs].float(),
                     emitted["x"].float())
    c2 = dfscan.fdot("bsj,bsn->bjn", rhs_a[:, :, :n_rhs].float(),
                     emitted["r"].float())
    g = df32.df_from_sum(v14 * 2.0 ** -14, v22 * 2.0 ** -22,
                         v30 * 2.0 ** -30, c1, c2, v38 * 2.0 ** -38,
                         v46 * 2.0 ** -46)[0]             # (B, n_rhs, Np)
    gram = torch.zeros(B, 16, Np, dtype=torch.float32, device=A.device)
    gram[:, 0] = d
    gram[:, 1:1 + n_rhs] = g[:, :15]
    return (q123, outs.get("x"), outs.get("r"), outs.get("a"), gram)


def _prep_block_cuda(A, rhs_q, rhs_r, rhs_a, tile, planes, n_rhs):
    B, S, Np = A.shape
    kernels.check(A, torch.float32, (B, S, Np), "A")
    kernels.check(rhs_q, torch.int8, (B, S, 3 * _LANE), "rhs_q")
    kernels.check(rhs_r, torch.bfloat16, (B, S, _LANE), "rhs_r")
    kernels.check(rhs_a, torch.bfloat16, (B, S, _LANE), "rhs_a")
    if not 0 <= n_rhs <= MAX_RHS:
        raise ValueError("n_rhs must be in [0, %d]" % MAX_RHS)
    strip_width(S, tile, n_rhs)
    nt = Np // tile
    dev = A.device
    q123 = torch.empty(B, nt, S, 3 * tile, dtype=torch.int8, device=dev)
    planes = _planes(planes)
    outs = {p: torch.empty(B, nt, S, tile, dtype=torch.bfloat16, device=dev)
            for p in planes}
    gram = torch.empty(B, 16, Np, dtype=torch.float32, device=dev)
    kernels.launch(
        "prep_block", A, rhs_q, rhs_r, rhs_a, q123,
        outs.get("x"), outs.get("r"), outs.get("a"), gram,
        B, S, Np, tile, n_rhs)
    return (q123, outs.get("x"), outs.get("r"), outs.get("a"), gram)


def prep_block(A, rhs_q, rhs_r, rhs_a, tile, planes="xra", n_rhs=None):
    """Normalize + quantize + pack + hoist-Grams for one rotated block.

    A (B, S, Np) f32 raw columns with Np % tile == 0 (pad with zero
    columns); rhs_* from ``pack_rhs``; ``n_rhs`` the number of rhs
    columns packed (rows 1 + n_rhs.. of the gram are zero). Returns
    (q123 (B, nt, S, 3*tile) int8, xbf/rbf/abf (B, nt, S, tile) bf16 or
    None where ``planes`` leaves them out, gram (B, 16, Np) f32)."""
    Np = A.shape[2]
    if Np % tile:
        raise ValueError("Np=%d is not a multiple of tile=%d" % (Np, tile))
    if n_rhs is None:
        n_rhs = MAX_RHS
    if A.is_cuda:
        return _prep_block_cuda(A, rhs_q, rhs_r, rhs_a, tile, planes, n_rhs)
    return prep_block_twin(A, rhs_q, rhs_r, rhs_a, tile, planes, n_rhs)
