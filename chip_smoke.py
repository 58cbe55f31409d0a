"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the thirteen CUDA kernels of ``microstructure_fingerprinting_torch``
from ``csrc/``, holds each against its plain PyTorch version on the card
at the main paths' shapes (see ``held`` for the tolerance) and times
both (kernel 13, the row passes' rhs columns normalized and packed, on
a chunk at 2 and 12 columns; kernel 12, the flagship row pass's hoists,
on a chunk at 782 x 782; kernels 9 and 6, the df2 scan's operands and the scan, on a chunk
at [782, 782] and [782, 1]; kernel 10, the re-scan's operands, on a chunk
at 128 x 128 and 256 x 256, on the 782 x 782 grid for 8 voxels and on
the EAR-mixed volume's 782 x 10 grid; kernel 8, the EAR re-scan's
operands, on an EAR chunk at 256 x 256 and on the 782 x 782 grid for 8
voxels; kernel 11, the EAR row pass's hoists, on an EAR chunk at
782 x 782; each operand, and kernels 3, 5, 6 and 4 fed them and the
plain ones; kernel 7, the
double-float finalize, on the gathered columns of
flagship, mixed and EAR chunks and, bit for bit, on columns whose
largest value sits an ulp off a power of two), times the four hoisted
functions' routes a chunk (the df2 scan, the two re-scans, the two row
passes) against the routes with the plain hoists and the plain versions,
in turns, then drives the main
paths through ``MFModel.fit``: the flagship
[782, 782, 1] two-fascicle + CSF volume and the EAR (UK-Biobank)
[782, 782, 1, 10] volume (552 sequences, 4096 voxels each, random
directions, noiseless), and two volumes that mix the fast path's buckets
at the same widths: "mixed" (2048 voxels of 0, 1 and 2 fascicles with
CSF and 2 without) and "ear_mixed" (1024 voxels of 0, 1 and 2 fascicles
+ CSF + EAR, kernel 3 on the one-fascicle bucket's [782, 10, 1] grid).
It writes and reloads their maps, drives the overflow tiers of the
two-fascicle + CSF buckets, and fits a few voxels of each newer bucket
on the card and on the CPU. Then the general path (no kernel of its
own): the "general" volume (1024 voxels of one fascicle without CSF,
with and without EAR, and two fascicles + EAR without CSF), a 4-block
bucket with 20 EAR atoms, the flagship's two-fascicle + CSF bucket with
engine="xla" against the fast path, each bucket's stages, refine time
and peak memory, and tests/golden/golden_fit.npz fitted with the default
arguments and with engine="xla". Then the user's workflow from the
shell, through ``cli.main``: the flagship volume (and 1024 voxels of the
EAR one) written as a user's files (dictionary .mat, NIfTI volumes, a
scheme text file), ``cleanup`` on its planted directions and fractions,
and ``fit`` on cleanup's output, each held against the same steps in
process (files equal, maps equal, launches equal); and the reference
surface (``monte_carlo_average``, ``interp_PGSE_from_multishell``,
``eval_rotation``) on the card against the CPU, and ``mf_utils`` without
matplotlib. Then the modules of the last slice: the MCF simulators
(``MCF_PGSE`` on the 552 sequences for three cylinder sizes, ``MCF_DDE``
on a 64-row DDE scheme) on the card against the CPU; device meshes of
two slots on the one card, (2, 1) through ``run_bucket_fast(mesh=)`` and
``MFModel.fit(parallel=True, mesh_shape=(2, 1))`` on flagship and EAR
voxels (bit for bit the serial fit, the same launches) and (1, 2) with
the atoms axis; two processes of this script joined by
``parallel/mesh.init_distributed`` (gloo) each fitting half of 512
flagship voxels, gathered and held bit for bit against one process
(``python3 chip_smoke.py --multihost-worker ...`` is that worker); and
the examples ``demo_synthetic`` and ``exactness_check`` with their
gates. Last, the graphs phase: the flagship, EAR, mixed, ear_mixed and
general volumes fitted with eager chunk steps (``models/graphs.eager()``)
and through their CUDA graphs in turns, every graph fit's maps and
launches bit for bit the eager fit's, with voxels/s of both routes, the
captures, the memory the graphs hold and the device-idle share of a
flagship, an EAR and a mixed fit on each route. Every phase runs; exits non-zero
on any failure; needs one CUDA device. The last line of standard output
is the JSON summary {"ok": true, "device": {...}}; the kernel table is
the JSON line before the card's name and power limit, with kernel 1 in
a row per rhs width (its launches in the fits at that width, its times
at that width) and every row's launches summed over the fits that run
it; an earlier ``record:`` line holds every number measured. Each fit
is run once cold (launch counts, recovery) and WARM_FITS times warm as
a user runs it, every chunk step a CUDA graph replay (voxels/s, each
bucket's wall time, as median and min-max), then once under the stage
timer, which runs the steps eagerly: every stage and each bucket's
stages, the flagship and EAR paths' "prep" and "re-scan" stages and the
mixed path's "df2 scan" split into their kernels and the torch code
around them. Each phase's graphs are
recorded (captures, replays) and freed after it.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

N_VOX = 4096          # 16 x 16 x 16 volume
N_ATOM = 782          # flagship sub-dictionary size
N_EAR = 10            # EAR diffusivities of the UK-Biobank configuration
R_EAR = 256           # the EAR two-pass row budget (twopass_rows_ear)
EAR_ATOM = 4          # the EAR atom planted in every voxel (testing.make_ear)
CHUNK = 512           # voxels per chunk of the fit (MFModel.fit default)
#: voxels per call of each plain version when it is held against its
#: kernel on a whole chunk (bounds the plain versions' temporaries)
SLICE = {"prep_block": 128, "rowmin3": 64, "rescan3": 512, "rowmin4": 16,
         "rescan4": 64, "rescan3_ear": 64, "df2scan": 64}

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense; the
#: float32 rate is outside the tensor cores), for the kernels' bounds
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "f32": 67e12}
#: float32 operations per grid point of each kernel's chain, counted by
#: hand from its source (an add, multiply, divide or compare is one, a
#: fused multiply-add two);
#: nx = n3 + n4 extra columns, ns = n3 * n4 sweeps
CHAIN_OPS = {
    "rowmin3": lambda nx, ns: 70,
    "rescan3": lambda nx, ns: 521,
    # 6 Dekker products of 24 (two splits of 4, 9 for the error, 4 for
    # the cross terms, 3 to renormalise), a compensated sum of 4 terms
    # (25), 5 values, det12 / w1D / w2D (9), a divide, the case logic
    # (14 compares), the scale by 2 and the row minimum's compare (4)
    "df2scan": lambda nx, ns: 202,
    "rowmin4": lambda nx, ns: 30 + 37 * nx + 47 * ns,
    "rescan4": lambda nx, ns: 120 + 173 * nx + 145 * ns,
}
#: float32 operations of the chain of kernels 8, 9 and 10 per atom,
#: counted by hand from csrc/df4hoist.cu, csrc/df2hoist.cu and
#: csrc/df3hoist.cu as ``CHAIN_OPS`` counts (a Dekker product 24, a
#: double-float sum 11, a divide ~30, a presplit write 3; the sub-supports
#: {A, 3} ~450 and {A, 3, 4} ~1,000; kernel 10: 21 products of a row, 31
#: of a column, compensated sums and the case logic): a row and a column,
#: nx = n3 + n4 extra columns, ns = n3 * n4 sweeps
HOIST_CHAIN_OPS = {
    "df4hoist": (lambda nx, ns: 600 + 57 * nx + 1750 * ns,
                 lambda nx, ns: 600 + 510 * nx + 1660 * ns),
    "df2hoist": (lambda nx, ns: 65, lambda nx, ns: 65),
    "df3hoist": (lambda nx, ns: 650, lambda nx, ns: 1000),
}
#: float32 operations of kernel 11's plain float32 chain, counted by hand
#: from csrc/row4hoist.cu as ``CHAIN_OPS`` counts (an x_chain 14, a pair
#: 17 a row and 8 a column, the sub-supports {a} 10, {a, b} 32 and
#: {a, b, c} 64 with their folds): a row and a column
ROW4_CHAIN_OPS = (lambda nx, ns: 43 + 14 * nx + 121 * ns,
                  lambda nx, ns: 42 + 5 * nx + 108 * ns)
#: float32 operations of kernel 12's chain, counted by hand from
#: csrc/row3hoist.cu as ``ROW4_CHAIN_OPS`` counts (the sub-supports {a} 10
#: and {a, b} 32, their fold 2; the chain prefixes 18 a row, 6 a column,
#: the floor's minimum 1): a row and a column
ROW3_CHAIN_OPS = (62, 51)
#: float32 operations of kernel 13 on one element of a column: its square
#: into the norm (a multiply-add, 2), the quotient and quantize3
RHS_PREP_OPS = 3
#: operations of f32scan._gram3_hi a sample (9 int8 level products, 2
#: float64 corrections) and of quantize3 an element (quantize2's 19 and a
#: third level, 3 bf16 roundings)
GRAM3_INT_OPS, GRAM3_F32_OPS, QUANTIZE3_OPS = 9, 2, 30
#: float32 operations of quantize2 on one element (two levels: a divide,
#: round, clamp, convert and multiply each, a subtract, an add, a subtract;
#: the add of a + R and the two float64 conversions)
QUANTIZE_OPS = 19
#: the re-scans' chains before their products were fused (Dekker products
#: on presplit halves), for the old bounds beside the new ones. Kernel 3's
#: 400 is the count its bound rested on while it held that chain; counted
#: as ``CHAIN_OPS`` is now (36 products of 13 instead of 7 operations and 6
#: splits of 4) that chain was 761 operations
CHAIN_OPS_DEKKER = {"rescan3": lambda nx, ns: 400,
                    "rescan4": lambda nx, ns: 160 + 215 * nx + 215 * ns}
#: samples (zero-padded) at which kernel 1 is also held at each of its
#: narrower strip widths, with the flagship's 2 rhs columns at tile 128
NARROW_S = {16: 900, 8: 2000}
#: samples kept of a re-scan's operands to time it with nearly no Gram
FEW_SAMPLES = 8
#: warm fits of each main path (voxels/s and stages: median and min-max)
WARM_FITS = 3
#: the fused and the Dekker product of two floats are the same float when
#: |product| is at least this (tests/test_torch_df32_fma.py)
FUSED_EQUALS_DEKKER_ABOVE = 2.0 ** -101
#: the volumes that mix buckets: their shape and (voxels, fascicles, CSF)
#: groups, planted by ``testing.make_mixed`` (EAR_MIXED with ear_mask = 1
#: and EAR atom 4 in every voxel)
MIXED = {"shape": (16, 16, 8), "groups": ((256, 0, True), (1024, 1, True),
                                          (512, 2, True), (256, 2, False))}
EAR_MIXED = {"shape": (16, 8, 8), "groups": ((512, 1, True), (256, 2, True),
                                             (256, 0, True))}
#: voxels of each newer bucket fitted on the card and on the CPU
CROSS_VOX = 8
#: the "general" volume: the buckets a brain fitted without a CSF mask
#: falls into, at the flagship widths, as (voxels, fascicles, CSF, EAR)
#: groups planted by ``testing.make_mixed`` (EAR atom 4 of the 10-atom
#: block where EAR is on); the fast path covers none of them
GENERAL = {"shape": (16, 8, 8), "groups": ((512, 1, False, False),
                                           (256, 1, False, True),
                                           (256, 2, False, True))}
#: an EAR block wider than the fast path's 16 atoms: the 4-block general
#: scan, on WIDE_VOX voxels of 2 fascicles + CSF + EAR
N_EAR_WIDE = 20
WIDE_VOX = 128
#: flagship (2, CSF) voxels fitted with engine="xla" beside the fast path
XLA_VOX = 512
#: voxels of the EAR volume fitted from the shell (the cli_ear phase)
CLI_EAR_VOX = 1024
#: the Monte-Carlo average of the surface phase: reference sequences and
#: spins, mapped to the flagship protocol's sequences
MC_REF, MC_SPINS = 2, 100000
#: fascicle directions of the surface phase's rotations
N_DIRS = 16
#: the MCF phase: cylinder diameters [m] and the rows of its DDE scheme
MCF_SIZES = (2e-6, 5e-6, 8e-6)
DDE_ROWS = 64
#: card against CPU, per value: at L = 2 um the exponentials' arguments
#: reach a norm of ~2000, where scaling and squaring in float64 leaves
#: ~1e-12 of relative error on values of ~0.2 (the port and the JAX
#: package differ by 2.1e-12 there on one CPU)
MCF_RTOL = 1e-11
#: the mesh phase: flagship and EAR voxels on the (2, 1) mesh, flagship
#: voxels on the (1, 2) mesh (one chunk)
MESH_VOX, MESH_EAR_VOX, ATOMS_VOX = 1024, 512, 256
#: the multihost phase: flagship voxels over two processes, the kernels
#: each must launch, and the seconds before a process is killed
MH_VOX = 512
MH_KERNELS = ("rhsprep", "prep_block", "row3hoist", "rowmin3", "rescan3")
MH_TIMEOUT = 240
#: voxels of the exactness_check example
EXACT_VOX = 256
#: the graphs phase: the volumes fitted eagerly (``graphs.eager()``) and
#: through the CUDA graphs in these turns, and those whose device-idle
#: share is traced on both routes
GRAPH_VOLUMES = ("flagship", "EAR", "mixed", "ear_mixed", "general")
GRAPH_TURNS = ("eager", "graph", "graph", "eager") * 2
IDLE_VOLUMES = ("flagship", "EAR", "mixed")
#: the repo's frozen end-to-end fixture (tests/test_golden.py)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "golden_fit.npz")

RECORD = {}
#: max|kernel - plain| of kernel 7 in the phases after the kernels phase
FINALIZE_ERR = []


def log(msg):
    print(msg, flush=True)


def timed(fn, reps=3):
    """Mean device milliseconds of fn() over reps (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def nbytes(*ts):
    """Bytes of the tensors (None skipped)."""
    import torch
    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            out += t.numel() * t.element_size()
    return out


def bound(bytes_moved, ops):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations, each type over its peak
    (an int8 or bf16 multiply-add counts as 2 operations). Returns
    (ms, "bytes" or "operations")."""
    t_b = bytes_moved / PEAK["bytes"]
    t_o = sum(n / PEAK[kind] for kind, n in ops.items())
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def scan_ops(name, B, S, n1p, n2p, nx=0, ns=0, chain=CHAIN_OPS):
    """Operations of a row pass or re-scan over a B x n1p x n2p grid."""
    pts = float(B) * n1p * n2p
    if name.startswith("rowmin"):
        gram = {"int8": 2 * 9 * S * pts, "bf16": 2 * 2 * S * pts}
    else:
        gram = {"int8": 2 * 4 * S * pts, "f32": 2 * 2 * S * pts}
    gram["f32"] = gram.get("f32", 0.0) + chain[name](nx, ns) * pts
    return gram


def hoist_ops(name, B, S, n1, n2, n_small, nx=0, ns=0):
    """Operations of kernel 8 or 9 on the real atoms (n1 rows, n2
    columns) of B voxels: quantize2 of every element; per atom and
    sample 1 + n_small Grams (with itself and with each small column) of
    4 int8 level products and 2 float64 multiply-adds (counted at the
    float32 rate, as the re-scans' cross products); per voxel and block
    the small columns' Grams; per atom its chain."""
    atoms = float(B) * (n1 + n2)
    grams = atoms * S * (1 + n_small)
    row, col = HOIST_CHAIN_OPS[name]
    return {"int8": 2 * 4 * grams,
            "f32": (QUANTIZE_OPS * atoms * S + 2 * 2 * grams
                    + float(B) * (n1 * row(nx, ns) + n2 * col(nx, ns)))}


def row4_hoist_ops(B, S, n1, n2, n4):
    """Operations of kernel 11 on the real atoms (n1 rows, n2 columns)
    of B voxels: the voxel's 3 + 3 n4 small Grams and the quantize3 of
    its 2 + n4 small columns once, and each atom's chain (what the
    function needs; the kernel sums the small Grams again in every block
    of the voxel)."""
    nx, ns = 1 + n4, n4
    grams = float(B) * (3 + 3 * n4) * S
    row, col = ROW4_CHAIN_OPS
    return {"int8": 2 * GRAM3_INT_OPS * grams,
            "f32": (2 * GRAM3_F32_OPS * grams
                    + QUANTIZE3_OPS * float(B) * (2 + n4) * S
                    + float(B) * (n1 * row(nx, ns) + n2 * col(nx, ns)))}


def row3_hoist_ops(B, S, n1, n2):
    """Operations of kernel 12 on the real atoms (n1 rows, n2 columns) of
    B voxels: the voxel's 3 small Grams and the quantize3 of its 2 small
    columns once, and each atom's chain (the kernel sums the small Grams
    again in every block of the voxel)."""
    grams = float(B) * 3 * S
    row, col = ROW3_CHAIN_OPS
    return {"int8": 2 * GRAM3_INT_OPS * grams,
            "f32": (2 * GRAM3_F32_OPS * grams + QUANTIZE3_OPS * float(B) * 2 * S
                    + float(B) * (n1 * row + n2 * col))}


def rhs_prep_ops(B, S, n_cols):
    """Operations of kernel 13 on B voxels' n_cols columns of S samples
    (the packs' zero lanes are no work)."""
    return {"f32": (RHS_PREP_OPS + QUANTIZE3_OPS) * float(B) * S * n_cols}


def finalize_ops(B, S, C):
    """Operations of kernel 7 (counted from ``csrc/finalize.cu``): per
    sample and column ~15 to scale and quantize; per entry i <= j of
    the (C + 1)^2 Gram 8 integer operations, per entry used 4 float64;
    per voxel the solver's double-float chain, ~20 operations a product
    or sum: 1 divide and quotient form for C = 1, ~60 df operations for
    C = 2, ~250 for C = 3, ~1,500 for C = 4 (15 supports, Cramer)."""
    K = C + 1
    sample = 15 * K + 8 * K * (K + 1) // 2 + 4 * (C * K + 1)
    solver = 20 * {1: 10, 2: 60, 3: 250, 4: 1500}[C]
    return {"f32": float(B) * (S * sample + solver)}


def prep_ops(A, n_rhs):
    """Operations of prep on one block: per element the 6 + 9 n_rhs
    level products, 1 + 2 n_rhs bf16 corrections and ~26 quantization
    operations."""
    el = float(A.numel())
    return {"int8": 2 * (6 + 9 * n_rhs) * el,
            "bf16": 2 * (1 + 2 * n_rhs) * el, "f32": 26 * el}


def spread(xs):
    """Median, minimum and maximum of a few readings."""
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_setup():
    import torch
    from microstructure_fingerprinting_torch.ops import kernels
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("card: %s" % card_line())
    log("torch %s, CUDA %s, nvcc: %s" % (torch.__version__, torch.version.cuda,
                                         nvcc[-1]))
    t0 = time.time()
    kernels.library()
    build_s = time.time() - t0
    log("kernels %s in %.1f s: %s" % (
        "reused" if kernels.BUILD_INFO["cached"] else "built", build_s,
        kernels.BUILD_INFO["cmd"]))
    for line in kernels.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    RECORD["build_s"] = build_s


def voxel_inputs(wl, vox, ys_np, device):
    """Rotated blocks (both directions of the workload's voxels ``vox``),
    their signals of ``ys_np`` and the CSF block, in the rotation's
    sequence order."""
    import torch
    from microstructure_fingerprinting_torch.ops import interp as mfi
    ms, plan = wl["msinterp"], wl["plan"]
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    _x, ys, _c = ms.device_tables(device, torch.float32)
    D = rotate(ys, torch.as_tensor(wl["peaks"][vox], dtype=torch.float32,
                                   device=device))
    y = torch.as_tensor(ys_np[vox][:, perm], dtype=torch.float32,
                        device=device)
    csf = torch.as_tensor(wl["sig_csf"][perm], dtype=torch.float32,
                          device=device)
    return D, y, csf[None, :, None].expand(len(vox), -1, 1).contiguous()



def held(what, k, p, exact=False):
    """Hold a kernel output against its plain version's by
    ``testing.kernel_agreement``; raises if they differ, else returns
    max|k - p|."""
    from microstructure_fingerprinting_torch import testing
    ok, n_diff, n, err, tol = testing.kernel_agreement(k, p, exact)
    log("%s: %d of %d entries differ, max|err| %.3e (limit %.3e)%s"
        % (what, n_diff, n, err, tol, "" if ok else " FAIL"))
    if not ok:
        raise AssertionError(
            "%s: kernel and plain version differ (tolerance: %s, same "
            "inf/NaN entries, %d float32 ulp of max|value|)" % (
                what, "no entry differs" if exact else "<= %.0e of entries "
                "differ" % testing.KERNEL_DIFF_SHARE, testing.KERNEL_ULPS))
    return err


def plain_sliced(fn, ops, step):
    """fn over voxel slices of ``step``, outputs joined on the voxel
    axis: the plain versions' temporaries for a whole chunk would not
    fit on the card, and every voxel is independent."""
    import torch
    B = ops[0].shape[0]
    outs = [fn(*[o[i:i + step] for o in ops]) for i in range(0, B, step)]
    return tuple(None if parts[0] is None else torch.cat(parts)
                 for parts in zip(*outs))


def row(err, ms, plain_ms, bytes_moved, ops):
    b_ms, b_by = bound(bytes_moved, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_prep(rows, name, blocks, rhs, n_rhs):
    """Kernel 1 on each (A, tile, planes) block against its plain
    version; rows[name] gets the summed times and bounds."""
    from microstructure_fingerprinting_torch.ops import prep
    err, ms_k, ms_p, nb, ops = 0.0, 0.0, 0.0, 0, {}
    for A, tile, planes in blocks:
        ins = (prep.pad_block(A, tile)[0].contiguous(),) + tuple(rhs)
        kern = lambda: prep.prep_block(*ins, tile, planes, n_rhs=n_rhs)
        plain = lambda: plain_sliced(
            lambda *o: prep.prep_block_twin(*o, tile, planes, n_rhs=n_rhs),
            ins, SLICE["prep_block"])
        shape = "prep %s tile %d, %d rhs" % (tuple(ins[0].shape), tile,
                                             n_rhs)
        outs = kern()
        for what, k, p in zip(("q123", "x", "r", "a", "gram"), outs,
                              plain()):
            if k is not None:
                err = max(err, held("%s %s" % (shape, what), k, p))
        ms_k += timed(kern)
        ms_p += timed(plain)
        nb += nbytes(ins, outs)
        for kind, n in prep_ops(ins[0], n_rhs).items():
            ops[kind] = ops.get(kind, 0.0) + n
    rows[name] = row(err, ms_k, ms_p, nb, ops)


def check_prep_narrow(A, rhs, n_rhs, W_want, S_wide):
    """Kernel 1 at a narrower strip: a few voxels of A with the samples
    padded with zeros up to ``S_wide``, where ``W_want`` is the widest
    strip that fits shared memory, against the plain version."""
    import torch.nn.functional as F
    from microstructure_fingerprinting_torch.ops import prep
    tile, pad = 128, S_wide - A.shape[1]
    ins = [F.pad(t[:4], (0, 0, 0, pad)).contiguous()
           for t in (prep.pad_block(A, tile)[0],) + tuple(rhs)]
    W = prep.strip_width(S_wide, tile, n_rhs)
    if W != W_want:
        raise AssertionError("S = %d selects strips of %d columns, not %d"
                             % (S_wide, W, W_want))
    outs = prep.prep_block(*ins, tile, "xra", n_rhs=n_rhs)
    plain = prep.prep_block_twin(*ins, tile, "xra", n_rhs=n_rhs)
    shape = "prep %s strip width %d, %d rhs" % (tuple(ins[0].shape), W,
                                                 n_rhs)
    for what, k, p in zip(("q123", "x", "r", "a", "gram"), outs, plain):
        held("%s %s" % (shape, what), k, p)


def aten_ops(fn):
    """ATen ops that fn() dispatches, as a ``TorchDispatchMode`` sees
    them (a composite op as the ops it decomposes into; a kernel of this
    package, launched through ctypes, is not one): what a call costs the
    card in kernels besides its own launches."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return len(seen)


def record_ops(name, **fns):
    """``aten_ops`` of each named call, recorded and logged."""
    counts = {k: aten_ops(f) for k, f in fns.items()}
    RECORD.setdefault("aten_ops", {})[name] = counts
    log("%s: ATen ops a call %s" % (name, counts))


def few_samples_ms(name, fn, ops, full_ms, S, **kw):
    """The re-scan launch ``fn`` on the first FEW_SAMPLES samples (operands
    0-7 hold the sample axis): chain and staging with nearly no Gram, so
    the rest of the full time is the Gram tile's share."""
    few = tuple(o[:, :FEW_SAMPLES].contiguous() if k < 8 else o
                for k, o in enumerate(ops))
    ms = timed(lambda: fn(*few, **kw))
    RECORD[name + "_few_samples_ms"] = [FEW_SAMPLES, ms]
    log("%s on %d of %d samples: %.3f ms of %.3f" % (name, FEW_SAMPLES, S,
                                                     ms, full_ms))


def smallest_product(plain):
    """Smallest non-zero |x.hi * y.hi| over the double-float products of
    one run of a plain re-scan (its ``df32.mul_ps`` calls): where the
    kernel multiplies by fused multiply-add, the two forms are the same
    float only above FUSED_EQUALS_DEKKER_ABOVE."""
    import torch
    from microstructure_fingerprinting_torch.ops import df32
    orig, seen = df32.mul_ps, []

    def spy(x, y):
        p = (x[0].double() * y[0].double()).abs()
        p = p[p > 0]
        if p.numel():
            seen.append(p.min())
        return orig(x, y)

    df32.mul_ps = spy
    try:
        plain()
    finally:
        df32.mul_ps = orig
    return float(torch.stack(seen).min())


def check_rescan(name, kern, plain, top1, B, n, n2=None):
    """A re-scan kernel against its plain version on an n x n2 grid (n2
    = n by default): row minima by the agreement rule, first-minimum
    indices and the top-1 exact. Returns (max|err|, the kernel's
    outputs)."""
    import torch
    k, p = kern(), plain()
    what = "%s %d x %d, %d voxels" % (name, n, n if n2 is None else n2, B)
    err = held(what + " row minima", k[0], p[0])
    held(what + " first-minimum index", k[1], p[1], exact=True)
    if not torch.equal(top1(k), top1(p)):
        raise AssertionError(what + ": top-1 candidates differ")
    return err, k


HOIST_NAMES = ("q1a", "q2a", "a1h", "ra", "q1b", "q2b", "rb", "ab",
               "row_pack", "col_pack", "vox")


def check_hoist(what, k, p, flags=(), names=HOIST_NAMES):
    """Kernel 8's, 9's, 10's or 11's outputs ``k`` (``names``) against its
    plain version's ``p``, each by ``held``: the int8 levels exactly, the
    float planes and packs by the agreement rule, and the entries
    ``flags`` ((operand, pack entries) of 0/1 flags) exactly; the NaN
    entries (the padded zero atoms' res1 = 0/0) bit for bit, sign
    included. Returns max|err|."""
    import torch
    err = 0.0
    for name, a, b in zip(names, k, p):
        err = max(err, held("%s %s" % (what, name), a, b,
                            exact=a.dtype == torch.int8))
        if a.dtype == torch.float32:
            nan = torch.isnan(b)
            if not torch.equal(a[nan].view(torch.int32),
                               b[nan].view(torch.int32)):
                raise AssertionError("%s %s: NaN bits differ" % (what, name))
    for k_op, entries in flags:
        held("%s %s flags" % (what, names[k_op]), k[k_op][:, entries],
             p[k_op][:, entries], exact=True)
    return err


def df4_flags(n4):
    """(operand, entries) of the 0/1 flags in kernel 8's packs: rowok of
    each sweep in row_pack, ok34 of each sweep in vox (n3 = 1)."""
    nx, ns = 1 + n4, n4
    r_ok = 12 + 12 * nx + 16 * ns + 1
    return ((8, [r_ok + 3 * s for s in range(ns)]),
            (10, [4 + 6 * nx + 4 * s for s in range(ns)]))


ROW4_NAMES = ("row_pack", "col_pack", "vox", "lo_c_sup", "upf")


def row4_flags(n4):
    """(output, entries) of the 0/1 flags of kernel 11's packs: stab3r,
    stab4r and stabr of every pair in row_pack, stab34 in vox (n3 = 1)."""
    nx = 1 + n4
    rows = ([2 + 5 * x + 4 for x in range(nx)]
            + [2 + 5 * nx + 5 * s + 4 for s in range(n4)])
    return ((0, rows), (2, [1 + nx + 3 * s + 2 for s in range(n4)]))


RHS_NAMES = ("rhs_q", "rhs_r", "rhs_a", "yh", "A3h", "A4h")


def check_rhsprep(y, a3, a4=None):
    """Kernel 13 on a chunk's rhs columns (the signal, the CSF column and
    with ``a4`` the EAR columns) against its plain version: every output
    by ``check_hoist`` (the int8 levels exactly); timed. Returns its row
    (times, bound: the raw columns read once, the packs and the
    normalized columns written once)."""
    from microstructure_fingerprinting_torch.ops import prep
    B, S = y.shape
    n = 1 + a3.shape[2] + (0 if a4 is None else a4.shape[2])
    kern = lambda: prep.rhs_prep(y, a3, a4)
    plain = lambda: prep.rhs_prep_twin(y, a3, a4)
    k, p = kern(), plain()
    what = "rhsprep %d columns, %d voxels" % (n, B)
    live = [i for i, t in enumerate(k) if t is not None]
    err = check_hoist(what, [k[i] for i in live], [p[i] for i in live],
                      names=[RHS_NAMES[i] for i in live])
    r = row(err, timed(kern), timed(plain, reps=1), nbytes(y, a3, a4, k),
            rhs_prep_ops(B, S, n))
    log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)" % (
        what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    return r


def check_row3hoist(A1, A2, a3, y):
    """Kernel 12 on the flagship row pass's inputs against its plain
    version: every output by ``check_hoist`` (the flag stab1 exactly, NaN
    bits, the column lows and the floor), kernel 2 fed both output sets
    (row and column bounds by ``held``); timed, with the function a
    chunk (``rowmin_3``) and the ATen ops of ``rowmin_3_operands`` and its
    plain route. Returns its row (times, bound on the real atoms)."""
    from microstructure_fingerprinting_torch.ops import f32scan
    B, S = y.shape
    n1, n2 = A1.shape[2], A2.shape[2]
    planes, ins = f32scan.rowmin_3_prep(A1, A2, a3, y)
    kern = lambda: f32scan.row3_hoist(*ins)
    plain = lambda: f32scan.row3_hoist_twin(*ins)
    k, p = kern(), plain()
    what = "row3hoist %d x %d, %d voxels" % (n1, n2, B)
    err = check_hoist(what, k, p, ((0, [11]),), ROW4_NAMES)
    fed = [f32scan.rowmin3_rows(*(planes + tuple(o[:3])), n1=n1, n2=n2)
           for o in (k, p)]
    for name, a, b in zip(("lo_row", "up_row", "lo_col"), *fed):
        held("%s: kernel 2 fed both, %s" % (what, name), a, b)
    # the bytes of the real rows and columns: the Gram rows read, the
    # small columns, the packs' entries and the outputs written once
    gA, gB, yh, a3h = ins
    r = row(err, timed(kern), timed(plain, reps=1),
            nbytes(gA[:, :3, :n1], gB[:, :3, :n2], yh, a3h,
                   k[0][:, :12, :n1], k[1][:, :6, :n2], k[2][:, :2],
                   k[3][:, :n2], k[4]),
            row3_hoist_ops(B, S, n1, n2))
    log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)" % (
        what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    del planes, ins, k, p, fed, gA, gB
    # the function a chunk: the JAX rowmin_3 (colmin, as df3_twopass calls
    # it at N2 > R) on the port's route: kernel 13, kernel 1 twice, kernel
    # 12, kernel 2 and the folds
    RECORD["rowmin3_function_ms"] = timed(
        lambda: f32scan.rowmin_3(A1, A2, a3, y, colmin=True))
    few = (A1[:8], A2[:8], a3[:8], y[:8])
    record_ops("rowmin_3_operands %d x %d" % (n1, n2),
               route=lambda: f32scan.rowmin_3_operands(*few),
               plain=lambda: f32scan.rowmin_3_operands_plain(*few))
    return r


def check_df3hoist(what, A1, A2, a3, y):
    """Kernel 10 on the re-scan's inputs (A1, A2, a3, y) against its plain
    version: every operand by ``check_hoist``, then kernel 3 fed both
    operand sets: row minima by ``held``, first-minimum indices and the
    top-1 exact. Returns (max|err|, its row (times, bound) on the real
    atoms)."""
    import torch
    from microstructure_fingerprinting_torch.ops import rescan
    B, S = y.shape
    n1, n2 = A1.shape[2], A2.shape[2]
    *blk, n2pb, _yn = rescan.df3_normalized(A1, A2, a3, y)
    kern = lambda: rescan.df3_hoist(*blk, n2pb)
    plain = lambda: rescan.df3_hoist_twin(*blk, n2pb)
    ops, ops_p = kern(), plain()
    err = check_hoist(what, ops, ops_p)
    segw = rescan.col_blocks(n2)[1] // 8
    seg = rescan.n_segments(n2)
    fed = [rescan.rescan3_rows(*o, n2=n2, segw=segw) for o in (ops, ops_p)]
    held(what + ": kernel 3 fed both, row minima", fed[0][0], fed[1][0])
    held(what + ": kernel 3 fed both, first-minimum index", fed[0][1],
         fed[1][1], exact=True)
    top1 = [rescan.candidates_from_rows(
        f[0].reshape(B, -1), f[1].reshape(B, -1), segments=seg)[0]
        for f in fed]
    if not torch.equal(*top1):
        raise AssertionError(what + ": kernel 3 fed both: top-1 "
                             "candidates differ")
    # the real rows' and columns' bytes: the inputs once, the operands
    # once (a1h is A1h itself, not written)
    cut = lambda i: n1 if i < 4 else n2
    real = [o[..., :cut(i)] for i, o in enumerate(ops) if i not in (2, 8,
                                                                    9, 10)]
    r = row(err, timed(kern), timed(plain, reps=1),
            nbytes(blk[0][..., :n1], blk[1:], real, ops[8][..., :n1],
                   ops[9][..., :n2], ops[10]),
            hoist_ops("df3hoist", B, S, n1, n2, 2))
    log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)" % (
        what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    return err, r


def check_df2(rows, A1, A2, a3, y):
    """Kernels 9 and 6 against their plain versions on the chunk at the
    fit's two shapes, [782, 782] (two fascicles without CSF: A2) and
    [782, 1] (one fascicle + CSF: a3). Kernel 9: every operand by
    ``check_hoist``; kernel 6 fed its operands and the plain ones: row
    minima by ``held``, first i2 and top-1 exact. Kernel 6 against its
    plain version: per-row minima by ``held``, first i2 and the top-1
    candidates of ``df2_candidates(M=1)`` exact (against
    ``df2_candidates_plain``). Both timed; rows["df2hoist"] and
    rows["df2scan"] are the [782, 782] rows; both shapes are recorded."""
    import torch
    from microstructure_fingerprinting_torch.ops import dfscan
    B, S = y.shape
    err = err9 = 0.0
    for name, blk in (("782 x 782", A2), ("782 x 1", a3)):
        n2 = blk.shape[2]
        A1h, A2h, yh, _yn = dfscan.df2_normalized(A1, blk, y)
        n2pb = dfscan.df2_cols(n2)
        kern9 = lambda: dfscan.df2_hoist(A1h, A2h, yh, n2pb)
        plain9 = lambda: dfscan.df2_hoist_twin(A1h, A2h, yh, n2pb)
        ops, ops_p = kern9(), plain9()
        what = "df2hoist %s, %d voxels" % (name, B)
        err9 = max(err9, check_hoist(what, ops, ops_p))
        fed = [dfscan.df2_rows(*o, n1=N_ATOM, n2=n2) for o in (ops, ops_p)]
        held(what + ": kernel 6 fed both, row minima", fed[0][0], fed[1][0])
        held(what + ": kernel 6 fed both, first i2", fed[0][1], fed[1][1],
             exact=True)
        top1 = [dfscan.df2_top1_from_rows(*f, n2)[0] for f in fed]
        if not torch.equal(*top1):
            raise AssertionError(what + ": kernel 6 fed both: top-1 "
                                 "candidates differ")
        # the bytes of the grid's real rows and columns: the inputs once
        # and the operands once (a1h too: kernel 9 writes it)
        r9 = row(0.0, timed(kern9), timed(plain9, reps=1),
                 nbytes(A1h[..., :N_ATOM], A2h, yh,
                        [o[..., :N_ATOM] if i < 4 or i == 8 else
                         (o if i == 10 else o[..., :n2])
                         for i, o in enumerate(ops)]),
                 hoist_ops("df2hoist", B, S, N_ATOM, n2, 1))
        RECORD.setdefault("df2hoist", {})[name] = r9
        log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)"
            % (what, r9["ms"], r9["plain_ms"], r9["bound_ms"],
               r9["bound_by"]))
        record_ops("df2_scan_operands " + name,
                   route=lambda: dfscan.df2_scan_operands(
                       A1[:8], blk[:8], y[:8]),
                   plain=lambda: dfscan.df2_scan_operands_plain(
                       A1[:8], blk[:8], y[:8]))
        if n2 > 1:
            rows["df2hoist"] = dict(r9)
        del fed, ops_p, A1h, A2h, yh
        kern = lambda: dfscan.df2_rows(*ops, n1=N_ATOM, n2=n2)
        plain = lambda: plain_sliced(
            lambda *o: dfscan.df2_rows_twin(*o, n1=N_ATOM, n2=n2), ops,
            SLICE["df2scan"])
        k, p = kern(), plain()
        what = "df2scan %s, %d voxels" % (name, B)
        err = max(err, held(what + " row minima", k[0], p[0]))
        held(what + " first i2", k[1], p[1], exact=True)
        ck = dfscan.df2_candidates(A1, blk, y, M=1)[0]
        cp = plain_sliced(
            lambda a, b_, c: dfscan.df2_candidates_plain(a, b_, c, 1),
            (A1, blk, y), SLICE["df2scan"])[0]
        if not torch.equal(ck, cp):
            raise AssertionError(what + ": top-1 candidates differ")
        # the bytes of the grid's own rows and columns: the operands'
        # padding (rows to N1p, columns to a multiple of 64) is not work
        cut = lambda i: N_ATOM if i in (0, 1, 2, 3, 8) else n2
        real = [o if i == 10 else o[..., :cut(i)] for i, o in enumerate(ops)]
        r = row(0.0, timed(kern), timed(plain, reps=1),
                nbytes(real, [t[:, :N_ATOM] for t in k]),
                scan_ops("df2scan", B, S, N_ATOM, n2))
        RECORD.setdefault("df2scan", {})[name] = r
        log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)"
            % (what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
        if n2 > 1:
            rows["df2scan"] = dict(r)
        del ops, k, p
    rows["df2scan"]["max_abs_err"] = err
    rows["df2hoist"]["max_abs_err"] = err9


def gathered(D, ids, extra=()):
    """The columns a fit's finalize gathers: D[:, k][:, :, ids[:, k]] for
    each fascicle k of ``ids`` (B, K), then the ``extra`` (B, S, 1)
    columns, as one (B, S, C) tensor."""
    import torch
    B, _K, S, _N = D.shape
    idx = torch.as_tensor(ids, dtype=torch.int64, device=D.device)
    cols = [torch.gather(D[:, k], 2, idx[:, None, k:k + 1].expand(B, S, 1))
            for k in range(idx.shape[1])]
    return torch.cat(cols + list(extra), dim=2).contiguous()


def check_finalize(label, cols, y, exact=False):
    """Kernel 7 (``df_nnls_cols`` on the card) against its plain version
    on the same columns: weights and residuals by ``held``; timed.
    Returns the row and records it under ``label``."""
    from microstructure_fingerprinting_torch.ops import dfscan
    kern = lambda: dfscan.df_nnls_cols(cols, y)
    plain = lambda: dfscan.df_nnls_cols_twin(cols, y)
    k, p = kern(), plain()
    what = "finalize %s, C = %d, %d voxels" % (label, cols.shape[2],
                                               cols.shape[0])
    err = max(held(what + " weights", k[0], p[0], exact),
              held(what + " residuals", k[1], p[1], exact))
    r = row(err, timed(kern), timed(plain, reps=1), nbytes(cols, y, k),
            finalize_ops(*cols.shape))
    RECORD.setdefault("finalize", {})[label] = r
    log("%s: kernel %.3f ms vs plain %.3f (bound %.4f, %s)"
        % (what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    return r


def scale_edges(C, S, seed):
    """Voxels whose largest |column| and |y| are 2^k (1 + 2^-23) and
    2^k (1 - 2^-23) for k in -6, -1, 0, 3, 10: where log2 of a float32
    can round onto k, so the kernel's scale must be torch's on the card
    (tests/test_torch_finalize_kernel.py builds the same family)."""
    import torch
    rng = np.random.RandomState(seed)
    out_c, out_y = [], []
    for k in (-6, -1, 0, 3, 10):
        for u in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
            top = np.float32(2.0 ** k * u)
            cols = np.float32(rng.rand(S, C) * 0.9 * top)
            yy = np.float32(cols @ (rng.rand(C) + 0.2))
            yy = np.float32(yy / np.abs(yy).max() * top)
            cols[rng.randint(S, size=C), np.arange(C)] = top
            out_c.append(cols)
            out_y.append(yy)
    on = lambda x: torch.as_tensor(np.stack(x), device="cuda")
    return on(out_c), on(out_y)


def phase_kernels(wl):
    """Kernels 13, 1, 2, 12, 10, 3, 9, 6 and 7 against their plain
    PyTorch versions, on the card, at the flagship path's chunk of CHUNK
    voxels (the re-scan also on the full 782 x 782 grid of the one-pass
    branch and the last overflow tier), and the routes of the row pass,
    the re-scan and the df2 scan a chunk."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan, prep, rescan
    dev = torch.device("cuda")
    D, y, a3 = voxel_inputs(wl, np.arange(CHUNK), wl["y"], dev)
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    del D
    rows = {}
    S = y.shape[1]

    # kernel 13 at 2 rhs columns (signal, CSF), then kernel 1 on its
    # packs: both prep shapes of the row pass
    rows["rhsprep"] = check_rhsprep(y, a3)
    rhs = prep.rhs_prep(y, a3)[:3]
    check_prep(rows, "prep_block", ((A1, 128, "xr"), (A2, 512, "ra")), rhs,
               2)
    for W, S_wide in NARROW_S.items():
        check_prep_narrow(A1, rhs, 2, W, S_wide)

    # kernel 2: the row pass at N1 = N2 = 782
    ops, _ = f32scan.rowmin_3_operands(A1, A2, a3, y)
    kern = lambda: f32scan.rowmin3_rows(*ops, n1=N_ATOM, n2=N_ATOM)
    plain = lambda: plain_sliced(
        lambda *o: f32scan.rowmin3_twin(*o, n1=N_ATOM, n2=N_ATOM), ops,
        SLICE["rowmin3"])
    outs = kern()
    err = max(held("rowmin3 " + name, k, p) for name, k, p in
              zip(("lo_row", "up_row", "lo_col"), outs, plain()))
    n1p, n2p = ops[6].shape[2], ops[7].shape[2]
    rows["rowmin3"] = row(err, timed(kern), timed(plain),
                          nbytes(ops, outs),
                          scan_ops("rowmin3", CHUNK, S, n1p, n2p))
    del ops, outs
    # kernel 12: the row pass's hoists, and the row pass's route a chunk
    rows["row3hoist"] = check_row3hoist(A1, A2, a3, y)
    row3_chunk_cost(A1, A2, a3, y)

    # kernel 10: the re-scan's operands at the two-pass shapes 128 x 128
    # (timed for its row) and 256 x 256 on the chunk, and on the full
    # 782 x 782 grid for 8 voxels, each with kernel 3 fed both operand sets
    err10 = 0.0
    for n, B in ((128, CHUNK), (256, CHUNK), (N_ATOM, 8)):
        e, r = check_df3hoist("df3hoist %d x %d, %d voxels" % (n, n, B),
                              A1[:B, :, :n], A2[:B, :, :n], a3[:B], y[:B])
        err10 = max(err10, e)
        RECORD.setdefault("df3hoist", {})["%d x %d" % (n, n)] = dict(
            r, voxels=B)
        if n == 128:
            rows["df3hoist"] = r
    rows["df3hoist"]["max_abs_err"] = err10

    # kernel 3: the re-scan at the two-pass shape 128 x 128 on the chunk
    # (timed), then on the full 782 x 782 grid for a few voxels
    err = 0.0
    for n, B in ((128, CHUNK), (N_ATOM, 8)):
        ops, segw, _yn = rescan.row_scan_df3_operands(
            A1[:B, :, :n], A2[:B, :, :n], a3[:B], y[:B])
        kern = lambda: rescan.rescan3_rows(*ops, n2=n, segw=segw)
        plain = lambda: plain_sliced(
            lambda *o: rescan.rescan3_twin(*o, n2=n, segw=segw), ops,
            SLICE["rescan3"])
        seg = rescan.n_segments(n)
        top1 = lambda o: rescan.candidates_from_rows(
            o[0].reshape(B, -1), o[1].reshape(B, -1), segments=seg)[0]
        e, outs = check_rescan("rescan3", kern, plain, top1, B, n)
        err = max(err, e)
        if n == 128:
            shape = (B, S, ops[0].shape[2], ops[4].shape[2])
            rows["rescan3"] = row(0.0, timed(kern), timed(plain),
                                  nbytes(ops, outs),
                                  scan_ops("rescan3", *shape))
            RECORD["rescan3_bound_ms_dekker_chain"] = bound(
                nbytes(ops, outs),
                scan_ops("rescan3", *shape, chain=CHAIN_OPS_DEKKER))[0]
            few_samples_ms("rescan3", rescan.rescan3_rows, ops,
                           rows["rescan3"]["ms"], S, n2=n, segw=segw)
            # the function a chunk: kernels 10 and 3 and the normalization
            # around them, as the JAX row_scan_df3 computes
            fn = lambda: rescan.row_scan_df3(A1[:B, :, :n], A2[:B, :, :n],
                                             a3[:B], y[:B])
            RECORD["rescan3_function_ms"] = timed(fn)
            few = (A1[:8, :, :n], A2[:8, :, :n], a3[:8], y[:8])
            record_ops("row_scan_df3_operands %d x %d" % (n, n),
                       route=lambda: rescan.row_scan_df3_operands(*few),
                       plain=lambda: rescan.row_scan_df3_operands_plain(
                           *few))
            log("row_scan_df3 %d x %d, %d voxels: %.3f ms a chunk "
                "(kernel 3 %.3f, kernel 10 %.3f)" % (
                    n, n, B, RECORD["rescan3_function_ms"],
                    rows["rescan3"]["ms"], rows["df3hoist"]["ms"]))
            small = smallest_product(plain)
            RECORD["rescan3_smallest_product"] = small
            log("rescan3: smallest non-zero product of the chain %.3e "
                "(fused = Dekker above %.3e)"
                % (small, FUSED_EQUALS_DEKKER_ABOVE))
            if small < FUSED_EQUALS_DEKKER_ABOVE:
                raise AssertionError("kernel 3 multiplies below the range "
                                     "where fused and Dekker products agree")
        else:
            RECORD["rescan3_full_grid_ms"] = [B, timed(kern), timed(plain)]
        del ops, outs
    rows["rescan3"]["max_abs_err"] = err
    df3_chunk_cost(A1[:, :, :128].contiguous(), A2[:, :, :128].contiguous(),
                   a3, y)

    # kernel 6 at [782, 782] and [782, 1]; kernel 7 on the chunk's planted
    # columns (C = 3: two fascicles + CSF, the flagship's finalize), on one
    # of them alone (C = 1, constructed), and bit for bit at the scales'
    # edges for C = 1-4
    check_df2(rows, A1, A2, a3, y)
    D = torch.stack([A1, A2], dim=1)
    gt = wl["gt_ids"][:CHUNK]
    cols = gathered(D, gt, (a3,))
    del D
    rows["finalize"] = check_finalize("flagship", cols, y)
    e1 = check_finalize("constructed", cols[:, :, :1].contiguous(), y)
    rows["finalize"]["max_abs_err"] = max(rows["finalize"]["max_abs_err"],
                                          e1["max_abs_err"])
    for C in (1, 2, 3, 4):
        check_finalize("scale edges", *scale_edges(C, S, 1200 + C),
                       exact=True)
    RECORD["kernel_check_voxels"] = CHUNK
    log_rows(rows)
    del A1, A2, a3, y, cols
    torch.cuda.empty_cache()
    return rows


def log_rows(rows):
    RECORD.setdefault("kernels", {}).update(rows)
    log("kernel vs plain ms (bound ms) on a %d-voxel chunk: " % CHUNK
        + ", ".join("%s %.3f vs %.3f (%.3f, %s)" % (
            name, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"])
            for name, r in rows.items()))


def ear_inputs(wl, sig_ear, B, device):
    """The flagship inputs of the first B voxels with the EAR block and
    the EAR signals."""
    import torch
    from microstructure_fingerprinting_torch.ops import interp as mfi
    D, _y, a3 = voxel_inputs(wl, np.arange(B), wl["y"], device)
    _r, perm = mfi.make_grouped_rotation_paired(wl["msinterp"], wl["plan"])
    y = torch.as_tensor(wl["y_ear"][:B][:, perm], dtype=torch.float32,
                        device=device)
    a4 = torch.as_tensor(sig_ear[perm], dtype=torch.float32, device=device)
    return D, y, a3, a4[None].expand(B, -1, -1).contiguous()


def check_row4hoist(A1, A2, a3, a4, y):
    """Kernel 11 on the EAR row pass's inputs against its plain version:
    every output by ``check_hoist`` (the flags exactly, NaN bits, the
    column lows and the floor), kernel 4 fed both output sets (row and
    column bounds by ``held``); timed, with the function a chunk
    (``rowmin_4``) and the ATen ops of ``rowmin_4_operands``. Returns its
    row (times, bound on the real atoms)."""
    from microstructure_fingerprinting_torch.ops import f32scan
    B, S = y.shape
    n1, n2, n4 = A1.shape[2], A2.shape[2], a4.shape[2]
    nx, ns = 1 + n4, n4
    planes, ins = f32scan.rowmin_4_prep(A1, A2, a3, a4, y)
    kern = lambda: f32scan.row4_hoist(*ins)
    plain = lambda: f32scan.row4_hoist_twin(*ins)
    k, p = kern(), plain()
    what = "row4hoist %d x %d, %d voxels" % (n1, n2, B)
    err = check_hoist(what, k, p, row4_flags(n4), ROW4_NAMES)
    nr = f32scan.row4_pack_rows(1, n4)[0]
    kw = dict(n1=n1, n2=n2, n3=1, n4=n4, nr=nr)
    fed = [f32scan.rowmin4_rows(*(planes + tuple(o[:3])), **kw)
           for o in (k, p)]
    for name, a, b in zip(("lo_row", "up_row", "lo_col"), *fed):
        held("%s: kernel 4 fed both, %s" % (what, name), a, b)
    # the bytes of the real rows and columns: the Gram rows read, the
    # small columns, the packs' entries and the outputs written once
    ncol, nvox = 2 + 4 * nx + 4 * ns, 1 + nx + 3 * ns
    gA, gB, yh, a3h, a4h = ins
    r = row(err, timed(kern), timed(plain, reps=1),
            nbytes(gA[:, :3 + n4, :n1], gB[:, :3 + n4, :n2], yh, a3h, a4h,
                   k[0][:, :nr + 2, :n1], k[1][:, :ncol, :n2],
                   k[2][:, :nvox], k[3][:, :n2], k[4]),
            row4_hoist_ops(B, S, n1, n2, n4))
    log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)" % (
        what, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))
    del planes, ins, k, p, fed, gA, gB
    # the function a chunk: the JAX rowmin_4 (colmin, as df4_twopass calls
    # it at N2 > R) on the port's route: kernel 1 twice, kernel 11, kernel 4
    # and the folds
    RECORD["rowmin4_function_ms"] = timed(
        lambda: f32scan.rowmin_4(A1, A2, a3, a4, y, colmin=True))
    few = (A1[:8], A2[:8], a3[:8], a4[:8], y[:8])
    record_ops("rowmin_4_operands %d x %d" % (n1, n2),
               route=lambda: f32scan.rowmin_4_operands(*few),
               plain=lambda: f32scan.rowmin_4_operands_plain(*few))
    return r


def phase_ear_kernels(wl, sig_ear):
    """Kernels 13, 1, 11, 4, 8 and 5 against their plain versions at the
    EAR path's shapes: the rhs pack and prep with 12 rhs columns on both
    blocks, the row
    pass's hoists (kernel 11: every output by ``check_hoist``, kernel 4
    fed them and the plain ones; the row pass's route cost a chunk,
    ``row4_chunk_cost``) and the row pass on a CHUNK-voxel chunk at
    [782, 782, 1, 10]; the re-scan's
    operands (kernel 8: every operand by ``check_hoist``, kernel 5 fed
    them and the plain ones agreeing with the same top-1) and the
    re-scan at the two-pass shape R_EAR x R_EAR on the chunk and on the
    full grid for 8 voxels; then the re-scan's route cost a chunk
    (``df4_chunk_cost``)."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan, prep, rescan
    dev = torch.device("cuda")
    D, y, a3, a4 = ear_inputs(wl, sig_ear, CHUNK, dev)
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    del D
    rows = {}
    S = y.shape[1]
    nx, ns = 1 + N_EAR, N_EAR

    # kernel 13 at 12 rhs columns (signal, CSF, 10 EAR atoms), then kernel
    # 1 on its packs
    rows["rhsprep_ear"] = check_rhsprep(y, a3, a4)
    rhs = prep.rhs_prep(y, a3, a4)[:3]
    NB, N2B = rescan.col_blocks(N_ATOM, 512, 16)
    check_prep(rows, "prep_block_ear", ((A1, 128, "xr"), (A2, N2B, "ra")),
               rhs, 2 + N_EAR)

    # kernel 11: the row pass's hoists, and the row pass's route a chunk
    rows["row4hoist"] = check_row4hoist(A1, A2, a3, a4, y)
    row4_chunk_cost(A1, A2, a3, a4, y)

    # kernel 4: the EAR row pass at N1 = N2 = 782
    ops, nr, _ = f32scan.rowmin_4_operands(A1, A2, a3, a4, y)
    kw = dict(n1=N_ATOM, n2=N_ATOM, n3=1, n4=N_EAR, nr=nr)
    kern = lambda: f32scan.rowmin4_rows(*ops, **kw)
    plain = lambda: plain_sliced(
        lambda *o: f32scan.rowmin4_twin(*o, **kw), ops, SLICE["rowmin4"])
    outs = kern()
    err = max(held("rowmin4 " + name, k, p) for name, k, p in
              zip(("lo_row", "up_row", "lo_col"), outs, plain()))
    n1p, n2p = ops[6].shape[2], ops[7].shape[2]
    rows["rowmin4"] = row(err, timed(kern), timed(plain, reps=1),
                          nbytes(ops, outs),
                          scan_ops("rowmin4", CHUNK, S, n1p, n2p, nx, ns))
    RECORD["rowmin4_packs"] = [ops[6].shape[1], ops[7].shape[1],
                               ops[8].shape[1]]
    del ops, outs

    # kernels 8 and 5: the re-scan's operands and the re-scan at R_EAR x
    # R_EAR on the chunk (timed), then on the full 782 x 782 grid for 8
    # voxels (rows padded to 896, columns to 1024)
    err = err8 = 0.0
    for n, B in ((R_EAR, CHUNK), (N_ATOM, 8)):
        *blk, n2pb, _yn = rescan.df4_normalized(
            A1[:B, :, :n], A2[:B, :, :n], a3[:B], a4[:B], y[:B])
        kern8 = lambda: rescan.df4_hoist(*blk, n2pb)
        plain8 = lambda: rescan.df4_hoist_twin(*blk, n2pb)
        ops, ops_p = kern8(), plain8()
        what = "df4hoist %d x %d, %d voxels" % (n, n, B)
        err8 = max(err8, check_hoist(what, ops, ops_p, df4_flags(N_EAR)))
        segw = rescan.col_blocks(n, 256, 16)[1]
        kw = dict(n2=n, n3=1, n4=N_EAR, segw=segw)
        seg = rescan.n_segments_df4(n)
        top1 = lambda o: rescan.candidates_from_rows_df4(
            o[0].reshape(B, -1), o[1].reshape(B, -1), ns, N_EAR, n,
            segments_total=seg)[0]
        fed = [rescan.rescan4_rows(*o, **kw) for o in (ops, ops_p)]
        held(what + ": kernel 5 fed both, row minima", fed[0][0], fed[1][0])
        held(what + ": kernel 5 fed both, first flat index", fed[0][1],
             fed[1][1], exact=True)
        if not torch.equal(top1(fed[0]), top1(fed[1])):
            raise AssertionError(what + ": kernel 5 fed both: top-1 "
                                 "candidates differ")
        # the real rows' and columns' bytes: the inputs once, the operands
        # once (a1h is A1h itself, not written)
        real = [o[..., :n] for i, o in enumerate(ops) if i not in (2, 10)]
        if n == R_EAR:
            rows["df4hoist"] = row(
                0.0, timed(kern8), timed(plain8, reps=1),
                nbytes([b_[..., :n] for b_ in blk[:2]], blk[2:], real,
                       ops[10]),
                hoist_ops("df4hoist", B, S, n, n, 2 + N_EAR, nx, ns))
            log("%s: kernel %.3f ms vs plain %.3f (bound %.3f, %s)" % (
                what, rows["df4hoist"]["ms"], rows["df4hoist"]["plain_ms"],
                rows["df4hoist"]["bound_ms"], rows["df4hoist"]["bound_by"]))
        else:
            RECORD["df4hoist_full_grid_ms"] = [B, timed(kern8),
                                               timed(plain8, reps=1)]
        del ops_p, fed, blk
        kern = lambda: rescan.rescan4_rows(*ops, **kw)
        plain = lambda: plain_sliced(
            lambda *o: rescan.rescan4_twin(*o, **kw), ops, SLICE["rescan4"])
        e, outs = check_rescan("rescan4", kern, plain, top1, B, n)
        err = max(err, e)
        if n == R_EAR:
            rows["rescan4"] = row(0.0, timed(kern), timed(plain),
                                  nbytes(ops, outs),
                                  scan_ops("rescan4", B, S, ops[0].shape[2],
                                           ops[4].shape[2], nx, ns))
            RECORD["rescan4_packs"] = [ops[8].shape[1], ops[9].shape[1],
                                       ops[10].shape[1]]
            RECORD["rescan4_bound_ms_dekker_chain"] = bound(
                nbytes(ops, outs), scan_ops(
                    "rescan4", B, S, ops[0].shape[2], ops[4].shape[2], nx,
                    ns, chain=CHAIN_OPS_DEKKER))[0]
            few_samples_ms("rescan4", rescan.rescan4_rows, ops,
                           rows["rescan4"]["ms"], S, **kw)
        else:
            RECORD["rescan4_full_grid_ms"] = [B, timed(kern), timed(plain)]
        del ops, outs
    rows["rescan4"]["max_abs_err"] = err
    rows["df4hoist"]["max_abs_err"] = err8
    few = (A1[:8, :, :R_EAR], A2[:8, :, :R_EAR], a3[:8], a4[:8], y[:8])
    record_ops("row_scan_df4_operands %d x %d" % (R_EAR, R_EAR),
               route=lambda: rescan.row_scan_df4_operands(*few),
               plain=lambda: rescan.row_scan_df4_operands_plain(*few))
    df4_chunk_cost(A1[:, :, :R_EAR].contiguous(),
                   A2[:, :, :R_EAR].contiguous(), a3, a4, y)
    # kernel 7 on the chunk's planted columns: two fascicles, CSF and EAR
    # atom EAR_ATOM (C = 4, the EAR finalize)
    cols = gathered(torch.stack([A1, A2], dim=1), wl["gt_ids"][:CHUNK],
                    (a3, a4[:, :, EAR_ATOM:EAR_ATOM + 1]))
    FINALIZE_ERR.append(check_finalize("EAR", cols, y)["max_abs_err"])
    del cols
    log_rows(rows)
    del A1, A2, a3, a4, y
    torch.cuda.empty_cache()
    return rows


def make_volume(wl, ys):
    side = round(N_VOX ** (1 / 3))
    shape = (side, side, side)
    S = ys.shape[1]
    data = ys.reshape(shape + (S,))
    peaks = wl["peaks"].reshape(shape + (6,))
    return data, np.ones(shape), np.full(shape, 2.0), peaks


def fit_dictionary(wl, sig_ear=None):
    import microstructure_fingerprinting_torch as mft
    sig, dpar, _dperp = mft.testing.make_dictionary(wl["sch_mat"], N_ATOM)
    dic = {"dictionary": sig, "sch_mat": wl["sch_mat"],
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": N_ATOM,
           "fasc_propnames": ["atom_id", "dpar"],
           "atom_id": np.arange(N_ATOM, dtype=float), "dpar": dpar,
           "T2_csf": 2.0, "DIFF_csf": 3.0e-9}
    if sig_ear is not None:
        dic.update(T2_ear=0.8, DIFF_ear=wl["Dear"], num_ear=N_EAR)
    return dic


def cold_fit(label, model, args, kw, path):
    """The fit of one path with every launch count set to 0 just before
    it and read just after: every kernel of ``path`` must have run.
    Returns (fit, launches, seconds)."""
    import torch
    import microstructure_fingerprinting_torch as mft
    mft.reset_counts()
    t0 = time.time()
    fit = model.fit(*args, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {k: mft.LAUNCHES[k] for k in path}
    log("%s: cold fit of %d voxels: %.2f s; kernel launches %s"
        % (label, args[0][..., 0].size, cold_s, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the %s path was never launched"
                             % label)
    # kernels 8, 9, 10, 11 and 12 build the operands of one launch of 5,
    # 6, 3, 4 and 2 each, kernel 13 the rhs columns of one row pass
    for hoist, scan in (("df4hoist", "rescan4"), ("df2hoist", "df2scan"),
                        ("df3hoist", "rescan3"), ("row4hoist", "rowmin4"),
                        ("row3hoist", "rowmin3")):
        if hoist in launches and launches[hoist] != launches[scan]:
            raise AssertionError("%s: %d launches of %s, %d of %s" % (
                label, launches[hoist], hoist, launches[scan], scan))
    row_passes = mft.LAUNCHES["rowmin3"] + mft.LAUNCHES["rowmin4"]
    if mft.LAUNCHES["rhsprep"] != row_passes:
        raise AssertionError("%s: %d launches of rhsprep, %d row passes" % (
            label, mft.LAUNCHES["rhsprep"], row_passes))
    return fit, launches, cold_s


def planted_objectives(wl, vox, ys_np, gt, K, csf, sig_ear, ear):
    """Objectives of the planted supports of the workload's voxels
    ``vox`` (fascicle ids ``gt``, CSF index 0, with EAR the atom EAR_ATOM
    of ``sig_ear``) on the rotated columns the fit used, by the
    double-float finalize on the card, bucket by bucket (K, csf and ear
    per voxel)."""
    import torch
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import interp as mfi
    _r, perm = mfi.make_grouped_rotation_paired(wl["msinterp"], wl["plan"])
    on_card = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                        device="cuda")
    ear_d = on_card(sig_ear[perm]) if sig_ear is not None else None
    out = np.zeros(vox.size)
    for k, c, e in sorted(set(zip(K[vox].tolist(), csf[vox].tolist(),
                                  ear[vox].tolist()))):
        sel = np.flatnonzero((K[vox] == k) & (csf[vox] == c)
                             & (ear[vox] == e))
        v = vox[sel]
        D, y, a3 = voxel_inputs(wl, v, ys_np, "cuda")
        cand = np.concatenate(
            [gt[v, :k], np.zeros((v.size, int(c))),
             np.full((v.size, int(e)), EAR_ATOM)], axis=1)
        _w, obj, _r2 = fit_mod._finalize_top1(
            D, a3[0, :, 0], ear_d if e else None, y,
            torch.as_tensor(cand, dtype=torch.int64, device="cuda"),
            csf_on=bool(c), ear_on=bool(e), K=k)
        out[sel] = obj.double().cpu().numpy()
    return out


def check_recovery(label, wl, fit, ys_np, gt, K, csf, sig_ear, ear=None,
                   dear=None):
    """Every voxel must recover its planted atoms (gt (n, 2), -1 where a
    fascicle is absent; with EAR also ie = EAR_ATOM) or an objective at
    most the planted one's plus 2e-9 ||y||^2, at R^2 >= 1 - 1e-6. K, csf
    and ear (n,) give each voxel's bucket; ear defaults to every voxel
    when ``sig_ear`` is given, none otherwise, and ``dear`` (the EAR
    diffusivities) to the workload's. Returns (equal-or-better
    objectives, min R^2)."""
    n, S = ys_np.shape
    if ear is None:
        ear = np.full(n, sig_ear is not None)
    dear = wl["Dear"] if dear is None else dear
    r2 = fit.R2.reshape(-1)
    if not np.all(r2 >= 1 - 1e-6):
        raise AssertionError("R2 below 1 - 1e-6 in %d voxels (min %.9f)"
                             % (int(np.sum(r2 < 1 - 1e-6)), r2.min()))
    ids = [fit.atom_id_f0.reshape(-1), fit.atom_id_f1.reshape(-1)]
    want = [np.maximum(gt[:, 0], 0), np.maximum(gt[:, 1], 0)]
    if ear.any():
        d_ear = fit.D_ear.reshape(-1)
        ids.append(np.where(ear, np.argmin(
            np.abs(d_ear[:, None] - dear[None]), axis=1), 0))
        want.append(np.where(ear, EAR_ATOM, 0))
    ids = np.stack(ids, axis=1).astype(np.int64)
    want = np.stack(want, axis=1)
    diff = np.flatnonzero(np.any(ids != want, axis=1))
    ysq = np.sum(ys_np ** 2, axis=1)
    obj = fit.MSE.reshape(-1) * S
    n_tie = 0
    if diff.size:
        obj_gt = planted_objectives(wl, diff, ys_np, gt, K, csf, sig_ear,
                                    ear)
        for k, v in enumerate(diff):
            tie = obj[v] <= obj_gt[k] + 2e-9 * ysq[v]
            log("%s voxel %d (K=%d, csf=%d, ear=%d): selected %s, planted "
                "%s, objective %.6e vs planted %.6e -> %s" % (
                    label, v, K[v], csf[v], ear[v], ids[v].tolist(),
                    want[v].tolist(), obj[v], obj_gt[k],
                    "tie" if tie else "ERROR"))
            if not tie:
                raise AssertionError("voxel %d selected a worse support" % v)
            n_tie += 1
    log("%s: planted atoms recovered in %d/%d voxels (%d equal-or-better "
        "objectives); min R2 %.9f; max MSE/||y||^2 %.3e" % (
            label, n - diff.size, n, n_tie, r2.min(), np.max(obj / ysq)))
    return n_tie, float(r2.min())


def check_maps(label, fit, ear):
    """The maps must reload identically (and hold the EAR maps)."""
    from microstructure_fingerprinting_torch.utils import nifti
    with tempfile.TemporaryDirectory() as tmp:
        files = fit.write_nifti(os.path.join(tmp, "mf.nii.gz"),
                                affine=np.eye(4))
        for fname, p in zip(files, fit.param_names):
            back = nifti.load(fname).get_fdata()
            if not np.array_equal(back, getattr(fit, p)):
                raise AssertionError("map %s did not reload identically" % p)
    if ear and not {"frac_ear", "D_ear"} <= set(fit.param_names):
        raise AssertionError("the EAR maps were not written")
    log("%s: wrote and reloaded %d maps (%s)" % (label, len(files),
                                                ", ".join(fit.param_names)))


def bucket_walls(text):
    """{"K=.. csf=.. ear=..: wall ms": ms} from a fit's verbose-2 lines:
    a bucket's "dispatched" plus its "pulled" time (every bucket is
    queued before the first pull, so a bucket's pull also waits for the
    device work queued before it)."""
    out = {}
    for m in re.finditer(r"Bucket (K=\d csf=\d ear=\d) \(\d+ voxels\) "
                         r"(?:dispatched|pulled) in (\S+) second", text):
        key = "%s: wall ms" % m.group(1)
        out[key] = out.get(key, 0.0) + 1e3 * float(m.group(2))
    return out


def warm_fits(label, model, args, kw, launches, split=()):
    """WARM_FITS warm fits as a user runs them (no stage timer: every
    chunk step a CUDA graph replay): host wall clock around the fit for
    voxels/s, and per bucket its wall time ("dispatched" plus "pulled"
    at verbose 2). Then one fit under the stage timer, which runs the
    steps eagerly (two event records a region, no synchronisation
    inside the fit): device time per stage and, per bucket, the device
    time of the stages inside it. Each launch is a stage of its own
    inside the stage that holds it: for each (stage, kernels) of
    ``split`` what is left of the stage is its torch code (hoists), and
    every launch of those kernels in the fit must lie inside that stage,
    or the split would understate the hoists. Returns the record of the
    runs."""
    import torch
    from microstructure_fingerprinting_torch.utils import profiling
    n_vox = args[0][..., 0].size
    card = card_line()
    warm_s, buckets = [], []
    for _ in range(WARM_FITS):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t0 = time.time()
            model.fit(*args, **dict(kw, verbose=2))
            torch.cuda.synchronize()
            warm_s.append(time.time() - t0)
        buckets.append(bucket_walls(out.getvalue()))
    with profiling.StageTimer() as st, \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.time()
        model.fit(*args, **kw)
        torch.cuda.synchronize()
        timer_s = time.time() - t0
    totals = st.totals_ms()
    stages = {k: v for k, v in totals.items()
              if not k.startswith(("kernel ", "bucket "))}
    for stage_name, kernel_names in split:
        torch_ms = stages[stage_name]
        for kernel in kernel_names:
            k_ms, n = st.inside(stage_name).get("kernel " + kernel,
                                                (0.0, 0))
            if n != launches[kernel]:
                raise AssertionError(
                    "%d of the fit's %d launches of %s lie inside stage %s"
                    % (n, launches[kernel], kernel, stage_name))
            stages["%s: kernel %s" % (stage_name, kernel)] = k_ms
            torch_ms -= k_ms
        stages[stage_name + ": torch hoists"] = torch_ms
    per = {}
    for name in totals:
        if name.startswith("bucket "):
            for inner, (ms, _n) in st.inside(name).items():
                per["%s: %s ms" % (name[len("bucket "):], inner)] = ms
    vps = spread([n_vox / s for s in warm_s])
    log("%s: %d warm fits (graph replays): %s s; voxels/s median %.1f "
        "(min %.1f, max %.1f); one eager fit under the stage timer %.3f s "
        "[%s]" % (label, WARM_FITS, ", ".join("%.3f" % s for s in warm_s),
                  vps["median"], vps["min"], vps["max"], timer_s, card))
    log("%s: stages, device ms of the eager fit under the timer: " % label
        + ", ".join("%s %.1f" % (k, v) for k, v in stages.items()))
    per_bucket = {k: spread([b.get(k, 0.0) for b in buckets])
                  for k in buckets[0]}
    log("%s: buckets, wall ms median (min-max) of the %d warm fits: " % (
        label, WARM_FITS) + ", ".join(
            "%s %.1f (%.1f-%.1f)" % (k, v["median"], v["min"], v["max"])
            for k, v in sorted(per_bucket.items())))
    log("%s: buckets, device ms of their stages in the eager fit: " % label
        + ", ".join("%s %.1f" % (k, v) for k, v in sorted(per.items())))
    return dict(warm_fit_s=warm_s, voxels_per_s=vps, timer_fit_s=timer_s,
                stages_ms=stages, buckets_wall_ms=per_bucket,
                buckets_stage_ms=per, card=card,
                route="warm fits: graph replays, no stage timer; stages: "
                      "one eager fit under the stage timer")


def volume(wl, label, sig_ear=None):
    """The volume of a fit phase: ``label`` "flagship" or "EAR" (the
    N_VOX workload voxels, 2 fascicles + CSF, with EAR csf_mask =
    ear_mask = 1), "mixed" / "ear_mixed" (MIXED / EAR_MIXED) or
    "general" (GENERAL, csf_mask = 0). Returns (model, args, kw, mix):
    ``mix`` is ``testing.make_mixed``'s record (None for the first two);
    the model's EAR block is ``sig_ear`` where the volume has EAR."""
    import microstructure_fingerprinting_torch as mft
    S = wl["sch_mat"].shape[0]
    if label in ("flagship", "EAR"):
        ear = sig_ear if label == "EAR" else None
        data, mask, numfasc, peaks = make_volume(
            wl, wl["y_ear"] if ear is not None else wl["y"])
        kw = dict(peaks=peaks, pgse_scheme=wl["sch_mat"], csf_mask=1,
                  verbose=0)
        if ear is not None:
            kw["ear_mask"] = 1
        return (mft.MFModel(fit_dictionary(wl, ear)), (data, mask, numfasc),
                kw, None)
    spec, ear = {"mixed": (MIXED, None), "ear_mixed": (EAR_MIXED, sig_ear),
                 "general": (GENERAL, sig_ear)}[label]
    mix = mft.testing.make_mixed(wl, spec["groups"], ear, ear_atom=EAR_ATOM)
    shape = spec["shape"]
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"], verbose=0,
              csf_mask=mix["csf_mask"].reshape(shape).astype(float))
    if label == "ear_mixed":
        kw["ear_mask"] = 1
    elif label == "general":
        kw.update(csf_mask=0,
                  ear_mask=mix["ear_mask"].reshape(shape).astype(float))
    return mft.MFModel(fit_dictionary(wl, ear)), args, kw, mix


def phase_fit(wl, sig_ear=None):
    """One main path through MFModel.fit, cold (launch counts) and
    WARM_FITS times warm (voxels/s, stages): the flagship volume, or with
    ``sig_ear`` the EAR volume (csf_mask = ear_mask = 1). Every voxel must
    recover its planted atoms (with EAR: also ie = 4) or an objective at
    most the planted one's plus 2e-9 ||y||^2, at R^2 >= 1 - 1e-6; the maps
    must reload identically."""
    ear = sig_ear is not None
    label = "EAR" if ear else "flagship"
    ys_np = wl["y_ear"] if ear else wl["y"]
    model, args, kw, _mix = volume(wl, label, sig_ear)
    path = ("rhsprep", "prep_block", "row4hoist", "rowmin4", "rescan4",
            "df4hoist", "finalize") if ear else (
        "rhsprep", "prep_block", "row3hoist", "rowmin3", "rescan3",
        "df3hoist", "finalize")
    fit, launches, cold_s = cold_fit(label, model, args, kw, path)
    n_tie, min_r2 = check_recovery(label, wl, fit, ys_np, wl["gt_ids"],
                                   np.full(N_VOX, 2), np.ones(N_VOX, bool),
                                   sig_ear)
    check_maps(label, fit, ear)
    RECORD[label] = dict(
        cold_fit_s=cold_s, launches=launches, n_ties=n_tie, min_r2=min_r2,
        **warm_fits(label, model, args, kw, launches,
                    split=(("prep", ("rhsprep", "prep_block",
                                     "row4hoist" if ear else "row3hoist")),
                           ("re-scan", ("rescan4", "df4hoist") if ear
                            else ("rescan3", "df3hoist")),
                           ("finalize", ("finalize",)))))
    return launches


def check_rescan3_ear_grid(wl, mix, sig_ear):
    """Kernels 10 and 3 on the one-fascicle + CSF + EAR bucket's full
    [782, 10, 1] grid (the EAR atoms as the second axis, CSF the fixed
    third block), on the chunk of that bucket's CHUNK voxels that the fit
    gives it, against their plain versions (kernel 3 also fed both
    operand sets); timed. Returns (kernel 3's row, kernel 10's row)."""
    import torch
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.ops import rescan
    vox = mix["buckets"][(1, True)][:CHUNK]
    D, y, a3 = voxel_inputs(wl, vox, mix["y"], "cuda")
    A1 = D[:, 0].contiguous()
    del D
    B, S = y.shape
    _r, perm = mfi.make_grouped_rotation_paired(wl["msinterp"], wl["plan"])
    a4 = torch.as_tensor(sig_ear[perm], dtype=torch.float32, device="cuda")
    a4 = a4[None].expand(B, -1, -1)
    _e, r10 = check_df3hoist("df3hoist %d x %d EAR grid, %d voxels" % (
        N_ATOM, N_EAR, B), A1, a4, a3, y)
    RECORD["df3hoist_ear_grid"] = dict(r10, voxels=B)
    ops, segw, _yn = rescan.row_scan_df3_operands(A1, a4, a3, y)
    kern = lambda: rescan.rescan3_rows(*ops, n2=N_EAR, segw=segw)
    plain = lambda: plain_sliced(
        lambda *o: rescan.rescan3_twin(*o, n2=N_EAR, segw=segw), ops,
        SLICE["rescan3_ear"])
    seg = rescan.n_segments(N_EAR)
    top1 = lambda o: rescan.candidates_from_rows(
        o[0].reshape(B, -1), o[1].reshape(B, -1), segments=seg)[0]
    err, outs = check_rescan("rescan3 EAR grid", kern, plain, top1, B,
                             N_ATOM, N_EAR)
    # the bound counts the grid's real points, not its padded columns
    r = row(err, timed(kern), timed(plain), nbytes(ops, outs),
            scan_ops("rescan3", B, S, N_ATOM, N_EAR))
    RECORD["rescan3_ear_grid"] = dict(r, voxels=B, padded_columns=
                                      ops[4].shape[2])
    log("rescan3 on the %d x %d EAR grid, %d voxels: %.3f ms vs plain "
        "%.3f (bound %.3f, %s)" % (N_ATOM, N_EAR, B, r["ms"],
                                   r["plain_ms"], r["bound_ms"],
                                   r["bound_by"]))
    return r, r10


ROUTE_TURNS = ("plain", "plain hoists", "kernel", "kernel", "plain hoists",
               "plain")


def route_cost(label, routes):
    """The callables of ``routes`` (route name -> fn) in ROUTE_TURNS:
    device ms of each (two runs a turn) and the most memory each
    allocates above what was held before it. Returns the record."""
    import torch
    rec = {}
    for route in ROUTE_TURNS:
        fn = routes[route]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = timed(fn, reps=1 if route == "plain" else 2)
        r = rec.setdefault(route, {"ms": [], "peak_bytes": []})
        r["ms"].append(ms)
        r["peak_bytes"].append(peak)
    log("%s, %d voxels, a chunk in turns: " % (label, CHUNK) + "; ".join(
        "%s %s ms, peak %s GB above its inputs" % (
            route, "/".join("%.3f" % m for m in r["ms"]),
            "/".join("%.2f" % (b / 1e9) for b in r["peak_bytes"]))
        for route, r in rec.items()) + " [%s]" % card_line())
    return rec


def df2_chunk_cost(wl):
    """The df2 scan (``dfscan.df2_candidates``, M = 1) on one CHUNK-voxel
    chunk at both of its shapes, [782, 782] (two fascicles without CSF)
    and [782, 1] (one fascicle + CSF), in turns (``route_cost``): the
    fit's route ("kernel": kernels 9 and 6 and the cross-row minimum),
    the same with the hoists' plain version ("plain hoists":
    ``df2_scan_operands_plain`` before kernel 6, the route before kernel
    9) and the eager plain version ("plain": ``df2_candidates_plain``)."""
    import torch
    from microstructure_fingerprinting_torch.ops import dfscan
    D, y, a3 = voxel_inputs(wl, np.arange(CHUNK), wl["y"], "cuda")
    out = {}
    for name, A2 in (("782 x 782", D[:, 1]), ("782 x 1", a3)):
        def hoists_plain():
            ops, _yn = dfscan.df2_scan_operands_plain(D[:, 0], A2, y)
            rv, ri = dfscan.df2_rows(*ops, n1=N_ATOM, n2=A2.shape[2])
            return dfscan.df2_top1_from_rows(rv, ri, A2.shape[2])
        out[name] = route_cost("df2 scan " + name, {
            "kernel": lambda: dfscan.df2_candidates(D[:, 0], A2, y, M=1),
            "plain hoists": hoists_plain,
            "plain": lambda: dfscan.df2_candidates_plain(D[:, 0], A2, y,
                                                         1)})
    RECORD["df2_chunk"] = out
    del D, y, a3
    torch.cuda.empty_cache()


def df3_chunk_cost(A1, A2, a3, y):
    """The re-scan (``rescan.row_scan_df3`` and its top-1) on one chunk
    at the flagship's two-pass shape (the width of A1 and A2), in turns
    (``route_cost``): the fit's route ("kernel": kernels 10 and 3), the
    same with the hoists' plain version ("plain hoists":
    ``row_scan_df3_operands_plain`` before kernel 3, the route before
    kernel 10) and the plain version of both ("plain": kernel 3's plain
    version over slices of SLICE["rescan3"] voxels)."""
    import torch
    from microstructure_fingerprinting_torch.ops import rescan
    B, n = y.shape[0], A1.shape[2]
    seg = rescan.n_segments(n)
    top1 = lambda res, idx: rescan.candidates_from_rows(
        res.reshape(B, -1), idx.reshape(B, -1), segments=seg)

    def route(rows):
        ops, segw, _yn = rescan.row_scan_df3_operands_plain(A1, A2, a3, y)
        return top1(*rows(ops, segw))

    kern3 = lambda ops, segw: rescan.rescan3_rows(*ops, n2=n, segw=segw)
    plain3 = lambda ops, segw: plain_sliced(
        lambda *o: rescan.rescan3_twin(*o, n2=n, segw=segw), ops,
        SLICE["rescan3"])
    RECORD["df3_chunk"] = route_cost("df3 re-scan %d x %d" % (n, n), {
        "kernel": lambda: top1(*rescan.row_scan_df3(A1, A2, a3, y)[:2]),
        "plain hoists": lambda: route(kern3),
        "plain": lambda: route(plain3)})
    torch.cuda.empty_cache()


def row3_chunk_cost(A1, A2, a3, y):
    """The flagship row pass (``f32scan.rowmin_3`` with column minima, as
    ``df3_twopass`` calls it at N2 > R) on one chunk at 782 x 782, in turns
    (``route_cost``): the fit's route ("kernel": kernel 13, kernel 1
    twice, kernel 12, kernel 2 and the folds), the same with the plain
    versions of kernels 13 and 12 ("plain hoists":
    ``rowmin_3_operands_plain`` before kernel 2, the route before them)
    and the plain hoists with kernel 2's plain version ("plain", over
    slices of SLICE["rowmin3"] voxels; kernel 1 stays: its plain version
    is timed on its own row)."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan
    n1, n2 = A1.shape[2], A2.shape[2]

    def route(rows):
        ops, (lo_c, upf) = f32scan.rowmin_3_operands_plain(A1, A2, a3, y)
        lo, up, lo_col = rows(ops)
        return lo, up, upf, torch.minimum(lo_col[:, :n2], lo_c[:, :n2])

    kern2 = lambda ops: f32scan.rowmin3_rows(*ops, n1=n1, n2=n2)
    plain2 = lambda ops: plain_sliced(
        lambda *o: f32scan.rowmin3_twin(*o, n1=n1, n2=n2), ops,
        SLICE["rowmin3"])
    RECORD["row3_chunk"] = route_cost("row pass %d x %d" % (n1, n2), {
        "kernel": lambda: f32scan.rowmin_3(A1, A2, a3, y, colmin=True),
        "plain hoists": lambda: route(kern2),
        "plain": lambda: route(plain2)})
    torch.cuda.empty_cache()


def row4_chunk_cost(A1, A2, a3, a4, y):
    """The EAR row pass (``f32scan.rowmin_4`` with column minima, as
    ``df4_twopass`` calls it at N2 > R) on one chunk at 782 x 782, in turns
    (``route_cost``): the fit's route ("kernel": kernel 13, kernel 1
    twice, kernel 11, kernel 4 and the folds), the same with the plain
    versions of kernels 13 and 11 ("plain hoists":
    ``rowmin_4_operands_plain`` before kernel 4, the route before them)
    and the plain hoists with kernel 4's plain
    version ("plain", over slices of SLICE["rowmin4"] voxels; kernel 1
    stays: its plain version is timed on its own row)."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan
    n1, n2 = A1.shape[2], A2.shape[2]
    kw = dict(n1=n1, n2=n2, n3=1, n4=a4.shape[2])

    def route(rows):
        ops, nr, (lo_c, upf) = f32scan.rowmin_4_operands_plain(A1, A2, a3,
                                                               a4, y)
        lo, up, lo_col = rows(ops, dict(kw, nr=nr))
        return lo, up, upf, torch.minimum(lo_col[:, :n2], lo_c[:, :n2])

    kern4 = lambda ops, k: f32scan.rowmin4_rows(*ops, **k)
    plain4 = lambda ops, k: plain_sliced(
        lambda *o: f32scan.rowmin4_twin(*o, **k), ops, SLICE["rowmin4"])
    RECORD["row4_chunk"] = route_cost("EAR row pass %d x %d" % (n1, n2), {
        "kernel": lambda: f32scan.rowmin_4(A1, A2, a3, a4, y, colmin=True),
        "plain hoists": lambda: route(kern4),
        "plain": lambda: route(plain4)})
    torch.cuda.empty_cache()


def df4_chunk_cost(A1, A2, a3, a4, y):
    """The 4-block re-scan (``rescan.row_scan_df4`` and its top-1) on one
    EAR chunk at the two-pass shape R_EAR x R_EAR, in turns
    (``route_cost``): the fit's route ("kernel": kernels 8 and 5), the
    same with the hoists' plain version ("plain hoists":
    ``row_scan_df4_operands_plain`` before kernel 5, the route before
    kernel 8) and the plain version of both ("plain": kernel 5's plain
    version over slices of SLICE["rescan4"] voxels, which bound its
    temporaries)."""
    import torch
    from microstructure_fingerprinting_torch.ops import rescan
    B = y.shape[0]
    seg = rescan.n_segments_df4(R_EAR)

    def route(operands, rows):
        ops, segw, _yn = operands(A1, A2, a3, a4, y)
        res, idx = rows(ops, dict(n2=R_EAR, n3=1, n4=N_EAR, segw=segw))
        return rescan.candidates_from_rows_df4(
            res.reshape(B, -1), idx.reshape(B, -1), N_EAR, N_EAR, R_EAR,
            segments_total=seg)

    kern5 = lambda ops, kw: rescan.rescan4_rows(*ops, **kw)
    plain5 = lambda ops, kw: plain_sliced(
        lambda *o: rescan.rescan4_twin(*o, **kw), ops, SLICE["rescan4"])
    RECORD["df4_chunk"] = route_cost("df4 re-scan %d x %d" % (R_EAR, R_EAR), {
        "kernel": lambda: rescan.candidates_from_rows_df4(
            *rescan.row_scan_df4(A1, A2, a3, a4, y)[:2], N_EAR, N_EAR,
            R_EAR, segments_total=seg),
        "plain hoists": lambda: route(rescan.row_scan_df4_operands_plain,
                                      kern5),
        "plain": lambda: route(rescan.row_scan_df4_operands_plain, plain5)})
    torch.cuda.empty_cache()


def check_finalize_mixed(wl, mix):
    """Kernel 7 on the planted columns of the mixed volume's df2 buckets,
    C = 2 each: a chunk of one fascicle + CSF, and the 256 voxels of two
    fascicles without CSF."""
    for (K, csf), name in (((1, True), "mixed (1, CSF)"),
                           ((2, False), "mixed (2, no CSF)")):
        vox = mix["buckets"][(K, csf)][:CHUNK]
        D, y, a3 = voxel_inputs(wl, vox, mix["y"], "cuda")
        cols = gathered(D[:, :K], wl["gt_ids"][vox, :K], (a3,) if csf else ())
        FINALIZE_ERR.append(check_finalize(name, cols, y)["max_abs_err"])
        del D, y, a3, cols


def cross_check(label, wl, mix, buckets, sig_ear):
    """CROSS_VOX voxels of each of ``buckets`` ((K, csf) pairs) through
    run_bucket_fast on the card and on the CPU (the plain versions): ids
    equal, objectives within 2e-9 ||y||^2."""
    import torch
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    ear = sig_ear is not None
    ms = wl["msinterp"]
    for K, csf in buckets:
        vox = mix["buckets"][(K, csf)][:CROSS_VOX]
        y = mix["y"][vox]
        out = {}
        for dev in ("cuda", "cpu"):
            _x, ys, _c = ms.device_tables(dev, torch.float32)
            out[dev] = fit_mod.run_bucket_fast(
                ms, wl["plan"], ys, mix["peaks"][vox, :3 * K], y,
                wl["sig_csf"], K, csf, batch=CROSS_VOX, sig_ear=sig_ear,
                ear_on=ear)
        g, c = out["cuda"], out["cpu"]
        err = float(np.max(np.abs(g[2] - c[2]) / np.sum(y ** 2, axis=1)))
        what = "K=%d csf=%d ear=%d" % (K, csf, ear)
        log("%s: %d voxels of bucket %s on the card and the CPU: ids %s; "
            "objective max|card - plain|/||y||^2 %.3e" % (
                label, vox.size, what, g[1].tolist(), err))
        RECORD.setdefault("card_vs_cpu", {})[what] = err
        if not np.array_equal(g[1], c[1]) or err > 2e-9:
            raise AssertionError("bucket %s: card and CPU disagree" % what)


def phase_mixed(wl, sig_ear=None):
    """A volume that mixes the fast path's buckets at the flagship's
    widths through MFModel.fit: MIXED, or with ``sig_ear`` EAR_MIXED
    (ear_mask = 1), cold (launch counts: with EAR kernel 3 must run, on
    the one-fascicle bucket's grid, beside kernels 4 and 5) and WARM_FITS
    times warm, held as the main paths are; then kernel 3 on that grid
    against its plain version (with EAR) or the df2 scan's cost a chunk,
    and CROSS_VOX voxels of each newer bucket on the card and the CPU."""
    ear = sig_ear is not None
    label = "ear_mixed" if ear else "mixed"
    model, args, kw, mix = volume(wl, label, sig_ear)
    path = ("rhsprep", "prep_block", "row4hoist", "rowmin4", "rescan4",
            "df4hoist", "rescan3", "df3hoist", "finalize") if ear else (
        "rhsprep", "prep_block", "row3hoist", "rowmin3", "rescan3",
        "df3hoist", "df2scan", "df2hoist", "finalize")
    fit, launches, cold_s = cold_fit(label, model, args, kw, path)
    n_tie, min_r2 = check_recovery(label, wl, fit, mix["y"], mix["gt_ids"],
                                   mix["numfasc"], mix["csf_mask"], sig_ear)
    check_maps(label, fit, ear)
    split = (("finalize", ("finalize",)),) if ear else (
        ("df2 scan", ("df2hoist", "df2scan")), ("finalize", ("finalize",)))
    RECORD[label] = dict(
        cold_fit_s=cold_s, launches=launches, n_ties=n_tie, min_r2=min_r2,
        voxels={"K=%d csf=%d" % k: len(v) for k, v in mix["buckets"].items()},
        **warm_fits(label, model, args, kw, launches, split=split))
    del fit, model
    if ear:
        rescan3_ear = check_rescan3_ear_grid(wl, mix, sig_ear)
    else:
        rescan3_ear = None
        df2_chunk_cost(wl)
        check_finalize_mixed(wl, mix)
    cross_check(label, wl, mix, [(1, True)] if ear else [(1, True),
                                                         (2, False)],
                sig_ear)
    return launches, rescan3_ear


def phase_overflow(ear=False):
    """Duplicated atoms with a squeezed row budget (8): both overflow
    tiers (16, then 72 = N) run through the kernels and match the plain
    versions on the CPU. With ``ear`` the EAR bucket (csf + 4 EAR atoms,
    twopass_rows = twopass_rows_ear = 8, batch 2)."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch import config
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import f32scan
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.utils.scheme import b_values
    sch = mft.testing.make_dense_scheme(n_shells=3, dirs_per_shell=12,
                                        n_b0=4)
    sig, _, _ = mft.testing.make_dictionary(sch, num_atom=6)
    sig = np.tile(sig, (1, 12))                       # 72 columns, 12x each
    ms = mfi.init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    rng = np.random.RandomState(141414)
    n = 6
    peaks = rng.randn(n, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    TE, b = sch[:, 6], b_values(sch)
    csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    y = 300 * (0.6 * sig[:, 2] + 0.4 * csf)
    kw, name = {}, "df3_twopass"
    if ear:
        Dear = np.linspace(0.8e-9, 2.6e-9, 4)
        sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear)
        y = y + 30 * sig_ear[:, 1]
        kw, name = dict(sig_ear=sig_ear, ear_on=True), "df4_twopass"
    y = np.broadcast_to(y[None], (n, sch.shape[0])).copy()
    old = config.DEFAULTS["solver"]
    config.DEFAULTS["solver"] = dataclasses.replace(
        old, twopass_rows=8, twopass_rows_ear=8)
    seen = []
    orig = getattr(f32scan, name)

    def spy(*a, **k):
        if a[0].is_cuda:
            seen.append(k["R"])
        return orig(*a, **k)

    setattr(f32scan, name, spy)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            _x, ys, _c = ms.device_tables(dev, torch.float32)
            out[dev] = fit_mod.run_bucket_fast(ms, plan, ys,
                                               peaks.reshape(n, 6), y, csf,
                                               2, True, batch=2, **kw)
    finally:
        setattr(f32scan, name, orig)
        config.DEFAULTS["solver"] = old
    ysq = np.sum(y ** 2, axis=1)
    g, c = out["cuda"], out["cpu"]
    label = "EAR overflow" if ear else "overflow"
    log("%s: row budgets run on the card %s; ids %s; objective "
        "max|card - plain|/||y||^2 %.3e" % (
            label, sorted(set(seen)), g[1].tolist(),
            np.max(np.abs(g[2] - c[2]) / ysq)))
    if not {16, 72} <= set(seen):
        raise AssertionError("an overflow tier did not run")
    if not np.array_equal(g[1], c[1]) or \
            np.max(np.abs(g[2] - c[2]) / ysq) > 2e-9:
        raise AssertionError("overflow tiers disagree with the plain path")


def general_bucket(label, ms, plan, peaks, y, sig_csf, sig_ear, K, csf, ear):
    """One bucket through ``fit.run_bucket`` on the card as MFModel.fit
    runs it (FitConfig.batch chunks, top-16 pool, float64 refine): its
    wall ms, the device ms of its stages (rotation, candidates), the host
    ms of the refine, and the most memory it allocates above what was
    held before it. Returns the record."""
    import torch
    from microstructure_fingerprinting_torch import config
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.utils import profiling
    tables = ms.device_tables("cuda", torch.float32)
    plan_t = fit_mod.plan_tensors(plan, torch.float32, "cuda")
    refine_ms = []
    orig = fit_mod.refine_mod.refine_candidates

    def timed_refine(*a, **k):
        t0 = time.time()
        out = orig(*a, **k)
        refine_ms.append(1e3 * (time.time() - t0))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fit_mod.refine_mod.refine_candidates = timed_refine
    try:
        with profiling.StageTimer() as st:
            t0 = time.time()
            fit_mod.run_bucket(tables, plan_t, peaks, y, sig_csf, sig_ear,
                               K, csf, ear, batch=config.DEFAULTS["fit"].batch,
                               refine=True, ms_host=ms, plan_host=plan,
                               topm=16)
            torch.cuda.synchronize()
            wall = 1e3 * (time.time() - t0)
    finally:
        fit_mod.refine_mod.refine_candidates = orig
    rec = {"voxels": int(y.shape[0]), "wall_ms": wall,
           "refine_host_ms": sum(refine_ms),
           "peak_bytes": torch.cuda.max_memory_allocated() - base}
    rec.update({k + "_ms": v for k, v in st.totals_ms().items()})
    log("%s: bucket K=%d csf=%d ear=%d, %d voxels: wall %.1f ms; device "
        "ms %s; refine %.1f ms on the host; peak %.2f GB above its inputs "
        "[%s]" % (label, K, csf, ear, rec["voxels"], wall, ", ".join(
            "%s %.1f" % (k, v) for k, v in st.totals_ms().items()),
            rec["refine_host_ms"], rec["peak_bytes"] / 1e9, card_line()))
    return rec


def cross_check_general(label, wl, mix, sig_ear):
    """CROSS_VOX voxels of each bucket of ``mix`` through ``run_bucket``
    (top-16 pool, float64 refine) on the card and on the CPU (the same
    torch code): ids equal, objectives within 2e-9 ||y||^2."""
    import torch
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    ms, plan = wl["msinterp"], wl["plan"]
    for (K, csf, ear), vox in mix["buckets"].items():
        vox = vox[:CROSS_VOX]
        y = mix["y"][vox]
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev] = fit_mod.run_bucket(
                ms.device_tables(dev, torch.float32),
                fit_mod.plan_tensors(plan, torch.float32, dev),
                mix["peaks"][vox, :3 * K], y, wl["sig_csf"], sig_ear, K,
                csf, ear, batch=CROSS_VOX, refine=True, ms_host=ms,
                plan_host=plan, topm=16)
        g, c = out["cuda"], out["cpu"]
        err = float(np.max(np.abs(g[2] - c[2]) / np.sum(y ** 2, axis=1)))
        what = "K=%d csf=%d ear=%d" % (K, csf, ear)
        log("%s: %d voxels of bucket %s on the card and the CPU: ids %s; "
            "objective max|card - CPU|/||y||^2 %.3e" % (
                label, vox.size, what, g[1].tolist(), err))
        RECORD.setdefault("card_vs_cpu", {})["%s %s" % (label, what)] = err
        if not np.array_equal(g[1], c[1]) or err > 2e-9:
            raise AssertionError("bucket %s: card and CPU disagree" % what)


def general_fit(label, model, args, kw):
    """A fit that must take the general path only: no kernel of the fast
    path launches. Returns (fit, seconds)."""
    import torch
    import microstructure_fingerprinting_torch as mft
    mft.reset_counts()
    t0 = time.time()
    fit = model.fit(*args, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    log("%s: cold fit of %d voxels: %.2f s" % (label, args[0][..., 0].size,
                                               cold_s))
    if any(mft.LAUNCHES.values()):
        raise AssertionError("%s: a fast-path kernel launched: %s"
                             % (label, mft.LAUNCHES))
    return fit, cold_s


def phase_general(wl, sig_ear):
    """The general path at the flagship widths: the GENERAL volume
    through MFModel.fit, cold and WARM_FITS times warm (voxels/s, each
    bucket's stages), every voxel its planted atoms or an equal-or-better
    objective at R^2 >= 1 - 1e-6, maps reloaded; each bucket once more
    through run_bucket for its wall time, stages, refine time and peak
    memory; CROSS_VOX voxels of each bucket on the card and the CPU."""
    from microstructure_fingerprinting_torch.utils import native
    ok = native.available()
    log("general: native host helper available: %s" % ok)
    RECORD["native_available"] = ok
    if not ok:
        raise AssertionError("the native host helper (csrc/mf_native.cpp) "
                             "did not build")
    label = "general"
    model, args, kw, mix = volume(wl, label, sig_ear)
    fit, cold_s = general_fit(label, model, args, kw)
    n_tie, min_r2 = check_recovery(label, wl, fit, mix["y"], mix["gt_ids"],
                                   mix["numfasc"], mix["csf_mask"], sig_ear,
                                   ear=mix["ear_mask"])
    check_maps(label, fit, True)
    del fit
    direct = {}
    for (K, csf, ear), vox in mix["buckets"].items():
        direct["K=%d csf=%d ear=%d" % (K, csf, ear)] = general_bucket(
            label, wl["msinterp"], wl["plan"], mix["peaks"][vox, :3 * K],
            mix["y"][vox], None, sig_ear if ear else None, K, csf, ear)
    RECORD[label] = dict(
        cold_fit_s=cold_s, n_ties=n_tie, min_r2=min_r2, buckets=direct,
        voxels={"K=%d csf=%d ear=%d" % k: len(v)
                for k, v in mix["buckets"].items()},
        **warm_fits(label, model, args, kw, {}))
    cross_check_general(label, wl, mix, sig_ear)


def phase_general_wide(wl):
    """The 4-block general scan: WIDE_VOX voxels of 2 fascicles + CSF +
    EAR with an EAR block of N_EAR_WIDE atoms (more than the fast path's
    16) through MFModel.fit, held as the general volume is; the bucket
    once more through run_bucket (times, peak memory); CROSS_VOX voxels
    on the card and the CPU."""
    import microstructure_fingerprinting_torch as mft
    label = "general_wide"
    sig_ear, _y = mft.testing.make_ear(wl, N_EAR_WIDE)
    dear = np.linspace(0.8e-9, 2.6e-9, N_EAR_WIDE)
    mix = mft.testing.make_mixed(wl, [(WIDE_VOX, 2, True, True)], sig_ear,
                                 ear_atom=EAR_ATOM)
    shape, S = (8, 4, 4), wl["sch_mat"].shape[0]
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            np.full(shape, 2.0))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"], csf_mask=1, ear_mask=1, verbose=0)
    dic = dict(fit_dictionary(wl, sig_ear), DIFF_ear=dear,
               num_ear=N_EAR_WIDE)
    fit, cold_s = general_fit(label, mft.MFModel(dic), args, kw)
    n_tie, min_r2 = check_recovery(label, wl, fit, mix["y"], mix["gt_ids"],
                                   mix["numfasc"], mix["csf_mask"], sig_ear,
                                   dear=dear)
    check_maps(label, fit, True)
    del fit
    vox = mix["buckets"][(2, True, True)]
    RECORD[label] = dict(
        cold_fit_s=cold_s, n_ties=n_tie, min_r2=min_r2, n_ear=N_EAR_WIDE,
        bucket=general_bucket(label, wl["msinterp"], wl["plan"],
                              mix["peaks"][vox], mix["y"][vox],
                              wl["sig_csf"], sig_ear, 2, True, True))
    cross_check_general(label, wl, mix, sig_ear)


def phase_xla(wl):
    """engine="xla" on XLA_VOX voxels of the flagship (2, CSF) bucket: on
    every voxel the fast path's ids or an equal objective (2e-9
    ||y||^2); the bucket once more through run_bucket (times, peak)."""
    import microstructure_fingerprinting_torch as mft
    label = "xla"
    vox = np.arange(XLA_VOX)
    shape, S = (8, 8, 8), wl["sch_mat"].shape[0]
    args = (wl["y"][vox].reshape(shape + (S,)), np.ones(shape),
            np.full(shape, 2.0))
    kw = dict(peaks=wl["peaks"][vox].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"], csf_mask=1, verbose=0)
    model = mft.MFModel(fit_dictionary(wl))
    fx, cold_s = general_fit(label, model, args, dict(kw, engine="xla"))
    ff = model.fit(*args, **kw)
    ids = lambda f: np.stack([f.atom_id_f0.reshape(-1),
                              f.atom_id_f1.reshape(-1)], axis=1)
    diff = np.flatnonzero(np.any(ids(fx) != ids(ff), axis=1))
    ysq = np.sum(wl["y"][vox] ** 2, axis=1)
    gap = np.abs(fx.MSE.reshape(-1) - ff.MSE.reshape(-1)) * S / ysq
    log("%s: %d voxels: ids of the fast path on %d, others within %.3e "
        "||y||^2 of its objective; min R2 %.9f" % (
            label, vox.size, vox.size - diff.size,
            float(gap[diff].max()) if diff.size else 0.0, fx.R2.min()))
    if diff.size and gap[diff].max() > 2e-9:
        raise AssertionError("engine='xla' selected a worse support")
    if fx.R2.min() < 1 - 1e-6:
        raise AssertionError("engine='xla': R2 below 1 - 1e-6")
    RECORD[label] = dict(
        cold_fit_s=cold_s, n_ties=int(diff.size), min_r2=float(fx.R2.min()),
        bucket=general_bucket(label, wl["msinterp"], wl["plan"],
                              wl["peaks"][vox].reshape(-1, 6), wl["y"][vox],
                              wl["sig_csf"], None, 2, True, False))


def phase_golden():
    """tests/golden/golden_fit.npz fitted on the card with the default
    arguments and with engine="xla": every map within 1e-5 x max(1,
    max|map|) of the fixture (tests/test_golden.py's check), the maps
    reloaded exactly. The default fit's fast-path kernel launches are
    recorded on their own, outside the kernel table's counts."""
    import microstructure_fingerprinting_torch as mft
    g = np.load(GOLDEN, allow_pickle=False)
    dic = {"dictionary": g["dictionary"], "sch_mat": g["sch_mat"],
           "orientation": g["orientation"],
           "num_atom": g["dictionary"].shape[1],
           "num_ear": g["DIFF_ear"].size, "fasc_propnames": ["dpar", "dperp"],
           "dpar": g["dpar"], "dperp": g["dperp"], "T2_csf": 2.0,
           "DIFF_csf": 3.0e-9, "T2_ear": 0.8, "DIFF_ear": g["DIFF_ear"]}
    model = mft.MFModel(dic)
    names = [str(p) for p in g["param_names"]]
    for name, extra in (("default", {}), ("xla", {"engine": "xla"})):
        mft.reset_counts()
        fit = model.fit(g["data"], g["mask"], g["numfasc"], peaks=g["peaks"],
                        pgse_scheme=g["sch_mat"], csf_mask=g["csf_mask"],
                        ear_mask=g["ear_mask"], verbose=0, **extra)
        launches = {k: v for k, v in mft.LAUNCHES.items() if v}
        if fit.param_names != names:
            raise AssertionError("golden %s: maps %s" % (name,
                                                         fit.param_names))
        err = {p: float(np.max(np.abs(getattr(fit, p) - g["map_" + p])))
               / max(1.0, float(np.max(np.abs(g["map_" + p]))))
               for p in names}
        worst = max(err, key=err.get)
        log("golden %s: worst map %s at %.3e of its scale (limit 1e-5); "
            "fast-path launches %s" % (name, worst, err[worst], launches))
        RECORD.setdefault("golden", {})[name] = dict(
            worst_map=worst, worst_rel_err=err[worst], launches=launches)
        if err[worst] > 1e-5:
            raise AssertionError("golden %s: map %s off the fixture"
                                 % (name, worst))
        check_maps("golden " + name, fit, True)


def phase_cli(wl, sig_ear=None):
    """The user's workflow from the shell on the flagship volume (with
    ``sig_ear``: the first CLI_EAR_VOX voxels of the EAR volume, csf_mask
    = ear_mask = 1). The workload is written as a user's files (the
    dictionary .mat, the DWI, mask, mu1/mu2 = the planted directions and
    frac1/frac2 = the planted fractions as NIfTI, a VERSION: 1 scheme);
    ``cli.main(["cleanup", ...])`` must write what an in-process
    ``cleanup_2fascicles`` gives; ``cli.main(["fit", ...])`` on cleanup's
    files must write every map equal to that of an in-process
    ``MFModel.fit`` on the same arrays (after the same write and read),
    with the same launches. Where cleanup kept both planted fascicles,
    every voxel must recover its planted atoms (the fit phase's gate)."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch import cli
    from microstructure_fingerprinting_torch.utils import io as mfio
    from microstructure_fingerprinting_torch.utils import nifti
    from microstructure_fingerprinting_torch.utils.scheme import (
        load_scheme_text)
    ear = sig_ear is not None
    label = "cli_ear" if ear else "cli"
    n = CLI_EAR_VOX if ear else N_VOX
    side = round(n ** (1 / 3))
    shape = (n // 64, 8, 8) if ear else (side, side, side)
    ys_np = (wl["y_ear"] if ear else wl["y"])[:n]
    S = ys_np.shape[1]
    planted = wl["peaks"][:n]
    arrays = {"dwi": ys_np.reshape(shape + (S,)), "mask": np.ones(shape),
              "mu1": planted[:, 0].reshape(shape + (3,)),
              "mu2": planted[:, 1].reshape(shape + (3,)),
              "frac1": wl["gt_nu"][:n, 0].reshape(shape),
              "frac2": wl["gt_nu"][:n, 1].reshape(shape)}
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    path = ("prep_block", "rowmin4", "rescan4") if ear else (
        "prep_block", "rowmin3", "rescan3")
    rec = {"voxels": n}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)
        t0 = time.time()
        mfio.savemat(p("dic.mat"), fit_dictionary(wl, sig_ear))
        with open(p("scheme.txt"), "w") as f:
            f.write("VERSION: 1\n")
            np.savetxt(f, wl["sch_mat"], fmt="%.17g")
        for name, arr in arrays.items():
            nifti.save(nifti.Nifti1Image(arr, aff), p(name + ".nii.gz"))
        rec["write_inputs_s"] = time.time() - t0
        t0 = time.time()
        dwi = nifti.load(p("dwi.nii.gz")).get_fdata()
        rec["read_dwi_s"] = time.time() - t0
        if not (np.array_equal(dwi, arrays["dwi"]) and np.array_equal(
                load_scheme_text(p("scheme.txt")), wl["sch_mat"])):
            raise AssertionError("%s: the DWI or the scheme did not read "
                                 "back exactly" % label)

        # cleanup: from the shell and in process
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["cleanup", "--peakmode", "peaks"] + sum(
                (["--" + k, p(k + ".nii.gz")] for k in
                 ("mu1", "mu2", "frac1", "frac2", "mask")), [])
                + ["--out", p("clean.nii.gz")])
        rec["cleanup_cli_s"] = time.time() - t0
        t0 = time.time()
        pk, nf = mft.cleanup_2fascicles(arrays["frac1"], arrays["frac2"],
                                        "peaks", arrays["mu1"], arrays["mu2"],
                                        arrays["mask"])
        rec["cleanup_s"] = time.time() - t0
        if rc != 0 or not (
                np.array_equal(nifti.load(p("clean_peaks.nii.gz"))
                               .get_fdata(), pk)
                and np.array_equal(nifti.load(p("clean_numfasc.nii.gz"))
                                   .get_fdata(), nf)):
            raise AssertionError("%s: the cleanup files differ from "
                                 "cleanup_2fascicles" % label)
        counts = np.bincount(nf.reshape(-1).astype(int), minlength=3)
        rec["numfasc_after_cleanup"] = counts.tolist()

        # fit: from the shell, then in process on the same arrays
        argv = ["fit", "--dictionary", p("dic.mat"), "--data",
                p("dwi.nii.gz"), "--mask", p("mask.nii.gz"), "--numfasc",
                p("clean_numfasc.nii.gz"), "--peaks", p("clean_peaks.nii.gz"),
                "--pgse-scheme", p("scheme.txt"), "--csf-mask", "1",
                "--out", p("cli/mf.nii.gz"), "--verbose", "1"]
        if ear:
            argv += ["--ear-mask", "1"]
        mft.reset_counts()
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        rec["cli_fit_s"] = time.time() - t0
        cli_launches = dict(mft.LAUNCHES)
        if rc != 0:
            raise AssertionError("%s: fit returned %d" % (label, rc))
        model = mft.MFModel(fit_dictionary(wl, sig_ear))
        mft.reset_counts()
        t0 = time.time()
        fit = model.fit(arrays["dwi"], arrays["mask"], nf, peaks=pk,
                        pgse_scheme=wl["sch_mat"], csf_mask=1,
                        ear_mask=1 if ear else None, verbose=0)
        torch.cuda.synchronize()
        rec["fit_s"] = time.time() - t0
        launches = dict(mft.LAUNCHES)
        t0 = time.time()
        files = fit.write_nifti(p("mine/mf.nii.gz"), affine=aff)
        rec["write_maps_s"] = time.time() - t0
        t0 = time.time()
        mine = [nifti.load(f).get_fdata() for f in files]
        rec["read_maps_s"] = time.time() - t0
        written = sorted(os.listdir(p("cli")))
        want = sorted("mf_%s.nii.gz" % m for m in fit.param_names)
        if written != want:
            raise AssertionError("%s: the command line wrote %s, not %s"
                                 % (label, written, want))
        diff = {m: float(np.max(np.abs(
            nifti.load(p("cli/mf_%s.nii.gz" % m)).get_fdata() - a)))
            for m, a in zip(fit.param_names, mine)}
    worst = max(diff, key=diff.get)
    rec.update(launches=cli_launches, max_map_diff=diff[worst],
               card=card_line())
    log("%s: %d voxels, fascicle counts after cleanup %s; cleanup %.3f s "
        "from the shell (%.3f s in process); fit %.3f s from the shell "
        "(.mat, NIfTI reads, model, fit, %d map writes) vs %.3f s in "
        "process; NIfTI: inputs written in %.3f s, DWI read in %.3f s, maps "
        "written in %.3f s and read in %.3f s; largest map difference %.3e "
        "(%s); launches %s from the shell, %s in process [%s]" % (
            label, n, counts.tolist(), rec["cleanup_cli_s"], rec["cleanup_s"],
            rec["cli_fit_s"], len(files), rec["fit_s"],
            rec["write_inputs_s"], rec["read_dwi_s"], rec["write_maps_s"],
            rec["read_maps_s"], diff[worst], worst, cli_launches, launches,
            rec["card"]))
    if diff[worst] != 0.0:
        raise AssertionError("%s: map %s differs from the in-process fit's "
                             "by %.3e" % (label, worst, diff[worst]))
    if cli_launches != launches:
        raise AssertionError("%s: launches %s from the shell, %s in process"
                             % (label, cli_launches, launches))
    if min(cli_launches[k] for k in path) <= 0:
        raise AssertionError("a kernel of the %s path was never launched: "
                             "%s" % (label, cli_launches))

    # recovery where cleanup kept both planted fascicles (their order is
    # cleanup's: by descending fraction)
    kept = np.flatnonzero(nf.reshape(-1) == 2)
    clean = pk.reshape(-1, 2, 3)[kept]
    swapped = np.all(clean[:, 0] == planted[kept, 1], axis=1)
    gt = wl["gt_ids"][:n][kept]
    gt = np.where(swapped[:, None], gt[:, ::-1], gt)
    maps = ("R2", "MSE", "atom_id_f0", "atom_id_f1") + (
        ("D_ear",) if ear else ())
    sub = types.SimpleNamespace(**{m: getattr(fit, m).reshape(-1)[kept]
                                   for m in maps})
    rec["n_ties"], rec["min_r2"] = check_recovery(
        label, dict(wl, peaks=clean), sub, ys_np[kept], gt,
        np.full(kept.size, 2), np.ones(kept.size, bool), sig_ear)
    rec["kept_voxels"] = int(kept.size)
    RECORD[label] = rec
    return cli_launches


def phase_surface(wl):
    """The reference surface on the card against the CPU: the Monte-Carlo
    average of MC_REF reference sequences x MC_SPINS spins x 3 axes
    mapped to the flagship's 552 sequences (float64, rtol 1e-12), and the
    flagship dictionary's 782 atoms rotated to N_DIRS directions by
    interp_PGSE_from_multishell and eval_rotation (float64, 1e-12 of the
    scale); mf_utils imports without matplotlib, whose plotters are then
    tripwires; nothing of JAX was imported in this run."""
    import importlib.util
    import torch
    import microstructure_fingerprinting_torch.mf_utils  # noqa: F401
    from microstructure_fingerprinting_torch import viz
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.ops import mc
    from microstructure_fingerprinting_torch.tripwire import (
        TripWireError, is_tripwire)
    rec = {"card": card_line()}
    rng = np.random.RandomState(0)
    sch = wl["sch_mat"]
    S = sch.shape[0]

    # Monte-Carlo average: card vs CPU (each once warm, host clock)
    ph = rng.randn(MC_REF * MC_SPINS, 3)
    dmap = rng.randint(0, MC_REF, S)
    gsc = rng.rand(S, 3)
    out = {}
    for dev in ("cuda", "cpu"):
        mc.monte_carlo_average(ph[:MC_REF * 1000], dmap, gsc, 1.0, 1000,
                               device=dev)
        t0 = time.time()
        out[dev] = mc.monte_carlo_average(ph, dmap, gsc, 1.0, MC_SPINS,
                                          device=dev)
        rec["mc_%s_ms" % dev] = 1e3 * (time.time() - t0)
    rel = float(np.max(np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"])))
    rec["mc_max_rel_diff"] = rel
    log("surface: monte_carlo_average, %d x %d spins -> %d sequences: card "
        "%.1f ms, CPU %.1f ms, max relative difference %.3e (limit 1e-12) "
        "[%s]" % (MC_REF, MC_SPINS, S, rec["mc_cuda_ms"], rec["mc_cpu_ms"],
                  rel, rec["card"]))
    if not rel <= 1e-12:
        raise AssertionError("monte_carlo_average: card and CPU differ")

    # rotations of the flagship dictionary: card vs CPU
    ms = wl["msinterp"]
    dirs = rng.randn(N_DIRS, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    plan = mfi.plan_target_scheme(ms, sch)
    sig, ev = {}, {}
    for dev in ("cuda", "cpu"):
        mfi.interp_PGSE_from_multishell(sch, dirs[0], msinterp=ms,
                                        device=dev)
        t0 = time.time()
        sig[dev] = np.stack([mfi.interp_PGSE_from_multishell(
            sch, d, msinterp=ms, device=dev) for d in dirs])
        rec["interp_%s_ms" % dev] = 1e3 * (time.time() - t0) / N_DIRS
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        xs, ys, cnt = ms.device_tables(dev, torch.float64)
        ev[dev] = np.stack([mfi.eval_rotation(
            xs, ys, cnt, f64(plan.gdir),
            torch.as_tensor(plan.shell_lo, device=dev),
            torch.as_tensor(plan.shell_hi, device=dev), f64(plan.wG),
            f64(d)).cpu().numpy() for d in dirs])
    t0 = time.time()
    one_shot = mfi.interp_PGSE_from_multishell(
        sch, dirs[0], sig_ms=wl["dictionary"], sch_mat_ms=sch,
        ordir=np.array([0.0, 0.0, 1.0]))
    rec["interp_one_shot_ms"] = 1e3 * (time.time() - t0)
    scale = float(np.abs(sig["cpu"]).max())
    rec["interp_max_diff"] = float(np.max(np.abs(sig["cuda"] - sig["cpu"])))
    rec["eval_rotation_max_diff"] = float(np.max(np.abs(ev["cuda"]
                                                        - ev["cpu"])))
    rec["one_shot_max_diff"] = float(np.max(np.abs(one_shot
                                                   - sig["cuda"][0])))
    log("surface: %d atoms to %d directions on %d sequences: "
        "interp_PGSE_from_multishell %.2f ms a direction on the card, %.2f "
        "on the CPU, one-shot (tables rebuilt) %.1f ms; max|card - CPU| "
        "%.3e (interp), %.3e (eval_rotation), one-shot vs tables %.3e, of a "
        "scale %.3e (limit 1e-12 x scale)" % (
            N_ATOM, N_DIRS, S, rec["interp_cuda_ms"], rec["interp_cpu_ms"],
            rec["interp_one_shot_ms"], rec["interp_max_diff"],
            rec["eval_rotation_max_diff"], rec["one_shot_max_diff"], scale))
    if sig["cuda"].shape != (N_DIRS, S, N_ATOM) or max(
            rec["interp_max_diff"], rec["eval_rotation_max_diff"],
            rec["one_shot_max_diff"]) > 1e-12 * scale:
        raise AssertionError("rotations: card and CPU differ")

    # mf_utils without matplotlib; no JAX in this process
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    rec["matplotlib_installed"] = has_mpl
    if "matplotlib" in sys.modules:
        raise AssertionError("importing mf_utils imported matplotlib")
    if not has_mpl:
        if not is_tripwire(viz.pyplot()):
            raise AssertionError("viz.pyplot() is not a tripwire")
        try:
            viz.plot_multi_shell_signal(wl["dictionary"][:, :2], sch,
                                        [0.0, 0.0, 1.0])
            raise AssertionError("a plotter ran without matplotlib")
        except TripWireError:
            pass
    jax_mods = sorted(m for m in sys.modules if m == "jax"
                      or m.startswith(("jax.", "microstructure_fingerprinting_tpu")))
    log("surface: mf_utils imported; matplotlib installed: %s (plotters %s); "
        "JAX modules imported in this run: %s" % (
            has_mpl, "draw" if has_mpl else "are tripwires", jax_mods))
    if jax_mods:
        raise AssertionError("this run imported %s" % jax_mods)
    RECORD["surface"] = rec


def phase_mcf(wl):
    """The MCF simulators on the card against the CPU (float64): MCF_PGSE
    for a cylinder of each diameter in MCF_SIZES on the flagship's 552
    sequences, and MCF_DDE on a DDE_ROWS-row DDE scheme; every value
    within relative MCF_RTOL of the CPU's; host ms of each, once warm."""
    import microstructure_fingerprinting_torch as mft
    rec = {"card": card_line()}
    sch, dde = wl["sch_mat"], mft.testing.make_dde_scheme(DDE_ROWS)
    runs = [("pgse L=%g um" % (1e6 * L),
             lambda dev, L=L: mft.mcf.MCF_PGSE("cylinder", L, 2e-9,
                                               scheme=sch, device=dev))
            for L in MCF_SIZES]
    runs.append(("dde L=5 um, %d rows" % DDE_ROWS,
                 lambda dev: mft.mcf.MCF_DDE("cylinder", 5e-6, 2e-9, dde,
                                             device=dev)))
    for name, run in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            run(dev)
            t0 = time.time()
            out[dev] = run(dev)
            rec["%s: %s ms" % (name, dev)] = 1e3 * (time.time() - t0)
        rel = float(np.max(np.abs(out["cuda"] - out["cpu"])
                           / np.abs(out["cpu"])))
        rec["%s: max rel diff" % name] = rel
        log("mcf %s: %d sequences, card %.2f ms, CPU %.2f ms, max relative "
            "difference %.3e (limit %.0e), E in [%.3e, %.3e] [%s]" % (
                name, out["cpu"].size, rec["%s: cuda ms" % name],
                rec["%s: cpu ms" % name], rel, MCF_RTOL, out["cpu"].min(),
                out["cpu"].max(), rec["card"]))
        if not (rel <= MCF_RTOL and np.all(np.isfinite(out["cuda"]))):
            raise AssertionError("mcf %s: card and CPU differ" % name)
    RECORD["mcf"] = rec


def _counted(fn):
    """fn() with every launch count set to 0 just before it: (result,
    launches of this call, host seconds)."""
    import torch
    import microstructure_fingerprinting_torch as mft
    mft.reset_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in mft.LAUNCHES.items() if v}, \
        time.time() - t0


def _abba(runs):
    """Two warm runs {name: fn} timed in turns A, B, B, A (each once
    before, to warm): {name: (result, launches of its last call, [host
    seconds of its two timed calls])}."""
    (a, run_a), (b, run_b) = runs.items()
    run_a()
    run_b()
    out = {a: [None, None, []], b: [None, None, []]}
    for name, run in ((a, run_a), (b, run_b), (b, run_b), (a, run_a)):
        res, launches, sec = _counted(run)
        out[name][0], out[name][1] = res, launches
        out[name][2].append(sec)
    return {k: tuple(v) for k, v in out.items()}


def _vps(n, secs):
    """voxels/s of each timed call."""
    return [n / t for t in secs]


def _fmt(xs):
    return "/".join("%.1f" % x for x in xs)


def _same(label, got, ref):
    for k, (a, b) in enumerate(zip(got, ref)):
        if not np.array_equal(a, b):
            raise AssertionError("%s: output %d differs from the serial "
                                 "fit's" % (label, k))


def phase_mesh(wl, sig_ear):
    """Meshes of two slots on cuda:0 (one card: a check of the mesh code,
    not a speed-up). (2, 1): MESH_VOX flagship voxels and MESH_EAR_VOX
    EAR voxels (two chunks) through run_bucket_fast(mesh=) and
    MFModel.fit(parallel=True, mesh_shape=(2, 1)), each timed warm in
    turns with the serial run (serial, mesh, mesh, serial): outputs and
    maps bit for bit the serial fit's, the same launches. (1, 2):
    ATOMS_VOX flagship voxels with the second block's atoms split over
    the two slots (df3_candidates on [782, 391, 1] a slot): ids equal to
    the serial fit's, objectives within 2e-9 ||y||^2; ms and peak memory
    of the atoms-split scan on one chunk."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.parallel import mesh as pmesh
    rec = {"card": card_line()}
    ms, plan = wl["msinterp"], wl["plan"]
    _x, ys, _c = ms.device_tables("cuda", torch.float32)
    rotator = mft.ops.interp.make_grouped_rotation_paired(ms, plan)
    slots = [torch.device("cuda", 0)] * 2
    data2 = pmesh.build_mesh(2, 1, devices=slots)
    for label, n, kw, y in (
            ("flagship", MESH_VOX, {}, wl["y"]),
            ("EAR", MESH_EAR_VOX, dict(sig_ear=sig_ear, ear_on=True),
             wl["y_ear"])):
        # two chunks: one a slot
        batch = n // 2
        args = (ms, plan, ys, wl["peaks"][:n].reshape(n, 6), y[:n],
                wl["sig_csf"], 2, True)
        kw = dict(kw, batch=batch, rotator=rotator)
        res = _abba({
            "serial": lambda: fit_mod.run_bucket_fast(*args, **kw),
            "mesh (2, 1)": lambda: fit_mod.run_bucket_fast(
                *args, mesh=data2, **kw)})
        _same("run_bucket_fast %s (2, 1)" % label, res["mesh (2, 1)"][0],
              res["serial"][0])
        path = ("prep_block", "rowmin4", "rescan4") if kw.get("ear_on") \
            else ("prep_block", "rowmin3", "rescan3")
        if res["mesh (2, 1)"][1] != res["serial"][1] or min(
                res["mesh (2, 1)"][1].get(k, 0) for k in path) <= 0:
            raise AssertionError("mesh %s: launches %s, serial %s" % (
                label, res["mesh (2, 1)"][1], res["serial"][1]))
        RECORD.setdefault("launches_by_fit", {})[
            "mesh (2, 1) %s" % label] = res["mesh (2, 1)"][1]
        rec["run_bucket_fast %s" % label] = {
            name: dict(voxels_per_s=_vps(n, r[2]), launches=r[1])
            for name, r in res.items()}
        log("mesh (2, 1) %s: run_bucket_fast on %d voxels equals the serial "
            "run bit for bit, launches %s; voxels/s serial %s, mesh %s "
            "[%s]" % (label, n, res["serial"][1],
                      _fmt(_vps(n, res["serial"][2])),
                      _fmt(_vps(n, res["mesh (2, 1)"][2])), rec["card"]))

        # the same voxels as a volume through MFModel.fit
        shape = (n, 1, 1)
        model = mft.MFModel(fit_dictionary(wl, sig_ear if kw.get("ear_on")
                                           else None))
        fargs = (y[:n].reshape(shape + (-1,)), np.ones(shape),
                 np.full(shape, 2.0))
        fkw = dict(peaks=wl["peaks"][:n].reshape(shape + (6,)),
                   pgse_scheme=wl["sch_mat"], csf_mask=1, verbose=0,
                   ear_mask=1 if kw.get("ear_on") else None,
                   batch_size=batch)
        fits = _abba({
            "serial": lambda: model.fit(*fargs, **fkw),
            "mesh (2, 1)": lambda: model.fit(*fargs, parallel=True,
                                             mesh_shape=(2, 1), **fkw)})
        a, b = fits["mesh (2, 1)"][0], fits["serial"][0]
        for p in b.param_names:
            if not np.array_equal(getattr(a, p), getattr(b, p)):
                raise AssertionError("MFModel.fit %s on the (2, 1) mesh: "
                                     "map %s differs" % (label, p))
        if fits["mesh (2, 1)"][1] != fits["serial"][1]:
            raise AssertionError("mesh fit %s: launches differ" % label)
        rec["MFModel.fit %s" % label] = {
            name: dict(voxels_per_s=_vps(n, r[2]), launches=r[1])
            for name, r in fits.items()}
        log("mesh (2, 1) %s: MFModel.fit(parallel=True, mesh_shape=(2, 1)) "
            "on %d voxels: every map equal to the serial fit's, launches "
            "%s; voxels/s serial %s, mesh %s [%s]" % (
                label, n, fits["serial"][1],
                _fmt(_vps(n, fits["serial"][2])),
                _fmt(_vps(n, fits["mesh (2, 1)"][2])), rec["card"]))
        del model, fits, res
        torch.cuda.empty_cache()

    # (1, 2): the atoms axis
    n = ATOMS_VOX
    atoms2 = pmesh.build_mesh(1, 2, devices=slots)
    args = (ms, plan, ys, wl["peaks"][:n].reshape(n, 6), wl["y"][:n],
            wl["sig_csf"], 2, True)
    res = {}
    for name, mesh in (("serial", None), ("mesh (1, 2)", atoms2)):
        run = lambda: fit_mod.run_bucket_fast(*args, batch=n, mesh=mesh,
                                              rotator=rotator)
        run()
        res[name] = _counted(run)
    got, ref = res["mesh (1, 2)"][0], res["serial"][0]
    ysq = np.sum(wl["y"][:n] ** 2, axis=1)
    gap = float(np.max(np.abs(got[2] - ref[2]) / ysq))
    if not np.array_equal(got[1], ref[1]) or gap > 2e-9:
        raise AssertionError("atoms axis: ids or objectives differ (%.3e)"
                             % gap)
    D, y, a3 = voxel_inputs(wl, np.arange(n), wl["y"], "cuda")
    scan = lambda: pmesh.atoms_df3_candidates(slots, D[:, 0], D[:, 1], a3,
                                              y, M=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    scan()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    scan_ms = timed(scan, reps=2)
    rec["atoms"] = dict(
        voxels=n, max_obj_gap=gap, launches=res["mesh (1, 2)"][1],
        voxels_per_s={k: n / r[2] for k, r in res.items()},
        scan_ms=scan_ms, scan_peak_bytes=peak)
    log("mesh (1, 2): %d flagship voxels with the atoms split over two "
        "slots: ids equal to the serial fit's, objectives within %.3e "
        "||y||^2 (limit 2e-9); voxels/s serial %.1f, mesh %.1f; the "
        "atoms-split scan (df3_candidates on [782, 391, 1] a slot) %.1f ms "
        "a %d-voxel chunk, peak %.2f GB above its inputs [%s]" % (
            n, gap, n / res["serial"][2], n / res["mesh (1, 2)"][2],
            scan_ms, n, peak / 1e9, rec["card"]))
    RECORD["mesh"] = rec
    del D, y, a3
    torch.cuda.empty_cache()


def multihost_worker(rank, port, tmp):
    """One of the multihost phase's two processes: joins the gloo group,
    fits its half of the MH_VOX voxels that the parent wrote to ``tmp``
    on cuda:0 with run_bucket_fast (one chunk), and gathers every
    process's results; rank 0 writes them with each rank's launches."""
    import torch
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.parallel import mesh as pmesh
    rank = int(rank)
    devices = pmesh.init_distributed("localhost:%s" % port, 2, rank,
                                     local_device_ids=[0], backend="gloo")
    ins = np.load(os.path.join(tmp, "inputs.npz"))
    ms = mfi.MultiShellInterp.load(os.path.join(tmp, "tables.npz"))
    plan = mfi.plan_target_scheme(ms, ins["sch_mat"])
    half = MH_VOX // 2
    sl = slice(rank * half, (rank + 1) * half)
    _x, ys, _c = ms.device_tables(devices[0], torch.float32)
    run = lambda: fit_mod.run_bucket_fast(
        ms, plan, ys, ins["peaks"][sl], ins["y"][sl], ins["sig_csf"], 2,
        True, batch=half)
    (w, ind, obj, _mse, r2), launches, sec = _counted(run)
    got = {k: pmesh.gather_to_host(v) for k, v in
           (("w", w), ("ind", ind), ("obj", obj), ("r2", r2))}
    got["launches"] = pmesh.gather_to_host(
        np.array([[launches.get(k, 0) for k in MH_KERNELS]]))
    got["seconds"] = pmesh.gather_to_host(np.array([sec]))
    if rank == 0:
        np.savez(os.path.join(tmp, "out.npz"), **got)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_multihost(wl):
    """Two processes of this script on cuda:0 joined by init_distributed
    (gloo: NCCL takes one card a process), each fitting half of MH_VOX
    flagship voxels with kernels 1-3; what gather_to_host hands rank 0
    must equal the single-process fit in the same chunks bit for bit.
    Each process is killed after MH_TIMEOUT s."""
    import socket
    import torch
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    torch.cuda.empty_cache()
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ms = wl["msinterp"]
    peaks = wl["peaks"][:MH_VOX].reshape(MH_VOX, 6)
    with tempfile.TemporaryDirectory() as tmp:
        ms.save(os.path.join(tmp, "tables.npz"))
        np.savez(os.path.join(tmp, "inputs.npz"), sch_mat=wl["sch_mat"],
                 peaks=peaks, y=wl["y"][:MH_VOX], sig_csf=wl["sig_csf"])
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-worker",
             str(rank), str(port), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MH_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            raise AssertionError("multihost: a worker timed out")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError("multihost worker failed:\n" + text)
        got = dict(np.load(os.path.join(tmp, "out.npz")))
    half = MH_VOX // 2
    _x, ys, _c = ms.device_tables("cuda", torch.float32)
    ref = fit_mod.run_bucket_fast(ms, wl["plan"], ys, peaks,
                                  wl["y"][:MH_VOX], wl["sig_csf"], 2, True,
                                  batch=half)
    _same("multihost", (got["w"], got["ind"], got["obj"], got["r2"]),
          ref[:3] + ref[4:])
    launches = {r: dict(zip(MH_KERNELS, got["launches"][r].tolist()))
                for r in range(2)}
    if min(min(v.values()) for v in launches.values()) <= 0:
        raise AssertionError("multihost: a kernel did not launch in a "
                             "process: %s" % launches)
    RECORD["multihost"] = dict(wall_s=wall, launches=launches,
                               fit_s=got["seconds"].tolist(),
                               card=card_line())
    log("multihost: 2 gloo processes on cuda:0, %d voxels each: gathered "
        "results equal the single-process fit bit for bit; launches a "
        "process %s; fit %.2f / %.2f s, the phase %.1f s [%s]" % (
            half, launches[0], got["seconds"][0], got["seconds"][1], wall,
            card_line()))


def phase_examples():
    """The examples on the card: demo_synthetic (its gates: the first
    fascicle's d_par exact in the median voxel, median R^2 > 0.999) and
    exactness_check on EXACT_VOX voxels of 986 atoms (exact fascicle ids
    with and without EAR, residuals below 1e-9 ||y||^2)."""
    from microstructure_fingerprinting_torch.examples import (
        demo_synthetic, exactness_check)
    rec = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in (
                ("demo_synthetic", lambda: demo_synthetic.main(
                    ["--device", "cuda", "--out", tmp])),
                ("exactness_check", lambda: exactness_check.main(
                    [str(EXACT_VOX), "--device", "cuda"]))):
            try:
                out, launches, sec = _counted(run)
            except SystemExit as e:
                raise AssertionError("%s: %s" % (name, e))
            # 128 atoms take the full-grid re-scan; 986 every kernel
            path = (("rescan3",) if name == "demo_synthetic" else
                    ("prep_block", "rowmin3", "rescan3", "rowmin4",
                     "rescan4"))
            if min(launches.get(k, 0) for k in path) <= 0:
                raise AssertionError("%s: a kernel of its path did not "
                                     "launch: %s" % (name, launches))
            out.pop("files", None)
            rec[name] = dict(out, launches=launches, seconds=sec)
            log("example %s: %s; launches %s; %.2f s [%s]" % (
                name, out, launches, sec, rec["card"]))
    RECORD["examples"] = rec


def idle_share(fn):
    """Device-idle share of fn() (which ends in a synchronisation), from
    a ``utils/profiling.device_trace`` capture: 1 minus the union of the
    kernel intervals over the window of a host range around fn() (the
    host and device clocks of a trace are one). Returns the record."""
    import glob
    import torch
    from microstructure_fingerprinting_torch.utils import profiling
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            with torch.profiler.record_function("chip_smoke fit"):
                fn()
        (path,) = glob.glob(os.path.join(tmp, "*.json"))
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    (win,) = [e for e in events if e.get("name") == "chip_smoke fit"
              and e.get("cat") == "user_annotation"]
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events if e.get("cat") == "kernel"
                   and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            busy += 0.0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += 0.0 if end is None else end - start
    return {"idle_share": 1.0 - busy / (t1 - t0), "window_ms": (t1 - t0) / 1e3,
            "kernel_busy_ms": busy / 1e3, "kernels": len(spans),
            "trace_mb": trace_mb}


def phase_graphs(wl, sig_ear):
    """Eager steps against CUDA graphs, on the GRAPH_VOLUMES: a fit of
    each volume eagerly (``graphs.eager()``) as the reference, a fit
    through the graphs (its captures), then GRAPH_TURNS warm fits, each
    timed on the host clock; every map and every launch count of each
    graph fit must equal the reference's bit for bit. Records voxels/s
    of each route (median, min-max), the graphs captured and the seconds
    of each capture, the allocator's peak and reserved memory after the
    volume (the graphs' pool holds their temporaries) and, for the
    IDLE_VOLUMES, the device-idle share of one fit on each route; then
    the cache is cleared."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.models import graphs
    rec = {"card": card_line()}
    for label in GRAPH_VOLUMES:
        model, args, kw, _mix = volume(wl, label, sig_ear)
        n = args[0][..., 0].size

        def fit(route):
            with graphs.eager() if route == "eager" else \
                    contextlib.nullcontext():
                mft.reset_counts()
                t0 = time.time()
                f = model.fit(*args, **kw)
                torch.cuda.synchronize()
                return f, dict(mft.LAUNCHES), time.time() - t0

        graphs.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_launches, _s = fit("eager")
        runs = {"eager": [], "graph": []}
        for route in ("graph",) + GRAPH_TURNS:
            f, launches, sec = fit(route)
            if route == "graph":
                for p in ref.param_names:
                    if not np.array_equal(getattr(f, p), getattr(ref, p)):
                        raise AssertionError("graphs %s: map %s of a graph "
                                             "fit differs from the eager "
                                             "fit's" % (label, p))
                if launches != ref_launches:
                    raise AssertionError("graphs %s: launches %s, eager %s"
                                         % (label, launches, ref_launches))
            runs[route].append(sec)
        cold = runs["graph"].pop(0)
        st = graphs.stats()
        r = {route: spread([n / t for t in secs])
             for route, secs in runs.items()}
        r.update(voxels=n, cold_graph_fit_s=cold, launches=ref_launches,
                 graphs=len(st),
                 capture_s=[e["capture_s"] for e in st],
                 replays=[e["replays"] for e in st],
                 steps=sorted({e["step"] for e in st}),
                 max_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                 reserved_gb=torch.cuda.memory_reserved() / 1e9)
        if label in IDLE_VOLUMES:
            for route in ("eager", "graph"):
                r["idle_" + route] = idle_share(lambda: fit(route))
        rec[label] = r
        log("graphs %s: %d voxels, every map and launch count of %d graph "
            "fits equal to the eager fit's; voxels/s eager %.1f (%.1f-%.1f), "
            "graph %.1f (%.1f-%.1f); %d graphs captured in %s s (first "
            "graph fit %.2f s), replays %s; peak %.2f GB, reserved %.2f GB%s "
            "[%s]" % (
                label, n, len(runs["graph"]) + 1, r["eager"]["median"],
                r["eager"]["min"], r["eager"]["max"], r["graph"]["median"],
                r["graph"]["min"], r["graph"]["max"], len(st),
                "/".join("%.3f" % c for c in r["capture_s"]), cold,
                r["replays"], r["max_allocated_gb"], r["reserved_gb"],
                "".join("; device idle %s %.3f of %.1f ms (%d kernels)" % (
                    route, r["idle_" + route]["idle_share"],
                    r["idle_" + route]["window_ms"],
                    r["idle_" + route]["kernels"])
                    for route in ("eager", "graph")
                    if "idle_" + route in r), rec["card"]))
        del model, ref
        graphs.clear()
        torch.cuda.empty_cache()
    RECORD["graphs"] = rec


KERNEL_META = {
    "prep_block": ("csrc/prep.cu", "ops/pallas_prep.py:206"),
    "prep_block_ear": ("csrc/prep.cu", "ops/pallas_prep.py:206"),
    "rowmin3": ("csrc/rowmin3.cu", "ops/f32scan.py:463"),
    "rescan3": ("csrc/rescan3.cu", "ops/pallas_dfscan.py:402"),
    "rowmin4": ("csrc/rowmin4.cu", "ops/f32scan.py:1042"),
    "rescan4": ("csrc/rescan4.cu", "ops/pallas_dfscan.py:911"),
    # XLA in the JAX package, no Pallas: the jitted function's line
    "df2scan": ("csrc/df2scan.cu", "ops/dfscan.py:428"),
    "finalize": ("csrc/finalize.cu", "ops/dfscan.py:1190"),
    # the XLA prologues of the JAX functions of rows rescan4 and df2scan
    "df4hoist": ("csrc/df4hoist.cu", "ops/pallas_dfscan.py:696"),
    "df2hoist": ("csrc/df2hoist.cu", "ops/dfscan.py:444"),
    # the XLA prologues of the JAX functions of rows rescan3 and rowmin4
    "df3hoist": ("csrc/df3hoist.cu", "ops/pallas_dfscan.py:258"),
    "row4hoist": ("csrc/row4hoist.cu", "ops/f32scan.py:823"),
    "row3hoist": ("csrc/row3hoist.cu", "ops/f32scan.py:367"),
    # the XLA normalization and pack_rhs before the prep of rowmin_3 and
    # rowmin_4: a row per rhs width, as kernel 1's
    "rhsprep": ("csrc/rhsprep.cu", "ops/f32scan.py:355"),
    "rhsprep_ear": ("csrc/rhsprep.cu", "ops/f32scan.py:808"),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.models import graphs
    t_all = time.time()
    phase_setup()
    t0 = time.time()
    wl = mft.testing.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX,
                                       device="cuda")
    sig_ear, wl["y_ear"] = mft.testing.make_ear(wl, N_EAR)
    wl["Dear"] = np.linspace(0.8e-9, 2.6e-9, N_EAR)
    log("workload synthesized in %.1f s" % (time.time() - t0))
    # kernel rows, and the launches of each fit summed per row: kernels 1
    # and 13 have a row per rhs width (2 columns without EAR, 12 with),
    # kernels 12 and 2 run in the flagship and mixed fits, kernels 3 and
    # 10 there and, on the EAR grid, in the EAR-mixed one, kernels 6 and 9
    # in the mixed one, kernels 11, 4, 5 and 8 in the EAR and EAR-mixed
    # ones, kernel 7 in all four
    rows, launches = {}, {}
    plain3 = {"rhsprep": "rhsprep", "prep_block": "prep_block",
              "row3hoist": "row3hoist", "rowmin3": "rowmin3",
              "rescan3": "rescan3", "finalize": "finalize",
              "df3hoist": "df3hoist"}
    plain4 = {"rhsprep_ear": "rhsprep", "prep_block_ear": "prep_block",
              "rowmin4": "rowmin4", "rescan4": "rescan4",
              "finalize": "finalize", "df4hoist": "df4hoist",
              "row4hoist": "row4hoist"}

    def counted(label, counts, by_row):
        RECORD.setdefault("launches_by_fit", {})[label] = counts
        for name, kernel in by_row.items():
            launches[name] = launches.get(name, 0) + counts[kernel]

    def ear_mixed():
        counts, (r3, r10) = phase_mixed(wl, sig_ear)
        counted("ear_mixed", counts, dict(plain4, rescan3="rescan3",
                                          df3hoist="df3hoist"))
        for name, r in (("rescan3", r3), ("df3hoist", r10)):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            r["max_abs_err"])

    for name, step in (
            ("kernels", lambda: rows.update(phase_kernels(wl))),
            ("fit", lambda: counted("flagship", phase_fit(wl), plain3)),
            ("overflow", phase_overflow),
            ("mixed", lambda: counted("mixed", phase_mixed(wl)[0],
                                      dict(plain3, df2scan="df2scan",
                                           df2hoist="df2hoist"))),
            ("ear_kernels", lambda: rows.update(phase_ear_kernels(wl,
                                                                  sig_ear))),
            ("ear_fit", lambda: counted("EAR", phase_fit(wl, sig_ear),
                                        plain4)),
            ("ear_overflow", lambda: phase_overflow(ear=True)),
            ("ear_mixed", ear_mixed),
            ("general", lambda: phase_general(wl, sig_ear)),
            ("general_wide", lambda: phase_general_wide(wl)),
            ("xla", lambda: phase_xla(wl)),
            ("golden", phase_golden),
            ("cli", lambda: RECORD["launches_by_fit"].update(
                cli=phase_cli(wl))),
            ("cli_ear", lambda: RECORD["launches_by_fit"].update(
                cli_ear=phase_cli(wl, sig_ear))),
            ("surface", lambda: phase_surface(wl)),
            ("mcf", lambda: phase_mcf(wl)),
            ("mesh", lambda: phase_mesh(wl, sig_ear)),
            ("multihost", lambda: phase_multihost(wl)),
            ("examples", phase_examples),
            ("graphs", lambda: phase_graphs(wl, sig_ear))):
        t0 = time.time()
        step()
        RECORD.setdefault("phase_s", {})[name] = time.time() - t0
        log("phase %s: %.1f s" % (name, time.time() - t0))
        # the phase's CUDA graphs (captures, replays), then the cache and
        # its memory pool freed for the next phase
        st = graphs.stats()
        if st:
            RECORD.setdefault("graphs_by_phase", {})[name] = dict(
                graphs=len(st), capture_s=sum(e["capture_s"] for e in st),
                replays=[e["replays"] for e in st])
        graphs.clear()
        torch.cuda.empty_cache()
    rows["finalize"]["max_abs_err"] = max([rows["finalize"]["max_abs_err"]]
                                          + FINALIZE_ERR)
    table = {"kernels": [
        dict(name=name, route="cuda",
             source="microstructure_fingerprinting_torch/" + src,
             replaces="microstructure_fingerprinting_tpu/" + tpu,
             launches=launches[name], **rows[name])
        for name, (src, tpu) in KERNEL_META.items()]}
    RECORD["total_s"] = time.time() - t_all
    log("record: " + json.dumps(RECORD))
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(*sys.argv[2:]))
    sys.exit(main())
