"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels of ``microstructure_fingerprinting_torch``
from ``csrc/``, holds each against its plain PyTorch version on the card
at the main paths' shapes (see ``held`` for the tolerance) and times
both, then drives the main paths through ``MFModel.fit``: the flagship
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
gates. Every phase runs; exits non-zero on any failure; needs one CUDA
device. The last line of standard output is the
JSON summary {"ok": true, "device": {...}}; the kernel table is the JSON
line before the card's name and power limit, with kernel 1 in a row per
rhs width (its launches in the fits at that width, its times at that
width) and every row's launches summed over the fits that run it; an
earlier ``record:`` line holds every number measured. Each fit is run
once cold (launch counts, recovery) and WARM_FITS times warm under the
stage timer: voxels/s, every stage, and each bucket's wall time and
stages as median and min-max, the flagship and EAR paths' "prep" and
"re-scan" stages split into the kernel and the torch code around it.
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
         "rescan4": 64, "rescan3_ear": 64}

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
    "rowmin4": lambda nx, ns: 30 + 37 * nx + 47 * ns,
    "rescan4": lambda nx, ns: 120 + 173 * nx + 145 * ns,
}
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
MH_KERNELS = ("prep_block", "rowmin3", "rescan3")
MH_TIMEOUT = 240
#: voxels of the exactness_check example
EXACT_VOX = 256
#: the repo's frozen end-to-end fixture (tests/test_golden.py)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "golden_fit.npz")

RECORD = {}


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


def phase_kernels(wl):
    """Kernels 1-3 against their plain PyTorch versions, on the card, at
    the flagship path's chunk of CHUNK voxels (the re-scan also on the
    full 782 x 782 grid of the one-pass branch and the last overflow
    tier)."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan, prep, rescan
    from microstructure_fingerprinting_torch.ops import nnls as mfn
    dev = torch.device("cuda")
    D, y, a3 = voxel_inputs(wl, np.arange(CHUNK), wl["y"], dev)
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    del D
    rows = {}
    S = y.shape[1]

    # kernel 1: both prep shapes of the row pass
    yh, _, _ = mfn._normalize_y(y)
    a3h, _ = mfn._normalize_block(a3)
    rhs = prep.pack_rhs([yh, a3h[:, :, 0]])[:3]
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
    RECORD["kernel_check_voxels"] = CHUNK
    log_rows(rows)
    del A1, A2, a3, y
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


def phase_ear_kernels(wl, sig_ear):
    """Kernels 1, 4 and 5 against their plain versions at the EAR path's
    shapes: prep with 12 rhs columns on both blocks and the row pass on a
    CHUNK-voxel chunk at [782, 782, 1, 10]; the re-scan at the two-pass
    shape R_EAR x R_EAR on the chunk and on the full grid for 8 voxels."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan, prep, rescan
    from microstructure_fingerprinting_torch.ops import nnls as mfn
    dev = torch.device("cuda")
    D, y, a3, a4 = ear_inputs(wl, sig_ear, CHUNK, dev)
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    del D
    rows = {}
    S = y.shape[1]
    nx, ns = 1 + N_EAR, N_EAR

    # kernel 1 at 12 rhs columns (signal, CSF, 10 EAR atoms)
    yh, _, _ = mfn._normalize_y(y)
    a3h, _ = mfn._normalize_block(a3)
    a4h, _ = mfn._normalize_block(a4)
    rhs = prep.pack_rhs([yh, a3h[:, :, 0]]
                        + [a4h[:, :, i] for i in range(N_EAR)])[:3]
    NB, N2B = rescan.col_blocks(N_ATOM, 512, 16)
    check_prep(rows, "prep_block_ear", ((A1, 128, "xr"), (A2, N2B, "ra")),
               rhs, 2 + N_EAR)

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

    # kernel 5: the re-scan at R_EAR x R_EAR on the chunk (timed), then
    # on the full 782 x 782 grid for 8 voxels
    err = 0.0
    for n, B in ((R_EAR, CHUNK), (N_ATOM, 8)):
        ops, segw, _yn = rescan.row_scan_df4_operands(
            A1[:B, :, :n], A2[:B, :, :n], a3[:B], a4[:B], y[:B])
        kw = dict(n2=n, n3=1, n4=N_EAR, segw=segw)
        kern = lambda: rescan.rescan4_rows(*ops, **kw)
        plain = lambda: plain_sliced(
            lambda *o: rescan.rescan4_twin(*o, **kw), ops, SLICE["rescan4"])
        seg = rescan.n_segments_df4(n)
        top1 = lambda o: rescan.candidates_from_rows_df4(
            o[0].reshape(B, -1), o[1].reshape(B, -1), ns, N_EAR, n,
            segments_total=seg)[0]
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


def warm_fits(label, model, args, kw, launches, split=()):
    """WARM_FITS warm fits, each under the stage timer (two event records
    a region, no synchronisation inside the fit): host wall clock around
    the fit for voxels/s, device time per stage, and per bucket its wall
    time (its "pulled" line at verbose 2: a bucket's work all happens
    there and ends in a copy to the host) and the device time of the
    stages inside it. Each launch is a stage of its own inside the stage
    that holds it: for each (stage, kernel) of ``split`` what is left of
    the stage is its torch code (hoists), and every launch of the fit
    must lie inside that stage, or the split would understate the
    hoists. Returns the record of the runs."""
    import torch
    from microstructure_fingerprinting_torch.utils import profiling
    n_vox = args[0][..., 0].size
    card = card_line()
    warm_s, runs, buckets = [], [], []
    for _ in range(WARM_FITS):
        out = io.StringIO()
        with profiling.StageTimer() as st, contextlib.redirect_stdout(out):
            t0 = time.time()
            model.fit(*args, **dict(kw, verbose=2))
            torch.cuda.synchronize()
            warm_s.append(time.time() - t0)
        totals = st.totals_ms()
        stages = {k: v for k, v in totals.items()
                  if not k.startswith(("kernel ", "bucket "))}
        for stage_name, kernel in split:
            k_ms, n = st.inside(stage_name).get("kernel " + kernel, (0.0, 0))
            if n != launches[kernel]:
                raise AssertionError(
                    "%d of the fit's %d launches of %s lie inside stage %s"
                    % (n, launches[kernel], kernel, stage_name))
            stages["%s: kernel %s" % (stage_name, kernel)] = k_ms
            stages[stage_name + ": torch hoists"] = stages[stage_name] - k_ms
        runs.append(stages)
        per = {}
        for m in re.finditer(r"Bucket (K=\d csf=\d ear=\d) \(\d+ voxels\) "
                             r"pulled in (\S+) second", out.getvalue()):
            per["%s: wall ms" % m.group(1)] = 1e3 * float(m.group(2))
        for name in totals:
            if name.startswith("bucket "):
                for inner, (ms, _n) in st.inside(name).items():
                    per["%s: %s ms" % (name[len("bucket "):], inner)] = ms
        buckets.append(per)
    vps = spread([n_vox / s for s in warm_s])
    log("%s: %d warm fits: %s s; voxels/s median %.1f (min %.1f, max %.1f) "
        "[%s]" % (label, WARM_FITS, ", ".join("%.3f" % s for s in warm_s),
                  vps["median"], vps["min"], vps["max"], card))
    stages = {k: spread([r[k] for r in runs]) for k in runs[0]}
    log("%s: stages, device ms a fit, median (min-max) of %d fits: " % (
        label, WARM_FITS) + ", ".join(
            "%s %.1f (%.1f-%.1f)" % (k, v["median"], v["min"], v["max"])
            for k, v in stages.items()))
    per_bucket = {k: spread([b.get(k, 0.0) for b in buckets])
                  for k in buckets[0]}
    log("%s: buckets, wall ms and device ms of their stages, median "
        "(min-max) of %d fits: " % (label, WARM_FITS) + ", ".join(
            "%s %.1f (%.1f-%.1f)" % (k, v["median"], v["min"], v["max"])
            for k, v in sorted(per_bucket.items())))
    return dict(warm_fit_s=warm_s, voxels_per_s=vps, stages_ms=stages,
                buckets_ms=per_bucket, card=card)


def phase_fit(wl, sig_ear=None):
    """One main path through MFModel.fit, cold (launch counts) and
    WARM_FITS times warm (voxels/s, stages): the flagship volume, or with
    ``sig_ear`` the EAR volume (csf_mask = ear_mask = 1). Every voxel must
    recover its planted atoms (with EAR: also ie = 4) or an objective at
    most the planted one's plus 2e-9 ||y||^2, at R^2 >= 1 - 1e-6; the maps
    must reload identically."""
    import microstructure_fingerprinting_torch as mft
    ear = sig_ear is not None
    label = "EAR" if ear else "flagship"
    ys_np = wl["y_ear"] if ear else wl["y"]
    data, mask, numfasc, peaks = make_volume(wl, ys_np)
    model = mft.MFModel(fit_dictionary(wl, sig_ear))
    kw = dict(peaks=peaks, pgse_scheme=wl["sch_mat"], csf_mask=1, verbose=0)
    if ear:
        kw["ear_mask"] = 1
    path = ("prep_block", "rowmin4", "rescan4") if ear else (
        "prep_block", "rowmin3", "rescan3")
    args = (data, mask, numfasc)
    fit, launches, cold_s = cold_fit(label, model, args, kw, path)
    n_tie, min_r2 = check_recovery(label, wl, fit, ys_np, wl["gt_ids"],
                                   np.full(N_VOX, 2), np.ones(N_VOX, bool),
                                   sig_ear)
    check_maps(label, fit, ear)
    RECORD[label] = dict(
        cold_fit_s=cold_s, launches=launches, n_ties=n_tie, min_r2=min_r2,
        **warm_fits(label, model, args, kw, launches,
                    split=(("prep", path[0]), ("re-scan", path[2]))))
    return launches


def check_rescan3_ear_grid(wl, mix, sig_ear):
    """Kernel 3 on the one-fascicle + CSF + EAR bucket's full
    [782, 10, 1] grid (the EAR atoms as the second axis, CSF the fixed
    third block), on the chunk of that bucket's CHUNK voxels that the fit
    gives it, against its plain version; timed. Returns its row."""
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
    return r


def df2_chunk_cost(wl):
    """The eager-torch df2 scan (``dfscan.df2_candidates``, M = 1) on one
    CHUNK-voxel chunk at both of its shapes, [782, 782] (two fascicles
    without CSF) and [782, 1] (one fascicle + CSF): device ms a chunk and
    the most memory it allocates above what was held before it."""
    import torch
    from microstructure_fingerprinting_torch.ops import dfscan
    D, y, a3 = voxel_inputs(wl, np.arange(CHUNK), wl["y"], "cuda")
    out = {}
    for name, A2 in (("782 x 782", D[:, 1]), ("782 x 1", a3)):
        scan = lambda: dfscan.df2_candidates(D[:, 0], A2, y, M=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scan()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = timed(scan, reps=2)
        out[name] = {"ms": ms, "peak_bytes": peak}
        log("df2 scan %s, %d voxels: %.3f ms a chunk, peak %.2f GB above "
            "its inputs" % (name, CHUNK, ms, peak / 1e9))
    RECORD["df2_chunk"] = out
    del D, y, a3
    torch.cuda.empty_cache()


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
    import microstructure_fingerprinting_torch as mft
    ear = sig_ear is not None
    label, spec = ("ear_mixed", EAR_MIXED) if ear else ("mixed", MIXED)
    mix = mft.testing.make_mixed(wl, spec["groups"], sig_ear,
                                 ear_atom=EAR_ATOM)
    shape, S = spec["shape"], wl["sch_mat"].shape[0]
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"],
              csf_mask=mix["csf_mask"].reshape(shape).astype(float),
              verbose=0)
    if ear:
        kw["ear_mask"] = 1
    path = ("prep_block", "rowmin4", "rescan4", "rescan3") if ear else (
        "prep_block", "rowmin3", "rescan3")
    model = mft.MFModel(fit_dictionary(wl, sig_ear))
    fit, launches, cold_s = cold_fit(label, model, args, kw, path)
    n_tie, min_r2 = check_recovery(label, wl, fit, mix["y"], mix["gt_ids"],
                                   mix["numfasc"], mix["csf_mask"], sig_ear)
    check_maps(label, fit, ear)
    RECORD[label] = dict(
        cold_fit_s=cold_s, launches=launches, n_ties=n_tie, min_r2=min_r2,
        voxels={"K=%d csf=%d" % k: len(v) for k, v in mix["buckets"].items()},
        **warm_fits(label, model, args, kw, launches))
    del fit, model
    if ear:
        rescan3_ear = check_rescan3_ear_grid(wl, mix, sig_ear)
    else:
        rescan3_ear = None
        df2_chunk_cost(wl)
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
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.utils import native
    ok = native.available()
    log("general: native host helper available: %s" % ok)
    RECORD["native_available"] = ok
    if not ok:
        raise AssertionError("the native host helper (csrc/mf_native.cpp) "
                             "did not build")
    label = "general"
    mix = mft.testing.make_mixed(wl, GENERAL["groups"], sig_ear,
                                 ear_atom=EAR_ATOM)
    shape, S = GENERAL["shape"], wl["sch_mat"].shape[0]
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"], csf_mask=0,
              ear_mask=mix["ear_mask"].reshape(shape).astype(float),
              verbose=0)
    model = mft.MFModel(fit_dictionary(wl, sig_ear))
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


KERNEL_META = {
    "prep_block": ("csrc/prep.cu", "ops/pallas_prep.py:206"),
    "prep_block_ear": ("csrc/prep.cu", "ops/pallas_prep.py:206"),
    "rowmin3": ("csrc/rowmin3.cu", "ops/f32scan.py:463"),
    "rescan3": ("csrc/rescan3.cu", "ops/pallas_dfscan.py:402"),
    "rowmin4": ("csrc/rowmin4.cu", "ops/f32scan.py:1042"),
    "rescan4": ("csrc/rescan4.cu", "ops/pallas_dfscan.py:911"),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import microstructure_fingerprinting_torch as mft
    t_all = time.time()
    phase_setup()
    t0 = time.time()
    wl = mft.testing.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX,
                                       device="cuda")
    sig_ear, wl["y_ear"] = mft.testing.make_ear(wl, N_EAR)
    wl["Dear"] = np.linspace(0.8e-9, 2.6e-9, N_EAR)
    log("workload synthesized in %.1f s" % (time.time() - t0))
    # kernel rows, and the launches of each fit summed per row: kernel 1
    # has a row per rhs width (2 columns without EAR, 12 with), kernel 3
    # runs in the flagship and mixed fits and, on the EAR grid, in the
    # EAR-mixed one
    rows, launches = {}, {}
    plain3 = {"prep_block": "prep_block", "rowmin3": "rowmin3",
              "rescan3": "rescan3"}
    plain4 = {"prep_block_ear": "prep_block", "rowmin4": "rowmin4",
              "rescan4": "rescan4"}

    def counted(label, counts, by_row):
        RECORD.setdefault("launches_by_fit", {})[label] = counts
        for name, kernel in by_row.items():
            launches[name] = launches.get(name, 0) + counts[kernel]

    def ear_mixed():
        counts, r3 = phase_mixed(wl, sig_ear)
        counted("ear_mixed", counts, dict(plain4, rescan3="rescan3"))
        rows["rescan3"]["max_abs_err"] = max(rows["rescan3"]["max_abs_err"],
                                             r3["max_abs_err"])

    for name, step in (
            ("kernels", lambda: rows.update(phase_kernels(wl))),
            ("fit", lambda: counted("flagship", phase_fit(wl), plain3)),
            ("overflow", phase_overflow),
            ("mixed", lambda: counted("mixed", phase_mixed(wl)[0], plain3)),
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
            ("examples", phase_examples)):
        t0 = time.time()
        step()
        RECORD.setdefault("phase_s", {})[name] = time.time() - t0
        log("phase %s: %.1f s" % (name, time.time() - t0))
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
