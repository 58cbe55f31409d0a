"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels of ``microstructure_fingerprinting_torch``
from ``csrc/``, holds each against its plain PyTorch version on the card
at the main paths' shapes (see ``held`` for the tolerance) and times
both, then drives the two main paths through ``MFModel.fit``: the
flagship [782, 782, 1] two-fascicle + CSF volume and the EAR (UK-Biobank)
[782, 782, 1, 10] volume (552 sequences, 4096 voxels each, random
directions, noiseless), writes and reloads their maps, and drives the
overflow tiers of both. Every phase runs; exits non-zero on any
failure; needs one CUDA device. The last line of standard output is the
JSON summary {"ok": true, "device": {...}}; the kernel table is the JSON
line before the card's name and power limit, with kernel 1 in a row per
main path (its launches in that path's fit, its times at that path's rhs
count); an earlier ``record:`` line holds every number measured. Each main
path is fitted once cold (launch counts, recovery) and WARM_FITS times warm
under the stage timer: voxels/s and every stage as median and min-max, the
"prep" and "re-scan" stages split into the kernel and the torch code
around it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_VOX = 4096          # 16 x 16 x 16 volume
N_ATOM = 782          # flagship sub-dictionary size
N_EAR = 10            # EAR diffusivities of the UK-Biobank configuration
R_EAR = 256           # the EAR two-pass row budget (twopass_rows_ear)
CHUNK = 512           # voxels per chunk of the fit (MFModel.fit default)
#: voxels per call of each plain version when it is held against its
#: kernel on a whole chunk (bounds the plain versions' temporaries)
SLICE = {"prep_block": 128, "rowmin3": 64, "rescan3": 512, "rowmin4": 16,
         "rescan4": 64}

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


def flagship_inputs(wl, B, device):
    """Rotated blocks, signals and the CSF block for the first B voxels."""
    import torch
    from microstructure_fingerprinting_torch.ops import interp as mfi
    ms, plan = wl["msinterp"], wl["plan"]
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    _x, ys, _c = ms.device_tables(device, torch.float32)
    D = rotate(ys, torch.as_tensor(wl["peaks"][:B], dtype=torch.float32,
                                   device=device))
    y = torch.as_tensor(wl["y"][:B][:, perm], dtype=torch.float32,
                        device=device)
    csf = torch.as_tensor(wl["sig_csf"][perm], dtype=torch.float32,
                          device=device)
    return D, y, csf[None, :, None].expand(B, -1, 1).contiguous()


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


def check_rescan(name, kern, plain, top1, B, n):
    """A re-scan kernel against its plain version: row minima by the
    agreement rule, first-minimum indices and the top-1 exact. Returns
    (max|err|, the kernel's outputs)."""
    import torch
    k, p = kern(), plain()
    what = "%s %d x %d, %d voxels" % (name, n, n, B)
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
    D, y, a3 = flagship_inputs(wl, CHUNK, dev)
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
    D, _y, a3 = flagship_inputs(wl, B, device)
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


def phase_fit(wl, sig_ear=None):
    """One main path through MFModel.fit, cold (launch counts) and
    WARM_FITS times warm (voxels/s, stages): the flagship volume, or with
    ``sig_ear`` the EAR volume (csf_mask = ear_mask = 1). Every voxel must
    recover its planted atoms (with EAR: also ie = 4) or an objective at
    most the planted one's plus 2e-9 ||y||^2, at R^2 >= 1 - 1e-6; the maps
    must reload identically."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.utils import nifti, profiling
    ear = sig_ear is not None
    label = "EAR" if ear else "flagship"
    sch = wl["sch_mat"]
    ys_np = wl["y_ear"] if ear else wl["y"]
    data, mask, numfasc, peaks = make_volume(wl, ys_np)
    model = mft.MFModel(fit_dictionary(wl, sig_ear))
    kw = dict(peaks=peaks, pgse_scheme=sch, csf_mask=1, verbose=0)
    if ear:
        kw["ear_mask"] = 1
    path = ("prep_block", "rowmin4", "rescan4") if ear else (
        "prep_block", "rowmin3", "rescan3")

    mft.reset_counts()
    t0 = time.time()
    fit = model.fit(data, mask, numfasc, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = {k: mft.LAUNCHES[k] for k in path}
    log("%s: cold fit of %d voxels: %.2f s; kernel launches %s"
        % (label, N_VOX, cold_s, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the %s path was never launched"
                             % label)

    r2 = fit.R2.reshape(-1)
    if not np.all(r2 >= 1 - 1e-6):
        raise AssertionError("R2 below 1 - 1e-6 in %d voxels (min %.9f)"
                             % (int(np.sum(r2 < 1 - 1e-6)), r2.min()))
    ids = [fit.atom_id_f0.reshape(-1), fit.atom_id_f1.reshape(-1)]
    gt = [wl["gt_ids"][:, 0], wl["gt_ids"][:, 1]]
    if ear:
        d_ear = fit.D_ear.reshape(-1)
        ids.append(np.argmin(np.abs(d_ear[:, None] - wl["Dear"][None]),
                             axis=1))
        gt.append(np.full(N_VOX, 4))
    ids = np.stack(ids, axis=1).astype(np.int64)
    gt = np.stack(gt, axis=1)
    diff = np.flatnonzero(np.any(ids != gt, axis=1))
    ysq = np.sum(ys_np ** 2, axis=1)
    obj = fit.MSE.reshape(-1) * sch.shape[0]
    n_tie = 0
    if diff.size:
        # objective of the planted atoms on the same rotated columns
        rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                        wl["plan"])
        _x, ys, _c = wl["msinterp"].device_tables("cuda", torch.float32)
        D = rotate(ys, torch.as_tensor(wl["peaks"][diff], dtype=torch.float32,
                                       device="cuda"))
        y = torch.as_tensor(ys_np[diff][:, perm], dtype=torch.float32,
                            device="cuda")
        csf = torch.as_tensor(wl["sig_csf"][perm], dtype=torch.float32,
                              device="cuda")
        cand = np.concatenate([gt[diff][:, :2], np.zeros((diff.size, 1)),
                               gt[diff][:, 2:]], axis=1)
        ear_d = (torch.as_tensor(sig_ear[perm], dtype=torch.float32,
                                 device="cuda") if ear else None)
        _w, obj_gt, _r2 = fit_mod._finalize_top1(
            D, csf, y, torch.as_tensor(cand, dtype=torch.int64,
                                       device="cuda"), ear_d)
        obj_gt = obj_gt.double().cpu().numpy()
        for k, v in enumerate(diff):
            tie = obj[v] <= obj_gt[k] + 2e-9 * ysq[v]
            log("%s voxel %d: selected %s, planted %s, objective %.6e vs "
                "planted %.6e -> %s" % (label, v, ids[v].tolist(),
                                        gt[v].tolist(), obj[v], obj_gt[k],
                                        "tie" if tie else "ERROR"))
            if not tie:
                raise AssertionError("voxel %d selected a worse support" % v)
            n_tie += 1
    log("%s: planted atoms recovered in %d/%d voxels (%d equal-or-better "
        "objectives); min R2 %.9f; max MSE/||y||^2 %.3e" % (
            label, N_VOX - diff.size, N_VOX, n_tie, r2.min(),
            np.max(obj / ysq)))

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

    # WARM_FITS warm fits, each under the stage timer (two event records a
    # region, no synchronisation inside the fit): host wall clock around
    # the fit for voxels/s, device time per stage. Each launch is a stage
    # of its own inside the stage that holds it: what is left of "prep" and
    # "re-scan" is their torch code (hoists). Every launch of the fit must
    # lie inside that stage, or the split would understate the hoists
    card = card_line()
    warm_s, runs = [], []
    for _ in range(WARM_FITS):
        with profiling.StageTimer() as st:
            t0 = time.time()
            model.fit(data, mask, numfasc, **kw)
            torch.cuda.synchronize()
            warm_s.append(time.time() - t0)
        stages = {k: v for k, v in st.totals_ms().items()
                  if not k.startswith("kernel ")}
        for stage_name, kernel in (("prep", path[0]), ("re-scan", path[2])):
            k_ms, n = st.inside(stage_name).get("kernel " + kernel, (0.0, 0))
            if n != launches[kernel]:
                raise AssertionError(
                    "%d of the fit's %d launches of %s lie inside stage %s"
                    % (n, launches[kernel], kernel, stage_name))
            stages["%s: kernel %s" % (stage_name, kernel)] = k_ms
            stages[stage_name + ": torch hoists"] = stages[stage_name] - k_ms
        runs.append(stages)
    vps = spread([N_VOX / s for s in warm_s])
    log("%s: %d warm fits: %s s; voxels/s median %.1f (min %.1f, max %.1f) "
        "[%s]" % (label, WARM_FITS, ", ".join("%.3f" % s for s in warm_s),
                  vps["median"], vps["min"], vps["max"], card))
    stages = {k: spread([r[k] for r in runs]) for k in runs[0]}
    log("%s: stages, device ms a fit, median (min-max) of %d fits: " % (
        label, WARM_FITS) + ", ".join(
            "%s %.1f (%.1f-%.1f)" % (k, v["median"], v["min"], v["max"])
            for k, v in stages.items()))
    RECORD[label] = dict(cold_fit_s=cold_s, warm_fit_s=warm_s,
                         voxels_per_s=vps, stages_ms=stages,
                         launches=launches, n_ties=n_tie,
                         min_r2=float(r2.min()), card=card)
    return launches


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
    # kernel rows, and the launches of each main path's cold fit: kernel 1
    # has a row per path (2 rhs columns on the flagship, 12 on the EAR one)
    rows, launches = {}, {}

    def ear_fit():
        n = phase_fit(wl, sig_ear)
        launches.update(prep_block_ear=n["prep_block"], rowmin4=n["rowmin4"],
                        rescan4=n["rescan4"])

    for name, step in (
            ("kernels", lambda: rows.update(phase_kernels(wl))),
            ("fit", lambda: launches.update(phase_fit(wl))),
            ("overflow", phase_overflow),
            ("ear_kernels", lambda: rows.update(phase_ear_kernels(wl,
                                                                  sig_ear))),
            ("ear_fit", ear_fit),
            ("ear_overflow", lambda: phase_overflow(ear=True))):
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
    sys.exit(main())
