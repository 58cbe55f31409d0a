"""Where the time of kernels 6-13 goes, phase by phase.

Builds the kernels a second time with ``-DMF_PHASES`` (``csrc/phases.cuh``:
at each mark a block barrier, then thread 0 adds the clock cycles since
the previous mark to that phase's counter), apart from the fit's library
(``build/mf_torch_kernels_phases/``), and runs on one chunk of the
flagship workload (552 sequences, 782 atoms, seed 0): kernel 8
(``rescan.df4_hoist``, the EAR re-scan's operands at R x R) and kernel 11
(``f32scan.row4_hoist``, the EAR row pass's hoists at N x N) with the CSF
and ``--ear`` EAR atoms; kernel 6 (``dfscan.df2_rows``, the df2 scan of
two fascicles without CSF) on the chunk's two rotated blocks at 782 x
782; kernel 13 (``prep.rhs_prep``) at 2 columns (the signal and the CSF
column) and at 2 + ``--ear`` columns; kernel 10 (``rescan.df3_hoist``,
the re-scan's operands) at the two-pass shape 128 x 128; kernel 9
(``dfscan.df2_hoist``, the df2 scan's operands) at 782 x 782 and 782 x 1
(the CSF column); kernel 12 (``f32scan.row3_hoist``, the flagship row
pass's hoists) at 782 x 782; kernel 7 (``dfscan.finalize_top1``, the
fit's finalize) on the chunk's planted winners at C = 3 (two fascicles
+ CSF) and C = 4 (+ EAR atom 4). For each kernel it prints every
phase's cycles, summed over blocks, and their share, beside the kernel
call's time on the fit's library (CUDA events, mean of ``--reps``), and
the card's name and power limit, and each launch's device time
(``torch.profiler``). The barriers of the marks serialise what the warps
of a block would overlap, and the cycles are summed over the blocks of
every launch of the call: the shares split a launch, the times are the
fit's.

    python -m microstructure_fingerprinting_torch.examples.kernel_phases \
        [chunk] [--rows 256] [--ear 10] [--reps 5]
"""

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from .. import testing as mft
from ..ops import dfscan, f32scan, kernels, prep, rescan
from ..ops import interp as mfi

_DF_HOIST_PHASES = ("the voxel launch (its small Grams, vox)",
                    "the atom stream (copy waits, tile stores)",
                    "the atoms' quantise and Grams (one pass)",
                    "the chain and the pack stores")
#: what each phase counter holds (csrc/phases.cuh marks), by the counter
#: reader of the kernel's source
PHASES = {
    "mf_df4hoist_phases": ("the voxel's small Grams",
                           "the atom stream / Gram reads",
                           "the voxel's factors",
                           "the chain and the pack stores",
                           "the atom Grams on the tensor cores"),
    "mf_row4hoist_phases": ("the voxel's small Grams",
                            "the atom stream / Gram reads",
                            "the voxel's factors",
                            "the chain and the pack stores"),
    "mf_df2scan_phases": ("the Gram tile (copies and mma)",
                          "the move to the chain's owners",
                          "the chain and the running minima"),
    "mf_rhsprep_phases": ("the norms (a launch of their own)",
                          "the live columns normalised and quantised",
                          "the pack stores"),
    "mf_df3hoist_phases": _DF_HOIST_PHASES,
    "mf_df2hoist_phases": _DF_HOIST_PHASES,
    "mf_row3hoist_phases": ("the voxel launch (quantise, small Grams)",
                            "the atom launch's scratch read",
                            "the chain and the pack stores",
                            "the column blocks' floor partials"),
    "mf_finalize_phases": ("the column reads (staged)",
                           "the scales and the Gram",
                           "the solve across the lanes",
                           "R^2 and the stores"),
}


def _ms(fn, reps):
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


def _launches(fn, reps):
    """Device ms a call of each kernel that fn launches (torch.profiler,
    CUPTI), by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t:
            out[ev.key] = t / 1e3 / reps
    return out


def _phase_library():
    """The kernels built with -DMF_PHASES, loaded apart."""
    flags, where, lib = kernels.NVCC_FLAGS, kernels.BUILD_DIR, kernels._lib
    kernels.NVCC_FLAGS = flags + ("-DMF_PHASES",)
    kernels.BUILD_DIR = where + "_phases"
    kernels._lib = None
    try:
        return kernels.library()
    finally:
        kernels.NVCC_FLAGS, kernels.BUILD_DIR, kernels._lib = (flags, where,
                                                               lib)


def _cycles(phases_lib, name, fn):
    """Run fn once on the phase library; its counters."""
    out = (ctypes.c_ulonglong * 8)()
    reader = getattr(phases_lib, name)
    reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    if reader(ctypes.addressof(out), 1):
        raise RuntimeError("%s failed" % name)
    fn()
    torch.cuda.synchronize()
    if reader(ctypes.addressof(out), 1):
        raise RuntimeError("%s failed" % name)
    return [int(c) for c in out]


def _report(label, reader, ms, cycles, launches):
    total = float(sum(cycles)) or 1.0
    print("%s: %.3f ms a call (fit's library)" % (label, ms))
    for name, t in sorted(launches.items(), key=lambda kv: -kv[1]):
        print("  launch %-60s %.4f ms" % (name[:60], t))
    for k, c in enumerate(cycles):
        if c:
            print("  phase %d %-36s %14d cycles  %5.1f%%"
                  % (k, PHASES[reader][k], c, 100.0 * c / total))
    return {"ms": ms, "cycles": cycles}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512)
    ap.add_argument("--rows", type=int, default=256,
                    help="kernel 8's R x R grid (default 256)")
    ap.add_argument("--ear", type=int, default=10,
                    help="EAR atoms (kernel 11 takes at most 13)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print("card: %s" % (card[0] if card else "not read"))
    wl = mft.make_fit_workload(num_atom=782, n_vox=args.chunk, device="cuda")
    sig_ear, y_ear = mft.make_ear(wl, args.ear)
    rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                    wl["plan"])
    _x, ys_t, _c = wl["msinterp"].device_tables(dev, torch.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    D = rotate(ys_t, f32(wl["peaks"]))
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    y = f32(y_ear[:, perm])
    B = y.shape[0]
    a3 = f32(wl["sig_csf"][perm])[None, :, None].expand(B, -1, 1)
    a3 = a3.contiguous()
    a4 = f32(sig_ear[perm])[None].expand(B, -1, -1).contiguous()

    n = args.rows
    *blk, n2pb, _yn = rescan.df4_normalized(A1[:, :, :n], A2[:, :, :n], a3,
                                            a4, y)
    _planes, ins = f32scan.rowmin_4_prep(A1, A2, a3, a4, y)
    y2 = f32(wl["y"][:, perm])
    ops6, _yn = dfscan.df2_scan_operands(A1, A2, y2)
    *blk10, n2pb10, _yn = rescan.df3_normalized(A1[:, :, :128],
                                                A2[:, :, :128], a3, y2)
    ins9 = {name: dfscan.df2_normalized(A1, blk, y2)[:3]
            for name, blk in (("782 x 782", A2), ("782 x 1", a3))}
    _planes3, ins12 = f32scan.rowmin_3_prep(A1, A2, a3, y2)
    gt = torch.as_tensor(wl["gt_ids"], dtype=torch.int64, device=dev)
    csf, ear = a3[0, :, 0], a4[0]
    fin3 = (D, csf, None, y2, gt, True, False, 2)
    fin4 = (D, csf, ear, y, torch.cat([gt, torch.full_like(gt[:, :1], 4)],
                                      1), True, True, 2)
    runs = (
        ("df4hoist", "mf_df4hoist_phases", "kernel 8 df4hoist %d x %d, "
         "E = %d, %d voxels" % (n, n, args.ear, B),
         lambda: rescan.df4_hoist(*blk, n2pb)),
        ("row4hoist", "mf_row4hoist_phases", "kernel 11 row4hoist 782 x "
         "782, E = %d, %d voxels" % (args.ear, B),
         lambda: f32scan.row4_hoist(*ins)),
        ("df2scan", "mf_df2scan_phases", "kernel 6 df2scan 782 x 782, %d "
         "voxels" % B, lambda: dfscan.df2_rows(*ops6, n1=782, n2=782)),
        ("rhsprep", "mf_rhsprep_phases", "kernel 13 rhsprep 2 columns, %d "
         "voxels" % B, lambda: prep.rhs_prep(y2, a3)),
        ("rhsprep_ear", "mf_rhsprep_phases", "kernel 13 rhsprep %d "
         "columns, %d voxels" % (2 + args.ear, B),
         lambda: prep.rhs_prep(y, a3, a4)),
        ("df3hoist", "mf_df3hoist_phases", "kernel 10 df3hoist 128 x 128, "
         "%d voxels" % B, lambda: rescan.df3_hoist(*blk10, n2pb10))) + tuple(
        ("df2hoist %s" % name, "mf_df2hoist_phases", "kernel 9 df2hoist "
         "%s, %d voxels" % (name, B),
         lambda x=x: dfscan.df2_hoist(*x, dfscan.df2_cols(x[1].shape[2])))
        for name, x in ins9.items()) + (
        ("row3hoist", "mf_row3hoist_phases", "kernel 12 row3hoist 782 x "
         "782, %d voxels" % B, lambda: f32scan.row3_hoist(*ins12)),
        ("finalize C = 3", "mf_finalize_phases", "kernel 7 finalize_top1 "
         "C = 3, %d voxels" % B, lambda: dfscan.finalize_top1(*fin3)),
        ("finalize C = 4", "mf_finalize_phases", "kernel 7 finalize_top1 "
         "C = 4, %d voxels" % B, lambda: dfscan.finalize_top1(*fin4)))
    ms = {key: _ms(fn, args.reps) for key, _r, _l, fn in runs}
    launches = {key: _launches(fn, args.reps) for key, _r, _l, fn in runs}

    lib = _phase_library()
    saved = kernels._lib
    kernels._lib = lib
    try:
        cycles = {key: _cycles(lib, reader, fn)
                  for key, reader, _l, fn in runs}
    finally:
        kernels._lib = saved
    return {key: _report(label, reader, ms[key], cycles[key], launches[key])
            for key, reader, label, _fn in runs}


if __name__ == "__main__":
    main()
