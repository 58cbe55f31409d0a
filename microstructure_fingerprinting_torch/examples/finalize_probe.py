"""Kernels 7 and 12 built with parts of their design changed, timed in
turns against the shipped ones; the fit's finalize stage against the
route it replaced; and the split of both kernels as a checkout calls them.

Builds ``csrc/finalize.cu`` and ``csrc/row3hoist.cu`` apart from the
fit's library (``build/mf_torch_kernels_probe7/``), as shipped and
changed each way of ``CUTS``:

  * kernel 7, "divisions": the per-sample scalings as quotients (x / sc,
    z / 2^-7, z / 2^-15, the first body's) in place of the exact
    products;
  * kernel 7, "stage 1" / "stage 18": 1 or 18 samples a lane in flight
    while the columns are staged (8 shipped);
  * kernel 7, "1 warp a block": a voxel a block (4 shipped);
  * kernel 12, "serial floor": a column block's floor partial folded by
    one thread over the block's 128 values (the first body's), in place
    of the shuffles.

Each build is held bit for bit against the shipped one, then timed by the
device time of its launches (``torch.profiler``, mean of ``--reps``),
warm and with the L2 cache flushed before each call (a 256 MB write), in
turns (shipped, builds, builds reversed, shipped last) on one chunk of
the flagship workload (552 sequences, 782 atoms, seed 0: the rotated
blocks of its first ``chunk`` voxels): kernel 7 as the fit runs it
(``dfscan.finalize_top1``) at C = 3 (two fascicles + CSF), C = 4 (+ EAR
atom 4 of 10) and C = 2 (two fascicles), kernel 12 at 782 x 782. Then
the finalize stage's two routes on the same chunks, every launch's device
time: "one launch" (``finalize_top1``) and "glue" (the route before it:
the winner's columns gathered and concatenated in torch, ``df_nnls_cols``
on the block, the float64 R^2 in torch). It prints each build's ptxas
registers and the card's name and power limit.

With ``--split`` it instead splits kernel 12 (``f32scan.row3_hoist``) and
the fit's finalize (``models.fit._finalize_top1``) at C = 3 and 4 as the
package it runs in calls them: each launch's device time and, from a
library built with ``-DMF_PHASES`` (``examples/kernel_phases.py``), the
counters of ``mf_row3hoist_phases`` and ``mf_finalize_phases``, raw. Copied
into an earlier checkout whose kernels were given those marks, it splits
that checkout's kernels.

    python -m microstructure_fingerprinting_torch.examples.finalize_probe \\
        [chunk] [--reps 10] [--split]
"""

import argparse
import os
import re
import tempfile

import numpy as np
import torch

from .. import testing as mft
from ..models import fit
from ..ops import dfscan, f32scan, kernels
from ..ops import interp as mfi
from ..utils import profiling
from . import kernel_phases, trials

#: the trial builds: {file: {build: [(text, its replacement)]}}
_CUTS = {
    "finalize.cu": {
        "shipped": [],
        "divisions": [
            ("scaled(x[c * S + s], sc[c], inv[c])",
             "mf::dv(x[c * S + s], sc[c])"),
            ("level(mf::mul(z, 128.0f))", "level(mf::dv(z, 0.0078125f))"),
            ("level(mf::mul(mf::sub(z, A1), 32768.0f))",
             "level(mf::dv(mf::sub(z, A1), 3.0517578125e-05f))")],
        "stage 1": [("constexpr int kStage = 8;",
                     "constexpr int kStage = 1;")],
        "stage 18": [("constexpr int kStage = 8;",
                      "constexpr int kStage = 18;")],
        "1 warp a block": [("constexpr int kWarps = 4;",
                            "constexpr int kWarps = 1;")],
    },
    "row3hoist.cu": {
        "shipped": [],
        "serial floor": [("""  float m = acc.up;
  for (int off = 16; off > 0; off /= 2) {
    m = tmin(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    m = red[0];
    for (int t = 1; t < kAtoms / 32; ++t) m = tmin(m, red[t]);""",
                          """  __shared__ float all[kAtoms];
  all[tid] = acc.up;
  __syncthreads();
  if (tid == 0) {
    float m = all[0];
    for (int t = 1; t < kAtoms; ++t) m = tmin(m, all[t]);""")],
    },
}
#: the same as cuts (``trials.swap``)
CUTS = {f: {name: [trials.swap(f, *c) for c in cuts]
            for name, cuts in builds.items()}
        for f, builds in _CUTS.items()}
_ENTRY = {"finalize.cu": "finalize", "row3hoist.cu": "row3hoist"}
_KERNELS = {"finalize.cu": "finalize_kernel",
            "row3hoist.cu": "row3vox|row3hoist|fold_min"}


def sources():
    """The text of each build: {(file, build): text}; raises where a
    shipped file no longer holds the text a cut replaces."""
    return {(f, name): files[f] for f, cuts in CUTS.items()
            for name, files in trials.sources("finalize_probe", (f,),
                                              cuts).items()}


def _builds(where):
    """Each build compiled into a library of its own (all nvcc at once),
    its ptxas registers printed. Returns {(file, build): library}."""
    paths, outs = trials.compile_all(
        "finalize_probe", where,
        {key: {key[0]: text} for key, text in sources().items()})
    for (f, name), out in outs.items():
        print("%s %-16s registers %s" % (
            f, name, ", ".join(re.findall(r"Used (\d+) registers", out))))
    return {key: trials.bind(path, (_ENTRY[key[0]],))
            for key, path in paths.items()}


def device_ms(fn, reps, pattern=None, flush=None):
    """Device ms a call of fn() (``utils.profiling.device_ms``) of the
    launches whose name matches ``pattern`` (all where None); with
    ``flush`` (a tensor) zeroed before each call, outside the pattern."""
    if flush is None:
        return profiling.device_ms(fn, reps, pattern)

    def flushed():
        flush.zero_()
        return fn()
    return profiling.device_ms(flushed, reps, pattern)


def _chunk(n):
    """The flagship workload's first n voxels on the card: the rotated
    blocks, the signals without and with EAR atom 4 of 10, the CSF and
    EAR signatures (the rotation's sample order) and the planted ids."""
    dev = torch.device("cuda")
    wl = mft.make_fit_workload(num_atom=782, n_vox=n, device="cuda")
    sig_ear, y_ear = mft.make_ear(wl, 10)
    rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                    wl["plan"])
    _x, ys_t, _c = wl["msinterp"].device_tables(dev, torch.float32)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    D = rotate(ys_t, f32(wl["peaks"]))
    gt = torch.as_tensor(wl["gt_ids"], dtype=torch.int64, device=dev)
    return (D, f32(wl["y"][:, perm]), f32(y_ear[:, perm]),
            f32(wl["sig_csf"][perm]), f32(sig_ear[perm]), gt)


def _finalize_cases(D, y, ye, csf, ear, gt, finalize):
    """(label, call) of kernel 7 through ``finalize`` (a function of
    ``finalize_top1``'s arguments) at C = 3, 4 and 2."""
    cand4 = torch.cat([gt, torch.full_like(gt[:, :1], 4)], 1)
    return [("C = 3", lambda: finalize(D, csf, None, y, gt, True, False, 2)),
            ("C = 4", lambda: finalize(D, csf, ear, ye, cand4, True, True,
                                       2)),
            ("C = 2", lambda: finalize(D, None, None, y, gt, False, False,
                                       2))]


def _row3_case(D, y, _ye, csf, _ear, _gt):
    """(label, call) of kernel 12 at 782 x 782."""
    B = y.shape[0]
    a3 = csf[None, :, None].expand(B, -1, 1).contiguous()
    _planes, ins = f32scan.rowmin_3_prep(D[:, 0].contiguous(),
                                         D[:, 1].contiguous(), a3, y)
    return [("782 x 782", lambda: f32scan.row3_hoist(*ins))]


def _glue(D, sig_csf, sig_ear, y, cand, csf_on, ear_on, K):
    """The finalize stage as it ran before kernel 7 read the columns: the
    torch gather and cat (``dfscan.winner_columns``), ``df_nnls_cols`` on
    the block, R^2 in torch."""
    cols = dfscan.winner_columns(D, sig_csf, sig_ear, cand, csf_on, ear_on,
                                 K)
    w, res = dfscan.df_nnls_cols(cols, y)
    y_rec = (cols.double() * w.double()[:, None, :]).sum(dim=2)
    return w, res, dfscan.r_squared(y.double(), y_rec)


def _split(args):
    """Launches and phase counters of kernels 12 and 7 as this package's
    fit calls them."""
    data = _chunk(args.chunk)
    runs = [("kernel 12 " + label, "mf_row3hoist_phases", fn)
            for label, fn in _row3_case(*data)] + [
        ("kernel 7 " + label, "mf_finalize_phases", fn)
        for label, fn in _finalize_cases(*data, fit._finalize_top1)[:2]]
    launches = {k: kernel_phases._launches(fn, args.reps)
                for k, _r, fn in runs}
    lib = kernel_phases._phase_library()
    saved = kernels._lib
    kernels._lib = lib
    try:
        cycles = {k: kernel_phases._cycles(lib, r, fn) for k, r, fn in runs}
    finally:
        kernels._lib = saved
    for k, _r, _fn in runs:
        total = float(sum(cycles[k])) or 1.0
        print("%s, %d voxels: %.4f device ms a call" % (
            k, args.chunk, sum(launches[k].values())))
        for name, t in sorted(launches[k].items(), key=lambda kv: -kv[1]):
            print("  launch %-60s %.4f ms" % (name[:60], t))
        for i, c in enumerate(cycles[k]):
            if c:
                print("  phase %d %14d cycles %5.1f%%"
                      % (i, c, 100.0 * c / total))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--split", action="store_true",
                    help="split kernels 12 and 7 as this package calls "
                         "them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("finalize_probe needs a CUDA device")
    print("card: %s" % trials.card())
    if args.split:
        return _split(args)
    where = kernels.BUILD_DIR + "_probe7"
    os.makedirs(where, exist_ok=True)
    saved = kernels._lib
    out = {}
    with tempfile.TemporaryDirectory(dir=where) as tmp:
        libs = _builds(tmp)
        data = _chunk(args.chunk)
        cases = {"finalize.cu": _finalize_cases(*data, dfscan.finalize_top1),
                 "row3hoist.cu": _row3_case(*data)}
        flush = torch.empty(64 * 2 ** 20, device="cuda")
        try:
            for f, runs in cases.items():
                names = list(CUTS[f])
                for label, fn in runs:
                    kernels._lib = libs[(f, "shipped")]
                    want = [o.clone() for o in fn()]
                    for name in names:
                        kernels._lib = libs[(f, name)]
                        if not all(trials.same(a, b)
                                   for a, b in zip(fn(), want)):
                            raise AssertionError(
                                "finalize_probe: %s differs from the "
                                "shipped build at %s" % (name, label))
                    for name in names + names[::-1]:
                        kernels._lib = libs[(f, name)]
                        out.setdefault((f, label, name), []).append(
                            (device_ms(fn, args.reps, _KERNELS[f]),
                             device_ms(fn, args.reps, _KERNELS[f], flush)))
        finally:
            kernels._lib = saved
        for (f, label, name), times in out.items():
            print("%s %s, %d voxels, %-16s warm / flushed: %s ms" % (
                f, label, args.chunk, name, ", ".join(
                    "%.4f / %.4f" % t for t in times)))
        # the finalize stage's routes, every launch on the card
        for (label, one), (_l, glue) in zip(
                cases["finalize.cu"], _finalize_cases(*data, _glue)):
            print("finalize stage %s, %d voxels: one launch %.4f, glue "
                  "route %.4f device ms" % (
                      label, args.chunk, device_ms(one, args.reps),
                      device_ms(glue, args.reps)))
    return out


if __name__ == "__main__":
    main()
