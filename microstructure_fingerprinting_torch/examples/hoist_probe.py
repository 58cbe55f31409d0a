"""Kernels 9 and 10 built with parts of their design changed: the trial
builds of their voxel and atom launches, timed against the shipped ones.

Builds ``csrc/df2hoist.cu`` and ``csrc/df3hoist.cu`` apart from the fit's
library (``build/mf_torch_kernels_probe/``), with ``csrc/hoist.cuh`` as
shipped and changed each way of ``CUTS``:

  * "two loops": the quantise pass and the Gram pass as two loops over a
    thread's samples, the second reading the tile back (the first body);
  * "rolled": one pass, but a chunk's samples in a loop of runtime length
    (no full unroll);
  * "3 blocks an SM": a ring of 3 chunks and launch bounds of 3 blocks of
    256 threads an SM (at most 80 registers: ptxas spills);
  * "ring of 3" / "ring of 6": 3 or 6 chunks in the ring;
  * "streaming stores": the tile's vectors stored with ``__stcs``;
  * "voxel loop unrolled": the voxel launch's Gram loop unrolled by 4.

Each build is held bit for bit against the shipped kernels, then all are
timed through the wrappers (CUDA events, mean of ``--reps``) on one chunk
of the flagship workload (552 sequences, 782 atoms, seed 0: the rotated
blocks of its first ``chunk`` voxels), kernel 10 at 128 x 128 and 256 x
256, kernel 9 at 782 x 782 and 782 x 1, in turns: shipped, builds,
builds, shipped. It prints each build's ptxas registers and spills, and
the card's name and power limit.

    python -m microstructure_fingerprinting_torch.examples.hoist_probe \\
        [chunk] [--reps 10]
"""

import argparse
import os
import re
import tempfile

import numpy as np
import torch

from .. import testing as mft
from ..ops import dfscan, kernels, rescan
from ..ops import interp as mfi
from . import trials

_FILES = ("hoist.cuh", "df2hoist.cu", "df3hoist.cu")
_FUSED = """      #pragma unroll
      for (int c = 0; c < C; ++c) {
        gram_step(acc[1 + c], l.q1, l.q2, dapr, dr, cc.q[c][k],
                  cc.ra[c][k].x, cc.ra[c][k].y);
      }
    };
"""
_TWO_LOOPS = """    };
    #pragma unroll 2
    for (int k = p; k < kn; k += kParts) {
      const Level l = quantize2(xs[k][a]);
      t.q[0][k][a] = (int8_t)l.q1;
      t.q[1][k][a] = (int8_t)l.q2;
      t.r[k][a] = l.r;
      if (out.v) t.v[k][a] = out.v_apr ? add(l.a, l.r) : l.a;
    }
    #pragma unroll 2
    for (int k = p; k < kn; k += kParts) {
      const int q1 = t.q[0][k][a], q2 = t.q[1][k][a];
      const float r = t.r[k][a];
      const float av = add(mul(__int2float_rn(q1), kS1),
                           mul(__int2float_rn(q2), kS2));
      const double dapr = (double)add(av, r), dr = (double)r;
      gram_step(acc[0], q1, q2, dapr, dr, make_int2(q1, q2), dr, (double)av);
      #pragma unroll
      for (int c = 0; c < C; ++c) {
        gram_step(acc[1 + c], q1, q2, dapr, dr, cc.q[c][k], cc.ra[c][k].x,
                  cc.ra[c][k].y);
      }
    }
    if (false) {
"""
_UNROLLED = """    if (kn == kSK) {
      #pragma unroll
      for (int u = 0; u < kSK / kParts; ++u) step(p + kParts * u);
    } else {"""
_BOUNDS = "__launch_bounds__(mf::hoist::kStreamThreads, 2)"
_STORE_Q = """        reinterpret_cast<uint4*>(dst)[j] =
            reinterpret_cast<const uint4*>(t.q[l][k])[j];"""
_STORE_F = """        reinterpret_cast<float4*>(dst)[j] =
            reinterpret_cast<const float4*>(l ? t.v[k] : t.r[k])[j];"""
_RING = "kSK = 32, kStages = 4;"
_VOX_LOOP = """    #pragma unroll 1
    for (int s = p; s < S; s += kParts) {"""


#: the trial builds: (file, text, its replacement) each
_CUTS = {
    "shipped": [],
    "two loops": [("hoist.cuh", _FUSED + _UNROLLED,
                   _FUSED.replace("    };\n", _TWO_LOOPS))],
    "rolled": [("hoist.cuh", _UNROLLED, "    {")],
    "3 blocks an SM": [("hoist.cuh", _RING, _RING.replace("4", "3"))] + [
        (f, _BOUNDS, _BOUNDS.replace("2)", "3)"))
        for f in ("df2hoist.cu", "df3hoist.cu")],
    "ring of 3": [("hoist.cuh", _RING, _RING.replace("4", "3"))],
    "ring of 6": [("hoist.cuh", _RING, _RING.replace("4", "6"))],
    "streaming stores": [
        ("hoist.cuh", _STORE_Q,
         "        __stcs(reinterpret_cast<uint4*>(dst) + j,\n"
         "               reinterpret_cast<const uint4*>(t.q[l][k])[j]);"),
        ("hoist.cuh", _STORE_F,
         "        __stcs(reinterpret_cast<float4*>(dst) + j,\n"
         "               reinterpret_cast<const float4*>"
         "(l ? t.v[k] : t.r[k])[j]);")],
    "voxel loop unrolled": [("hoist.cuh", _VOX_LOOP,
                             _VOX_LOOP.replace("unroll 1", "unroll 4"))],
}
#: the same as cuts (``trials.swap``)
CUTS = {name: [trials.swap(*c) for c in cuts] for name, cuts in _CUTS.items()}


def sources():
    """The text of each build's files: {build: {file: text}}; raises where
    a shipped file no longer holds the text a cut replaces."""
    return trials.sources("hoist_probe", _FILES, CUTS)


def _ptxas(out):
    """ptxas's registers and spills of each kernel in nvcc's output."""
    lines = out.splitlines()
    return ["%s: %s" % (re.search(r"(df[23](?:hoist|vox)_kernel)", line)
                        .group(1), "; ".join(
                            x.split(":", 1)[-1].strip() for x in
                            lines[i + 2:i + 4]))
            for i, line in enumerate(lines)
            if "Compiling entry function" in line
            and re.search(r"df[23](?:hoist|vox)_kernel", line)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hoist_probe needs a CUDA device")
    dev = torch.device("cuda")
    print("card: %s" % trials.card())
    where = kernels.BUILD_DIR + "_probe"
    os.makedirs(where, exist_ok=True)
    saved = kernels._lib
    with tempfile.TemporaryDirectory(dir=where) as tmp:
        paths, outs = trials.compile_all("hoist_probe", tmp, sources())
        libs = {name: trials.bind(path, ("df2hoist", "df3hoist"))
                for name, path in paths.items()}
        for name, out in outs.items():
            print("%-20s %s" % (name, " | ".join(_ptxas(out))))
        wl = mft.make_fit_workload(num_atom=782, n_vox=args.chunk,
                                   device="cuda")
        rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                        wl["plan"])
        _x, ys_t, _c = wl["msinterp"].device_tables(dev, torch.float32)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=dev)
        D = rotate(ys_t, f32(wl["peaks"]))
        A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
        del D
        y = f32(wl["y"][:, perm])
        B = y.shape[0]
        a3 = f32(wl["sig_csf"][perm])[None, :, None].expand(B, -1, 1)
        a3 = a3.contiguous()
        cases = []
        for n in (128, 256):
            *blk, n2pb, _yn = rescan.df3_normalized(A1[:, :, :n],
                                                    A2[:, :, :n], a3, y)
            cases.append(("kernel 10, %d x %d" % (n, n),
                          lambda blk=blk, n2pb=n2pb:
                          rescan.df3_hoist(*blk, n2pb)))
        for n2, blk in ((782, A2), (1, a3)):
            ins = dfscan.df2_normalized(A1, blk, y)[:3]
            cases.append(("kernel 9, 782 x %d" % n2,
                          lambda ins=ins, n2=n2: dfscan.df2_hoist(
                              *ins, dfscan.df2_cols(n2))))
        del A1, A2
        out = {}
        try:
            for label, fn in cases:
                kernels._lib = libs["shipped"]
                want = fn()
                for name, lib in libs.items():
                    kernels._lib = lib
                    if not all(trials.same(a, b) for a, b in zip(fn(), want)):
                        raise AssertionError("hoist_probe: %s differs from "
                                             "the shipped kernels at %s"
                                             % (name, label))
                del want
                for name in list(libs) + list(libs)[::-1]:
                    kernels._lib = libs[name]
                    out.setdefault(label, {}).setdefault(name, []).append(
                        trials.ms(fn, args.reps))
        finally:
            kernels._lib = saved
        for label, times in out.items():
            for name, ms in times.items():
                print("%s, %d voxels, %-20s %s ms" % (
                    label, B, name, " / ".join("%.3f" % m for m in ms)))
    return out


if __name__ == "__main__":
    main()
