"""EAR two-pass row-budget sweep.

Times the EAR chunk's scan, ``ops/f32scan.df4_twopass`` (kernels 1, 4,
5 on the card), plus the device finalize at several row budgets R, and
reports each R's time, throughput and overflow (voxels whose in-band
rows exceed R, which the fit re-solves at 2R and then on the full
grid), on the benchmark's workload (552 sequences x 782 atoms, CSF + 10
EAR diffusivities, one 512-voxel chunk). The fit's budget
(``SolverConfig.twopass_rows_ear``) should sit where throughput, net of
the overflow's re-solves, peaks. Times are CUDA events on the card and
the host clock on the CPU, median of ``--reps``.

    python -m microstructure_fingerprinting_torch.examples.ear_rsweep \
        [chunk] [--atoms 782] [--rows 64 128 192 256] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from .. import testing as mft
from ..models.fit import _finalize_top1
from ..ops import f32scan
from ..ops import interp as mfi


def _median_ms(fn, reps, cuda):
    fn()
    ts = []
    for _ in range(reps):
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            out = fn()
            ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts)), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512,
                    help="voxels of the chunk (default 512)")
    ap.add_argument("--atoms", type=int, default=782)
    ap.add_argument("--rows", type=int, nargs="+", default=[64, 128, 192,
                                                            256])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    wl = mft.make_fit_workload(num_atom=args.atoms, n_vox=args.chunk,
                               device=args.device)
    sig_ear, y_ear = mft.make_ear(wl)
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables(dev, torch.float32)
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    D = rotate(ys_t, f32(wl["peaks"]))
    y = f32(y_ear[:, perm])
    csf_d, ear_d = f32(wl["sig_csf"][perm]), f32(sig_ear[perm])
    B, S = y.shape
    csf_blk = csf_d[None, :, None].expand(B, S, 1)
    ear_blk = ear_d[None].expand(B, S, ear_d.shape[1])
    out = {}
    for R in args.rows:
        def step():
            c, _v, _q, ok = f32scan.df4_twopass(D[:, 0], D[:, 1], csf_blk,
                                                ear_blk, y, M=1, R=R)
            w, obj, r2 = _finalize_top1(D, csf_d, ear_d, y, c[:, 0],
                                        csf_on=True, ear_on=True, K=2)
            return c, ok, w, obj, r2
        t, res = _median_ms(step, args.reps, cuda)
        n_bad = int((~res[1]).sum())
        print("R=%3d  %8.1f ms  -> %6.0f voxels/s   overflow %d/%d"
              % (R, t, B / (1e-3 * t), n_bad, B))
        out[R] = dict(ms=t, overflow=n_bad)
    return out


if __name__ == "__main__":
    main()
