"""Per-stage device time of the fast fit path.

At the benchmark's shapes (552 sequences x 782 atoms, one 512-voxel
chunk) runs the flagship 2-fascicle + CSF chunk (kernels 1-3) and the
EAR chunk (10 EAR atoms; kernels 1, 4, 5) through
``models/fit.run_bucket_fast`` under ``utils/profiling.StageTimer``:
every stage of the fit path ("rotation", "prep", "row pass",
"selection", "re-scan", "finalize") and every kernel launch ("kernel
<name>") timed by CUDA events on the card, median of ``--reps`` warm
runs. On the CPU only each chunk's host wall time is printed (stages
are timed on CUDA devices).

    python -m microstructure_fingerprinting_torch.examples.profile_stages \
        [chunk] [--atoms 782] [--reps 5] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from .. import testing as mft
from ..models.fit import run_bucket_fast
from ..utils.profiling import StageTimer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=512,
                    help="voxels of the chunk (default 512)")
    ap.add_argument("--atoms", type=int, default=782)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    wl = mft.make_fit_workload(num_atom=args.atoms, n_vox=args.chunk,
                               device=args.device)
    sig_ear, y_ear = mft.make_ear(wl)
    ms, plan = wl["msinterp"], wl["plan"]
    _xs, ys_t, _cnt = ms.device_tables(args.device, torch.float32)
    peaks = wl["peaks"].reshape(args.chunk, 6)
    out = {}
    for label, y, kw in (("flagship", wl["y"], {}),
                         ("EAR", y_ear, dict(sig_ear=sig_ear, ear_on=True))):
        run = lambda: run_bucket_fast(ms, plan, ys_t, peaks, y,
                                      wl["sig_csf"], 2, True,
                                      batch=args.chunk, **kw)
        run()                                   # builds the kernels
        walls, stages = [], []
        for _ in range(args.reps):
            with StageTimer() as st:
                t0 = time.perf_counter()
                run()
                if cuda:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            stages.append(st.totals_ms() if cuda else {})
        wall = float(np.median(walls))
        print("%s chunk of %d voxels: %.1f ms wall (median of %d) -> "
              "%.0f voxels/s" % (label, args.chunk, 1e3 * wall, args.reps,
                                 args.chunk / wall))
        med = {k: float(np.median([s.get(k, 0.0) for s in stages]))
               for k in stages[0]}
        for name, ms_ in med.items():
            print("  %-22s %9.3f ms" % (name, ms_))
        if not cuda:
            print("  (stages are timed on CUDA devices only)")
        out[label] = dict(wall_ms=1e3 * wall, stages_ms=med)
    return out


if __name__ == "__main__":
    main()
