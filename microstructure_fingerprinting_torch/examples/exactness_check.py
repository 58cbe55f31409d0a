"""Measured selection exactness of the fast fit path.

Plants noiseless atom mixtures from a UKBB-scale correlated dictionary
(986 zeppelin atoms, the atom count of the reference's UK-Biobank
subject dictionary) and checks that ``models/fit.run_bucket_fast``
(double-float scans, kernels 1-5 on the card, and the double-float
finalize, kernel 7) recovers them:

* 2 fascicles + CSF: both fascicle atom IDs must match the planted ones
  exactly (the planted combination is the unique optimum).
* 2 fascicles + CSF + EAR (10 diffusivities): fascicle IDs must match
  exactly; the CSF/EAR split is genuinely ambiguous for nearly
  collinear isotropic columns, so there the check is optimality: the
  fitted residual must stay below 1e-9 * ||y||^2 (the scan's design
  resolution).

    python -m microstructure_fingerprinting_torch.examples.exactness_check \
        [n_voxels] [--atoms 986] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from .. import testing as mft
from ..models.fit import run_bucket_fast
from ..ops import interp as mfi
from ..utils.scheme import b_values


def planted_columns(ms, plan, dirs, ids, device, chunk=256):
    """Column ``ids[v, k]`` of the dictionary rotated to ``dirs[v, k]``,
    float64 on ``device``: (n, K, S)."""
    xs, ys, cnt = ms.device_tables(device, torch.float64)
    gdir, lo, hi, wG = (torch.as_tensor(a, device=device) for a in
                        (plan.gdir, plan.shell_lo, plan.shell_hi, plan.wG))
    out = []
    for st in range(0, len(dirs), chunk):
        D = mfi.eval_rotation_batch(
            xs, ys, cnt, gdir, lo, hi, wG,
            torch.as_tensor(dirs[st:st + chunk], device=device))
        idx = torch.as_tensor(ids[st:st + chunk], device=device)
        out.append(torch.gather(D, 3, idx[:, :, None, None].expand(
            -1, -1, D.shape[2], 1))[..., 0].cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=128,
                    help="voxels (default 128)")
    ap.add_argument("--atoms", type=int, default=986)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_vox, num_atom = args.n, args.atoms
    rng = np.random.RandomState(args.seed)
    sch = mft.make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40)
    sig, _dpar, _dperp = mft.make_dictionary(sch, num_atom=num_atom)
    ms = mfi.init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    _xs, ys_t, _cnt = ms.device_tables(args.device, torch.float32)

    TE, b = sch[:, 6], b_values(sch)
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])

    dirs = np.zeros((n_vox, 2, 3))
    planted = np.zeros((n_vox, 3), int)
    for v in range(n_vox):
        d1 = rng.randn(3)
        d1 /= np.linalg.norm(d1)
        d2 = rng.randn(3)
        d2 /= np.linalg.norm(d2)
        while abs(d1 @ d2) > 0.9:
            d2 = rng.randn(3)
            d2 /= np.linalg.norm(d2)
        planted[v] = rng.randint(num_atom), rng.randint(num_atom), \
            rng.randint(len(Dear))
        dirs[v] = d1, d2
    cols = planted_columns(ms, plan, dirs, planted[:, :2], args.device)
    nu = np.array([0.4, 0.3, 0.15, 0.15])
    y = 300.0 * (nu[0] * cols[:, 0] + nu[1] * cols[:, 1]
                 + nu[2] * sig_csf[None] + nu[3] * sig_ear[:, planted[:, 2]].T)
    peaks = dirs.reshape(n_vox, 6)

    out = {}
    for ear_on in (False, True):
        kw = dict(sig_ear=sig_ear, ear_on=True) if ear_on else {}
        yy = y if ear_on else y - 300.0 * nu[3] * sig_ear[:, planted[:, 2]].T
        t0 = time.time()
        _w, ind, obj, _mse, _r2 = run_bucket_fast(
            ms, plan, ys_t, peaks, yy, sig_csf, 2, True, batch=128, **kw)
        dt = time.time() - t0
        ysq = np.sum(yy ** 2, axis=1)
        n_id = int(np.sum(np.all(ind[:, :2] == planted[:, :2], axis=1)))
        worst = float(np.max(obj / ysq))
        name = "2fasc+CSF+EAR" if ear_on else "2fasc+CSF"
        print("%-14s fascicle IDs exact %d/%d   max res/||y||^2 %.2e   "
              "(%.2f s, first call builds the kernels)"
              % (name, n_id, n_vox, worst, dt))
        out[name] = dict(ids_exact=n_id, max_res=worst, seconds=dt)
        if n_id != n_vox:
            raise SystemExit("exactness: fascicle atom recovery failed")
        if not worst < 1e-9:
            raise SystemExit("exactness: fitted residual above the scan "
                             "resolution")
        if ear_on:
            n_e = int(np.sum(ind[:, 3] == planted[:, 2]))
            print("%-14s EAR atom agreement %d/%d (ties below 1e-9 "
                  "resolution may pick an equally optimal atom)"
                  % ("", n_e, n_vox))
            out[name]["ear_agree"] = n_e
    return out


if __name__ == "__main__":
    main()
