"""Whole-brain-scale run: a volume of 10^5 voxels of mixed buckets through
``MFModel.fit`` end to end, with its bucket mix, its voxels/s on one
card and with ``parallel=True`` on every card in sight, and its
recovery.

The configuration mix is modelled on a UK-Biobank-style fit: most
white-matter voxels are 2-fascicle + CSF, a band gets the EAR
compartment, plus single-fascicle and CSF-only fringes. Signals are
noiseless mixtures of planted atoms, so every 2-fascicle voxel's first
fascicle d_par should be exact.

    python -m microstructure_fingerprinting_torch.examples.whole_brain \
        [n_voxels] [--atoms 782] [--device cuda]
"""

import argparse
import collections
import time

import numpy as np
import torch

from .. import MFModel
from .. import testing as mft
from ..ops import interp as mfi
from ..utils.scheme import b_values

MIX = [  # (K, csf, ear), share
    ((2, 1, 0), 0.62),
    ((2, 1, 1), 0.10),
    ((1, 1, 0), 0.16),
    ((2, 0, 0), 0.07),
    ((0, 1, 0), 0.05),
]


def synthesize(n_vox, num_atom, device, seed=7):
    """The dictionary, scheme and a volume of ``n_vox`` noiseless voxels
    of the MIX buckets: (dic, sch, Y, peaks, K, csf, ear, ids)."""
    rng = np.random.RandomState(seed)
    sch = mft.make_dense_scheme(n_shells=8, dirs_per_shell=64, n_b0=40)
    sig, dpar, dperp = mft.make_dictionary(sch, num_atom=num_atom)
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    dic = {
        "dictionary": sig, "sch_mat": sch,
        "orientation": np.array([0.0, 0.0, 1.0]),
        "num_atom": num_atom, "num_ear": 10,
        "fasc_propnames": ["d_par", "d_perp"],
        "d_par": dpar, "d_perp": dperp,
        "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
        "T2_ear": 0.8, "DIFF_ear": Dear,
    }
    sig_csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    sig_ear = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])

    cfgs = np.concatenate([np.full(int(round(share * n_vox)), i)
                           for i, (_c, share) in enumerate(MIX)])[:n_vox]
    cfgs = np.pad(cfgs, (0, n_vox - cfgs.size), constant_values=0)
    rng.shuffle(cfgs)
    K = np.array([MIX[i][0][0] for i in cfgs])
    csf = np.array([MIX[i][0][1] for i in cfgs])
    ear = np.array([MIX[i][0][2] for i in cfgs])
    dirs = rng.randn(n_vox, 2, 3)
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    ids = rng.randint(0, num_atom, (n_vox, 2))
    eids = rng.randint(0, 10, n_vox)
    nus = rng.rand(n_vox, 4) + 0.3

    # signals in chunks through the rotation on the device (the rotated
    # block is B x 2 x S x N: keep it well under the card's memory)
    ms = mfi.init_PGSE_multishell_interp(sig, sch, dic["orientation"])
    plan = mfi.plan_target_scheme(ms, sch)
    xs, ys, cnt = ms.device_tables(device, torch.float64)
    gdir, lo, hi, wG = (torch.as_tensor(a, device=device) for a in
                        (plan.gdir, plan.shell_lo, plan.shell_hi, plan.wG))
    kk = np.arange(2)[None, :]
    w_f = nus[:, :2] * (kk < K[:, None])                  # fascicle weights
    w_c = np.take_along_axis(nus, K[:, None], 1)[:, 0] * csf
    w_e = np.take_along_axis(nus, (K + csf)[:, None], 1)[:, 0] * ear
    peaks = np.zeros((n_vox, 6))
    peaks[:, :3] = np.where((K >= 1)[:, None], dirs[:, 0], 0.0)
    peaks[:, 3:] = np.where((K >= 2)[:, None], dirs[:, 1], 0.0)
    Y = np.zeros((n_vox, sch.shape[0]))
    for st in range(0, n_vox, 256):
        en = min(st + 256, n_vox)
        D = mfi.eval_rotation_batch(xs, ys, cnt, gdir, lo, hi, wG,
                                    torch.as_tensor(dirs[st:en],
                                                    device=device))
        idx = torch.as_tensor(ids[st:en], device=device)
        cols = torch.gather(D, 3, idx[:, :, None, None].expand(
            -1, -1, D.shape[2], 1))[..., 0].cpu().numpy()
        acc = np.einsum("vk,vks->vs", w_f[st:en], cols)
        acc += w_c[st:en, None] * sig_csf[None]
        acc += w_e[st:en, None] * sig_ear[:, eids[st:en]].T
        Y[st:en] = 400 * acc
    return dic, sch, Y, peaks, K, csf, ear, ids


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100_000,
                    help="voxels (default 100,000)")
    ap.add_argument("--atoms", type=int, default=782)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="fit chunk (the fit's default when omitted)")
    args = ap.parse_args(argv)
    n_vox = args.n
    print("Synthesizing %d voxels (552 seqs, %d atoms)..."
          % (n_vox, args.atoms))
    t0 = time.time()
    dic, sch, Y, peaks, K, csf, ear, ids = synthesize(n_vox, args.atoms,
                                                      args.device)
    print("synthesis: %.1f s" % (time.time() - t0))
    model = MFModel(dic, device=args.device)
    shape = (n_vox, 1, 1)
    vol = dict(data=Y.reshape(shape + (sch.shape[0],)), mask=np.ones(shape),
               numfasc=K.reshape(shape))
    kw = dict(peaks=peaks.reshape(shape + (6,)), pgse_scheme=sch,
              csf_mask=csf.reshape(shape), ear_mask=ear.reshape(shape),
              batch_size=args.batch)
    n_warm = min(n_vox, 1024)
    model.fit(vol["data"][:n_warm], vol["mask"][:n_warm],
              vol["numfasc"][:n_warm], verbose=0,
              **{k: v[:n_warm] if isinstance(v, np.ndarray) and v.ndim > 2
                 else v for k, v in kw.items()})  # builds the kernels

    mix = collections.Counter(zip(K.tolist(), csf.tolist(), ear.tolist()))
    act = n_vox - mix.get((0, 0, 0), 0)
    print("bucket mix (K, csf, ear): %s" % dict(sorted(mix.items())))
    n_cards = (torch.cuda.device_count()
               if torch.device(args.device).type == "cuda" else 1)
    out = {"mix": dict(mix)}
    for label, parallel in (("one device", False),
                            ("parallel=True, %d device(s)" % n_cards, True)):
        t0 = time.time()
        f = model.fit(vol["data"], vol["mask"], vol["numfasc"], verbose=1,
                      parallel=parallel, **kw)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        print("%s: fit wall-clock %.2f s (%d voxels -> %.0f voxels/s)"
              % (label, wall, act, act / wall))
        out[label] = act / wall
    r2 = f.R2.reshape(-1)
    solved = (K + csf + ear) > 0
    multi = solved & ((K + csf + ear) > 1)
    print("R2 median %.6f | min %.4f (multi-compartment voxels)"
          % (np.median(r2[solved]), np.min(r2[multi])))
    two = K == 2
    hit = np.isclose(f.d_par_f0.reshape(-1)[two], dic["d_par"][ids[two, 0]])
    print("exact d_par_f0 recovery on 2-fascicle voxels: %.2f%%"
          % (100.0 * np.mean(hit)))
    out["dpar_f0_exact"] = float(np.mean(hit))
    out["r2_median"] = float(np.median(r2[solved]))
    return out


if __name__ == "__main__":
    main()
