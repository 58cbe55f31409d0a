"""The comparison that decides ``correct``.

What is judged is what the timed path returned: the maps of the fits
that completed in the window (``MFModel.fit``'s property maps: each
fascicle's atom through the dictionary's ``atom_id`` property, the EAR
atom through ``D_ear``, the weights as the fractions times ``M0``, and
``MSE`` and ``R2``). Two checks:

* every voxel of every fit: finite maps, no negative weight, a weight
  only on a compartment the voxel holds, each atom one of the
  dictionary's (``invalid``, a count, limit 0);
* a sample of voxels of each bucket, drawn from the seed over all the
  window's fits (``traffic[judge]`` voxels a bucket), held against the
  plain reference (``reference.py``), which rotates the dictionary to
  the voxel's directions and solves the exhaustive NNLS in float64:

  - ``obj_gap``: how far the residual of the claimed atoms and weights,
    ||y - A w||^2 with the reference's columns, lies above the
    reference's least residual, over ||y||^2;
  - ``mse_gap``: |MSE * S - that residual| / ||y||^2, the reported
    objective against what the claim gives;
  - ``r2_gap``: |R2 - the claim's R^2|.

The largest over the sample is held against the cell's limit
(``limits/<workload>.json``).
"""

import numpy as np
import torch

from . import dictionary, reference

#: sampled voxels rotated at once
GROUP = 32
#: the numbers compared, in the order they are printed
NUMBERS = ("obj_gap", "mse_gap", "r2_gap", "invalid")


def maps_of(fit):
    """The judged maps of an ``MFModelFit``, flattened to (n,) float64
    (a map the fit does not hold reads 0)."""
    names = ("M0", "frac_f0", "frac_f1", "frac_csf", "frac_ear",
             "atom_id_f0", "atom_id_f1", "D_ear", "MSE", "R2")
    n = np.asarray(fit.M0).size
    return {k: (np.asarray(getattr(fit, k), dtype=np.float64).reshape(-1)
                if hasattr(fit, k) else np.zeros(n)) for k in names}


def _claims(m, cfg):
    """Per voxel: weights (n, 4) [f0, f1, csf, ear], atom ids (n, 2),
    EAR atom (n,), each -1 where it names no atom, and whether the maps
    are well formed (n,)."""
    w = np.stack([m["frac_f0"], m["frac_f1"], m["frac_csf"],
                  m["frac_ear"]], axis=1) * m["M0"][:, None]
    ok = np.all(np.isfinite(w), axis=1) & np.all(w >= 0, axis=1)
    ids = np.stack([m["atom_id_f0"], m["atom_id_f1"]], axis=1)
    ok &= np.all((ids == np.round(ids)) & (ids >= 0)
                 & (ids < cfg["num_atom"]), axis=1)
    D = dictionary.ear_diffusivities(cfg)
    eid = np.full(m["D_ear"].shape, -1)
    if D.size:
        near = np.argmin(np.abs(m["D_ear"][:, None] - D[None, :]), axis=1)
        hit = m["D_ear"] == D[near]
        eid = np.where(hit, near, -1)
        ok &= hit | (w[:, 3] == 0)
    ok &= np.isfinite(m["MSE"]) & (m["MSE"] >= 0) & np.isfinite(m["R2"])
    return w, ids.astype(np.int64), eid, ok


def invalid(cfg, vol, m):
    """Voxels of one fit whose maps are not well formed, or that put
    weight on a compartment the voxel does not hold."""
    w, _ids, _eid, ok = _claims(m, cfg)
    K, csf, ear = (vol["bucket"][:, i] for i in range(3))
    holds = np.stack([K >= 1, K >= 2, csf > 0, ear > 0], axis=1)
    return int(np.sum(~ok | np.any((w != 0) & ~holds, axis=1)))


def sample(traffic, vols, fits, seed):
    """{bucket key: [(fit index, voxel), ...]} drawn from ``seed`` over
    every fit of the window."""
    gen = torch.Generator().manual_seed(int(seed) ^ 0x5EED)
    out = {}
    for key, m in sorted(traffic["judge"].items()):
        want = np.array([int(x) for x in key.split(",")])
        pairs = [(i, v) for i, f in enumerate(fits)
                 for v in np.flatnonzero(np.all(
                     vols[f["vol"]]["bucket"] == want, axis=1))]
        pick = torch.randperm(len(pairs), generator=gen)[:m].numpy()
        out[key] = [pairs[j] for j in sorted(pick)]
    return out


def judge(cfg, traffic, vols, fits, seed, device):
    """The numbers compared: {name: largest reading}, and the voxels
    whose own readings pass a limit. ``fits``: [{"vol": volume index,
    "maps": maps_of(fit)}, ...]."""
    sch, dic = dictionary.build(cfg)
    rot = reference.Rotation(dic["dictionary"], sch, dic["orientation"],
                             device)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=device)
    csf = put(dictionary.csf_signature(cfg, sch))
    ear = put(dictionary.ear_signatures(cfg, sch))
    claims = [_claims(f["maps"], cfg) for f in fits]
    S = sch.shape[0]
    read = {k: [] for k in NUMBERS[:3]}
    per_bucket = {}
    for key, pairs in sample(traffic, vols, fits, seed).items():
        if not pairs:
            continue
        K, has_csf, has_ear = (int(x) for x in key.split(","))
        got = {k: [] for k in read}
        for g0 in range(0, len(pairs), GROUP):
            grp = pairs[g0:g0 + GROUP]
            vol = [vols[fits[i]["vol"]] for i, _v in grp]
            y = put([vo["data"].reshape(-1, S)[v]
                     for vo, (_i, v) in zip(vol, grp)])
            dirs = np.stack([vo["dirs"][v] for vo, (_i, v) in zip(vol, grp)])
            w, ids, eid, mse, r2 = (
                np.stack([claims[i][0][v] for i, v in grp]),
                np.stack([claims[i][1][v] for i, v in grp]),
                np.array([claims[i][2][v] for i, v in grp]),
                np.array([fits[i]["maps"]["MSE"][v] for i, v in grp]),
                np.array([fits[i]["maps"]["R2"][v] for i, v in grp]))
            B = len(grp)
            blocks, cols, wc = [], [], []
            for k in range(K):
                A = rot(dirs[:, k])
                blocks.append(A)
                idx = torch.as_tensor(np.clip(ids[:, k], 0, None),
                                      device=device)
                cols.append(A[torch.arange(B, device=device), :, idx])
                wc.append(w[:, k])
            if has_csf:
                blocks.append(csf[None, :, None].expand(B, S, 1))
                cols.append(csf[None].expand(B, S))
                wc.append(w[:, 2])
            if has_ear:
                blocks.append(ear[None].expand(B, S, ear.shape[1]))
                cols.append(ear[:, np.clip(eid, 0, None)].T)
                wc.append(w[:, 3])
            best = reference.best_objective(y, blocks)
            res, r2_ref = reference.claimed(y, torch.stack(cols, dim=2),
                                            put(np.stack(wc, axis=1)))
            yy = (y * y).sum(-1)
            got["obj_gap"].append(((res - best) / yy).cpu().numpy())
            got["mse_gap"].append((torch.abs(put(mse) * S - res) / yy)
                                  .cpu().numpy())
            got["r2_gap"].append(torch.abs(put(r2) - r2_ref).cpu().numpy())
            del blocks, cols, best
        got = {k: np.concatenate(v) for k, v in got.items()}
        per_bucket[key] = {k: float(v.max()) for k, v in got.items()}
        for k in read:
            read[k].append(got[k])
    read = {k: np.concatenate(v) for k, v in read.items()}
    numbers = {k: float(v.max()) for k, v in read.items()}
    numbers["invalid"] = sum(invalid(cfg, vols[f["vol"]], f["maps"])
                             for f in fits)
    return numbers, read, per_bucket


def verdict(numbers, read, limits):
    """(correct, failed voxels, [(name, reading, limit), ...])."""
    rows, failed = [], numbers["invalid"]
    over = np.zeros(len(next(iter(read.values()))), dtype=bool)
    ok = True
    for name in NUMBERS:
        lim = limits[name]
        rows.append((name, numbers[name], lim))
        ok &= numbers[name] <= lim
        if name in read:
            over |= read[name] > lim
    return bool(ok), int(failed + over.sum()), rows
