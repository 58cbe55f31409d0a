"""Volumes of a traffic mix, made from the run's seed.

One general generator reads a mix's parameters (``traffic/<name>.json``):

* ``voxels``: masked voxels a volume (all of them in the mask: the
  background is left out);
* ``mix``: the buckets, each ``{"K", "csf", "ear", "share"}``: fascicles,
  and whether the voxel holds the CSF and EAR compartments; a bucket's
  count is its share of ``voxels``, rounded, the rounding's remainder
  going to the first bucket;
* ``weights``: the range [lo, hi) of each compartment's uniform weight,
  times ``scale``;
* ``snr_b0``: Rician noise, sigma the voxel's noiseless b0 signal over it;
* ``judge``: voxels of each bucket that the comparison draws (see
  ``judge.py``);
* ``source``: where the shares and levels come from (read by no code);
* ``fit`` (optional): keywords of every fit of the mix, which the
  harness passes to ``MFModel.fit`` (``run.Cell.fit_kw``).

Each voxel draws its fascicle directions uniformly on the sphere, one
atom a fascicle and one EAR atom, uniformly; its noiseless signal is the
closed-form mixture of zeppelins along those directions (the atoms'
d_par, d_perp), the CSF signature and the EAR signature, in float64 on
the device of the generator, then Rician noise (``gen_SoS_MRI`` with one
coil). A cell fits two volumes in turn, drawn one after the other from
one ``torch.Generator`` seeded with the run's seed, so the same seed
gives the same volumes and nothing keyed on identical inputs can flatter
a fit.
"""

import numpy as np
import torch

from . import dictionary

VOLUMES = 2


def bucket_key(K, csf, ear):
    return "%d,%d,%d" % (K, csf, ear)


def bucket_counts(traffic):
    """{bucket key: voxels} of a volume of the mix."""
    n = int(traffic["voxels"])
    keys = [bucket_key(b["K"], b["csf"], b["ear"]) for b in traffic["mix"]]
    counts = [int(round(b["share"] * n)) for b in traffic["mix"]]
    counts[0] += n - sum(counts)
    if min(counts) < 0 or len(set(keys)) != len(keys):
        raise ValueError("mix of %d voxels: %s" % (n, traffic["mix"]))
    return dict(zip(keys, counts))


def volumes(cfg, traffic, seed, device):
    """The cell's volumes: a list of dicts with the fit's arguments
    (``data`` (n, 1, 1, S), ``mask``, ``numfasc``, ``peaks`` (n, 1, 1,
    6), ``csf_mask``, ``ear_mask`` (None without EAR atoms), NumPy on the
    host) and what the comparison needs (``dirs`` (n, 2, 3), ``bucket``
    (n, 3) [K, csf, ear])."""
    sch, dic = dictionary.build(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=dev)
    b = torch.as_tensor(dictionary.b_values(sch), **f64)
    g = torch.as_tensor(sch[:, :3], **f64)
    b0 = int(np.flatnonzero(sch[:, 3] == 0)[0])
    d_par = torch.as_tensor(dic["d_par"], **f64)
    d_perp = torch.as_tensor(dic["d_perp"], **f64)
    csf = torch.as_tensor(dictionary.csf_signature(cfg, sch), **f64)
    n_ear = int(cfg.get("num_ear") or 0)
    ear = torch.as_tensor(dictionary.ear_signatures(cfg, sch), **f64)
    counts = bucket_counts(traffic)
    n = int(traffic["voxels"])
    table = torch.as_tensor([[int(x) for x in k.split(",")]
                             for k in counts], device=dev)
    label = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.as_tensor(list(counts.values()), device=dev))
    if bool((table[:, 2] > 0).any()) and not n_ear:
        raise ValueError("an EAR bucket needs a configuration with EAR atoms")
    lo, hi = traffic["weights"]
    out = []
    for _ in range(VOLUMES):
        bucket = table[label[torch.randperm(n, generator=gen, device=dev)]]
        K, has_csf, has_ear = bucket[:, 0], bucket[:, 1], bucket[:, 2]
        dirs = torch.randn((n, 2, 3), generator=gen, **f64)
        dirs = dirs / torch.linalg.norm(dirs, dim=2, keepdim=True)
        ids = torch.randint(0, cfg["num_atom"], (n, 2), generator=gen,
                            device=dev)
        eid = torch.randint(0, max(n_ear, 1), (n,), generator=gen,
                            device=dev)
        w = (lo + (hi - lo) * torch.rand((n, 4), generator=gen, **f64)) \
            * traffic["scale"]
        noise = torch.randn((2, n, sch.shape[0]), generator=gen, **f64)
        cos2 = (dirs @ g.T) ** 2                                # (n, 2, S)
        dp, dq = d_par[ids][..., None], d_perp[ids][..., None]
        zep = torch.exp(-b * (dq + (dp - dq) * cos2))           # (n, 2, S)
        y = (w[:, 0, None] * zep[:, 0] * (K >= 1)[:, None]
             + w[:, 1, None] * zep[:, 1] * (K >= 2)[:, None]
             + w[:, 2, None] * csf * (has_csf > 0)[:, None])
        if n_ear:
            y = y + w[:, 3, None] * ear[:, eid].T * (has_ear > 0)[:, None]
        sigma = y[:, b0:b0 + 1] / traffic["snr_b0"]
        y = torch.sqrt((y + sigma * noise[0]) ** 2 + (sigma * noise[1]) ** 2)
        present = (torch.arange(2, device=dev)[None, :] < K[:, None])
        peaks = (dirs * present[..., None]).reshape(n, 6)
        shape = (n, 1, 1)
        host = lambda t: t.cpu().numpy()
        out.append({
            "data": host(y).reshape(shape + (sch.shape[0],)),
            "mask": np.ones(shape),
            "numfasc": host(K).reshape(shape).astype(np.float64),
            "peaks": host(peaks).reshape(shape + (6,)),
            "csf_mask": host(has_csf).reshape(shape).astype(np.float64),
            "ear_mask": (host(has_ear).reshape(shape).astype(np.float64)
                         if n_ear else None),
            "dirs": host(dirs), "bucket": host(bucket),
        })
    return out
