"""The fast path's exact selection (``models/certify.py``) on the CPU:
``MFModel.fit(engine="auto")`` against the plain reference of the
benchmark (``mfbench/reference.py``: its own float64 rotation and the
exhaustive float64 NNLS over every combination of one atom a block).

Small cells of the ``dense552_2fasc_csf_ear10`` configuration (the
smooth zeppelin grid cut to its first 48 atoms, 3 EAR atoms, a 3-shell x
16-direction + 4 b0 scheme), every bucket of a brain; near-ties planted
by construction; the witness voxels of the chip runs at the real widths
(``tests/golden/witness_fast_path.npz``); the fallback tier forced.

Tolerances. ``obj_gap`` (the claim's float64 residual above the
reference's least one, over ||y||^2) <= 1e-11, the benchmark's limit for
these cells: a wrong atom on these grids costs 1e-10 or more, the
float64 solves agree to ~1e-15. Atoms are held equal to the
reference's optimum through that gap: two atoms whose float64
objectives agree to 1e-11 ||y||^2 are a float64 tie.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from mfbench import dictionary, generator, judge, reference

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch.models import certify
from microstructure_fingerprinting_torch.models import fit as tfit

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WITNESS = os.path.join(HERE, "golden", "witness_fast_path.npz")
#: the benchmark's limit on these cells (mfbench/limits/brain_mix.json)
OBJ_GAP = 1e-11


def _json(*parts):
    with open(os.path.join(ROOT, "mfbench", *parts)) as f:
        return json.load(f)


def _cfg(atoms=48, n_ear=3):
    cfg = copy.deepcopy(_json("configs", "dense552_2fasc_csf_ear10.json"))
    cfg["scheme"].update(n_shells=3, dirs_per_shell=16, n_b0=4)
    cfg["num_atom"] = atoms
    cfg["num_ear"] = n_ear
    return cfg


def _fit(model, vol, sch, **kw):
    args = dict(peaks=vol["peaks"], pgse_scheme=sch,
                csf_mask=vol["csf_mask"], verbose=0, device="cpu",
                batch_size=16)
    if vol.get("ear_mask") is not None:
        args["ear_mask"] = vol["ear_mask"]
    args.update(kw)
    return model.fit(vol["data"], vol["mask"], vol["numfasc"], **args)


def _gaps(cfg, vol, fit):
    """Each voxel's obj_gap against the reference (every voxel judged)."""
    keys = {generator.bucket_key(*b) for b in vol["bucket"].tolist()}
    traffic = {"judge": {k: 10 ** 6 for k in keys}}
    fits = [{"vol": 0, "maps": judge.maps_of(fit)}]
    _nums, read, per_bucket = judge.judge(cfg, traffic, [vol], fits, 1,
                                          "cpu")
    return read["obj_gap"], per_bucket


@pytest.fixture(scope="module")
def small():
    cfg = _cfg()
    traffic = copy.deepcopy(_json("traffic", "brain_mix.json"))
    traffic["voxels"] = 150
    vol = generator.volumes(cfg, traffic, 2 ** 31 + 24, "cpu")[0]
    sch, dic = dictionary.build(cfg)
    return cfg, vol, sch, mft.MFModel(dic, device="cpu")


def test_every_bucket_matches_the_float64_reference(small):
    """Every voxel of a small brain (five buckets, SNR 50), fitted by
    ``MFModel.fit`` with its defaults, is the reference's float64
    optimum within OBJ_GAP; each voxel is counted once, as certified,
    re-scored or solved by the fallback."""
    cfg, vol, sch, model = small
    before = dict(tfit.CERTIFY)
    fit = _fit(model, vol, sch)
    gaps, per_bucket = _gaps(cfg, vol, fit)
    assert len(per_bucket) == 5
    assert gaps.max() <= OBJ_GAP, per_bucket
    counted = sum(tfit.CERTIFY[k] - before[k] for k in before)
    assert counted == int(np.sum(vol["numfasc"] > 0))


def test_refine_false_is_the_scan_alone(small):
    """``refine=False`` runs the chunk steps without the certificate and
    counts nothing; the default fit's maps equal it bit for bit on every
    voxel but those it re-scored or handed to the fallback, and there
    its objective is never above the scan's."""
    cfg, vol, sch, model = small
    before = dict(tfit.CERTIFY)
    fit = _fit(model, vol, sch)
    moved = sum(tfit.CERTIFY[k] - before[k] for k in ("rescored",
                                                      "fallback"))
    after = dict(tfit.CERTIFY)
    plain = _fit(model, vol, sch, refine=False)
    assert tfit.CERTIFY == after
    n = vol["data"].shape[0]
    differ = np.zeros(n, dtype=bool)
    for p in fit.param_names:
        a = getattr(fit, p).reshape(n, -1)
        b = getattr(plain, p).reshape(n, -1)
        differ |= np.any(a != b, axis=1)
    assert differ.sum() <= moved
    g_fit, _ = _gaps(cfg, vol, fit)
    g_plain, _ = _gaps(cfg, vol, plain)
    assert np.all(g_fit <= g_plain + OBJ_GAP)


def _planted(cfg, sch, dic, rng, n, lam_steps=60):
    """``n`` two-fascicle + CSF voxels each on a float64 near-tie: the
    first fascicle a blend lam A_i + (1 - lam) A_(i+1) of two
    neighbouring atoms, lam bisected on the reference's float64
    objectives (with the noise in) until the two atoms' least residuals
    differ by less than 1e-13 ||y||^2, far inside the certificate's
    band."""
    rot = reference.Rotation(dic["dictionary"], sch, dic["orientation"],
                             "cpu")
    csf = torch.as_tensor(dictionary.csf_signature(cfg, sch))
    S = sch.shape[0]
    out = dict(data=[], peaks=[], dirs=[])
    while len(out["data"]) < n:
        d = rng.normal(size=(2, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        A1 = rot(d[:1])[0]
        A2 = rot(d[1:])[0]
        i = int(rng.integers(0, cfg["num_atom"] - 1))
        k = int(rng.integers(0, cfg["num_atom"]))
        noise = torch.as_tensor(rng.normal(size=S)) * 0.002
        base = 0.7 * A2[:, k] + 0.4 * csf + noise

        def best(y, j):
            return reference.best_objective(
                y[None], [A1[None, :, j], A2[None], csf[None, :, None]])[0]

        def gap(lam):
            y = lam * A1[:, i] + (1 - lam) * A1[:, i + 1] + base
            return float(best(y, slice(i, i + 1))
                         - best(y, slice(i + 1, i + 2))) / float(y @ y), y

        lo, hi = 0.0, 1.0
        for _ in range(lam_steps):
            mid = 0.5 * (lo + hi)
            g, y = gap(mid)
            if abs(g) < 1e-13:
                break
            lo, hi = (mid, hi) if g > 0 else (lo, mid)
        # a tie of the optimum: no other first-fascicle atom does better
        pair = best(y, slice(i, i + 2))
        if abs(g) < 1e-13 and best(y, slice(None)) >= pair:
            out["data"].append(y.numpy())
            out["peaks"].append(d.reshape(6))
            out["dirs"].append(d)
    n = len(out["data"])
    shape = (n, 1, 1)
    return dict(data=np.asarray(out["data"]).reshape(shape + (S,)),
                mask=np.ones(shape), numfasc=np.full(shape, 2.0),
                peaks=np.asarray(out["peaks"]).reshape(shape + (6,)),
                csf_mask=np.ones(shape), ear_mask=None,
                dirs=np.asarray(out["dirs"]),
                bucket=np.tile([2, 1, 0], (n, 1)))


@pytest.fixture(scope="module")
def planted():
    cfg = _cfg(n_ear=0)
    cfg.pop("num_ear")
    sch, dic = dictionary.build(cfg)
    vol = _planted(cfg, sch, dic, np.random.default_rng(24), 6)
    return cfg, vol, sch, mft.MFModel(dic, device="cpu")


def test_planted_near_ties_are_rescored_exactly(planted):
    """Voxels planted on a float64 near-tie of two neighbouring atoms
    (closer than the certificate's band) are not certified: their
    candidates are re-scored in float64 and the fit is the reference's
    optimum within OBJ_GAP."""
    cfg, vol, sch, model = planted
    before = dict(tfit.CERTIFY)
    fit = _fit(model, vol, sch)
    gaps, _ = _gaps(cfg, vol, fit)
    assert gaps.max() <= OBJ_GAP
    n = vol["data"].shape[0]
    assert tfit.CERTIFY["rescored"] - before["rescored"] >= n - 1
    assert tfit.CERTIFY["certified"] == before["certified"]


def test_fallback_tier_is_exact(planted, monkeypatch):
    """With room for one candidate only (``certify.M`` = 1), every
    planted near-tie exceeds the re-score and goes to the fallback, the
    exhaustive float64 solve of the voxel alone: counted there, and the
    reference's optimum within OBJ_GAP."""
    cfg, vol, sch, model = planted
    monkeypatch.setattr(certify, "M", 1)
    before = dict(tfit.CERTIFY)
    fit = _fit(model, vol, sch)
    gaps, _ = _gaps(cfg, vol, fit)
    assert gaps.max() <= OBJ_GAP
    n = vol["data"].shape[0]
    assert tfit.CERTIFY["fallback"] - before["fallback"] >= n - 1
    assert tfit.CERTIFY["rescored"] == before["rescored"]


def test_wide_pass_settles_what_the_first_cannot(planted, monkeypatch):
    """With one cell evaluated a voxel (``certify.Q_CELLS`` = 1), the
    planted near-ties lie partly in cells the first pass does not
    evaluate, so it hands them to the fallback; the wide pass
    (``fit.WIDE`` times the cells, no row pruned) settles them by the
    re-score alone, and the fit is the reference's optimum within
    OBJ_GAP."""
    cfg, vol, sch, model = planted
    monkeypatch.setattr(certify, "Q_CELLS", 1)
    handed = []
    take = tfit._Exact.take

    def spy(self, idx, packs, final=False):
        if final:
            handed.append(idx)
        return take(self, idx, packs, final)

    monkeypatch.setattr(tfit._Exact, "take", spy)
    before = dict(tfit.CERTIFY)
    fit = _fit(model, vol, sch)
    gaps, _ = _gaps(cfg, vol, fit)
    assert gaps.max() <= OBJ_GAP
    n = vol["data"].shape[0]
    assert sum(v.size for v in handed) >= n - 1
    assert tfit.CERTIFY["fallback"] == before["fallback"]
    assert tfit.CERTIFY["rescored"] - before["rescored"] >= n - 1


def test_bound_covers_the_float32_rotation(small):
    """``certify.Bound.eta`` bounds the relative error of every rotated
    float32 column against the float64 rotation of the same tables, and
    the objective error it implies (``certify.eps``) bounds the float32
    columns' float64 objectives against the float64 columns' on every
    combination of a voxel's grid."""
    cfg, vol, sch, model = small
    ms = model.ms_interpolator
    from microstructure_fingerprinting_torch.ops import interp as mfi
    plan = mfi.plan_target_scheme(ms, sch)
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    bound = certify.Bound(ms, plan)
    sel = np.flatnonzero(vol["numfasc"].reshape(-1) == 2)[:8]
    pk64 = torch.as_tensor(vol["peaks"].reshape(-1, 2, 3)[sel])
    pk32 = pk64.float()
    D32 = rotate(ms.device_tables("cpu", torch.float32)[1], pk32).double()
    D64 = rotate(ms.device_tables("cpu", torch.float64)[1], pk64)
    eta = bound.eta(pk32, pk64)
    rel = ((D32 - D64).norm(dim=2) / D64.norm(dim=2)).amax(dim=(1, 2))
    assert torch.all(rel <= eta)
    y64 = torch.as_tensor(vol["data"].reshape(-1, sch.shape[0])[sel])[
        :, perm]
    csf = torch.as_tensor(dictionary.csf_signature(cfg, sch))[perm]
    tau = certify.tau_of(eta, certify.U, 3)
    for b in range(len(sel)):
        grids = []
        for D, y, c in ((D64, y64, csf),
                        (D32, y64.float().double(), csf.float().double())):
            A1, A2 = D[b, 0], D[b, 1]
            yy = y[b] @ y[b]
            gram = [[(A1 * A1).sum(0)[:, None], A1.T @ A2, (A1.T @ c)[:, None]],
                    [None, (A2 * A2).sum(0)[None], (A2.T @ c)[None]],
                    [None, None, c @ c]]
            rhs = [(A1.T @ y[b])[:, None], (A2.T @ y[b])[None], c @ y[b]]
            grids.append(reference._least_over_supports(
                yy, gram, rhs, 100 * 2.2e-16) / yy)
        F64, F32 = grids
        err = (F32 - F64).abs()
        bnd = certify.eps(F32.reshape(1, -1), tau[b:b + 1]).reshape(F32.shape)
        assert torch.all(err <= bnd)


def test_witness_voxels_at_real_widths():
    """The voxels where the scan alone missed the float64 optimum on the
    card (the first volume's voxel 44746 of brain_mix seed 41005, two
    fascicles without CSF, 3.3e-9 above its optimum; voxel 2262 of ear_wm
    seed 30009, two fascicles + CSF + EAR, 3.6e-10), at the
    configuration's real widths (782 atoms, 552 sequences, 10 EAR
    atoms): the default fit is the reference's optimum within OBJ_GAP,
    where the scan alone (``refine=False``) misses it."""
    cfg = _json("configs", "dense552_2fasc_csf_ear10.json")
    sch, dic = dictionary.build(cfg)
    model = mft.MFModel(dic, device="cpu")
    z = np.load(WITNESS)
    keys = sorted({k.split("/")[0] for k in z.files})
    for key in keys:
        vol = {f: z[key + "/" + f] for f in ("data", "peaks", "numfasc",
                                             "csf_mask", "ear_mask", "dirs",
                                             "bucket")}
        n = vol["data"].shape[0]
        vol["mask"] = np.ones((n, 1, 1))
        if not vol["bucket"][:, 2].any():
            vol["ear_mask"] = None
        fit = _fit(model, vol, sch, batch_size=1)
        gaps, _ = _gaps(cfg, vol, fit)
        assert gaps.max() <= OBJ_GAP, key
        # the scan alone misses here, on the CPU as on the card
        plain = _fit(model, vol, sch, batch_size=1, refine=False)
        assert _gaps(cfg, vol, plain)[0].max() > OBJ_GAP, key
