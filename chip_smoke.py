"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of ``microstructure_fingerprinting_torch``
from ``csrc/``, holds each against its plain PyTorch version on the card
on a 512-voxel chunk of the flagship shapes (see ``held`` for the
tolerance) and times both, fits the flagship [782, 782, 1] two-fascicle + CSF volume (552 sequences,
4096 voxels, random directions, noiseless) through ``MFModel.fit``,
writes and reloads its maps, and drives both overflow tiers. Exits
non-zero on any failure; needs one CUDA device. The last line of standard
output is the JSON summary {"ok": true, "device": {...}}; the kernel table
is the JSON line before the card's name and power limit; an earlier
``record:`` line holds every number measured.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_VOX = 4096          # 16 x 16 x 16 volume
N_ATOM = 782          # flagship sub-dictionary size
CHUNK = 512           # voxels per chunk of the fit (MFModel.fit default)
#: voxels per call of each plain version when it is held against its
#: kernel on a whole chunk (bounds the plain versions' temporaries)
SLICE = {"prep_block": 128, "rowmin3": 64, "rescan3": 512}

RECORD = {}


def log(msg):
    print(msg, flush=True)


def timed(fn, reps=3):
    """Mean device milliseconds of fn() over reps (after one warm-up)."""
    import torch
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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_setup():
    import torch
    from microstructure_fingerprinting_torch.ops import kernels
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("card: %s" % card_line())
    log("torch %s, CUDA %s, nvcc: %s" % (torch.__version__, torch.version.cuda,
                                         nvcc[-1]))
    t0 = time.time()
    kernels.library()
    build_s = time.time() - t0
    log("kernels %s in %.1f s: %s" % (
        "reused" if kernels.BUILD_INFO["cached"] else "built", build_s,
        kernels.BUILD_INFO["cmd"]))
    for line in kernels.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    RECORD["build_s"] = build_s


def flagship_inputs(wl, B, device):
    """Rotated blocks, signals and the CSF block for the first B voxels."""
    import torch
    from microstructure_fingerprinting_torch.ops import interp as mfi
    ms, plan = wl["msinterp"], wl["plan"]
    rotate, perm = mfi.make_grouped_rotation_paired(ms, plan)
    _x, ys, _c = ms.device_tables(device, torch.float32)
    D = rotate(ys, torch.as_tensor(wl["peaks"][:B], dtype=torch.float32,
                                   device=device))
    y = torch.as_tensor(wl["y"][:B][:, perm], dtype=torch.float32,
                        device=device)
    csf = torch.as_tensor(wl["sig_csf"][perm], dtype=torch.float32,
                          device=device)
    return D, y, csf[None, :, None].expand(B, -1, 1).contiguous()


def held(what, k, p, exact=False):
    """Hold a kernel output against its plain version's by
    ``testing.kernel_agreement``; raises if they differ, else returns
    max|k - p|."""
    from microstructure_fingerprinting_torch import testing
    ok, n_diff, n, err, tol = testing.kernel_agreement(k, p, exact)
    log("%s: %d of %d entries differ, max|err| %.3e (limit %.3e)%s"
        % (what, n_diff, n, err, tol, "" if ok else " FAIL"))
    if not ok:
        raise AssertionError(
            "%s: kernel and plain version differ (tolerance: %s, same "
            "inf/NaN entries, %d float32 ulp of max|value|)" % (
                what, "no entry differs" if exact else "<= %.0e of entries "
                "differ" % testing.KERNEL_DIFF_SHARE, testing.KERNEL_ULPS))
    return err


def plain_sliced(fn, ops, step):
    """fn over voxel slices of ``step``, outputs joined on the voxel
    axis: the plain versions' temporaries for a whole chunk would not
    fit on the card, and every voxel is independent."""
    import torch
    B = ops[0].shape[0]
    outs = [fn(*[o[i:i + step] for o in ops]) for i in range(0, B, step)]
    return tuple(None if parts[0] is None else torch.cat(parts)
                 for parts in zip(*outs))


def phase_kernels(wl):
    """Each kernel against its plain PyTorch version, on the card, at
    the main path's chunk of CHUNK voxels (the re-scan also on the full
    782 x 782 grid of the one-pass branch and the last overflow tier)."""
    import torch
    from microstructure_fingerprinting_torch.ops import f32scan, prep, rescan
    from microstructure_fingerprinting_torch.ops import nnls as mfn
    dev = torch.device("cuda")
    D, y, a3 = flagship_inputs(wl, CHUNK, dev)
    A1, A2 = D[:, 0].contiguous(), D[:, 1].contiguous()
    del D
    rows = {}

    # kernel 1: both prep shapes of the row pass
    yh, _, _ = mfn._normalize_y(y)
    a3h, _ = mfn._normalize_block(a3)
    rq, rr, ra, _ = prep.pack_rhs([yh, a3h[:, :, 0]])
    err, ms_k, ms_p = 0.0, 0.0, 0.0
    for A, tile, planes in ((A1, 128, "xr"), (A2, 512, "ra")):
        ops = (prep.pad_block(A, tile)[0].contiguous(), rq, rr, ra)
        kern = lambda: prep.prep_block(*ops, tile, planes, n_rhs=2)
        plain = lambda: plain_sliced(
            lambda *o: prep.prep_block_twin(*o, tile, planes, n_rhs=2),
            ops, SLICE["prep_block"])
        shape = "prep %s tile %d" % (tuple(ops[0].shape), tile)
        for name, k, p in zip(("q123", "x", "r", "a", "gram"), kern(),
                              plain()):
            if k is not None:
                err = max(err, held("%s %s" % (shape, name), k, p))
        ms_k += timed(kern)
        ms_p += timed(plain)
    rows["prep_block"] = [err, ms_k, ms_p]

    # kernel 2: the row pass at N1 = N2 = 782
    ops, _ = f32scan.rowmin_3_operands(A1, A2, a3, y)
    kern = lambda: f32scan.rowmin3_rows(*ops, n1=N_ATOM, n2=N_ATOM)
    plain = lambda: plain_sliced(
        lambda *o: f32scan.rowmin3_twin(*o, n1=N_ATOM, n2=N_ATOM), ops,
        SLICE["rowmin3"])
    err = max(held("rowmin3 " + name, k, p) for name, k, p in
              zip(("lo_row", "up_row", "lo_col"), kern(), plain()))
    rows["rowmin3"] = [err, timed(kern), timed(plain)]
    del ops

    # kernel 3: the re-scan at the two-pass shape 128 x 128 on the chunk
    # (timed), then on the full 782 x 782 grid for a few voxels
    err = 0.0
    for n, B in ((128, CHUNK), (N_ATOM, 8)):
        ops, segw, _yn = rescan.row_scan_df3_operands(
            A1[:B, :, :n], A2[:B, :, :n], a3[:B], y[:B])
        kern = lambda: rescan.rescan3_rows(*ops, n2=n, segw=segw)
        plain = lambda: plain_sliced(
            lambda *o: rescan.rescan3_twin(*o, n2=n, segw=segw), ops,
            SLICE["rescan3"])
        k, p = kern(), plain()
        what = "rescan3 %d x %d, %d voxels" % (n, n, B)
        err = max(err, held(what + " row minima", k[0], p[0]))
        held(what + " first-minimum i2", k[1], p[1], exact=True)
        seg = rescan.n_segments(n)
        ck = rescan.candidates_from_rows(k[0].reshape(B, -1),
                                         k[1].reshape(B, -1), segments=seg)
        cp = rescan.candidates_from_rows(p[0].reshape(B, -1),
                                         p[1].reshape(B, -1), segments=seg)
        if not torch.equal(ck[0], cp[0]):
            raise AssertionError(what + ": top-1 candidates differ")
        if n == 128:
            rows["rescan3"] = [0.0, timed(kern), timed(plain)]
        else:
            RECORD["rescan3_full_grid_ms"] = [B, timed(kern), timed(plain)]
        del ops, k, p
    rows["rescan3"][0] = err
    RECORD["kernel_check_voxels"] = CHUNK
    RECORD["kernel_ms_plain_ms"] = rows
    log("kernel vs plain ms on a %d-voxel chunk: " % CHUNK + ", ".join(
        "%s %.3f vs %.3f" % (name, r[1], r[2]) for name, r in rows.items()))
    del A1, A2, a3, y
    torch.cuda.empty_cache()
    return rows


def make_volume(wl):
    side = round(N_VOX ** (1 / 3))
    shape = (side, side, side)
    S = wl["y"].shape[1]
    data = wl["y"].reshape(shape + (S,))
    peaks = wl["peaks"].reshape(shape + (6,))
    return data, np.ones(shape), np.full(shape, 2.0), peaks


def phase_fit(wl):
    """The flagship fit through MFModel.fit, cold then warm."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.utils import nifti, profiling
    sch = wl["sch_mat"]
    sig, dpar, dperp = mft.testing.make_dictionary(sch, N_ATOM)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": N_ATOM,
           "fasc_propnames": ["atom_id", "dpar"],
           "atom_id": np.arange(N_ATOM, dtype=float), "dpar": dpar,
           "T2_csf": 2.0, "DIFF_csf": 3.0e-9}
    data, mask, numfasc, peaks = make_volume(wl)
    model = mft.MFModel(dic)
    kw = dict(peaks=peaks, pgse_scheme=sch, csf_mask=1, verbose=0)

    mft.reset_counts()
    t0 = time.time()
    fit = model.fit(data, mask, numfasc, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = dict(mft.LAUNCHES)
    log("cold fit of %d voxels: %.2f s; kernel launches %s"
        % (N_VOX, cold_s, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the path was never launched")

    r2 = fit.R2.reshape(-1)
    if not np.all(r2 >= 1 - 1e-6):
        raise AssertionError("R2 below 1 - 1e-6 in %d voxels (min %.9f)"
                             % (int(np.sum(r2 < 1 - 1e-6)), r2.min()))
    ids = np.stack([fit.atom_id_f0.reshape(-1), fit.atom_id_f1.reshape(-1)],
                   axis=1).astype(np.int64)
    gt = wl["gt_ids"]
    diff = np.flatnonzero(np.any(ids != gt, axis=1))
    ysq = np.sum(wl["y"] ** 2, axis=1)
    obj = fit.MSE.reshape(-1) * sch.shape[0]
    n_tie = 0
    if diff.size:
        # objective of the planted pair on the same rotated columns
        rotate, perm = mfi.make_grouped_rotation_paired(wl["msinterp"],
                                                        wl["plan"])
        _x, ys, _c = wl["msinterp"].device_tables("cuda", torch.float32)
        D = rotate(ys, torch.as_tensor(wl["peaks"][diff], dtype=torch.float32,
                                       device="cuda"))
        y = torch.as_tensor(wl["y"][diff][:, perm], dtype=torch.float32,
                            device="cuda")
        csf = torch.as_tensor(wl["sig_csf"][perm], dtype=torch.float32,
                              device="cuda")
        _w, obj_gt, _r2 = fit_mod._finalize_top1(
            D, csf, y, torch.as_tensor(gt[diff], device="cuda"))
        obj_gt = obj_gt.double().cpu().numpy()
        for k, v in enumerate(diff):
            tie = obj[v] <= obj_gt[k] + 2e-9 * ysq[v]
            log("voxel %d: selected %s, planted %s, objective %.6e vs "
                "planted %.6e -> %s" % (v, ids[v].tolist(), gt[v].tolist(),
                                        obj[v], obj_gt[k],
                                        "tie" if tie else "ERROR"))
            if not tie:
                raise AssertionError("voxel %d selected a worse pair" % v)
            n_tie += 1
    log("planted pair recovered in %d/%d voxels (%d equal-objective ties); "
        "min R2 %.9f; max MSE/||y||^2 %.3e" % (
            N_VOX - diff.size, N_VOX, n_tie, r2.min(),
            np.max(obj / ysq)))

    with tempfile.TemporaryDirectory() as tmp:
        files = fit.write_nifti(os.path.join(tmp, "mf.nii.gz"),
                                affine=np.eye(4))
        for fname, p in zip(files, fit.param_names):
            back = nifti.load(fname).get_fdata()
            if not np.array_equal(back, getattr(fit, p)):
                raise AssertionError("map %s did not reload identically" % p)
    log("wrote and reloaded %d maps" % len(files))

    t0 = time.time()
    model.fit(data, mask, numfasc, **kw)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    card = card_line()
    log("warm fit: %.3f s, %.1f voxels/s [%s]" % (warm_s, N_VOX / warm_s,
                                                  card))
    with profiling.StageTimer() as st:
        model.fit(data, mask, numfasc, **kw)
    stages = st.totals_ms()
    log("stage split (device ms, one fit): " + ", ".join(
        "%s %.1f" % kv for kv in stages.items()))
    RECORD.update(cold_fit_s=cold_s, warm_fit_s=warm_s,
                  voxels_per_s=N_VOX / warm_s, stages_ms=stages,
                  launches=launches, n_ties=n_tie, min_r2=float(r2.min()),
                  card=card)
    return launches


def phase_overflow():
    """Duplicated atoms with a squeezed row budget: both overflow tiers
    run through the kernels and match the plain versions on the CPU."""
    import torch
    import microstructure_fingerprinting_torch as mft
    from microstructure_fingerprinting_torch import config
    from microstructure_fingerprinting_torch.models import fit as fit_mod
    from microstructure_fingerprinting_torch.ops import f32scan
    from microstructure_fingerprinting_torch.ops import interp as mfi
    from microstructure_fingerprinting_torch.utils.scheme import b_values
    sch = mft.testing.make_dense_scheme(n_shells=3, dirs_per_shell=12,
                                        n_b0=4)
    sig, _, _ = mft.testing.make_dictionary(sch, num_atom=6)
    sig = np.tile(sig, (1, 12))                       # 72 columns, 12x each
    ms = mfi.init_PGSE_multishell_interp(sig, sch, np.array([0.0, 0.0, 1.0]))
    plan = mfi.plan_target_scheme(ms, sch)
    rng = np.random.RandomState(141414)
    n = 6
    peaks = rng.randn(n, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    csf = np.exp(-sch[:, 6] / 2.0) * np.exp(-b_values(sch) * 3.0e-9)
    y = np.broadcast_to(300 * (0.6 * sig[:, 2][None] + 0.4 * csf[None]),
                        (n, sch.shape[0])).copy()
    old = config.DEFAULTS["solver"]
    config.DEFAULTS["solver"] = dataclasses.replace(old, twopass_rows=8)
    seen = []
    orig = f32scan.df3_twopass

    def spy(*a, **k):
        if a[0].is_cuda:
            seen.append(k["R"])
        return orig(*a, **k)

    f32scan.df3_twopass = spy
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            _x, ys, _c = ms.device_tables(dev, torch.float32)
            out[dev] = fit_mod.run_bucket_fast(ms, plan, ys,
                                               peaks.reshape(n, 6), y, csf,
                                               2, True, batch=2)
    finally:
        f32scan.df3_twopass = orig
        config.DEFAULTS["solver"] = old
    ysq = np.sum(y ** 2, axis=1)
    g, c = out["cuda"], out["cpu"]
    log("overflow: row budgets run on the card %s; ids %s; objective "
        "max|card - plain|/||y||^2 %.3e" % (
            sorted(set(seen)), g[1][:, :2].tolist(),
            np.max(np.abs(g[2] - c[2]) / ysq)))
    if not {16, 72} <= set(seen):
        raise AssertionError("an overflow tier did not run")
    if not np.array_equal(g[1], c[1]) or \
            np.max(np.abs(g[2] - c[2]) / ysq) > 2e-9:
        raise AssertionError("overflow tiers disagree with the plain path")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import microstructure_fingerprinting_torch as mft
    t_all = time.time()
    phase_setup()
    t0 = time.time()
    wl = mft.testing.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX,
                                       device="cuda")
    log("workload synthesized in %.1f s" % (time.time() - t0))
    t0 = time.time()
    rows = phase_kernels(wl)
    log("kernel checks: %.1f s" % (time.time() - t0))
    t0 = time.time()
    launches = phase_fit(wl)
    log("fit phase: %.1f s" % (time.time() - t0))
    t0 = time.time()
    phase_overflow()
    log("overflow phase: %.1f s" % (time.time() - t0))
    meta = {"prep_block": ("csrc/prep.cu", "ops/pallas_prep.py:206"),
            "rowmin3": ("csrc/rowmin3.cu", "ops/f32scan.py:463"),
            "rescan3": ("csrc/rescan3.cu", "ops/pallas_dfscan.py:402")}
    table = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "microstructure_fingerprinting_torch/" + meta[name][0],
         "replaces": "microstructure_fingerprinting_tpu/" + meta[name][1],
         "launches": launches[name], "max_abs_err": rows[name][0],
         "ms": rows[name][1], "plain_ms": rows[name][2]}
        for name in ("prep_block", "rowmin3", "rescan3")]}
    RECORD["total_s"] = time.time() - t_all
    log("record: " + json.dumps(RECORD))
    print(json.dumps(table))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
