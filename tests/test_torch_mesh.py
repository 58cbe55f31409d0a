"""The port's device meshes (``parallel/mesh.py``) and the fits on them vs
the serial port fit and the JAX package on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices (conftest); the
port's meshes name the CPU 8 times, which drives the same mesh code
(slots run in turn). Shapes are ``tests/test_sharding.py``'s (32 atoms,
3 x 12 directions + 4 b0, 8 voxels; B=8, S=30, N1=24, N2=32), so the
suite's persistent JAX cache already holds the programs. The two-process
test runs this file as a script: two gloo processes on localhost, each
fitting its half of the voxels on a local mesh of two CPU slots.
"""

import contextlib
import dataclasses
import io
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # the two-process test's worker
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import microstructure_fingerprinting_torch as mft  # noqa: E402
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import kernels as tkernels
from microstructure_fingerprinting_torch.parallel import mesh as tmesh
from microstructure_fingerprinting_torch.utils.scheme import b_values

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
#: (n_data, n_atoms) meshes of tests/test_sharding.py
SHAPES = [(2, 4), (4, 2), (8, 1)]
#: seconds before a worker of the two-process test is killed
WORKER_TIMEOUT = 300


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: this file also runs as
    the two-process test's worker, which imports no JAX)."""
    import jax
    import jax.numpy as jnp
    from microstructure_fingerprinting_tpu import MFModel
    from microstructure_fingerprinting_tpu import testing
    from microstructure_fingerprinting_tpu.models import fit
    from microstructure_fingerprinting_tpu.ops import dfscan
    from microstructure_fingerprinting_tpu.parallel import mesh
    if len(jax.devices()) != 8:
        pytest.skip("needs the suite's 8-device virtual mesh")
    return types.SimpleNamespace(jnp=jnp, MFModel=MFModel, testing=testing,
                                 fit=fit, dfscan=dfscan, pmesh=mesh)


def _scan_inputs(rng, tie=False):
    """tests/test_sharding.py's scan inputs (column 17 of A2 duplicates
    column 3), float32; with ``tie`` every signal is an exact mixture of
    A1[:, :, 5], A2[:, :, 3] and a3, so (5, 3) and (5, 17) tie."""
    B, S, N1, N2 = 8, 30, 24, 32
    A1 = np.abs(rng.randn(B, S, N1)) + 0.05
    A2 = np.abs(rng.randn(B, S, N2)) + 0.05
    A2[:, :, 17] = A2[:, :, 3]
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = rng.randn(B, S)
    if tie:
        y = 0.5 * A1[:, :, 5] + 0.3 * A2[:, :, 3] + 0.2 * a3[:, :, 0]
    return tuple(np.float32(v) for v in (A1, A2, a3, y))


def _held_scan(got, want):
    """Candidates equal, residuals and ||y||^2 to rtol 1e-6."""
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the mesh and its pieces
# ---------------------------------------------------------------------------

def test_build_mesh_shapes_and_errors(monkeypatch):
    """Shapes as the JAX ``build_mesh`` gives them, filled row by row;
    repeated devices allowed; a grid that does not hold the devices
    raises, and so does the default device list without CUDA."""
    m = tmesh.build_mesh(n_atoms=1, devices=CPU8)
    assert m.shape == {"data": 8, "atoms": 1}
    m = tmesh.build_mesh(n_data=2, n_atoms=4, devices=CPU8)
    assert m.shape == {"data": 2, "atoms": 4}
    assert m.data_devices == [torch.device("cpu")] * 2
    devs = [torch.device("meta"), torch.device("cpu")] * 2
    m = tmesh.build_mesh(2, 2, devices=devs)
    assert m.devices == ((devs[0], devs[1]), (devs[0], devs[1]))
    for nd, na in ((3, 3), (1, 16), (None, 16)):
        with pytest.raises(ValueError, match="does not match 8 devices"):
            tmesh.build_mesh(n_data=nd, n_atoms=na, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.build_mesh()


def test_pieces(rng):
    """shard_batch, replicate and shard_atoms return the grid's pieces
    (the JAX shardings' per-device blocks); uneven splits raise."""
    m = tmesh.build_mesh(4, 2, devices=CPU8)
    x = rng.randn(16, 5, 6)
    b = tmesh.shard_batch(m, x)
    r = tmesh.replicate(m, x)
    a = tmesh.shard_atoms(m, x)
    for j in range(4):
        for k in range(2):
            assert np.array_equal(b[j][k].numpy(), x[4 * j:4 * j + 4])
            assert np.array_equal(r[j][k].numpy(), x)
            assert np.array_equal(a[j][k].numpy(),
                                  x[4 * j:4 * j + 4, :, 3 * k:3 * k + 3])
    with pytest.raises(ValueError, match="equal parts"):
        tmesh.shard_batch(m, x[:6])
    with pytest.raises(ValueError, match="equal parts"):
        tmesh.shard_atoms(m, x[..., :5])
    assert np.array_equal(tmesh.host_local_to_global(m, x)[3][1].numpy(),
                          x[12:])


def test_gather_to_host_without_process_group(rng):
    """With one process ``gather_to_host`` is its input, as NumPy (a new
    leading axis when not tiled), as the JAX process_allgather is."""
    x = rng.randn(4, 3)
    assert np.array_equal(tmesh.gather_to_host(x), x)
    assert np.array_equal(tmesh.gather_to_host(torch.as_tensor(x),
                                               tiled=False), x[None])


def test_launch_takes_its_operands_device():
    """A kernel launch runs on its operands' device; operands that span
    devices raise before anything is launched or built."""
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert tkernels.operand_device((cpu, None, 3, cpu)) == cpu.device
    with pytest.raises(ValueError, match="one device"):
        tkernels.operand_device((cpu, meta, 3))
    with pytest.raises(ValueError, match="one device"):
        tkernels.launch("rescan3", cpu, meta, *([None] * 11),
                        *([0] * 5), 0.0)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("M", [1, 4])
def test_df3_candidates_matches_jax(jx, rng, M, tie):
    """``dfscan.df3_candidates`` vs the JAX scan (tile 32, the duplicate
    column): candidates equal, residuals rtol 1e-6; on the tied mixture
    the earlier of the two tied columns comes first."""
    args = _scan_inputs(rng, tie)
    want = jx.dfscan.df3_candidates(*map(jx.jnp.asarray, args), M=M,
                                    tile=32)
    got = tdfscan.df3_candidates(*map(torch.as_tensor, args), M=M, tile=32)
    _held_scan(got, want)
    if tie:
        assert np.all(got[0].numpy()[:, 0] == [5, 3])
        if M > 1:
            assert np.all(got[0].numpy()[:, 1] == [5, 17])


@pytest.mark.parametrize("nd,na", SHAPES)
def test_sharded_df3_candidates_matches_jax(jx, rng, nd, na):
    """The atoms-axis split scan on a (n_data, n_atoms) mesh vs the JAX
    ``sharded_df3_candidates`` on the 8 virtual devices and vs the port's
    one-device scan, top-1 and top-4, with the duplicate column."""
    args = _scan_inputs(rng)
    jm = jx.pmesh.build_mesh(n_data=nd, n_atoms=na)
    tm = tmesh.build_mesh(nd, na, devices=CPU8)
    for M in (1, 4):
        ja = list(map(jx.jnp.asarray, args))
        want = jx.pmesh.sharded_df3_candidates(
            jm, ja[0], jx.pmesh.shard_atoms(jm, ja[1]), ja[2], ja[3], M=M,
            tile=32)
        ta = list(map(torch.as_tensor, args))
        got = tmesh.sharded_df3_candidates(tm, *ta, M=M, tile=32)
        _held_scan(got, want)
        one = tdfscan.df3_candidates(*ta, M=M, tile=32)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


# ---------------------------------------------------------------------------
# fits on a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wl(jx):
    """tests/test_sharding.py's 8-voxel workload (32 atoms) with the
    port's interpolator on the JAX tables."""
    w = jx.testing.make_fit_workload(num_atom=32, n_vox=8, n_shells=3,
                                     dirs_per_shell=12, n_b0=4)
    w["tms"] = tinterp.MultiShellInterp.from_numpy(w["msinterp"])
    return w


def _fast(wl, mesh, batch):
    _x, ys, _c = wl["tms"].device_tables("cpu", torch.float32)
    return tfit.run_bucket_fast(wl["tms"], wl["plan"], ys,
                                wl["peaks"].reshape(8, 6), wl["y"],
                                wl["sig_csf"], 2, True, batch=batch,
                                mesh=mesh)


def _same(got, ref):
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_run_bucket_fast_mesh_matches_serial_and_jax(jx, wl):
    """run_bucket_fast on a (4, 2) mesh (the atoms-axis scan) and on an
    (8, 1) mesh (one 1-voxel chunk a slot) equals the serial port fit bit
    for bit and the JAX fit on the (4, 2) mesh: ids equal, weights and
    R^2 to rtol 1e-6, objectives (about 0 on these noiseless voxels)
    within 2e-9 max||y||^2, the tolerance of tests/test_torch_fit.py."""
    ref = _fast(wl, None, 8)
    got = _fast(wl, tmesh.build_mesh(4, 2, devices=CPU8), 8)
    _same(got, ref)
    _same(_fast(wl, tmesh.build_mesh(8, 1, devices=CPU8), 1),
          _fast(wl, None, 1))
    _x, ys2, _c = wl["msinterp"].device_tables()
    want = jx.fit.run_bucket_fast(
        wl["msinterp"], wl["plan"], ys2, wl["peaks"].reshape(8, 6),
        wl["y"], wl["sig_csf"], 2, True, batch=8,
        mesh=jx.pmesh.build_mesh(n_data=4, n_atoms=2),
        device_finalize=True)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[1][:, :2], wl["gt_ids"])
    for k in (0, 4):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9)
    ysq = np.sum(wl["y"] ** 2, axis=1)
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=2e-9 * ysq.max())


def test_overflow_tiers_under_mesh(rng, monkeypatch):
    """Duplicated atoms at R = 8 (tests/test_torch_fit.py's overflow
    case): on a (2, 1) mesh the voxels overflow R, then 2R, and end on the
    R = N tier, each tier's batches dealt to the two slots, with the
    serial fit's results bit for bit."""
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=8))
    sch = ttesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, _, _ = ttesting.make_dictionary(sch, num_atom=6)
    sig = np.tile(sig, (1, 12))                       # 72 cols, 12x each
    ms = tinterp.init_PGSE_multishell_interp(sig, sch,
                                             np.array([0.0, 0.0, 1.0]))
    plan = tinterp.plan_target_scheme(ms, sch)
    n = 6
    peaks = rng.randn(n, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    csf = np.exp(-sch[:, 6] / 2.0) * np.exp(
        -b_values(sch) * 3.0e-9)
    y = np.broadcast_to(300 * (0.6 * sig[:, 2][None] + 0.4 * csf[None]),
                        (n, sch.shape[0])).copy()
    budgets = []
    orig = tf32scan.df3_twopass

    def spy(*a, **k):
        budgets.append(k["R"])
        return orig(*a, **k)

    monkeypatch.setattr(tf32scan, "df3_twopass", spy)
    _x, ys, _c = ms.device_tables("cpu", torch.float32)
    run = lambda mesh: tfit.run_bucket_fast(
        ms, plan, ys, peaks.reshape(n, 6), y, csf, 2, True, batch=2,
        mesh=mesh)
    ref = run(None)
    n_serial = len(budgets)
    got = run(tmesh.build_mesh(2, 1, devices=["cpu"] * 2))
    assert {8, 16, 72} <= set(budgets[n_serial:])
    assert budgets[n_serial:] == budgets[:n_serial]
    _same(got, ref)


def _fit_inputs():
    """tests/test_sharding.py's MFModel.fit volume: 8 voxels of two
    planted fascicles + CSF on the 32-atom dictionary."""
    rng = np.random.RandomState(141414)
    sch = ttesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, dp, _ = ttesting.make_dictionary(sch, num_atom=32)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0.0, 0.0, 1.0]),
           "num_atom": 32, "num_ear": 0,
           "fasc_propnames": ["dpar"], "dpar": dp,
           "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
           "T2_ear": 2.0, "DIFF_ear": np.array([1.5e-9])}
    sh = (8, 1, 1)
    peaks = rng.randn(*sh, 6)
    peaks[..., :3] /= np.linalg.norm(peaks[..., :3], axis=-1, keepdims=True)
    peaks[..., 3:] /= np.linalg.norm(peaks[..., 3:], axis=-1, keepdims=True)
    TE, b = sch[:, 6], b_values(sch)
    csf = np.exp(-TE / 2.0) * np.exp(-b * 3.0e-9)
    data = np.zeros(sh + (sch.shape[0],))
    for v in range(8):
        data[np.unravel_index(v, sh)] = (
            0.6 * sig[:, v % 32] + 0.3 * sig[:, (5 * v) % 32]
            + 0.4 * csf) * 300.0
    return dic, data, np.ones(sh), peaks


def test_model_fit_mesh_shape_matches_serial_and_jax(jx):
    """MFModel.fit(parallel=True, mesh_shape=(4, 2), device="cpu") equals
    the serial port fit bit for bit, and the JAX fit on the same mesh by
    tests/test_torch_fit.py's rule (the port's float32 double-float
    finalize against the JAX package's float64 one): ids and the
    properties they select equal, fractions and M0 to rtol 1e-5 (and
    fractions within 1e-6: one voxel's second fascicle holds 0.4% of
    it), MSE to rtol 1e-6 or within 1e-9 max||y||^2 / S (these mixtures
    of unrotated atoms leave a residual), R^2 within 1e-6. It says so at
    verbose 2 as the JAX package does."""
    dic, data, mask, peaks = _fit_inputs()
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1)
    model = mft.MFModel(dict(dic), device="cpu")
    ser = model.fit(data, mask, 2, verbose=0, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        par = model.fit(data, mask, 2, verbose=2, parallel=True,
                        mesh_shape=(4, 2), batch_size=8, **kw)
    assert ("Starting estimation in 8 voxel(s) in device-parallel (8 "
            "devices) mode." in out.getvalue())
    want = jx.MFModel(dict(dic)).fit(data, mask, 2, verbose=0,
                                     parallel=True, mesh_shape=(4, 2),
                                     batch_size=8, **kw)
    assert par.param_names == ser.param_names == want.param_names
    S = dic["sch_mat"].shape[0]
    ysq_max = np.max(np.sum(data ** 2, axis=-1))
    for p in par.param_names:
        a, b = getattr(par, p), getattr(want, p)
        assert np.array_equal(a, getattr(ser, p)), p
        if p.startswith("peak") or p.endswith(("_f0", "_f1")) and \
                not p.startswith("frac"):
            assert np.array_equal(a, b), p              # IDs -> properties
        elif p == "MSE":
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-9 * ysq_max / S)
        elif p == "R2":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=p,
                                       atol=1e-6 if "frac" in p else 0)


def test_general_path_under_mesh(wl):
    """The general path on a (4, 2) mesh (its data rows; it has no atoms
    scan): run_bucket with and without the host refine, on a bucket of
    one fascicle and one of two fascicles + CSF + EAR in chunks of 2,
    equals the serial run bit for bit; so does MFModel.fit with
    engine="xla"."""
    tms, plan = wl["tms"], wl["plan"]
    tables = tms.device_tables("cpu", torch.float32)
    plan_t = tfit.plan_tensors(plan, torch.float32, "cpu")
    S = wl["y"].shape[1]
    sig_ear = np.abs(np.random.RandomState(7).randn(S, 3)) + 0.05
    mesh = tmesh.build_mesh(4, 2, devices=CPU8)
    for K, csf, ear in ((1, False, False), (2, True, True)):
        for refine in (True, False):
            run = lambda m: tfit.run_bucket(
                tables, plan_t, wl["peaks"][:, :K].reshape(8, 3 * K),
                wl["y"], wl["sig_csf"], sig_ear, K, csf, ear, batch=2,
                refine=refine, ms_host=tms, plan_host=plan, topm=4, mesh=m)
            _same(run(mesh), run(None))
    dic, data, mask, peaks = _fit_inputs()
    model = mft.MFModel(dict(dic), device="cpu")
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1,
              verbose=0, engine="xla", batch_size=4)
    ser = model.fit(data, mask, 2, **kw)
    par = model.fit(data, mask, 2, parallel=True, mesh_shape=(2, 1), **kw)
    for p in ser.param_names:
        assert np.array_equal(getattr(par, p), getattr(ser, p)), p


# ---------------------------------------------------------------------------
# two processes (gloo on localhost)
# ---------------------------------------------------------------------------

def _mh_workload():
    """tests/test_multihost.py's workload: 16 atoms, 8 voxels, float64."""
    return ttesting.make_fit_workload(num_atom=16, n_vox=8, n_shells=3,
                                      dirs_per_shell=8, n_b0=4)


def _mh_fit_step(wl, peaks, y):
    """The general fit step of the 2-fascicle + CSF bucket, float64."""
    ms, plan = wl["msinterp"], wl["plan"]
    xs, ys, cnt = ms.device_tables("cpu", torch.float64)
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    out = tfit.fit_step(xs, ys, cnt,
                        *tfit.plan_tensors(plan, torch.float64, "cpu"),
                        f64(peaks), f64(y), f64(wl["sig_csf"]),
                        torch.zeros(y.shape[1], 1, dtype=torch.float64),
                        K=2, csf_on=True, ear_on=False)
    return {k: out[k].numpy() for k in ("w", "ind", "mse")}


def _mh_fast(wl, peaks, y, mesh):
    ms = wl["msinterp"]
    _x, ys, _c = ms.device_tables("cpu", torch.float32)
    return tfit.run_bucket_fast(ms, wl["plan"], ys, peaks.reshape(-1, 6), y,
                                wl["sig_csf"], 2, True, batch=2, mesh=mesh)


def _worker(pid, nproc, port, out_path):
    """One process of the two-process fit: its half of the voxels on a
    local mesh of two CPU slots, through the general fit step (a piece a
    slot) and run_bucket_fast; the results gathered to every process,
    written by process 0."""
    pid, nproc = int(pid), int(nproc)
    devices = tmesh.init_distributed("localhost:%s" % port, nproc, pid,
                                     backend="gloo")
    assert torch.distributed.get_world_size() == nproc
    assert devices == [torch.device("cpu")]
    mesh = tmesh.build_mesh(2, 1, devices=devices * 2)
    wl = _mh_workload()
    per = wl["y"].shape[0] // nproc
    sl = slice(pid * per, (pid + 1) * per)
    pk_p = tmesh.host_local_to_global(mesh, wl["peaks"][sl])
    y_p = tmesh.host_local_to_global(mesh, wl["y"][sl])
    steps = [_mh_fit_step(wl, pk_p[j][0].numpy(), y_p[j][0].numpy())
             for j in range(2)]
    fast = _mh_fast(wl, wl["peaks"][sl], wl["y"][sl], mesh)
    got = {k: tmesh.gather_to_host(np.concatenate([s[k] for s in steps]))
           for k in ("w", "ind", "mse")}
    for k, v in zip(("fast_w", "fast_ind", "fast_obj"), fast[:3]):
        got[k] = tmesh.gather_to_host(v)
    if pid == 0:
        np.savez(out_path, **got)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("worker %d done" % pid)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_fit_matches_single(tmp_path):
    """Two processes joined by init_distributed (gloo, localhost), each
    fitting 4 of the 8 voxels on its own two-slot mesh: the results that
    gather_to_host hands process 0 equal the single-process fit bit for
    bit, for the general fit step (in the same pieces of 2 voxels) and for
    run_bucket_fast (chunks of 2). Each process is killed after
    WORKER_TIMEOUT s."""
    out = str(tmp_path / "mh.npz")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2",
         str(port), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("a worker of the two-process fit timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, "worker failed:\n%s" % log
    got = np.load(out)
    wl = _mh_workload()
    ref = [_mh_fit_step(wl, wl["peaks"][i:i + 2], wl["y"][i:i + 2])
           for i in range(0, 8, 2)]
    for k in ("w", "ind", "mse"):
        assert np.array_equal(got[k], np.concatenate([r[k] for r in ref])), k
    fast = _mh_fast(wl, wl["peaks"], wl["y"], None)
    for k, v in zip(("fast_w", "fast_ind", "fast_obj"), fast[:3]):
        assert np.array_equal(got[k], v), k
    assert np.array_equal(got["fast_ind"][:, :2], wl["gt_ids"])


if __name__ == "__main__":
    _worker(*sys.argv[1:])
