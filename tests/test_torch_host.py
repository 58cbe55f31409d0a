"""PyTorch port vs the JAX package: host modules, interpolation tables,
the grouped rotation, the double-float primitives, isolation from JAX and
the kernel dispatch rules.

Inputs are float32 arrays made with a seeded numpy RandomState and handed
to both packages (the suite runs JAX with x64 on)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu import testing as jtesting
from microstructure_fingerprinting_tpu.ops import df32 as jdf32
from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan
from microstructure_fingerprinting_tpu.ops import interp as jinterp
from microstructure_fingerprinting_tpu.utils import nifti as jnifti
from microstructure_fingerprinting_tpu.utils import scheme as jscheme

from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import df32 as tdf32
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.ops import prep as tprep
from microstructure_fingerprinting_torch.ops import rescan as trescan
from microstructure_fingerprinting_torch.utils import checks as tchecks
from microstructure_fingerprinting_torch.utils import io as tio
from microstructure_fingerprinting_torch.utils import nifti as tnifti
from microstructure_fingerprinting_torch.utils import scheme as tscheme

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if torch.is_tensor(b)
                          else np.asarray(b))


def _dense(num_atom=20):
    sch = jtesting.make_dense_scheme(n_shells=3, dirs_per_shell=16, n_b0=4)
    sig, _, _ = jtesting.make_dictionary(sch, num_atom=num_atom)
    return sch, sig


# ---------------------------------------------------------------------------
# host modules (identical outputs)
# ---------------------------------------------------------------------------

def test_testing_generators_identical():
    sch_j = jtesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sch_t = ttesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    assert np.array_equal(sch_j, sch_t)
    for a, b in zip(jtesting.make_dictionary(sch_j, 30),
                    ttesting.make_dictionary(sch_t, 30)):
        assert np.array_equal(a, b)


def test_scheme_and_checks_identical(rng):
    sch, _sig = _dense()
    assert np.array_equal(jscheme.b_values(sch), tscheme.b_values(sch))
    assert np.array_equal(jscheme.import_PGSE_scheme(sch),
                          tscheme.import_PGSE_scheme(sch))
    b = jscheme.b_values(sch)
    bvecs = sch[:, :3].T
    pj = jscheme.get_PGSE_scheme_from_bval_bvec_dense(sch, b / 1e6, bvecs)
    pt = tscheme.get_PGSE_scheme_from_bval_bvec_dense(sch, b / 1e6, bvecs)
    assert np.array_equal(pj, pt)
    y = rng.randn(5, 7)
    y[2, 3] = np.nan
    assert np.array_equal(tchecks.check_finite_signals(y), [0, 0, 1, 0, 0])


def test_io_and_nifti_cross_package(tmp_path, rng):
    d = {"dictionary": rng.rand(6, 4), "num_atom": 4,
         "fasc_propnames": ["rad"]}
    tio.savemat(str(tmp_path / "d.mat"), d)
    got = tio.loadmat(str(tmp_path / "d.mat"))
    assert np.array_equal(got["dictionary"], d["dictionary"])
    vol = rng.rand(3, 2, 2, 5)
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    path = str(tmp_path / "v.nii.gz")
    jnifti.save(jnifti.Nifti1Image(vol, aff), path)   # written by JAX pkg
    img = tnifti.load(path)                           # read by the port
    assert np.array_equal(img.get_fdata(), vol)
    assert np.array_equal(img.affine, aff)


def test_interp_tables_bitwise():
    sch, sig = _dense()
    ordir = np.array([0.0, 0.0, 1.0])
    mj = jinterp.init_PGSE_multishell_interp(sig, sch, ordir)
    mt = tinterp.init_PGSE_multishell_interp(sig, sch, ordir)
    for f in ("scheme_DeldelTE", "Gms_un", "xs", "ys", "cnt"):
        assert np.array_equal(getattr(mj, f), getattr(mt, f)), f
    assert mj.num_subs == mt.num_subs
    pj, pt = (m.plan_target_scheme(ms, sch)
              for m, ms in ((jinterp, mj), (tinterp, mt)))
    for f in ("gdir", "shell_lo", "shell_hi", "wG"):
        assert np.array_equal(getattr(pj, f), getattr(pt, f)), f


def test_interp_state_carried_across(tmp_path):
    """A JAX-saved .npz and the JAX object's fields both load into the
    port with bitwise-equal tables."""
    sch, sig = _dense()
    mj = jinterp.init_PGSE_multishell_interp(sig, sch,
                                             np.array([0.0, 0.0, 1.0]))
    path = mj.save(str(tmp_path / "tables.npz"))
    for mt in (tinterp.MultiShellInterp.load(path),
               tinterp.MultiShellInterp.from_numpy(mj)):
        for f in ("scheme_DeldelTE", "Gms_un", "xs", "ys", "cnt"):
            assert np.array_equal(getattr(mj, f), getattr(mt, f)), f
        assert mt.num_subs == mj.num_subs


def test_grouped_rotation_matches_jax(rng):
    """Rotated dictionary and sequence permutation vs the JAX grouped
    rotation on float32 tables: perm equal, D to rtol 1e-6 plus an
    absolute 1e-6 (= ~8 ulp of the unit-scale signals). The lerp-weight
    matmul sums its few nonzero products in another order; where the lerp
    cancels to ~1e-15 the error stays relative to the O(1) operands."""
    sch, sig = _dense(num_atom=24)
    mj = jinterp.init_PGSE_multishell_interp(sig, sch,
                                             np.array([0.0, 0.0, 1.0]))
    plan = jinterp.plan_target_scheme(mj, sch)
    newdirs = rng.randn(5, 2, 3)
    newdirs = np.float32(newdirs / np.linalg.norm(newdirs, axis=2,
                                                  keepdims=True))
    rj, perm_j = jinterp.make_grouped_rotation_paired(mj, plan)
    Dj = np.asarray(rj(jnp.asarray(mj.ys, jnp.float32), jnp.asarray(newdirs)))
    mt = tinterp.MultiShellInterp.from_numpy(mj)
    rt, perm_t = tinterp.make_grouped_rotation_paired(mt, plan)
    _x, ys, _c = mt.device_tables("cpu", torch.float32)
    Dt = rt(ys, _t(newdirs)).numpy()
    assert np.array_equal(perm_j, perm_t)
    assert Dt.dtype == np.float32 and Dt.shape == Dj.shape
    np.testing.assert_allclose(Dt, Dj, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# double-float primitives (bitwise on float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "split",
                                  "two_prod", "df_add", "df_mul",
                                  "mul_ps"])
def test_df32_bitwise(rng, name):
    a = np.float32(rng.randn(512) * 100)
    b = np.float32(rng.randn(512))
    c = np.float32(rng.randn(512) * 1e-6)
    if name == "split":
        args = (a,)
    elif name in ("df_add", "df_mul"):
        args = ((a, c), (b, c * 1e-3))
    elif name == "mul_ps":
        args = (jdf32.presplit((jnp.asarray(a), jnp.asarray(c))),
                jdf32.presplit((jnp.asarray(b), jnp.asarray(c))))
        args = tuple(tuple(np.asarray(v) for v in x) for x in args)
    else:
        args = (a, b)

    def conv(x, f):
        return tuple(f(v) for v in x) if isinstance(x, tuple) else f(x)

    rj = getattr(jdf32, name)(*[conv(x, jnp.asarray) for x in args])
    rt = getattr(tdf32, name)(*[conv(x, _t) for x in args])
    assert all(_same(x, y) for x, y in zip(rj, rt))


@pytest.mark.parametrize("name", ["quantize2", "quantize3"])
def test_quantize_bitwise(rng, name):
    X = np.float32((rng.rand(40, 30) * 2 - 1) * 0.99)
    rj = getattr(jdfscan, name)(jnp.asarray(X))
    rt = getattr(tdfscan, name)(_t(X))
    assert all(_same(x, y) for x, y in zip(rj, rt))


def test_df_gram_matches_jax(rng):
    """hi bitwise where the two float32 cross-product sums round alike;
    the port sums them in float64 (order-independent), the JAX package in
    float32, so hi may differ by 1 ulp and hi + lo agrees to 1e-10, the
    Gram's design accuracy (tests/test_dfscan.py::test_df_gram_accuracy);
    the float32 sums of the ~1e-3-sized cross terms carry ~1e-11."""
    B, S, N = 2, 60, 32
    A = np.float32(rng.randn(B, S, N) / np.sqrt(S))
    Bm = np.float32(rng.randn(B, S, N) / np.sqrt(S))
    hj, lj = jdfscan.df_gram(jdfscan.quantize2(jnp.asarray(A)),
                             jdfscan.quantize2(jnp.asarray(Bm)),
                             "bst,bsn->btn")
    ht, lt = tdfscan.df_gram(tdfscan.quantize2(_t(A)),
                             tdfscan.quantize2(_t(Bm)), "bst,bsn->btn")
    hj, lj = np.asarray(hj, np.float64), np.asarray(lj, np.float64)
    ht, lt = ht.double().numpy(), lt.double().numpy()
    assert np.mean(hj == ht) > 0.99
    np.testing.assert_allclose(ht + lt, hj + lj, rtol=0, atol=1e-10)
    want = np.einsum("bst,bsn->btn", A.astype(np.float64),
                     Bm.astype(np.float64))
    assert np.max(np.abs(ht + lt - want)) < 1e-10
    ht2, lt2 = tdfscan.df_gram_tile(tdfscan.quantize2(_t(A)),
                                    tdfscan.quantize2(_t(Bm)), N)
    assert torch.equal(ht2, torch.from_numpy(ht).float())


# ---------------------------------------------------------------------------
# isolation and dispatch
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """The package imports and synthesizes a workload with jax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import microstructure_fingerprinting_torch as m\n"
        "wl = m.testing.make_fit_workload(num_atom=16, n_vox=4, n_shells=2,"
        " dirs_per_shell=8, n_b0=2)\n"
        "assert wl['y'].shape == (4, 18), wl['y'].shape\n"
        "bad = [k for k in sys.modules if k.startswith("
        "'microstructure_fingerprinting_tpu') or k.startswith('jax')]\n"
        "assert not [k for k in bad if sys.modules[k] is not None], bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def _small_scan_inputs(rng, B=2, S=24, N1=40, N2=36):
    A1 = _t(np.float32(np.abs(rng.randn(B, S, N1)) + 0.05))
    A2 = _t(np.float32(np.abs(rng.randn(B, S, N2)) + 0.05))
    a3 = _t(np.float32(np.abs(rng.randn(B, S, 1)) + 0.05))
    y = _t(np.float32(np.abs(rng.randn(B, S))))
    return A1, A2, a3, y


def test_cpu_tensors_run_the_twins(rng):
    """CPU tensors take the plain versions: no kernel is launched."""
    kernels.reset_counts()
    A1, A2, a3, y = _small_scan_inputs(rng)
    tf32scan.rowmin_3(A1, A2, a3, y, colmin=True)     # prep + row pass
    trescan.row_scan_df3(A1, A2, a3, y)               # re-scan
    tf32scan.df3_twopass(A1, A2, a3, y, R=8)
    a4 = _t(np.float32(np.abs(rng.randn(2, 24, 3)) + 0.05))
    tf32scan.rowmin_4(A1, A2, a3, a4, y, colmin=True)  # prep + EAR row pass
    trescan.row_scan_df4(A1, A2, a3, a4, y)            # EAR re-scan
    tf32scan.df4_twopass(A1, A2, a3, a4, y, R=8)
    tdfscan.df2_candidates(A1, A2, y, M=1)             # df2 scan
    tdfscan.df_nnls_cols(torch.cat([A1[:, :, :2], a3], 2), y)  # finalize
    assert kernels.LAUNCHES == {"prep_block": 0, "rowmin3": 0,
                                "rescan3": 0, "rowmin4": 0, "rescan4": 0,
                                "df2scan": 0, "finalize": 0, "df4hoist": 0,
                                "df2hoist": 0, "df3hoist": 0,
                                "row4hoist": 0, "row3hoist": 0,
                                "rhsprep": 0}


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_entry_point_takes_its_signature(name):
    """Each C entry point of ``csrc/`` takes the arguments that
    ``kernels.launch`` passes it: a pointer, int or float for each kind of
    its signature, in order, then the stream (ctypes would pass a
    mismatch silently)."""
    import re
    cname, kinds = kernels._SIGNATURES[name]
    decl = None
    for src in kernels.SOURCES:
        with open(os.path.join(kernels._CSRC, src)) as f:
            m = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % cname,
                          f.read(), re.S)
        if m:
            decl = m.group(1)
    assert decl is not None, cname
    params = [p.strip() for p in decl.split(",")]
    assert params[-1].startswith("cudaStream_t")
    got = "".join("p" if "*" in p else "i" if p.startswith("int ")
                  else "f" if p.startswith("float ") else "?"
                  for p in params[:-1])
    assert got == kinds, (cname, got, kinds)


def test_kernel_library_reused_when_built(monkeypatch, tmp_path):
    """A library built from the same sources and flags is reused: no
    compiler is asked for."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "USER_BUILD_DIR", str(tmp_path))
    lib = tmp_path / ("libmfkernels-%s.so" % kernels._source_key())
    lib.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc asked for although the library exists")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    assert kernels.build() == str(lib)
    assert kernels._source_key() == kernels._source_key()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-g",))
    assert not os.path.exists(os.path.join(
        tmp_path, "libmfkernels-%s.so" % kernels._source_key()))


def test_kernel_build_failure_raises_and_leaves_nothing(monkeypatch,
                                                         tmp_path):
    """A failed compile raises and leaves neither a library nor its
    temporary file behind."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "USER_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert os.listdir(tmp_path) == []


def _stub_nvcc(tmp_path):
    """An ``nvcc`` that writes an empty file where ``-o`` points."""
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    stub.chmod(0o755)
    return str(stub)


@pytest.mark.parametrize("how", ["read-only", "not-a-directory"])
def test_kernel_build_falls_to_user_cache(monkeypatch, tmp_path, how):
    """Where ``build/`` of the checkout cannot be written (a read-only
    tree: an installed package) or cannot be created (its parent is
    taken by a file), the library is built into the per-user cache
    directory and reused from there; a writable checkout keeps it."""
    tree = tmp_path / "site-packages"
    tree.mkdir()
    if how == "read-only":
        (tree / "build").mkdir()
        (tree / "build").chmod(0o555)
        tree.chmod(0o555)
        if os.access(str(tree / "build"), os.W_OK):
            # permission bits do not bind this user (root): take the
            # directory's place with a file instead
            tree.chmod(0o755)
            (tree / "build").chmod(0o755)
            (tree / "build").rmdir()
            (tree / "build").write_text("")
    else:
        (tree / "build").write_text("")
    user = tmp_path / "home" / ".cache" / "kernels"
    monkeypatch.setattr(kernels, "BUILD_DIR",
                        str(tree / "build" / "mf_torch_kernels"))
    monkeypatch.setattr(kernels, "USER_BUILD_DIR", str(user))
    monkeypatch.setattr(kernels, "_nvcc", lambda: _stub_nvcc(tmp_path))
    try:
        out = kernels.build()
        assert os.path.dirname(out) == str(user) and os.path.exists(out)
        assert os.listdir(user) == [os.path.basename(out)]
        assert kernels.BUILD_INFO["cached"] is False
        assert kernels.build() == out and kernels.BUILD_INFO["cached"]
    finally:
        tree.chmod(0o755)
    # a checkout that can be written keeps its own build directory
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build" / "k"))
    monkeypatch.setattr(kernels, "USER_BUILD_DIR", str(tmp_path / "unused"))
    assert os.path.dirname(kernels.build()) == str(tmp_path / "build" / "k")
    assert not (tmp_path / "unused").exists()


@pytest.mark.cuda
def test_cuda_inputs_raise_without_library(rng, monkeypatch, tmp_path):
    """On a card, a wrapper whose kernel library cannot be built raises
    instead of running its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "USER_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/nonexistent/nvcc")
    A1, A2, a3, y = (x.cuda() for x in _small_scan_inputs(rng))
    A1p, _ = tprep.pad_block(A1, 128)
    rq, rr, ra, _ = tprep.pack_rhs([y, a3[:, :, 0]])
    before = kernels.LAUNCHES["prep_block"]
    with pytest.raises((RuntimeError, OSError)):
        tprep.prep_block(A1p.contiguous(), rq, rr, ra, 128, "xr", n_rhs=2)
    assert kernels.LAUNCHES["prep_block"] == before
