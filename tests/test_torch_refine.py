"""The port's float64 host refine (``models/refine.py``) and its native
helper (``utils/native.py``, ``csrc/mf_native.cpp``) vs the JAX package
on the CPU.

The refine is float64 NumPy on the host in both packages, over the same
closed-form solvers and the same native source, so it is held tightly:
ids exact, weights and objectives to rtol 1e-12. The native kernels are
held against the NumPy path (the same numbers up to rounding), and their
build against the rules of the kernel library's: reuse, a per-user
cache where ``build/`` cannot be written, NumPy without a compiler.
"""

import os

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_tpu.models import fit as jfit
from microstructure_fingerprinting_tpu.models import refine as jrefine
from microstructure_fingerprinting_tpu.ops import interp as jinterp

from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.models import refine as trefine
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.parallel import mesh as tmesh
from microstructure_fingerprinting_torch.utils import native
from microstructure_fingerprinting_torch.utils.scheme import b_values

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the general path's buckets: (K, csf, ear)
BUCKETS = [(1, False, False), (1, False, True), (2, False, True),
           (2, True, True)]


@pytest.fixture(scope="module")
def wl():
    """A 40-atom workload (3 shells x 12 directions + 4 b0, 8 voxels),
    both packages' interpolators and a 17-atom EAR block."""
    w = ttesting.make_fit_workload(num_atom=40, n_vox=8, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    ms = jinterp.init_PGSE_multishell_interp(
        w["dictionary"], w["sch_mat"], np.array([0.0, 0.0, 1.0]))
    w["jms"], w["jplan"] = ms, jinterp.plan_target_scheme(ms, w["sch_mat"])
    w["tms"] = tinterp.MultiShellInterp.from_numpy(ms)
    sch = w["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    w["sig_ear"] = (np.exp(-TE / 0.8)[:, None]
                    * np.exp(-b[:, None] * np.linspace(0.8e-9, 2.6e-9, 17)))
    return w


def _pool(wl, K, csf, ear, M=16):
    """Noisy voxels of bucket (K, csf, ear) and the JAX float32 scan's
    top-M candidates for them (the pool the refine gets on the card)."""
    mix = ttesting.make_mixed(wl, [(8, K, csf)],
                              wl["sig_ear"] if ear else None, ear_atom=0,
                              ear_amp=60.0)
    y = mix["y"] + 2.0 * np.random.RandomState(5).randn(*mix["y"].shape)
    ms, plan = wl["jms"], wl["jplan"]
    S = y.shape[1]
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    cand = np.asarray(jfit.fit_step_candidates(
        f32(ms.xs), f32(ms.ys), jnp.asarray(ms.cnt), f32(plan.gdir),
        jnp.asarray(plan.shell_lo), jnp.asarray(plan.shell_hi), f32(plan.wG),
        f32(mix["peaks"][:, :3 * K].reshape(8, K, 3)), f32(y),
        f32(wl["sig_csf"] if csf else np.zeros(S)),
        f32(wl["sig_ear"] if ear else np.zeros((S, 1))),
        K=K, csf_on=csf, ear_on=ear, M=M))
    args = (mix["peaks"][:, :3 * K].reshape(8, K, 3), y,
            wl["sig_csf"] if csf else None, wl["sig_ear"] if ear else None,
            cand, K, csf, ear)
    return args, mix


@pytest.mark.parametrize("K,csf,ear", BUCKETS)
def test_refine_candidates_match_jax(wl, K, csf, ear):
    """``refine_candidates`` on the same top-16 pool: the winner's ids
    exactly, weights, objectives and reconstructed signals to rtol 1e-12
    of the JAX package's (the EAR atom re-enumerated in float64)."""
    args, _mix = _pool(wl, K, csf, ear)
    ref = jrefine.refine_candidates(wl["jms"], wl["jplan"], *args)
    got = trefine.refine_candidates(wl["tms"], wl["jplan"], *args)
    assert got[1].dtype == np.int32 and got[1].shape == (8, K + csf + ear)
    assert np.array_equal(got[1], ref[1])
    for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_solve_support_matches_jax(C):
    """``_solve_support`` (C columns a candidate) and
    ``_solve_support_ear`` (C - 1 columns and a 5-atom EAR block
    enumerated) equal the JAX package's bit for bit on random columns."""
    rng = np.random.RandomState(C)
    cols = rng.randn(C, 4, 6, 30)
    y = rng.randn(4, 30)
    with np.errstate(all="ignore"):
        for a, b in zip(trefine._solve_support(cols, y),
                        jrefine._solve_support(cols, y)):
            assert np.array_equal(a, b)
        if C < 4:
            ear = np.abs(rng.randn(30, 5))
            for a, b in zip(trefine._solve_support_ear(cols, y, ear),
                            jrefine._solve_support_ear(cols, y, ear)):
                assert np.array_equal(a, b)


def test_native_equals_numpy(wl):
    """The native kernels equal the NumPy path up to rounding: rotated
    candidate columns (the blend (1 - w) lo + w hi against lo + w (hi -
    lo)) and candidate Grams (another summation order)."""
    assert native.available()
    rng = np.random.RandomState(11)
    newdir = rng.randn(8, 3)
    newdir /= np.linalg.norm(newdir, axis=1, keepdims=True)
    ids = rng.randint(0, 40, size=(8, 6)).astype(np.int32)
    got = trefine.interp_columns(wl["tms"], wl["jplan"], newdir, ids)
    ref = trefine.interp_columns_np(wl["tms"], wl["jplan"], newdir,
                                    ids).transpose(0, 2, 1)
    assert got.shape == (8, 6, 40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)
    cols = np.stack([got, got[:, ::-1]])
    y = rng.randn(8, 40)
    G, Y = native.candidate_grams_f64(cols, y)
    np.testing.assert_allclose(
        G, np.einsum("ibms,jbms->ijbm", cols, cols), rtol=1e-13)
    np.testing.assert_allclose(Y, np.einsum("ibms,bs->ibm", cols, y),
                               rtol=1e-13, atol=1e-13)


def test_refine_numpy_path_matches_native(wl, monkeypatch):
    """Without the native kernels the refine takes its NumPy path and
    picks the same winners: ids equal, objectives within 1e-12 ||y||^2,
    weights to rtol 1e-8 (the CSF and EAR columns of this scheme are
    nearly collinear)."""
    args, _mix = _pool(wl, 2, True, True)
    fast = trefine.refine_candidates(wl["tms"], wl["jplan"], *args)
    monkeypatch.setattr(native, "available", lambda: False)
    slow = trefine.refine_candidates(wl["tms"], wl["jplan"], *args)
    ysq = np.sum(args[1] ** 2, axis=1)
    assert np.array_equal(slow[1], fast[1])
    assert np.all(np.abs(slow[2] - fast[2]) <= 1e-12 * ysq)
    np.testing.assert_allclose(slow[0], fast[0], rtol=1e-8, atol=0)


def test_native_source_is_the_jax_packages():
    """The port's ``csrc/mf_native.cpp`` is its own copy of the JAX
    package's ``native/mf_native.cpp``: the code below the header
    comment is the same."""
    def code(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert code(os.path.join(REPO, "microstructure_fingerprinting_torch",
                             "csrc", "mf_native.cpp")) == code(os.path.join(
        REPO, "microstructure_fingerprinting_tpu", "native", "mf_native.cpp"))


def _fresh(monkeypatch, build_dir, user_dir):
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "USER_BUILD_DIR", str(user_dir))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)


@pytest.mark.parametrize("how", ["read-only", "not-a-directory"])
def test_native_build_falls_to_user_cache(monkeypatch, tmp_path, how):
    """Where ``build/`` cannot be written or created the helper is
    compiled into the per-user cache directory, loaded, and reused from
    there by a later load without a compiler; a writable checkout keeps
    its own."""
    tree = tmp_path / "site-packages"
    tree.mkdir()
    (tree / "build").write_text("")             # the directory's place
    if how == "read-only":
        (tree / "build").unlink()
        (tree / "build").mkdir()
        (tree / "build").chmod(0o555)
        if os.access(str(tree / "build"), os.W_OK):
            # permission bits do not bind this user (root): take the
            # directory's place with a file instead
            (tree / "build").chmod(0o755)
            (tree / "build").rmdir()
            (tree / "build").write_text("")
    user = tmp_path / "home" / "native"
    _fresh(monkeypatch, tree / "build" / "mf_torch_native", user)
    try:
        assert native.available()
        assert os.listdir(user) == [native._so_name()]
        _fresh(monkeypatch, tree / "build" / "mf_torch_native", user)
        monkeypatch.setattr(native, "CXX_CMDS", (("false",),))
        assert native.available()                    # reused, not built
    finally:
        if (tree / "build").is_dir():
            (tree / "build").chmod(0o755)
    _fresh(monkeypatch, tmp_path / "build" / "n", tmp_path / "unused")
    monkeypatch.undo()
    _fresh(monkeypatch, tmp_path / "build" / "n", tmp_path / "unused")
    assert native.available()
    assert os.listdir(tmp_path / "build" / "n") == [native._so_name()]
    assert not (tmp_path / "unused").exists()


def test_native_without_compiler(monkeypatch, tmp_path):
    """No compile command works: ``available()`` is false (the refine
    then takes its NumPy path) and no file is left behind."""
    _fresh(monkeypatch, tmp_path / "build", tmp_path / "user")
    monkeypatch.setattr(native, "CXX_CMDS", (("false",), ("false", "-x")))
    assert not native.available()
    assert os.listdir(tmp_path / "build") == []


# ---------------------------------------------------------------------------
# the general path's re-score chunk by chunk (fit.run_bucket with refine)
# ---------------------------------------------------------------------------

def _bucket_call(wl, K, csf, ear, n, batch):
    """``run_bucket(..., refine=True)`` on ``n`` noisy voxels of bucket
    (K, csf, ear) in chunks of ``batch``, float32 scans on the CPU:
    (args, keywords)."""
    mix = ttesting.make_mixed(wl, [(n, K, csf)],
                              wl["sig_ear"] if ear else None, ear_atom=0,
                              ear_amp=60.0)
    y = mix["y"] + 2.0 * np.random.RandomState(5).randn(*mix["y"].shape)
    tables = wl["tms"].device_tables("cpu", torch.float32)
    plan = tfit.plan_tensors(wl["jplan"], torch.float32, "cpu")
    args = (tables, plan, mix["peaks"][:, :3 * K], y, wl["sig_csf"],
            wl["sig_ear"], K, csf, ear)
    return args, dict(batch=batch, refine=True, ms_host=wl["tms"],
                      plan_host=wl["jplan"], topm=16)


def _bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("n,batch", [(7, 3), (5, 8)],
                         ids=["not-a-multiple", "under-a-chunk"])
@pytest.mark.parametrize("K,csf,ear", [(2, True, False), (1, False, True),
                                       (2, True, True)])
def test_run_bucket_rescores_chunks_bitwise(wl, monkeypatch, K, csf, ear,
                                            n, batch, route):
    """``run_bucket(..., refine=True)``, which re-scores chunk by chunk in
    one reused column buffer, returns what ``refine_candidates`` on the
    whole bucket's candidates (the scan's, chunk by chunk), then
    ``_r2_np``, return, bit for bit: a bucket of 7 voxels in chunks of 3
    and one of 5 in a chunk of 8, on the native and the NumPy route."""
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    seen = []
    step = tfit.fit_step_candidates

    def spy(*a, **k):
        seen.append(step(*a, **k))
        return seen[-1]

    monkeypatch.setattr(tfit, "fit_step_candidates", spy)
    args, kw = _bucket_call(wl, K, csf, ear, n, batch)
    got = tfit.run_bucket(*args, **kw)
    assert len(seen) == -(-n // batch)
    cand = torch.cat(seen).numpy()[:n]
    y = args[3]
    w, ind, obj, y_rec = trefine.refine_candidates(
        wl["tms"], wl["jplan"], args[2].reshape(n, K, 3), y,
        wl["sig_csf"] if csf else None, wl["sig_ear"] if ear else None,
        cand, K, csf, ear)
    obj = np.maximum(obj, 0.0)
    _bitwise(got, (w, ind, obj, obj / y.shape[1], tfit._r2_np(y, y_rec)))


class _Event:
    def __init__(self, c, dst, src):
        self.c, self.dst, self.src, self.landed = c, dst, src, False


class _StandInPulls(tfit._Pulls):
    """The card's chunk copies on the CPU: chunk c's copy lands (its data
    reach the host buffer, left full of -1 until then) once ``lag`` more
    chunks have been copied after it, or when it is waited for; with
    ``lag`` None only then."""

    def __init__(self, lag):
        self.lag, self.events, self.waits = lag, [], []

    def host(self, shape, dtype, device):
        return torch.full(shape, -1, dtype=dtype)

    def copy(self, dst, src):
        self.events.append(_Event(len(self.events), dst, src.clone()))
        return self.events[-1]

    def _land(self, ev):
        if not ev.landed:
            ev.dst.copy_(ev.src)
            ev.landed = True

    def done(self, ev):
        if self.lag is not None and len(self.events) > ev.c + self.lag:
            self._land(ev)
        return ev.landed

    def wait(self, ev):
        self.waits.append(ev.c)
        self._land(ev)


@pytest.mark.parametrize("lag,rows", [(0, 1), (1, 1), (3, 1), (None, 1),
                                      (2, 2)])
def test_run_bucket_rescore_pipeline(wl, monkeypatch, lag, rows):
    """With a stand-in for the card's copies and events, ``run_bucket``
    re-scores each of its 8 chunks once, in chunk order, none before its
    copy has landed; the chunks whose copies land before the last chunk
    step is enqueued count as overlapped in ``fit.RESCORES``, the others
    as tail, and only those are waited for; every call writes the same
    (C0, batch, M, S) column buffer; the maps equal the plain serial
    run's bit for bit, also with the chunks dealt to a two-row CPU
    mesh."""
    args, kw = _bucket_call(wl, 2, True, False, 8, 1)
    want = tfit.run_bucket(*args, **kw)
    pulls = _StandInPulls(lag)
    monkeypatch.setattr(tfit, "_PULLS", pulls)
    calls = []
    refine = trefine.refine_candidates

    def spy(*a, cols=None, **k):
        c = int(np.flatnonzero((args[3] == a[3][0]).all(axis=1))[0])
        calls.append((c, pulls.events[c].landed, id(cols), cols.shape))
        return refine(*a, cols=cols, **k)

    monkeypatch.setattr(trefine, "refine_candidates", spy)
    mesh = tmesh.build_mesh(2, 1, devices=["cpu", "cpu"]) if rows == 2 \
        else None
    before = dict(tfit.RESCORES)
    got = tfit.run_bucket(*args, mesh=mesh, **kw)
    _bitwise(got, want)
    assert [c for c, *_ in calls] == list(range(8))
    assert all(landed for _c, landed, *_ in calls)
    assert len({i for *_, i, _s in calls}) == 1
    assert all(sh == (3, 1, 16, args[3].shape[1]) for *_, sh in calls)
    overlapped = 0 if lag is None else max(0, 7 - lag)
    assert {k: tfit.RESCORES[k] - before[k] for k in before} == {
        "overlapped": overlapped, "tail": 8 - overlapped}
    assert pulls.waits == list(range(overlapped, 8))
