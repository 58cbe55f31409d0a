"""The port's reference-compatible surface vs the JAX package on the CPU:
the ``mf_utils`` namespace, ``TripWire``, the single-problem solvers,
the reference rotation functions, the noise generators, the Monte-Carlo
average and its phase-file reader, the plotters and the profiling hooks.

The same inputs, drawn from seeded NumPy generators, go to both
packages, in float64. The host functions are the JAX package's NumPy
code and are held bit for bit (the solvers' ids, weights and
objectives, ``rotate_atom``, ``rotate_atom_2Dprotocol``, ``gen_SoS_MRI``);
the torch functions to 1e-12 of the result's scale (the rotations:
another summation order of |g . n|) or rtol 1e-12 (the Monte-Carlo
average: another order of the float64 sums). ``gen_sos_mri_torch``
cannot draw JAX's bits: it is held by its noiseless branch, shape,
seeded determinism and moments.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microstructure_fingerprinting_tpu import mf_utils as jmfu
from microstructure_fingerprinting_tpu import viz as jviz
from microstructure_fingerprinting_tpu.ops import interp as jinterp
from microstructure_fingerprinting_tpu.ops import mc as jmc
from microstructure_fingerprinting_tpu.ops import nnls as jnnls
from microstructure_fingerprinting_tpu.ops import noise as jnoise

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import mf_utils as tmfu
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch import viz as tviz
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import mc as tmc
from microstructure_fingerprinting_torch.ops import nnls as tnnls
from microstructure_fingerprinting_torch.ops import noise as tnoise
from microstructure_fingerprinting_torch.tripwire import (
    TripWire, TripWireError, is_tripwire)
from microstructure_fingerprinting_torch.utils import profiling
from microstructure_fingerprinting_torch.utils.scheme import (
    get_gyromagnetic_ratio)

torch.set_num_threads(2)


def _public(module):
    return {n for n in vars(module) if not n.startswith("_")}


def test_mf_utils_names():
    """Every name of the JAX package's mf_utils, from this package, with
    gen_sos_mri_torch where JAX has gen_sos_mri_jax."""
    want = (_public(jmfu) - {"gen_sos_mri_jax"}) | {"gen_sos_mri_torch"}
    assert _public(tmfu) == want
    for name in want:
        assert getattr(tmfu, name).__module__.startswith(
            "microstructure_fingerprinting_torch."), name
    assert mft.mf_utils is tmfu and mft.viz is tviz


@pytest.mark.parametrize("use", [lambda t: t.anything,
                                 lambda t: t(1, key=2)],
                         ids=["attribute", "call"])
def test_tripwire(use):
    """A TripWire raises TripWireError (an AttributeError) with its
    message on first use; is_tripwire tells it from anything else."""
    wire = TripWire("optional module missing")
    with pytest.raises(TripWireError, match="optional module missing"):
        use(wire)
    assert issubclass(TripWireError, AttributeError)
    assert is_tripwire(wire)
    assert not is_tripwire(np) and not is_tripwire(None)
    assert (mft.TripWire, mft.TripWireError, mft.is_tripwire) == (
        TripWire, TripWireError, is_tripwire)


# ---------------------------------------------------------------------------
# single-problem solvers
# ---------------------------------------------------------------------------

DICSIZES = {1: [7], 2: [6, 5], 3: [5, 4, 3], 4: [4, 3, 2, 3],
            5: [3, 2, 2, 2, 2]}


def _problem(rng, sizes):
    """A (20, sum(sizes)) positive dictionary and a noisy mixture of one
    atom of each block."""
    A = np.abs(rng.randn(20, sum(sizes))) + 0.1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pick = starts + np.array([rng.randint(n) for n in sizes])
    y = A[:, pick] @ (rng.rand(len(sizes)) + 0.2) + 0.05 * rng.randn(20)
    return A, y, np.array(sizes)


def _bitwise(got, want):
    """Two solver outputs (tuples of arrays / scalars) equal bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        assert np.array_equal(g, w), (g, w)


@pytest.mark.parametrize("K", sorted(DICSIZES))
def test_solve_exhaustive_posweights_matches_jax(rng, K):
    """The dispatcher for K = 1-4 (closed-form grids) and K = 5 (the
    combinatorial loop): the 5-tuple equal bit for bit."""
    A, y, sizes = _problem(rng, DICSIZES[K])
    _bitwise(tnnls.solve_exhaustive_posweights(A, y, sizes),
             jnnls.solve_exhaustive_posweights(A, y, sizes))


@pytest.mark.parametrize("name", [
    "solve_exhaustive_posweights_1", "solve_exhaustive_posweights_2",
    "solve_exhaustive_posweights_3", "solve_exhaustive_posweights_4up",
    "lsqnonneg_2var_opt", "nnls_underdetermined"])
def test_single_problem_variants_match_jax(rng, name):
    """The per-K variants, lsqnonneg_2var_opt over every sign case and
    nnls_underdetermined on a wide system: equal to JAX bit for bit."""
    if name == "lsqnonneg_2var_opt":
        calls = []
        for _ in range(40):
            a = rng.randn(6, 2)
            G = a.T @ a
            Y = a.T @ rng.randn(6)
            calls.append((float(Y @ Y) + 1.0, G[0, 0], G[0, 1], G[1, 1],
                          Y[0], Y[1]))
    elif name == "nnls_underdetermined":
        calls = [(rng.randn(8, 20), rng.randn(8))]
    else:
        K = {"1": 1, "2": 2, "3": 3, "4up": 5}[name.rsplit("_", 1)[1]]
        A, y, sizes = _problem(rng, DICSIZES[K])
        calls = [(A, y) if K == 1 else (A, y, sizes)]
    for args in calls:
        _bitwise(getattr(tnnls, name)(*args), getattr(jnnls, name)(*args))


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def _scheme_2d():
    """A 2D AxCaliber-like protocol: per (Delta, delta) pair two b0 rows
    and the +-x and +-y lines at four gradient intensities (gz = 0)."""
    rows = []
    for Delta, delta in ((0.03, 0.01), (0.05, 0.015)):
        rows += [[0, 0, 0, 0, Delta, delta, 0.08]] * 2
        for g in ([1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]):
            rows += [g + [G, Delta, delta, 0.08]
                     for G in (0.05, 0.1, 0.15, 0.2)]
    return np.array(rows, dtype=np.float64)


def _signal_2d(sch, fascdir, c_perp, DIFF=2.0e-9):
    """Separable analytic signal: free diffusion along the fascicle times
    a Gaussian perpendicular attenuation of scale ``c_perp``."""
    G = sch[:, 3]
    gvec = sch[:, :3] * G[:, None]
    Gpar = np.abs(gvec @ fascdir)
    Gperp2 = np.sum(gvec ** 2, axis=1) - Gpar ** 2
    b_par = ((get_gyromagnetic_ratio("H") * sch[:, 5] * Gpar) ** 2
             * (sch[:, 4] - sch[:, 5] / 3))
    return np.exp(-b_par * DIFF) * np.exp(-c_perp * Gperp2)


def _unit(v):
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("case", ["hardi", "hardi_1d", "2d"])
def test_rotate_atom_matches_jax(rng, case):
    """rotate_atom (HARDI shells, 2-D and 1-D signals) and
    rotate_atom_2Dprotocol equal to the JAX package's bit for bit."""
    newdir = _unit(rng.randn(3))
    if case == "2d":
        sch = _scheme_2d()
        refdir = np.array([0.0, 0.0, 1.0])
        newdir = np.array([np.sin(0.4), 0.0, np.cos(0.4)])
        sig = np.stack([_signal_2d(sch, refdir, c) for c in (1.0, 2.0)],
                       axis=1)
        args = (sig, sch, refdir, newdir, 2.0e-9)
        fn = "rotate_atom_2Dprotocol"
    else:
        sch = ttesting.make_dense_scheme(n_shells=3, dirs_per_shell=12,
                                         n_b0=4)
        sig, _, _ = ttesting.make_dictionary(sch, num_atom=9)
        if case == "hardi_1d":
            sig = sig[:, 3]
        args = (sig, sch, np.array([0.0, 0.0, 1.0]), newdir, 2.0e-9,
                np.ones_like(sig))
        fn = "rotate_atom"
    kw = {} if case == "2d" else {"warnings": False}
    got = getattr(tinterp, fn)(*args, **kw)
    want = getattr(jinterp, fn)(*args, **kw)
    assert got.shape == sig.shape and np.array_equal(got, want)


def _rotation_inputs(rng):
    """Interpolators of a 24-atom dictionary on 3 shells x 12 directions
    + 4 b0 (both packages), and a target scheme of rotated directions at
    gradient intensities between the dense shells."""
    sch = ttesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, _, _ = ttesting.make_dictionary(sch, num_atom=24)
    ordir = np.array([0.0, 0.0, 1.0])
    tgt = sch.copy()
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    tgt[:, :3] = tgt[:, :3] @ Q
    tgt[tgt[:, 3] > 0, 3] -= 0.03
    return (sch, sig, ordir, tgt,
            jinterp.init_PGSE_multishell_interp(sig, sch, ordir),
            tinterp.init_PGSE_multishell_interp(sig, sch, ordir))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("fn", ["eval_rotation", "make_grouped_rotation",
                                "interp_msinterp", "interp_one_shot"])
def test_rotations_match_jax(rng, fn):
    """eval_rotation, the unpaired grouped rotation (also against the
    port's paired one at its permutation) and interp_PGSE_from_multishell
    in both modes, in float64 on the CPU: within 1e-12 of the scale."""
    sch, sig, ordir, tgt, msj, mst = _rotation_inputs(rng)
    plan = jinterp.plan_target_scheme(msj, tgt)
    newdirs = rng.randn(3, 2, 3)
    newdirs /= np.linalg.norm(newdirs, axis=2, keepdims=True)
    xj, yj, cj = msj.device_tables(jnp.float64)
    xt, yt, ct = mst.device_tables("cpu", torch.float64)
    if fn == "eval_rotation":
        P = (plan.gdir, plan.shell_lo, plan.shell_hi, plan.wG, newdirs[0, 0])
        want = jinterp.eval_rotation(xj, yj, cj, *map(jnp.asarray, P))
        got = tinterp.eval_rotation(xt, yt, ct,
                                    *map(lambda a: torch.as_tensor(a), P))
        assert got.shape == (tgt.shape[0], 24)
    elif fn == "make_grouped_rotation":
        want = jinterp.make_grouped_rotation(msj, plan)(
            yj, jnp.asarray(newdirs))
        got = tinterp.make_grouped_rotation(mst, plan)(
            yt, torch.as_tensor(newdirs))
        paired, perm = tinterp.make_grouped_rotation_paired(mst, plan)
        _close(paired(yt, torch.as_tensor(newdirs)), got[:, :, perm])
    elif fn == "interp_msinterp":
        want = jinterp.interp_PGSE_from_multishell(tgt, newdirs[0, 0],
                                                   msinterp=msj)
        got = tinterp.interp_PGSE_from_multishell(tgt, newdirs[0, 0],
                                                  msinterp=mst, device="cpu")
    else:
        kw = dict(sig_ms=sig, sch_mat_ms=sch, ordir=ordir)
        want = jinterp.interp_PGSE_from_multishell(tgt, newdirs[0, 0], **kw)
        got = tinterp.interp_PGSE_from_multishell(tgt, newdirs[0, 0],
                                                  device="cpu", **kw)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _close(got, want)


# ---------------------------------------------------------------------------
# noise, Monte Carlo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", ["scalar", "array", "zero", "mismatch"])
def test_gen_SoS_MRI_matches_jax(rng, sigma):
    """gen_SoS_MRI under the same np.random seed: equal bit for bit (or
    the same ValueError for a sigma of another shape)."""
    S0 = rng.rand(5, 7) + 0.5
    sg = {"scalar": 0.1, "array": 0.05 + 0.1 * rng.rand(5, 7), "zero": 0.0,
          "mismatch": np.full((7, 5), 0.1)}[sigma]
    out = []
    for mod in (jnoise, tnoise):
        np.random.seed(7)
        if sigma == "mismatch":
            with pytest.raises(ValueError) as err:
                mod.gen_SoS_MRI(S0, sg, N=3)
            out.append(str(err.value))
        else:
            out.append(mod.gen_SoS_MRI(S0, sg, N=3))
    if sigma == "mismatch":
        assert out[0] == out[1]
    else:
        assert np.array_equal(out[0], out[1])


def test_gen_sos_mri_torch():
    """gen_sos_mri_torch: the noiseless branch equals JAX's bit for bit;
    S0's shape and dtype; a seeded generator repeats its draws and
    another seed does not; E[Y^2] = N (S0^2 + 2 sigma^2) within 0.5%,
    and mean(Y) within 5 standard errors of gen_sos_mri_jax's."""
    N, S0v, sigma = 2, 5.0, 1.0
    S0 = torch.full((200, 500), S0v, dtype=torch.float64)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    quiet = tnoise.gen_sos_mri_torch(gen(3), S0, 0.0, N=N)
    want = jnoise.gen_sos_mri_jax(jax.random.PRNGKey(3), S0.numpy(), 0.0,
                                  N=N)
    assert np.array_equal(quiet.numpy(), np.asarray(want))
    a = tnoise.gen_sos_mri_torch(gen(3), S0, sigma, N=N)
    assert a.shape == S0.shape and a.dtype == S0.dtype
    assert torch.equal(a, tnoise.gen_sos_mri_torch(gen(3), S0, sigma, N=N))
    assert not torch.equal(a, tnoise.gen_sos_mri_torch(gen(4), S0, sigma,
                                                       N=N))
    m2 = float((a ** 2).mean())
    assert abs(m2 / (N * (S0v ** 2 + 2 * sigma ** 2)) - 1) < 5e-3
    j = np.asarray(jnoise.gen_sos_mri_jax(jax.random.PRNGKey(3),
                                          S0.numpy(), sigma, N=N))
    se = np.sqrt(a.var().item() / a.numel() + j.var() / j.size)
    assert abs(a.mean().item() - j.mean()) < 5 * se


def test_monte_carlo_average_matches_jax(rng):
    """monte_carlo_average over 3 chunks of spins: within rtol 1e-12."""
    n_spin = 2500
    ph = 2.0 * rng.randn(2 * n_spin, 3)
    dmap = rng.randint(0, 2, 30)
    gsc = rng.rand(30, 3)
    want = jmc.monte_carlo_average(ph, dmap, gsc, 0.8, n_spin, chunk=1024)
    got = tmc.monte_carlo_average(ph, dmap, gsc, 0.8, n_spin, chunk=1024,
                                  device="cpu")
    assert got.shape == (30,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("ext,D", [(".ldouble", None), (".bsingle", 1.5e-9)])
def test_get_PGSE_from_phases_matches_jax(rng, tmp_path, ext, D):
    """Phase files of 2 reference sequences x 2000 spins (little-endian
    float64, big-endian float32), written with np.tofile, mapped to 12
    sequences, with and without a diffusivity rescaling: within rtol
    1e-12."""
    n_spin = 2000
    sim = np.zeros((2, 7))
    sim[:, :3] = 1 / np.sqrt(3.0)
    sim[:, 3] = 0.1
    sim[:, 4:7] = [[0.03, 0.01, 0.08], [0.05, 0.015, 0.08]]
    new = np.zeros((12, 7))
    new[:, :3] = rng.randn(12, 3)
    new[:, :3] /= np.linalg.norm(new[:, :3], axis=1, keepdims=True)
    new[:, 3] = 0.2 * rng.rand(12)
    new[:, 4:7] = sim[rng.randint(0, 2, 12), 4:7]
    dtype = (">" if ext[1] == "b" else "<") + (
        "f8" if ext.endswith("double") else "f4")
    ph = 3.0 * rng.randn(2 * n_spin, 3)
    for i, ax in enumerate("xyz"):
        ph[:, i].astype(dtype).tofile(str(tmp_path / ("spins_phase_%s%s"
                                                      % (ax, ext))))
    path = str(tmp_path / ("spins_phase_x" + ext))
    kw = {} if D is None else {"D_sim": 2.0e-9, "D": D}
    want = jmc.get_PGSE_from_phases(path, sim, new, **kw)
    got = tmc.get_PGSE_from_phases(path, sim, new, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("call", ["interp_PGSE_from_multishell",
                                  "monte_carlo_average"])
def test_device_work_defaults_to_the_card(rng, monkeypatch, call):
    """Without CUDA, the functions that do device work raise unless the
    caller asks for the CPU: there is no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if call == "interp_PGSE_from_multishell":
        sch, _sig, _o, tgt, _msj, mst = _rotation_inputs(rng)
        run = lambda **kw: tinterp.interp_PGSE_from_multishell(
            tgt, np.array([0.0, 0.0, 1.0]), msinterp=mst, **kw)
    else:
        run = lambda **kw: tmc.monte_carlo_average(
            rng.randn(20, 3), np.zeros(4, int), rng.rand(4, 3), 1.0, 10,
            **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
    assert np.all(np.isfinite(run(device="cpu")))


# ---------------------------------------------------------------------------
# plotting, profiling
# ---------------------------------------------------------------------------

def _plot_args(which):
    if which == "plot_signal_2Dprotocol":
        sch = _scheme_2d()
        return (np.stack([_signal_2d(sch, np.array([0.0, 0.0, 1.0]), c)
                          for c in (1.0, 2.0)], axis=1), sch)
    sch = ttesting.make_dense_scheme(n_shells=2, dirs_per_shell=12, n_b0=2)
    sig, _, _ = ttesting.make_dictionary(sch, num_atom=3)
    return (sig, sch, np.array([0.0, 0.0, 1.0]))


@pytest.mark.parametrize("which", ["plot_multi_shell_signal",
                                   "plot_signal_2Dprotocol"])
def test_viz_figures_match_jax(which):
    """Both plotters, Agg backend: the same figures, axes and line data
    as the JAX package's."""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    try:
        figs = [getattr(mod, which)(*_plot_args(which))
                for mod in (jviz, tviz)]
        assert len(figs[0]) == len(figs[1]) > 0
        for fj, ft in zip(*figs):
            assert len(fj.axes) == len(ft.axes)
            for aj, at in zip(fj.axes, ft.axes):
                assert len(aj.lines) == len(at.lines)
                for lj, lt in zip(aj.lines, at.lines):
                    assert np.array_equal(lj.get_xydata(), lt.get_xydata())
    finally:
        plt.close("all")


def test_viz_without_matplotlib(monkeypatch):
    """Without matplotlib the plotters trip on first use, and importing
    the module did not need it."""
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert is_tripwire(tviz.pyplot())
    with pytest.raises(TripWireError):
        tviz.plot_multi_shell_signal(*_plot_args("plot_multi_shell_signal"))


def test_device_trace_and_annotate(tmp_path):
    """device_trace writes a Chrome trace under its directory on the
    CPU; an annotated function keeps its result and name, and its label
    is in the trace."""
    @profiling.annotate("mf_region")
    def double(x):
        return 2 * x

    with profiling.device_trace(str(tmp_path)):
        out = double(torch.arange(4.0))
    assert torch.equal(out, 2 * torch.arange(4.0))
    assert double.__name__ == "double"
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mf_region" for e in events)


def test_device_time_sums_between_markers_only():
    """``device_ms`` sums the launches between the last reps + 1 marker
    kernels of its trace: not those before (a trace may lose its start),
    not the markers between the timed calls, and only the names that
    match its pattern; a trace with too few markers reads as None."""
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    evs = [(0, "lost_kernel", 50.0), (1, mark, 3.0), (2, "mf_a", 10.0),
           (3, mark, 3.0), (4, "mf_a", 11.0), (5, "copy", 2.0),
           (6, mark, 3.0), (7, "mf_a", 12.0), (8, mark, 3.0)]
    assert profiling.marked_us(evs, 2) == 11.0 + 2.0 + 12.0
    assert profiling.marked_us(evs, 3) == 10.0 + 11.0 + 2.0 + 12.0
    assert profiling.marked_us(evs, 3, pattern="mf_") == 33.0
    assert profiling.marked_us(evs, 4) is None
