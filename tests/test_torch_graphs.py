"""The chunk steps as CUDA graphs (``models/graphs.py``), on the CPU.

A captured step must make no host synchronisation and read no host data:
each of the nine chunk steps runs under a ``TorchDispatchMode`` that
logs its aten ops, with spies on the Python constructors of tensors.
The graph cache's bookkeeping runs on the CPU with a stand-in for
``torch.cuda.CUDAGraph``: its capture records the aten ops the step
runs, and its replay runs them again on the tensors they were recorded
with, writing each fresh result into the tensor recorded for it, so
that, as on a card, a replay reads what the graph's own input tensors
hold and nothing that Python computes. The rotations rebuilt to keep
their constants on the device are held bit for bit against the
host-copy form they replace. A ``cuda``-marked test holds a graph fit
against an eager fit on the card.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.models import graphs
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.utils import profiling

torch.set_num_threads(2)
N_ATOM, N_VOX, BATCH, R, N_EAR = 72, 16, 8, 16, 6


@pytest.fixture(scope="module")
def wl():
    """72 atoms on a 40-sequence scheme, 16 voxels (the shapes of
    tests/test_torch_buckets.py), with an EAR block of 6 atoms."""
    w = ttesting.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    w["sig_ear"], w["y_ear"] = ttesting.make_ear(w, N_EAR)
    return w


# ---------------------------------------------------------------------------
# each step is capturable: no host sync, no host data
# ---------------------------------------------------------------------------

#: aten ops that wait for the device or whose output shape depends on
#: values (neither can be captured)
_SYNCING = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.unique", "aten._unique", "aten._unique2",
            "aten.unique_dim", "aten.unique_consecutive",
            "aten.repeat_interleave", "aten.lift_fresh",
            "aten.lift_fresh_copy"}


class _OpLog(TorchDispatchMode):
    """Logs the packet name of every aten op, and boolean-mask indexing
    (a hidden ``nonzero``). A lifted 0-dim tensor is a Python number
    (``t[:, 0] = True``): it reaches the device by value, as a kernel
    argument, so it is logged apart from lifted host arrays."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name == "aten.index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            name = "aten.index with a boolean mask"
        if name.startswith("aten.lift_fresh") and args[0].dim() == 0:
            name += " of a number"
        self.ops.append(name)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _host_data_spies():
    """Records each tensor that Python builds from host data (NumPy
    arrays, lists, numbers; not a tensor passed to ``as_tensor``)."""
    made, saved = [], {}
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = saved[name] = getattr(torch, name)

        def spy(data, *a, _orig=orig, _name=name, **k):
            if not isinstance(data, torch.Tensor):
                made.append(_name)
            return _orig(data, *a, **k)

        setattr(torch, name, spy)
    try:
        yield made
    finally:
        for name, orig in saved.items():
            setattr(torch, name, orig)


#: the nine chunk steps: the fast path's seven through ``_chunk_step``
#: (bucket (K, csf, ear), row budget), and the general path's two
FAST_STEPS = {
    "_twopass_step3": (2, True, False, R),
    "_onepass_step3": (2, True, False, None),
    "_twopass_step4": (2, True, True, R),
    "_onepass_step4": (2, True, True, None),
    "_scan12_step": (1, True, False, None),
    "_scan13_step": (1, True, True, None),
    "_scan22_step": (2, False, False, None),
}


def _fast_call(wl, K, csf, ear, R_):
    """(step, args, statics) of one chunk of ``_chunk_step`` on the
    CPU, its rotation's device constants already built (the graph cache
    runs a key's first chunk eagerly before it captures)."""
    ms, plan = wl["msinterp"], wl["plan"]
    rotate, perm = tinterp.make_grouped_rotation_paired(ms, plan)
    _x, ys, _c = ms.device_tables("cpu", torch.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    pk = f32(wl["peaks"][:BATCH, :K])
    y = f32((wl["y_ear"] if ear else wl["y"])[:BATCH][:, perm])
    csf_d = f32(wl["sig_csf"][perm]) if csf else None
    ear_d = f32(wl["sig_ear"][perm]) if ear else None
    rotate(ys, pk)
    return (tfit._chunk_step, (rotate, ys, csf_d, ear_d, pk, y),
            dict(K=K, csf_on=csf, ear_on=ear, R=R_))


def _general_call(wl, name):
    K, csf, ear = 2, True, True
    tables = wl["msinterp"].device_tables("cpu", torch.float32)
    plan = tfit.plan_tensors(wl["plan"], torch.float32, "cpu")
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    args = tables + plan + (
        f32(wl["peaks"][:BATCH]), f32(wl["y_ear"][:BATCH]),
        f32(wl["sig_csf"]), f32(wl["sig_ear"]))
    statics = dict(K=K, csf_on=csf, ear_on=ear)
    if name == "fit_step_candidates":
        statics["M"] = 4
    return getattr(tfit, name), args, statics


@pytest.mark.parametrize("name", list(FAST_STEPS)
                         + ["fit_step", "fit_step_candidates"])
def test_step_stays_capturable(wl, monkeypatch, name):
    """A chunk step makes no ``aten._local_scalar_dense`` (``.item()``,
    ``int(t)``, a branch on a value), no ``aten.nonzero`` or other op of
    value-dependent shape, and builds no tensor from host data: what a
    CUDA graph cannot hold."""
    if name in FAST_STEPS:
        step, args, statics = _fast_call(wl, *FAST_STEPS[name])
        ran = []
        orig = getattr(tfit, name)
        monkeypatch.setattr(
            tfit, name, lambda *a, **k: ran.append(name) or orig(*a, **k))
    else:
        step, args, statics = _general_call(wl, name)
        ran = [name]
    log = _OpLog()
    with _host_data_spies() as made, log:
        out = step(*args, **statics)
    assert ran == [name]
    assert made == []
    bad = set(log.ops) & (_SYNCING | {"aten.index with a boolean mask"})
    assert not bad
    assert len(log.ops) > 50
    assert all(torch.isfinite(t.float()).all() for t in
               pytree.tree_leaves(out) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# the cache's bookkeeping, with a stand-in for torch.cuda.CUDAGraph
# ---------------------------------------------------------------------------

class _Tape(TorchDispatchMode):
    """Runs and records every aten op: the stand-in graph's capture."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: a replay runs the recorded
    aten ops again on their recorded tensors; an op's output that
    aliases none of its inputs is overwritten with the new result (a
    view or an in-place op already works on the recorded memory)."""

    captures = 0

    def __init__(self):
        self.ops = None

    @contextlib.contextmanager
    def capture(self):
        tape = _Tape()
        with tape:
            yield
        self.ops = tape.ops
        _StandInGraph.captures += 1

    def replay(self):
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            inputs = _storages((args, kwargs))
            for o, n in zip(pytree.tree_leaves(out), pytree.tree_leaves(new)):
                if (isinstance(o, torch.Tensor) and o.numel()
                        and o.untyped_storage().data_ptr() not in inputs):
                    o.copy_(n)


class _StandInCard(graphs._Card):
    """The cache's card calls on the CPU."""

    device_type = "cpu"

    def __init__(self, fail=False):
        self.fail = fail

    def graph(self):
        return _StandInGraph()

    def pool(self):
        return object()

    def device(self, dev):
        return contextlib.nullcontext()

    def warm_up(self, fn, dev):
        fn()

    def capturing(self, graph, pool, dev):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return graph.capture()


@pytest.fixture
def stand_in(monkeypatch):
    graphs.clear()
    _StandInGraph.captures = 0
    monkeypatch.setattr(graphs, "_CARD", _StandInCard())
    kernels.reset_counts()
    yield
    graphs.clear()
    kernels.reset_counts()


def _toy_step(x, w, *, k):
    """A step that 'launches' kernel 3 once and does a few torch ops;
    counts its Python calls."""
    _toy_step.calls += 1
    kernels._count("rescan3")
    z = torch.tanh(x * w + k)
    return z, z.sum(dim=1), {"m": torch.amax(z, dim=1)}


def _eager_toy(x, w, k):
    z = torch.tanh(x * w + k)
    return z, z.sum(dim=1), {"m": torch.amax(z, dim=1)}


def _same(a, b):
    return all(torch.equal(p, q) for p, q in
               zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def test_cache_captures_once_a_key_and_counts_each_replay(stand_in):
    """One capture a key (step, device, shapes, dtypes, statics): the
    key's first chunk runs eagerly, then warm-up and capture; every later
    chunk replays (no Python call of the step), and LAUNCHES after N
    chunks equals the N launches of an eager run."""
    rng = np.random.RandomState(0)
    w = torch.as_tensor(rng.rand(6, 5), dtype=torch.float32)
    _toy_step.calls = 0
    xs = [torch.as_tensor(rng.rand(6, 5), dtype=torch.float32)
          for _ in range(5)]
    outs = [graphs.run(_toy_step, x, w, k=0.5) for x in xs]
    assert _toy_step.calls == 3                  # eager, warm-up, capture
    assert _StandInGraph.captures == 1
    assert kernels.LAUNCHES["rescan3"] == len(xs)
    for x, out in zip(xs, outs):
        assert _same(out, _eager_toy(x, w, 0.5))
    (rec,) = graphs.stats()
    assert rec["replays"] == len(xs) - 1
    assert rec["launches"] == {"rescan3": 1}
    assert rec["statics"] == {"k": 0.5}
    # another static, another shape, another dtype: a key each
    graphs.run(_toy_step, xs[0], w, k=1.5)
    graphs.run(_toy_step, xs[0][:3], w[:3], k=0.5)
    graphs.run(_toy_step, xs[0].double(), w.double(), k=0.5)
    assert _StandInGraph.captures == 4
    assert kernels.LAUNCHES["rescan3"] == len(xs) + 3


def test_outputs_survive_the_next_replay(stand_in):
    """A chunk's outputs are cloned out of the graph: the next replay,
    which overwrites the graph's outputs, leaves them as they were."""
    rng = np.random.RandomState(1)
    w = torch.as_tensor(rng.rand(6, 5), dtype=torch.float32)
    _toy_step.calls = 0
    xs = [torch.as_tensor(rng.rand(6, 5), dtype=torch.float32)
          for _ in range(4)]
    graphs.run(_toy_step, xs[0], w, k=0.0)
    first = graphs.run(_toy_step, xs[1], w, k=0.0)            # a replay
    kept = pytree.tree_map(torch.clone, first)
    graphs.run(_toy_step, xs[2], w, k=0.0)
    graphs.run(_toy_step, xs[3], w, k=0.0)
    assert _same(first, kept)
    assert _same(first, _eager_toy(xs[1], w, 0.0))


def test_route_eager_on_request_and_under_a_stage_timer(stand_in):
    """``graphs.eager()`` and an active StageTimer run the step eagerly:
    nothing is captured, every chunk calls the step."""
    x = torch.ones(4, 3)
    _toy_step.calls = 0
    with graphs.eager():
        for _ in range(3):
            graphs.run(_toy_step, x, x, k=1.0)
    with profiling.StageTimer():
        for _ in range(3):
            graphs.run(_toy_step, x, x, k=1.0)
    assert _toy_step.calls == 6
    assert graphs.stats() == [] and _StandInGraph.captures == 0
    assert graphs.graphed(torch.device("cpu"))


def _row_budget(monkeypatch):
    """The two-pass at R = 16 rows, so that 72 atoms take it."""
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=R))


def _fast_bucket(wl, tables_ys, sig_csf, rotator):
    """The workload's voxels as one (2, CSF) bucket, in chunks of BATCH."""
    return tfit.run_bucket_fast(wl["msinterp"], wl["plan"], tables_ys,
                                wl["peaks"].reshape(N_VOX, 6), wl["y"],
                                sig_csf, 2, True, batch=BATCH,
                                rotator=rotator)


def _results_equal(a, b):
    return all(np.array_equal(p, q) for p, q in zip(a, b))


def test_new_tables_reach_the_replay(wl, stand_in, monkeypatch):
    """A graph captured on one model's tables and CSF column, replayed
    with a second model's (the same rotation, other values), gives the
    second model's eager results bit for bit, not the first's: every
    input is copied into the graph before a replay."""
    _row_budget(monkeypatch)
    rot = tinterp.make_grouped_rotation_paired(wl["msinterp"], wl["plan"])
    _x, ys, _c = wl["msinterp"].device_tables("cpu", torch.float32)
    ys2 = ys * 1.25
    csf2 = wl["sig_csf"] * 0.5
    first = _fast_bucket(wl, ys, wl["sig_csf"], rot)
    assert _StandInGraph.captures == 1
    second = _fast_bucket(wl, ys2, csf2, rot)
    assert _StandInGraph.captures == 1
    assert graphs.stats()[0]["replays"] == 2 * N_VOX // BATCH - 1
    with graphs.eager():
        want = _fast_bucket(wl, ys2, csf2, rot)
        want_first = _fast_bucket(wl, ys, wl["sig_csf"], rot)
    assert _results_equal(second, want)
    assert _results_equal(first, want_first)
    assert not np.array_equal(second[2], first[2])


def test_failed_capture_raises(wl, monkeypatch):
    """A capture that fails makes the fit raise: no chunk is handed over
    to eager execution."""
    graphs.clear()
    monkeypatch.setattr(graphs, "_CARD", _StandInCard(fail=True))
    _row_budget(monkeypatch)
    dic, args, kw = _mixed_volume(wl)
    try:
        with pytest.raises(RuntimeError, match="capturing"):
            mft.MFModel(dic).fit(*args, **kw)
        assert graphs.stats() == []
    finally:
        graphs.clear()


def _mixed_volume(wl):
    """16 voxels: CSF only, (1, CSF), (2, CSF), (2, no CSF) and, with
    ear_mask = 0 there, the general path's (1, no CSF) bucket."""
    mix = ttesting.make_mixed(wl, [(2, 0, True), (4, 1, True), (4, 2, True),
                                   (3, 2, False), (3, 1, False)], seed=5)
    shape, S = (4, 2, 2), wl["sch_mat"].shape[0]
    sig, dpar, dperp = ttesting.make_dictionary(wl["sch_mat"], N_ATOM)
    dic = {"dictionary": sig, "sch_mat": wl["sch_mat"],
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": N_ATOM,
           "fasc_propnames": ["dpar"], "dpar": dpar, "T2_csf": 2.0,
           "DIFF_csf": 3.0e-9}
    args = (mix["y"].reshape(shape + (S,)), np.ones(shape),
            mix["numfasc"].reshape(shape).astype(float))
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"],
              csf_mask=mix["csf_mask"].reshape(shape).astype(float),
              verbose=0, batch_size=BATCH, device="cpu")
    return dic, args, kw


def test_graph_fit_equals_eager_fit(wl, stand_in, monkeypatch):
    """MFModel.fit on a mixed volume through the stand-in graphs (a
    capture for each bucket's chunk step, then replays) equals the eager
    fit, map for map, bit for bit."""
    _row_budget(monkeypatch)
    dic, args, kw = _mixed_volume(wl)
    model = mft.MFModel(dic)
    with graphs.eager():
        want = model.fit(*args, **kw)
    got = model.fit(*args, **kw)
    again = model.fit(*args, **kw)
    steps = {r["step"] for r in graphs.stats()}
    assert steps == {"_chunk_step", "fit_step_candidates"}
    assert sum(r["replays"] for r in graphs.stats()) > 0
    for p in want.param_names:
        assert np.array_equal(getattr(got, p), getattr(want, p)), p
        assert np.array_equal(getattr(again, p), getattr(want, p)), p


# ---------------------------------------------------------------------------
# the rotations keep their constants on the device
# ---------------------------------------------------------------------------

def _lerp_weights_host(msinterp, s, xq, kiota):
    """The host-copy form the rebuilt rotations replace."""
    xs_s = torch.as_tensor(msinterp.xs[s], dtype=xq.dtype, device=xq.device)
    j = torch.clamp((xq[..., None] >= xs_s).sum(-1) - 1,
                    0, int(msinterp.cnt[s]) - 2)
    x0 = xs_s[j]
    x1 = xs_s[j + 1]
    denom = x1 - x0
    pos = denom > 0
    t = torch.where(pos, (xq - x0) / torch.where(
        pos, denom, torch.ones_like(denom)), torch.zeros_like(xq))
    return ((1.0 - t)[..., None] * (kiota == j[..., None])
            + t[..., None] * (kiota == (j[..., None] + 1)))


def _abs_gdotn_host(gdir, newdirs, dt, dev):
    nd = newdirs.reshape(-1, 3).to(dt)
    g = torch.as_tensor(gdir, dtype=dt, device=dev)
    return torch.abs(nd[:, None, 0] * g[None, :, 0]
                     + nd[:, None, 1] * g[None, :, 1]
                     + nd[:, None, 2] * g[None, :, 2])


def _paired_host(msinterp, plan, tables_ys, newdirs):
    Kmax = msinterp.xs.shape[1]
    pair_ids = {}
    for q in range(plan.gdir.shape[0]):
        key = (int(plan.shell_lo[q]), int(plan.shell_hi[q]))
        pair_ids.setdefault(key, []).append(q)
    pairs = [(sl, sh, np.asarray(ids, np.int64))
             for (sl, sh), ids in sorted(pair_ids.items())]
    B, K, _ = newdirs.shape
    dt, dev = tables_ys.dtype, tables_ys.device
    x = _abs_gdotn_host(plan.gdir, newdirs, dt, dev)
    kiota = torch.arange(Kmax, device=dev)
    outs = []
    for sl, sh, ids in pairs:
        xq = x[:, torch.as_tensor(ids, device=dev)]
        wq = torch.as_tensor(plan.wG[ids], dtype=dt, device=dev)
        W = torch.cat([
            _lerp_weights_host(msinterp, sl, xq, kiota)
            * (1.0 - wq)[None, :, None],
            _lerp_weights_host(msinterp, sh, xq, kiota) * wq[None, :, None]],
            dim=2)
        T = torch.cat([tables_ys[sl], tables_ys[sh]], dim=0)
        outs.append(torch.matmul(W, T))
    return torch.cat(outs, dim=1).reshape(B, K, plan.gdir.shape[0], -1)


def _grouped_host(msinterp, plan, tables_ys, newdirs):
    S = msinterp.Gms_un.size
    Kmax = msinterp.xs.shape[1]
    groups, inv = {}, {}
    for role, shell in (("lo", plan.shell_lo), ("hi", plan.shell_hi)):
        groups[role] = [(s, np.flatnonzero(shell == s)) for s in range(S)
                        if np.any(shell == s)]
        inv[role] = np.argsort(np.concatenate(
            [ids for _s, ids in groups[role]]))
    B, K, _ = newdirs.shape
    dt, dev = tables_ys.dtype, tables_ys.device
    x = _abs_gdotn_host(plan.gdir, newdirs, dt, dev)
    kiota = torch.arange(Kmax, device=dev)
    Rr = {}
    for role, grp in groups.items():
        outs = [torch.matmul(_lerp_weights_host(
            msinterp, s, x[:, torch.as_tensor(ids, device=dev)], kiota),
            tables_ys[s]) for s, ids in grp]
        Rr[role] = torch.cat(outs, dim=1)[
            :, torch.as_tensor(inv[role], device=dev)]
    w = torch.as_tensor(plan.wG, dtype=dt, device=dev)[None, :, None]
    D = Rr["lo"] + w * (Rr["hi"] - Rr["lo"])
    return D.reshape(B, K, plan.gdir.shape[0], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["paired", "grouped"])
def test_rotation_equals_host_copy_form(wl, monkeypatch, dtype, which):
    """The rebuilt rotations equal the form that copied the plan's arrays
    to the device on every call, bit for bit; from their second call on
    they build no tensor from host data."""
    ms, plan = wl["msinterp"], wl["plan"]
    _x, ys, _c = ms.device_tables("cpu", dtype)
    pk = torch.as_tensor(wl["peaks"], dtype=dtype)
    if which == "paired":
        rotate, _perm = tinterp.make_grouped_rotation_paired(ms, plan)
        want = _paired_host(ms, plan, ys, pk)
    else:
        rotate = tinterp.make_grouped_rotation(ms, plan)
        want = _grouped_host(ms, plan, ys, pk)
    assert torch.equal(rotate(ys, pk), want)
    with _host_data_spies() as made:
        again = rotate(ys, pk)
    assert made == []
    assert torch.equal(again, want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_graph_fit_equals_eager_fit(wl):
    """On the card: a fit through the graphs (captures, then replays)
    equals the eager fit bit for bit, map for map, with the same kernel
    launches; the flagship two-pass bucket launches kernels 1-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = tconfig.DEFAULTS["solver"]
    tconfig.DEFAULTS["solver"] = dataclasses.replace(saved, twopass_rows=R)
    try:
        dic, args, kw = _mixed_volume(wl)
        kw["device"] = "cuda"
        model = mft.MFModel(dic)
        graphs.clear()
        fits, launches = {}, {}
        for name in ("eager", "graph", "graph again"):
            kernels.reset_counts()
            with graphs.eager() if name == "eager" else \
                    contextlib.nullcontext():
                fits[name] = model.fit(*args, **kw)
            torch.cuda.synchronize()
            launches[name] = dict(kernels.LAUNCHES)
    finally:
        tconfig.DEFAULTS["solver"] = saved
        graphs.clear()
    assert launches["graph"] == launches["eager"] == launches["graph again"]
    assert min(launches["eager"][k]
               for k in ("prep_block", "rowmin3", "rescan3")) > 0
    for name in ("graph", "graph again"):
        for p in fits["eager"].param_names:
            assert np.array_equal(getattr(fits[name], p),
                                  getattr(fits["eager"], p)), (name, p)
