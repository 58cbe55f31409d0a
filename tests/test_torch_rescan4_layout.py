"""The staged layout of kernel 5 (``csrc/rescan4.cu``), on the CPU.

The kernel multiplies double-float values by fused multiply-add and never
reads the split halves ``hh, hl`` that the packs carry beside ``hi, lo``:
it stages ``(hi, lo)`` of each quadruple and the single floats. Here: the
halves are ``split(hi)`` bitwise (so dropping them loses nothing), the
Python copy of the kernel's index map (``ops/rescan``) is a bijection
from the entries the kernel reads onto the staged slots, and the copy's
sizes and expressions are those of the source text."""

import os
import re

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch.ops import df32
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
CU = os.path.join(os.path.dirname(mft.__file__), "csrc", "rescan4.cu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quads(sizes, nx):
    """First entries of the (hi, lo, hh, hl) quadruples of each pack."""
    return {"row": range(0, sizes["row"][1], 4),
            "col": range(0, sizes["col"][1], 4),
            "vox": [0] + [4 + 6 * x for x in range(nx)]}


def test_split_halves_are_recomputable(rng):
    """On a small EAR case (n3 = 1, n4 = 3): every hh, hl of row_pack,
    col_pack and vox equals df32.split(hi) bit for bit."""
    B, S, N1, N2, n3, n4 = 2, 24, 40, 60, 1, 3
    base = np.abs(rng.randn(B, S, 1))
    mk = lambda n: np.float32(
        0.9 * base + 0.1 * (np.abs(rng.randn(B, S, n)) + 0.05))
    args = (mk(N1), mk(N2), np.float32(np.abs(rng.randn(B, S, n3)) + 0.05),
            np.float32(np.abs(rng.randn(B, S, n4)) + 0.05),
            np.float32(np.abs(rng.randn(B, S))))
    ops, _segw, _yn = trescan.row_scan_df4_operands(*[_t(x) for x in args])
    row_pack, col_pack, vox = ops[8], ops[9], ops[10]
    sizes = trescan.df4_pack_sizes(n3, n4)
    assert row_pack.shape[1] >= sizes["row"][0]
    assert col_pack.shape[1] >= sizes["col"][0]
    assert vox.shape[1] >= sizes["vox"]
    bits = lambda x: x.contiguous().view(torch.int32)
    n_checked = 0
    for name, pack in (("row", row_pack), ("col", col_pack),
                       ("vox", vox[:, :, None])):
        for e in _quads(sizes, n3 + n4)[name]:
            hh, hl = df32.split(pack[:, e])
            assert torch.equal(bits(hh), bits(pack[:, e + 2])), (name, e)
            assert torch.equal(bits(hl), bits(pack[:, e + 3])), (name, e)
            n_checked += 1
    assert n_checked == sizes["row"][1] // 4 + sizes["col"][1] // 4 + 5
    assert torch.isfinite(row_pack[:, :sizes["row"][1], :N1]).all()


@pytest.mark.parametrize("n3,n4", [(1, 3), (1, 10), (2, 3)])
def test_short_layout_is_a_bijection(n3, n4):
    """Each entry the kernel reads (everything but the split halves) goes
    to a distinct slot, the slots are 0 .. slots - 1, and ``short_entry``
    / ``vox_entry`` (the copy loops' direction) invert the maps."""
    nx = n3 + n4
    sizes = trescan.df4_pack_sizes(n3, n4)
    for name in ("row", "col"):
        n, quad = sizes[name]
        read = [e for e in range(n) if e >= quad or e % 4 < 2]
        slots = [trescan.short_slot(e, quad) for e in read]
        assert sorted(slots) == list(range(trescan.short_slots(n, quad)))
        assert [trescan.short_entry(s, quad) for s in slots] == read
        with pytest.raises(ValueError, match="split half"):
            trescan.short_slot(2, quad)
    n = sizes["vox"]
    halves = {q + k for q in _quads(sizes, nx)["vox"] for k in (2, 3)}
    read = [e for e in range(n) if e not in halves]
    slots = [trescan.vox_slot(e, nx) for e in read]
    assert sorted(slots) == list(range(trescan.vox_slots(n, nx)))
    assert [trescan.vox_entry(s, nx) for s in slots] == read
    with pytest.raises(ValueError, match="split half"):
        trescan.vox_slot(4 + 6 * (nx - 1) + 3, nx)


def _c_ints(text, env):
    """Evaluate ``const int a = ..., b = ...;`` declarations of C text
    (integer arithmetic only) into ``env``."""
    for decl in re.findall(r"const int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = part.split("=")
            env[name.strip()] = eval(expr.replace("/", "//"), {}, env)
    return env


def _c_ternary(text, struct, fn):
    """A one-line ``return a ? b : c;`` of ``struct::fn`` as a Python
    function of (arg, quad)."""
    body = text[text.index("struct " + struct):]
    m = re.search(r"int %s\(int (\w)\) const \{\s*return (.+?) \? (.+?) : "
                  r"(.+?);" % fn, body, re.S)
    arg, cond, a, b = (x.replace("/", "//") for x in m.groups())
    return lambda v, quad: eval("(%s) if (%s) else (%s)" % (a, cond, b), {},
                                {arg: v, "quad": quad})


@pytest.mark.parametrize("n3,n4", [(1, 3), (1, 10), (2, 3)])
def test_layout_is_the_sources(n3, n4):
    """Sizes, quadruple counts and the map's expressions read from
    ``rescan4.cu`` equal the Python copy's; at E = 10 the staged packs
    are 193 + 213 entries and two blocks fit an SM's shared memory."""
    with open(CU) as f:
        text = f.read()
    nx, ns = n3 + n4, n3 * n4
    sizes = trescan.df4_pack_sizes(n3, n4)
    launcher = text[text.index('extern "C" int mf_rescan4'):]
    env = _c_ints(launcher[:launcher.index("if (N1p")],
                  {"n3": n3, "n4": n4})
    assert (env["nrow"], env["ncol"], env["nvox"]) == (
        sizes["row"][0], sizes["col"][0], sizes["vox"])
    for name, pack in (("rmap", "row"), ("cmap", "col")):
        quad, n = re.search(r"PackMap %s = \{(.+?), (\w+)\}" % name,
                            launcher).groups()
        assert (eval(quad, {}, env), env[n]) == sizes[pack][::-1]
    kernel = text[text.index("// pack layout offsets"):]
    off = _c_ints(kernel[:kernel.index("const PackMap")],
                  {"nx": nx, "ns": ns, "n3": n3, "n4": n4})
    assert (off["r_res1"], off["c_res2"]) == (sizes["row"][1],
                                              sizes["col"][1])
    assert re.search(r"rmap = \{r_res1, nrow\}, cmap = \{c_res2, ncol\}",
                     kernel)
    slot, entry = (_c_ternary(text, "PackMap", fn) for fn in ("slot",
                                                              "entry"))
    for n, quad in (sizes["row"], sizes["col"]):
        for e in range(n):
            if e >= quad or e % 4 < 2:
                s = trescan.short_slot(e, quad)
                assert (slot(e, quad), entry(s, quad)) == (s, e)
    if (n3, n4) == (1, 10):
        rs = trescan.short_slots(*sizes["row"])
        cs = trescan.short_slots(*sizes["col"])
        assert (rs, cs) == (193, 213)
        gram = open(os.path.join(os.path.dirname(CU), "gram_df.cuh")).read()
        c = {k: int(v) for k, v in re.findall(
            r"(kDfTM|kDfSK|kDfThreads|kDfBufs) = (\d+)", gram)}
        # a thread's CN = TN / 16 columns each keep nx residuals
        chains = eval(re.search(r"TN = (\d+), CN = TN / 16;", text).group(1)
                      + " // 16")
        assert chains == 2 and "CN * nx * kThreads" in launcher
        assert "__launch_bounds__(kThreads, 2)" in text
        # the residuals and the tile of results (minimum, flat index) lie
        # over the Gram tile's buffers (``scratch_bytes``): kDfBufs chunks
        # of kDfSK samples of 4 level planes (rows of 32 + 16 bytes) and 4
        # float planes (rows of 32 + 8 values)
        assert "scratch_bytes(nx) +" in launcher
        gram_bytes = c["kDfBufs"] * c["kDfSK"] * (4 * 48 + 4 * 4 * 40)
        after = 4 * (chains * nx * c["kDfThreads"] + 2 * 32 * 33)
        dyn = 4 * (rs * c["kDfTM"] + cs * 32
                   + trescan.vox_slots(sizes["vox"], nx)) \
            + max(gram_bytes, after)
        # no static arrays; 1 KB a block reserved
        assert "__shared__ float" not in text.replace(
            "extern __shared__", "")
        assert 2 * (dyn + 1024) <= 227 * 1024
