"""Trial builds for the probes (``df2_probe``, ``hoist_probe``,
``finalize_probe``): a kernel's shipped sources changed by text cuts,
each build compiled into a library of its own apart from the fit's and
swapped in where the wrappers look their entry points up
(``kernels._lib``), then held bit for bit against the shipped build and
timed.

A cut is ``(file, marks, function)``: the texts ``marks`` the file must
hold, and the function that changes the file's text (``swap``, ``span``).
"""

import ctypes
import os
import subprocess

import torch

from ..ops import kernels


def swap(file, old, new):
    """A cut: the text ``old`` of ``file`` becomes ``new``."""
    return file, (old,), lambda src: src.replace(old, new)


def span(file, begin, end, new):
    """A cut: the text of ``file`` from ``begin`` up to (not including)
    ``end`` becomes ``new``."""
    def cut(src):
        i = src.index(begin) + len(begin)
        return src[:i] + new + src[src.index(end, i):]
    return file, (begin, end), cut


def sources(probe, files, cuts):
    """The text of each build, {build: {file: text}}: ``files`` as read
    from ``csrc/``, changed by the build's cuts (``cuts``: {build: [cut]}).
    Raises where a shipped file no longer holds the text a cut needs."""
    shipped = {}
    for f in files:
        with open(os.path.join(kernels._CSRC, f)) as fh:
            shipped[f] = fh.read()
    out = {}
    for name, build in cuts.items():
        src = dict(shipped)
        for f, marks, cut in build:
            if not all(m in src[f] for m in marks):
                raise RuntimeError("%s: %s no longer holds the text its cut "
                                   "%r replaces" % (probe, f, name))
            src[f] = cut(src[f])
        out[name] = src
    return out


def compile_all(probe, where, builds):
    """Each build ({build: {file: text}}) written into a directory of its
    own under ``where`` and its ``.cu`` files compiled into one library
    with the fit's flags, every nvcc at once. Returns ({build: library
    path}, {build: nvcc's output, ptxas's lines included})."""
    nvcc = kernels._nvcc()
    cmds, libs = [], {}
    for i, (name, src) in enumerate(builds.items()):
        d = os.path.join(where, "b%d" % i)
        os.makedirs(d)
        for f, text in src.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        libs[name] = os.path.join(d, "lib.so")
        cmds.append([nvcc] + list(kernels.NVCC_FLAGS) + [
            "-shared", "-I", kernels._CSRC, "-o", libs[name]] + [
            os.path.join(d, f) for f in src if f.endswith(".cu")])
    outs = {}
    for (rc, out), name in zip(kernels._run_all(cmds), libs):
        if rc:
            raise RuntimeError("%s: nvcc failed:\n%s" % (probe, out))
        outs[name] = out
    return libs, outs


def bind(path, keys):
    """The library at ``path`` with the C entry points of the wrappers
    ``keys`` (names in ``kernels._SIGNATURES``) typed, fit to stand in
    for ``kernels._lib``."""
    lib = ctypes.CDLL(path)
    for key in keys:
        cname, kinds = kernels._SIGNATURES[key]
        fn = getattr(lib, cname)
        fn.argtypes = [kernels._CTYPES[k] for k in kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def same(a, b):
    """Whether two outputs are equal bit for bit (float32 as its bits, so
    NaN payloads and zeros' signs count)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def ms(fn, reps):
    """Milliseconds a call of ``fn()`` by CUDA events, mean of ``reps``
    warm calls."""
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


def card():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    "not read"."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else "not read"
