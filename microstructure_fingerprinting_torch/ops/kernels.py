"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

The CUDA sources are compiled at first use by ``nvcc`` for ``sm_90a``
(one nvcc per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: the build takes seconds), in ``build/`` of the checkout or,
where that cannot be written, in a per-user cache directory. The
library's file name carries a
hash of the sources, the headers and the flags, so a later process
reuses it and an edit rebuilds it; the library is linked under a
temporary name and renamed into place, so processes that build at once
never load a half-written file. Each C entry point takes
device pointers, sizes and the CUDA stream, launches on that stream and
returns ``cudaGetLastError()``; ``launch`` raises when it is not 0.

Floating-point flags are part of the numerics, not tuning:
``--fmad=false`` (a contracted ``a*b + c`` breaks the Dekker transforms),
``-prec-div=true -prec-sqrt=true -ftz=false`` (the guards compare against
``EPS*d`` and 1e-12; flushed denormals or approximate divides move them),
and no ``--use_fast_math``.

``LAUNCHES`` counts, per kernel, what the card runs: the launches made
through ``launch`` and, for a CUDA graph (``models/graphs.py``), the
launches its capture recorded, once each replay. Inside ``recorded()``
(a capture, or its warm-up) a launch is kept apart instead of counted.
Each launch is its own span (``utils.profiling.stage``) "kernel <name>",
inside the fit path's span that holds it: under a ``StageTimer`` a stage
so splits into its kernel and the torch code around it. The build or
load of the library is the span "build". Importing this module needs
neither ``nvcc`` nor a GPU.
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import torch

from ..utils.profiling import stage

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
#: build output: ``build/`` of the checkout that holds the package
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)),
                         "build", "mf_torch_kernels")
#: build output where ``BUILD_DIR`` cannot be created or written (an
#: installed package, a read-only checkout): a per-user cache directory
USER_BUILD_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                              "microstructure_fingerprinting_torch",
                              "kernels")
SOURCES = ("prep.cu", "rowmin3.cu", "rescan3.cu", "rowmin4.cu",
           "rescan4.cu", "df2scan.cu", "finalize.cu", "df4hoist.cu",
           "df2hoist.cu", "df3hoist.cu", "row4hoist.cu", "row3hoist.cu",
           "rhsprep.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# C entry point -> argument kinds: "p" device pointer (None -> NULL),
# "i" int, "f" float; every entry point takes the stream last
_SIGNATURES = {
    "prep_block": ("mf_prep_block", "ppppppppp" + "iiiii"),
    "rowmin3": ("mf_rowmin3", "ppppppppppp" + "iiiiiiii"),
    "rescan3": ("mf_rescan3", "ppppppppppppp" + "iiiii" + "f"),
    "rowmin4": ("mf_rowmin4", "ppppppppppp" + "iiiiiiiiiiiiii"),
    "rescan4": ("mf_rescan4", "ppppppppppppp" + "iiiiiiiiii" + "f"),
    "df2scan": ("mf_df2scan", "ppppppppppppp" + "iiiiii"),
    "finalize": ("mf_finalize", "p" * 9 + "i" * 16 + "f"),
    "df4hoist": ("mf_df4hoist", "p" * 17 + "i" * 9 + "f"),
    "df2hoist": ("mf_df2hoist", "p" * 15 + "i" * 5),
    "df3hoist": ("mf_df3hoist", "p" * 15 + "i" * 5),
    "row4hoist": ("mf_row4hoist", "p" * 12 + "i" * 9 + "fff"),
    "row3hoist": ("mf_row3hoist", "p" * 11 + "i" * 4 + "ff"),
    "rhsprep": ("mf_rhsprep", "p" * 10 + "i" * 7),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

LAUNCHES = {name: 0 for name in _SIGNATURES}
BUILD_INFO = {}
_lib = None
_RECORDING = []


def reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recorded():
    """Launches made inside go to the yielded dict (kernel -> count),
    not to ``LAUNCHES``: a graph's capture, whose launches count at each
    replay, and its warm-up."""
    rec = {name: 0 for name in _SIGNATURES}
    _RECORDING.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.remove(rec)


def add_counts(counts):
    """Add a replayed graph's launches (kernel -> count) to LAUNCHES."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _count(name):
    (_RECORDING[-1] if _RECORDING else LAUNCHES)[name] += 1


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (CUDA_HOME unset): "
                           "cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_key():
    """Hash of the flags and every ``.cu``/``.cuh`` file under csrc/."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at once; returns [(returncode, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _writable(path):
    """Whether ``path`` is, or can be made, a directory that takes a new
    file (tried, not asked: permission bits do not bind every user)."""
    try:
        os.makedirs(path, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            return True
    except OSError:
        return False


def build():
    """Path of the shared library; compiles it unless a library built
    from the same sources and flags is already there. Each source is
    compiled by its own nvcc, all at once, then the objects are linked.
    The library lives in ``BUILD_DIR``, or in ``USER_BUILD_DIR`` when the
    former cannot be created or written."""
    name = "libmfkernels-%s.so" % _source_key()
    for where in (BUILD_DIR, USER_BUILD_DIR):
        out = os.path.join(where, name)
        if os.path.exists(out):
            BUILD_INFO.update(seconds=0.0, cached=True, cmd=out, log="")
            return out
    build_dir = BUILD_DIR if _writable(BUILD_DIR) else USER_BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, name)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        cmds = [[nvcc] + list(NVCC_FLAGS) + ["-I", _CSRC, "-c", "-o", o,
                                             os.path.join(_CSRC, src)]
                for src, o in zip(SOURCES, objs)]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", lib] + objs
        results = _run_all(cmds)
        if all(rc == 0 for rc, _ in results):
            results += _run_all([link])
        log = "".join(o for _, o in results)
        BUILD_INFO.update(seconds=time.time() - t0, cached=False,
                          cmd=" && ".join(" ".join(c) for c in cmds + [link]),
                          log=log)
        bad = [rc for rc, _ in results if rc != 0]
        if bad:
            raise RuntimeError("nvcc failed (exit %d):\n%s" % (bad[0], log))
        os.replace(lib, out)
    return out


def library():
    """The loaded kernel library, built on first use in this process."""
    global _lib
    if _lib is None:
        with stage("build"):
            lib = ctypes.CDLL(build())
            for name, (cname, kinds) in _SIGNATURES.items():
                fn = getattr(lib, cname)
                fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t, dtype, shape, name):
    """Validate a kernel operand: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def operand_device(args):
    """The one device of the tensors among ``args``; raises when they
    span devices (a launch runs on one card) or there is none."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError("kernel operands must lie on one device, got %s"
                         % sorted(str(d) for d in devs))
    return devs.pop()


def launch(name, *args):
    """Launch kernel ``name`` on the current stream of its operands'
    device, with that device current (the launchers run on the calling
    thread's current device); raises on a launch error or on operands
    that span devices, and counts the launch."""
    cname, kinds = _SIGNATURES[name]
    if len(args) != len(kinds):
        raise TypeError("%s takes %d arguments" % (name, len(kinds)))
    dev = operand_device(args)
    conv = []
    for kind, a in zip(kinds, args):
        if kind == "p":
            conv.append(None if a is None else a.data_ptr())
        else:
            conv.append(int(a) if kind == "i" else float(a))
    fn = getattr(library(), cname)
    with torch.cuda.device(dev), stage("kernel " + name, dev):
        err = fn(*conv, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))
    _count(name)
