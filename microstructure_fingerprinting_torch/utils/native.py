"""On-demand compilation and ctypes bindings of the native host kernels.

The float64 candidate re-scoring of the general path (models/refine.py)
gathers rotated dictionary columns per candidate and forms their Gram
scalars on the host; ``csrc/mf_native.cpp`` does both (host C++, no
CUDA). It is compiled with ``g++ -O3 -fopenmp`` (without OpenMP when that
fails) at first use, into ``build/`` of the checkout or, where that
cannot be written, a per-user cache directory; the file name carries a
hash of the source, so an edit rebuilds it and a later process reuses
it. Without a working compiler ``available()`` is false and
models/refine.py takes its NumPy path, which gives the same numbers up
to rounding. The build or load is the span "build"
(``utils/profiling.stage``).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..ops.kernels import _writable
from .profiling import stage

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "mf_native.cpp")
#: build output: ``build/`` of the checkout that holds the package
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mf_torch_native")
#: build output where ``BUILD_DIR`` cannot be created or written
USER_BUILD_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                              "microstructure_fingerprinting_torch", "native")
#: compile commands in the order they are tried
CXX_CMDS = (("g++", "-O3", "-shared", "-fPIC", "-fopenmp"),
            ("g++", "-O3", "-shared", "-fPIC"))

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _so_name():
    with open(_SRC, "rb") as f:
        return "mf_native-%s.so" % hashlib.sha256(f.read()).hexdigest()[:16]


def build():
    """Path of the shared object, compiled unless one built from the same
    source is there; None when no compile command succeeds."""
    name = _so_name()
    for where in (BUILD_DIR, USER_BUILD_DIR):
        out = os.path.join(where, name)
        if os.path.exists(out):
            return out
    build_dir = BUILD_DIR if _writable(BUILD_DIR) else USER_BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, name)
    for cmd in CXX_CMDS:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            lib = os.path.join(tmp, name)
            try:
                subprocess.run(list(cmd) + ["-o", lib, _SRC], check=True,
                               capture_output=True, timeout=120)
            except (subprocess.SubprocessError, OSError):
                continue
            os.replace(lib, out)
            return out
    return None


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        with stage("build"):
            path = build()
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                return None
        i64 = ctypes.c_int64
        dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.interp_columns_f64.argtypes = [dp, ip, dp, dp, ip, ip, dp, dp,
                                           ip, i64, i64, i64, i64, i64, i64,
                                           dp]
        lib.interp_columns_f64.restype = None
        lib.candidate_grams_f64.argtypes = [dp, dp, i64, i64, i64, i64,
                                            dp, dp]
        lib.candidate_grams_f64.restype = None
        _LIB = lib
        return _LIB


def available():
    """Whether the native kernels are built and loaded (built on the
    first call)."""
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host helper (csrc/mf_native.cpp) "
                           "could not be built or loaded")
    return lib


def interp_columns_f64(xs, cnt, ys, gdir, lo, hi, wg, newdir, atom_ids,
                       out=None):
    """Native rotated-column interpolation; see mf_native.cpp.
    Returns (B, M, Nseq) candidate-major columns (written into ``out``
    when given, avoiding a copy)."""
    lib = _lib()
    B, M = atom_ids.shape
    Nseq = gdir.shape[0]
    S, Kmax, N = ys.shape
    if atom_ids.size and not 0 <= np.min(atom_ids) <= np.max(atom_ids) < N:
        raise ValueError("atom ids outside [0, %d)" % N)
    if out is None:
        out = np.empty((B, M, Nseq), dtype=np.float64)
    if (out.dtype != np.float64 or not out.flags["C_CONTIGUOUS"]
            or out.shape != (B, M, Nseq)):
        raise ValueError("out must be a C-contiguous float64 (%d, %d, %d) "
                         "array" % (B, M, Nseq))
    lib.interp_columns_f64(
        np.ascontiguousarray(xs, np.float64),
        np.ascontiguousarray(cnt, np.int32),
        np.ascontiguousarray(ys, np.float64),
        np.ascontiguousarray(gdir, np.float64),
        np.ascontiguousarray(lo, np.int32),
        np.ascontiguousarray(hi, np.int32),
        np.ascontiguousarray(wg, np.float64),
        np.ascontiguousarray(newdir, np.float64),
        np.ascontiguousarray(atom_ids, np.int32),
        B, Nseq, S, Kmax, N, M, out)
    return out


def candidate_grams_f64(cols, y):
    """Native per-candidate Gram scalars: cols (C, B, M, Nseq), y (B, Nseq)
    -> (G (C, C, B, M), Y (C, B, M))."""
    lib = _lib()
    C, B, M, Nseq = cols.shape
    if y.shape != (B, Nseq):
        raise ValueError("y must be (%d, %d), got %s" % (B, Nseq, y.shape))
    G = np.empty((C, C, B, M), dtype=np.float64)
    Yv = np.empty((C, B, M), dtype=np.float64)
    lib.candidate_grams_f64(np.ascontiguousarray(cols, np.float64),
                            np.ascontiguousarray(y, np.float64),
                            C, B, Nseq, M, G, Yv)
    return G, Yv
