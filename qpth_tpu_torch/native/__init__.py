"""Native (C++) runtime components (counterpart of
``qpth_tpu/native/__init__.py``).

``qp_oracle.cpp``: a dependency-free dense float64 IPM oracle, the C++ twin
of ``solvers/oracle.py``. It is compiled on first use with the system's
C++ compiler into ``build/qpth_tpu_torch/`` beside the package, the library
named after a hash of the source, the flags and the host, and loaded with
ctypes (no pybind11, no PyTorch headers). ``QPSolvers.CPU_ORACLE`` solves
through it where it builds; escalation keeps the numpy oracle, as in the
JAX package.

Concurrent first uses (test workers, the ranks of a process group) may
build at once: each compiles to a name of its own and ``os.replace``-s the
result into place, so no process loads a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "qp_oracle.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "qpth_tpu_torch"
#: The JAX package's flags, OpenMP first: the batch loop runs across cores.
FLAG_SETS = (("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
             ("-O3", "-march=native", "-shared", "-fPIC"))
COMPILERS = ("g++", "c++", "clang++")
_lock = threading.Lock()
_lib = None
_build_error: str | None = None
#: (compiler, flags) of the loaded library.
built_with: tuple | None = None


def _lib_path(cxx: str, flags) -> Path:
    # -march=native ties the library to the host: its name carries the
    # host's name too.
    h = hashlib.sha256(" ".join((cxx, platform.node(), platform.machine())
                                + tuple(flags)).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libqp_oracle_{h.hexdigest()[:16]}.so"


def _build():
    """Build (or find) the library; returns (path, compiler, flags) or an
    error string."""
    err = "no C++ compiler found"
    for flags in FLAG_SETS:
        for cxx in COMPILERS:
            out = _lib_path(cxx, flags)
            if out.exists():
                return out, cxx, flags
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                  ".tmp")
            try:
                r = subprocess.run([cxx, *flags, "-o", str(tmp), str(_SRC)],
                                   capture_output=True, text=True,
                                   timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                err = str(e)
                continue
            if r.returncode == 0:
                os.replace(tmp, out)
                return out, cxx, flags
            tmp.unlink(missing_ok=True)
            err = r.stderr
    return err


def _load():
    global _lib, _build_error, built_with
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        res = _build()
        if isinstance(res, str):
            _build_error = res
            return None
        path, cxx, flags = res
        lib = ctypes.CDLL(str(path))
        lib.qp_solve_batch_status.restype = ctypes.c_int
        lib.qp_solve_batch_status.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_double)] * 6
            + [ctypes.c_double, ctypes.c_int]
            + [ctypes.POINTER(ctypes.c_double)] * 4
            + [ctypes.POINTER(ctypes.c_int)])
        _lib, built_with = lib, (cxx, flags)
    return _lib


def is_available() -> bool:
    """Whether the library builds (or was built) and loads."""
    return _load() is not None


def build_error() -> str | None:
    """The compiler's message where the build failed, else None."""
    _load()
    return _build_error


def solve_qp_batch_native(Q, p, G, h, A=None, b=None, tol=1e-11,
                          max_iter=100, return_status: bool = False):
    """Batched native solve (numpy float64 in and out). Matrix parameters
    may have batch 1 (shared) or B; p, h, b are (B, .). Returns
    (x, nu, lam, s), or with ``return_status=True`` (x, nu, lam, s,
    status) with status per lane (0 converged, 1 max_iter best effort, -1
    numerical failure). Failed lanes come back NaN-filled; healthy lanes
    are unaffected. Raises ``RuntimeError`` if the library does not
    build."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native oracle did not build:\n"
                           f"{_build_error}")
    p = np.ascontiguousarray(np.atleast_2d(np.asarray(p, np.float64)))
    B, n = p.shape

    def canon(M):
        M = np.asarray(M, np.float64)
        return np.ascontiguousarray(M[None] if M.ndim == 2 else M)

    Q = canon(Q)
    G = canon(G)
    m = G.shape[-2]
    h = np.ascontiguousarray(
        np.broadcast_to(np.atleast_2d(np.asarray(h, np.float64)), (B, m)))
    if A is not None and np.size(A) > 0:
        A = canon(A)
        neq = A.shape[-2]
        b = np.ascontiguousarray(
            np.broadcast_to(np.atleast_2d(np.asarray(b, np.float64)),
                            (B, neq)))
    else:
        neq = 0
        A = np.zeros((1, 0, n))
        b = np.zeros((B, 0))

    x = np.empty((B, n))
    y = np.empty((B, max(neq, 1)))
    lam = np.empty((B, m))
    s = np.empty((B, m))
    status = np.empty((B,), dtype=np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.qp_solve_batch_status(
        B, n, m, neq, Q.shape[0], G.shape[0], A.shape[0],
        ptr(Q), ptr(p), ptr(G), ptr(h), ptr(A), ptr(b),
        ctypes.c_double(tol), int(max_iter),
        ptr(x), ptr(y), ptr(lam), ptr(s),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    out = (x, y[:, :neq], lam, s)
    return out + (status,) if return_status else out
