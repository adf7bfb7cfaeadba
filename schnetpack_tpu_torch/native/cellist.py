"""The native linked-cell neighbor list (port of
``schnetpack_tpu/native/cellist.py``).

``cellist.cpp`` (a copy of the JAX package's source) is compiled with g++
at first use into ``schnetpack_tpu_torch/_build/``, named by a hash of the
source and the flags, so an edited source rebuilds; a file lock keeps
concurrent processes (test workers) from building it twice.  It is built
without ``-march=native``, so a library built on one host CPU loads on
another.  Nothing is built at import time.

There is no silent fallback: a failed build or load raises
``NativeBuildError`` with the compiler's output.  A geometry the C++ list
does not take (a periodic cell under 3 cutoffs high, or a singular cell)
raises ``UnsupportedGeometry``, on which the caller takes the brute force
(``transform/neighborlist.py::cell_list_neighbor_list``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.locking import file_lock

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "cellist.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
#: the C++ list's return code for a geometry it does not take
UNSUPPORTED = -1_000_000_000

_I32 = ctypes.POINTER(ctypes.c_int32)
_F64 = ctypes.POINTER(ctypes.c_double)
#: loaded libraries by path
_LIBS: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The native cell list could not be compiled or loaded."""


class UnsupportedGeometry(ValueError):
    """A periodic cell under 3 cutoffs high (or a singular cell)."""


def library_path(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Where the library of ``source`` is built: named by a hash of the
    source and the compiler flags."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libcellist_{h.hexdigest()[:12]}.so")


def build(source: str = SOURCE, build_dir: str = BUILD_DIR,
          compiler: str = "g++") -> str:
    """Compile ``source`` unless its library exists; returns its path.
    Raises ``NativeBuildError`` with the compiler's stderr on failure."""
    so = library_path(source, build_dir)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    with file_lock(so + ".lock"):
        if os.path.exists(so):
            return so
        exe = shutil.which(compiler)
        if exe is None:
            raise NativeBuildError(
                f"cannot build the native cell list: {compiler!r} not found")
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            res = subprocess.run([exe, *GXX_FLAGS, source, "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"cannot build the native cell list from {source}: {e}"
            ) from e
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise NativeBuildError(
                f"{compiler} failed ({res.returncode}) on {source}:\n"
                f"{res.stderr}")
        os.replace(tmp, so)
    return so


def load(source: str = SOURCE, build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library (built on first call), argument types set as in
    ``schnetpack_tpu/native/cellist.py:61-67``."""
    so = build(source, build_dir)
    lib = _LIBS.get(so)
    if lib is None:
        try:
            lib = ctypes.CDLL(so)
            fn = lib.cellist_neighbor_list
        except (OSError, AttributeError) as e:
            raise NativeBuildError(
                f"cannot load the native cell list {so}: {e}") from e
        fn.restype = ctypes.c_longlong
        fn.argtypes = [_F64, ctypes.c_longlong, _F64,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_double,
                       ctypes.c_longlong, _I32, _I32, _I32]
        _LIBS[so] = lib
    return lib


def neighbor_list(positions: np.ndarray, cutoff: float,
                  cell: Optional[np.ndarray] = None,
                  pbc: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full neighbor list ``(idx_i, idx_j, S)`` (int64) with ``Rij = R[j] +
    S @ cell - R[i]`` and ``|Rij| < cutoff``, sorted by (i, j, S).  A cell
    is periodic along the axes where ``pbc`` is set (none without a
    cell)."""
    R = np.ascontiguousarray(positions, dtype=np.float64).reshape(-1, 3)
    n = len(R)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros((0, 3), np.int64)
    periodic = (cell is not None and pbc is not None
                and bool(np.asarray(pbc).any()))
    C = np.ascontiguousarray(cell, np.float64) if periodic else None
    Pb = (np.ascontiguousarray(np.asarray(pbc, bool).astype(np.uint8))
          if periodic else None)
    fn = load().cellist_neighbor_list
    # a guess for a homogeneous density; on overflow the C++ list returns
    # minus the count it needs (``schnetpack_tpu/native/cellist.py:93-115``)
    max_pairs = max(1024, n * 64)
    for _ in range(4):
        idx_i = np.empty(max_pairs, np.int32)
        idx_j = np.empty(max_pairs, np.int32)
        shifts = np.empty((max_pairs, 3), np.int32)
        rc = fn(R.ctypes.data_as(_F64), n,
                C.ctypes.data_as(_F64) if C is not None else None,
                (Pb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                 if Pb is not None else None),
                float(cutoff), max_pairs, idx_i.ctypes.data_as(_I32),
                idx_j.ctypes.data_as(_I32), shifts.ctypes.data_as(_I32))
        if rc == UNSUPPORTED:
            raise UnsupportedGeometry(
                "cell narrower than 3 cutoffs (or singular)")
        if rc >= 0:
            ii, jj, S = idx_i[:rc], idx_j[:rc], shifts[:rc]
            order = np.lexsort((S[:, 2], S[:, 1], S[:, 0], jj, ii))
            return (ii[order].astype(np.int64), jj[order].astype(np.int64),
                    S[order].astype(np.int64))
        max_pairs = int(-rc) + 1024
    raise RuntimeError("native cell list: pair count retry limit exceeded")
