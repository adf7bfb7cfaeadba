"""Build and load the port's CUDA kernels.

The sources in ``schnetpack_tpu_torch/csrc/*.cu`` expose a plain C
interface.  On first use each is compiled with its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
one shared library under ``schnetpack_tpu_torch/_build/`` (named by a hash
of the sources, so an edited source rebuilds), which is loaded with
``ctypes``.  Pointers are passed as ``data_ptr()``; every entry
point launches on the given stream and returns ``cudaGetLastError()``.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argument types of each C entry point (pointers, ints, floats, stream)
SIGNATURES = {
    "spk_msg_fwd": [_P] * 12 + [_I] * 4 + [_P] + [_I] * 3 + [_F, _P],
    "spk_msg_bwd": [_P] * 12 + [_P] * 5 + [_I] * 4 + [_P] + [_I] * 3
                   + [_F, _P],
    "spk_geo_fwd": [_P] * 6 + [_I] * 4 + [_P] + [_I] * 3 + [_F, _P],
    "spk_geo_bwd": [_P] * 8 + [_I] * 4 + [_P] + [_I, _F, _P],
    "spk_cf_fwd": [_P] * 11 + [_I] * 4 + [_P] + [_I, _I, _P],
    "spk_cf_bwd": [_P] * 14 + [_I] * 4 + [_P] + [_I, _I, _P],
    "spk_msg_fwd_geo": [_P] * 10 + [_I] * 4 + [_P] + [_I] * 4 + [_P],
    "spk_msg_bwd_geores": [_P] * 16 + [_I] * 4 + [_P] + [_I] * 4
                          + [_F, _P],
    "spk_msg_bwd_src": [_P] * 14 + [_I] * 4 + [_P] + [_I] * 4 + [_P],
    "spk_msg_fwd_edge": [_P] * 10 + [_I] * 4 + [_P] + [_I] * 5 + [_P],
    "spk_msg_bwd_edge": [_P] * 14 + [_I] * 4 + [_P] + [_I] * 4 + [_P],
    "spk_mix_fwd": [_P] * 9 + [_P, _P] + [_I, _I, _F, _I, _P],
    "spk_mix_bwd": [_P] * 14 + [_P] * 4 + [_I] * 3 + [_F, _I, _P],
    "spk_gather_fwd": [_P] * 4 + [_I, _P],
    "spk_expand_fwd": [_P] * 4 + [_I, _P],
    "spk_gather_bwd": [_P] * 4 + [_I, _I, _P],
    "spk_fold_fwd": [_P] * 3 + [_I] * 5 + [_P],
    "spk_cell_gather_fwd": [_P] * 3 + [_I] * 6 + [_P],
    "spk_cell_gather_bwd": [_P] * 4 + [_I, _I, _P],
    "spk_cell_msg_fwd": [_P] * 7 + [_I] * 7 + [_P],
    "spk_cell_msg_bwd": [_P] * 13 + [_I] * 7 + [_P],
}
#: host queries: argument types (ints), no stream
QUERIES = {
    "spk_msg_fwd_blocks": [_I] * 4,
    "spk_msg_bwd_blocks": [_I] * 4,
}

_LIB = None
#: the entry points of the loaded library, argument types set
_ENTRIES = {}
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
#: ptxas's report (-v: registers, stack frame, spills of every kernel) of
#: the last build, per source file name (empty when nothing was built)
build_log = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns the library path."""
    global build_seconds
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libspk_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        build_seconds = 0.0
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    errors = []
    build_log.clear()
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        build_log[os.path.basename(src)] = err
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                          f"{err}")
    if not errors:
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in {**SIGNATURES, **QUERIES}.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _ENTRIES[name] = fn
        _LIB = handle
    return _LIB


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the current stream; raise on a launch
    error (a refused launch never runs and a later synchronize would not
    report it)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        lib()
        fn = _ENTRIES[name]
    # the current stream's raw handle, as Triton's launcher reads it:
    # ``torch.cuda.current_stream()`` builds a Stream object on every call
    err = fn(*args, torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice()))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def query(name: str, *args) -> int:
    """Call host query ``name`` (no launch, no stream) and return its int."""
    lib()
    return int(_ENTRIES[name](*args))


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given shape
    and type (what the kernels take)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
