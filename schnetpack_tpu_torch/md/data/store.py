"""The trajectory file that ``FileLogger`` writes and ``HDF5Loader`` reads.

Both go through one small store with the JAX package's layout
(``callback_hooks.py:42-130``): groups ``molecules`` and ``properties``,
each with attrs and datasets that grow along their first axis.

* ``H5Store``, where ``h5py`` is importable: an HDF5 file, written as the
  JAX ``FileLogger`` writes it, so the JAX ``HDF5Loader`` reads it.
* ``NpyStore``, without ``h5py``: a directory at the same path holding
  ``<group>/<name>.npy`` files, appended in place (a fixed 256-byte
  header whose shape is rewritten after each append, so ``numpy.load``
  reads them), and ``attrs.json``.

Which one is written is a choice of file format by installation;
``open_store(path, "r")`` reads either, by whether ``path`` is a
directory.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

GROUPS = ("molecules", "properties")


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def open_store(path: str, mode: str):
    """The store at ``path``: ``mode`` "r" reads, "w" creates (replacing a
    file), "a" appends to an existing store (or creates one).  An existing
    store keeps its format; a new one is HDF5 where ``h5py`` is
    importable."""
    exists = os.path.exists(path)
    if mode == "r":
        if not exists:
            raise FileNotFoundError(path)
        return NpyStore(path, mode) if os.path.isdir(path) else H5Store(
            path, mode)
    if mode == "a" and exists:
        return NpyStore(path, mode) if os.path.isdir(path) else H5Store(
            path, mode)
    return H5Store(path, "w") if h5py_available() else NpyStore(path, "w")


class H5Store:
    kind = "hdf5"

    def __init__(self, path: str, mode: str):
        import h5py

        self.path = path
        self._f = h5py.File(path, mode, libver="latest")

    def has_group(self, group: str) -> bool:
        return group in self._f

    def create_group(self, group: str, attrs: Dict[str, Any]) -> None:
        g = self._f.create_group(group)
        for k, v in attrs.items():
            g.attrs[k] = v

    def attrs(self, group: str) -> Dict[str, Any]:
        return dict(self._f[group].attrs)

    def keys(self, group: str) -> List[str]:
        return list(self._f[group].keys())

    def shape(self, group: str, name: str) -> Tuple[int, ...]:
        return tuple(self._f[f"{group}/{name}"].shape)

    def read(self, group: str, name: str, start: int = 0) -> np.ndarray:
        return self._f[f"{group}/{name}"][start:]

    def append(self, group: str, name: str, data: np.ndarray) -> None:
        g = self._f[group]
        if name not in g:
            g.create_dataset(name, data=data,
                             maxshape=(None,) + data.shape[1:],
                             chunks=(max(min(len(data), 128), 1),)
                             + data.shape[1:])
        else:
            ds = g[name]
            n0 = ds.shape[0]
            ds.resize(n0 + data.shape[0], axis=0)
            ds[n0:] = data

    def start_swmr(self) -> None:
        try:
            self._f.swmr_mode = True
        except Exception:       # an older HDF5 library: no readers while open
            pass

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


_NPY_HEADER = 256        # bytes: magic, version, length and the padded dict


def _npy_header(dtype: np.dtype, shape: Tuple[int, ...]) -> bytes:
    d = repr({"descr": np.lib.format.dtype_to_descr(dtype),
              "fortran_order": False, "shape": tuple(shape)})
    n = _NPY_HEADER - 10
    if len(d) + 1 > n:
        raise ValueError(f"shape {shape} does not fit the npy header")
    return (b"\x93NUMPY\x01\x00" + n.to_bytes(2, "little")
            + (d.ljust(n - 1) + "\n").encode("latin1"))


def _json_attr(v):
    if isinstance(v, np.ndarray):
        return {"array": v.tolist(), "dtype": v.dtype.str}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _attr_of_json(v):
    if isinstance(v, dict) and "array" in v:
        return np.asarray(v["array"], dtype=np.dtype(v["dtype"]))
    return v


class NpyStore:
    kind = "npy"

    def __init__(self, path: str, mode: str):
        self.path = path
        self._writable = mode != "r"
        self._attrs_file = os.path.join(path, "attrs.json")
        if mode == "w":
            if os.path.isfile(path):
                os.remove(path)
            os.makedirs(path, exist_ok=True)
            for g in GROUPS:
                gd = os.path.join(path, g)
                if os.path.isdir(gd):
                    for f in os.listdir(gd):
                        os.remove(os.path.join(gd, f))
            self._attrs: Dict[str, Dict[str, Any]] = {}
            self.flush()
        else:
            with open(self._attrs_file) as f:
                self._attrs = json.load(f)

    def _file(self, group: str, name: str) -> str:
        return os.path.join(self.path, group, f"{name}.npy")

    def has_group(self, group: str) -> bool:
        return group in self._attrs

    def create_group(self, group: str, attrs: Dict[str, Any]) -> None:
        os.makedirs(os.path.join(self.path, group), exist_ok=True)
        self._attrs[group] = {k: _json_attr(v) for k, v in attrs.items()}

    def attrs(self, group: str) -> Dict[str, Any]:
        return {k: _attr_of_json(v) for k, v in self._attrs[group].items()}

    def keys(self, group: str) -> List[str]:
        gd = os.path.join(self.path, group)
        return sorted(f[:-4] for f in os.listdir(gd) if f.endswith(".npy"))

    def _open(self, group: str, name: str) -> np.ndarray:
        path = self._file(group, name)
        if not os.path.exists(path):
            raise KeyError(f"{group}/{name}")
        return np.load(path, mmap_mode="r")

    def shape(self, group: str, name: str) -> Tuple[int, ...]:
        return tuple(self._open(group, name).shape)

    def read(self, group: str, name: str, start: int = 0) -> np.ndarray:
        return np.array(self._open(group, name)[start:])

    def append(self, group: str, name: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        path = self._file(group, name)
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(_npy_header(data.dtype, data.shape))
                f.write(data.tobytes())
            return
        with open(path, "r+b") as f:
            np.lib.format.read_magic(f)
            shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            if dtype != data.dtype or tuple(shape[1:]) != data.shape[1:]:
                raise ValueError(f"{group}/{name}: cannot append "
                                 f"{data.dtype}{data.shape} to {shape}")
            f.seek(0, os.SEEK_END)
            f.write(data.tobytes())
            f.seek(0)
            f.write(_npy_header(data.dtype,
                                (shape[0] + data.shape[0],) + data.shape[1:]))

    def start_swmr(self) -> None:
        pass

    def flush(self) -> None:
        with open(self._attrs_file, "w") as f:
            json.dump(self._attrs, f)

    def close(self) -> None:
        if self._writable:
            self.flush()
