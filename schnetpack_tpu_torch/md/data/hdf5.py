"""Trajectory loading from ``FileLogger``'s output (parity:
``schnetpack_tpu/md/data/hdf5.py``): the ``molecules`` and
``properties`` groups, velocities and temperature, and structure dicts
per frame.  It reads an HDF5 file (the JAX package's or the port's) or
the port's ``.npy`` store (``store.py``) alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ... import properties as structure
from ...units import md_units
from .store import open_store

MOLECULE_KEYS = ("positions", "momenta", "forces", "cells")


class HDF5Loader:
    def __init__(self, hdf5_file: str, skip_initial: int = 0,
                 load_properties: bool = True):
        self.filename = hdf5_file
        self._store = open_store(hdf5_file, "r")
        attrs = self._store.attrs("molecules")
        self.time_step = float(attrs["time_step"])      # MD units
        self.n_replicas = int(attrs["n_replicas"])
        self.n_molecules = int(attrs["n_molecules"])
        self.total_atoms = int(attrs["total_atoms"])
        self.masses = np.asarray(attrs["masses"])
        self.atomic_numbers = np.asarray(attrs["atomic_numbers"])
        self.idx_m = np.asarray(attrs["idx_m"])
        self.pbc = np.asarray(attrs["pbc"])
        self.skip = skip_initial
        self.entries = (self._store.shape("molecules", "positions")[0]
                        - skip_initial)

    def get(self, name: str, mol_idx: Optional[int] = None,
            replica_idx: Optional[int] = None,
            atomistic: Optional[bool] = None) -> np.ndarray:
        """A logged dataset [T, R, ...] from ``skip_initial`` on, averaged
        over the replicas unless ``replica_idx`` picks one; ``mol_idx``
        selects a molecule's atoms or entry."""
        if name == "velocities":
            data = (self._store.read("molecules", "momenta", self.skip)
                    / self.masses[None, None, :, None])
        else:
            group = "molecules" if name in MOLECULE_KEYS else "properties"
            data = self._store.read(group, name, self.skip)
        if (replica_idx is None and data.ndim > 1
                and data.shape[1] == self.n_replicas):
            data = data.mean(axis=1)
        elif replica_idx is not None:
            data = data[:, replica_idx]
        if mol_idx is not None and data.ndim > 1:
            if data.shape[1] == self.total_atoms:
                data = data[:, self.idx_m == mol_idx]
            elif data.shape[1] == self.n_molecules:
                data = data[:, mol_idx]
        return data

    @property
    def properties(self) -> List[str]:
        return (self._store.keys("properties") + ["velocities"]
                + self._store.keys("molecules"))

    def get_temperature(self) -> np.ndarray:
        return self.get("temperature")

    def convert_to_atoms(self, frame: int,
                         replica_idx: Optional[int] = None) -> Dict:
        """One frame as a structure dict in Angstrom."""
        conv = 1.0 / md_units().length
        pos = self.get("positions", replica_idx=replica_idx)[frame]
        out = {
            structure.Z: self.atomic_numbers,
            structure.R: pos * conv,
            structure.pbc: self.pbc[0] if self.pbc.ndim > 1 else self.pbc,
        }
        try:
            cells = self.get("cells", replica_idx=replica_idx)[frame]
            out[structure.cell] = cells[0] * conv
        except KeyError:
            out[structure.cell] = np.zeros((3, 3))
        return out

    def close(self):
        self._store.close()
