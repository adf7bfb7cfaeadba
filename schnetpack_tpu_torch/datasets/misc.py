"""The remaining benchmark dataset modules (a copy of
``schnetpack_tpu/datasets/misc.py``).

Parity: ``src/schnetpack/datasets/{iso17,ani1,qm7x,materials_project,omdb,
tmqm}.py``.  Each converts its raw distribution format into the common ASE
DB on first setup, from raw files placed in ``raw_dir``: the port never
downloads (``DownloadableDataModule._fetch``).  ``h5py`` (ANI-1, QM7-X)
and ``pymatgen`` (Materials Project) are imported inside the converters
that read them.
"""
from __future__ import annotations

import os
import tarfile
from typing import Optional, Sequence

import numpy as np

from ..data.atoms import ASEAtomsData
from .base import DownloadableDataModule


class ISO17(DownloadableDataModule):
    """ISO17: C7O2H10 isomer MD trajectories (ships as ASE DBs already).

    Parity: ``datasets/iso17.py``."""

    download_url = "http://quantum-machine.org/datasets/iso17.tar.gz"
    folds = [
        "reference", "reference_eq", "test_within", "test_other", "test_eq",
    ]

    def __init__(self, *args, fold: str = "reference", **kwargs):
        super().__init__(*args, **kwargs)
        if fold not in self.folds:
            raise ValueError(f"unknown fold {fold!r}")
        self.fold = fold

    def _build_database(self) -> None:
        archive = self._fetch(self.download_url, "iso17.tar.gz")
        with tarfile.open(archive) as tar:
            tar.extract(f"iso17/{self.fold}.db", self.raw_dir, filter="data")
        src = ASEAtomsData(os.path.join(self.raw_dir, "iso17", f"{self.fold}.db"))
        ds = ASEAtomsData.create(
            self.datapath,
            distance_unit="Ang",
            property_unit_dict={"total_energy": "eV", "atomic_forces": "eV/Ang"},
        )
        systems = []
        for s in src.iter_properties():
            systems.append(
                dict(
                    numbers=s["_atomic_numbers"], positions=s["_positions"],
                    total_energy=np.atleast_1d(s.get("total_energy", 0.0)),
                    atomic_forces=s.get("atomic_forces", np.zeros_like(s["_positions"])),
                )
            )
        ds.add_systems(systems)


class ANI1(DownloadableDataModule):
    """ANI-1: 20M off-equilibrium DFT conformations (HDF5).

    Parity: ``datasets/ani1.py``."""

    download_url = "https://ndownloader.figshare.com/files/9057631"
    self_energies = {1: -0.500607632585, 6: -37.8302333826,
                     7: -54.5680045287, 8: -75.0362229210}

    def __init__(self, *args, num_heavy_atoms: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_heavy_atoms = num_heavy_atoms

    def _build_database(self) -> None:
        import h5py

        archive = self._fetch(self.download_url, "ANI1_release.tar.gz")
        with tarfile.open(archive) as tar:
            tar.extractall(self.raw_dir, filter="data")
        ds = ASEAtomsData.create(
            self.datapath,
            distance_unit="Ang",
            property_unit_dict={"energy": "Ha"},
            atomrefs={"energy": [self.self_energies.get(z, 0.0) for z in range(101)]},
        )
        elements = {b"H": 1, b"C": 6, b"N": 7, b"O": 8}
        for i in range(1, self.num_heavy_atoms + 1):
            path = os.path.join(self.raw_dir, "ANI-1_release", f"ani_gdb_s{i:02d}.h5")
            if not os.path.exists(path):
                continue
            with h5py.File(path, "r") as f:
                systems = []
                for grp in f.values():
                    for mol in grp.values():
                        Z = np.array([elements[s] for s in mol["species"][()]])
                        for R, E in zip(mol["coordinates"][()], mol["energies"][()]):
                            systems.append(
                                dict(numbers=Z, positions=R, energy=np.array([E]))
                            )
                        if len(systems) > 20000:
                            ds.add_systems(systems)
                            systems = []
                if systems:
                    ds.add_systems(systems)


class QM7X(DownloadableDataModule):
    """QM7-X: 4.2M equilibrium+perturbed structures (HDF5 sets).

    Parity: ``datasets/qm7x.py`` — the reference's full property map
    (``property_dataset_keys``, qm7x.py:139-148; NB the reference
    mistakenly assigns ``FPBE0 = "FMBD"``, colliding the two force keys —
    here FPBE0 really maps to the ``pbe0FOR`` payload), its equilibrium
    duplicate filtering via DupMols.dat (qm7x.py:248-262, :333-336), the
    only_equilibrium / only_non_equilibrium selectors, the hierarchical
    group-id metadata for GroupSplit (qm7x.py:326-378) and the PBE0
    atomrefs."""

    base_url = "https://zenodo.org/record/4288677/files/"
    sets = ["1000", "2000", "3000", "4000", "5000", "6000", "7000", "8000"]
    #: output property -> (raw HDF5 key, unit) — reference qm7x.py:127-148
    property_map = {
        "energy": ("ePBE0+MBD", "eV"),
        "forces": ("totFOR", "eV/Ang"),
        "Eat": ("eAT", "eV"),
        "EPBE0": ("ePBE0", "eV"),
        "EMBD": ("eMBD", "eV"),
        "FPBE0": ("pbe0FOR", "eV/Ang"),
        "FMBD": ("vdwFOR", "eV/Ang"),
        "rmsd": ("sRMSD", "Ang"),
        "dipole_moment": ("vDIP", "e*Ang"),
        "polarizability": ("mPOL", "a0^3"),
    }
    #: PBE0 atomic reference energies (reference qm7x.py:151-159)
    EPBE0_atom = {
        1: -13.641404161,
        6: -1027.592489146,
        7: -1484.274819088,
        8: -2039.734879322,
        16: -10828.707468187,
        17: -12516.444619523,
    }

    def __init__(self, *args, only_equilibrium: bool = False,
                 only_non_equilibrium: bool = False,
                 remove_duplicates: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.only_equilibrium = only_equilibrium
        self.only_non_equilibrium = only_non_equilibrium
        self.remove_duplicates = remove_duplicates

    def _duplicate_ids(self) -> set:
        """Truncated conf ids of duplicated equilibrium structures, from
        Zenodo's DupMols.dat (one ``...xyz`` name per line; the reference
        strips the extension, qm7x.py:258-262)."""
        path = os.path.join(self.raw_dir, "DupMols.dat")
        if not os.path.exists(path):
            path = self._fetch(self.base_url + "DupMols.dat", "DupMols.dat")
        with open(path) as f:
            return {line.rstrip("\n")[:-4] for line in f if line.strip()}

    def _build_database(self) -> None:
        import re as _re

        import h5py

        ds = ASEAtomsData.create(
            self.datapath,
            distance_unit="Ang",
            property_unit_dict={k: u for k, (_, u) in self.property_map.items()},
            atomrefs={"EPBE0": [
                self.EPBE0_atom.get(z, 0.0) for z in range(100)
            ]},
        )
        dup_ids = self._duplicate_ids() if self.remove_duplicates else set()
        groups = {"smiles_id": [], "stereo_iso_id": [], "conform_id": [],
                  "step_id": []}
        found = False
        for set_id in self.sets:
            path = os.path.join(self.raw_dir, f"{set_id}.hdf5")
            if not os.path.exists(path):
                path = self._fetch(self.base_url + f"{set_id}.xz", f"{set_id}.hdf5")
            found = True
            with h5py.File(path, "r") as f:
                systems = []
                for mol in f.values():
                    for conf_name, conf in mol.items():
                        is_eq = "opt" in conf_name
                        if self.only_equilibrium and not is_eq:
                            continue
                        if self.only_non_equilibrium and is_eq:
                            continue
                        # drop duplicated equilibrium conformations (and
                        # their perturbed children): the id minus its last
                        # "-<step>" segment indexes DupMols.dat
                        trunc = conf_name.rsplit("-", 1)[0]
                        if trunc in dup_ids:
                            continue
                        props = {
                            out: np.asarray(conf[src][()])
                            for out, (src, _) in self.property_map.items()
                            if src in conf
                        }
                        props = {
                            k: (np.atleast_1d(v) if v.ndim == 0 else v)
                            for k, v in props.items()
                        }
                        systems.append(
                            dict(
                                numbers=np.asarray(conf["atNUM"][()], np.int64),
                                positions=np.asarray(conf["atXYZ"][()]),
                                **props,
                            )
                        )
                        # hierarchical ids (Geom-mX-iY-cZ-{opt|dW}) for
                        # GroupSplit over e.g. smiles_id
                        cid = (conf_name[:-3] + "d0") if is_eq else conf_name
                        ids = [int(x) for x in _re.findall(r"\d+", cid)]
                        for key, val in zip(groups, ids):
                            groups[key].append(val)
                        if len(systems) > 20000:
                            ds.add_systems(systems)
                            systems = []
                if systems:
                    ds.add_systems(systems)
        if not found:
            raise RuntimeError("no QM7-X set files found")
        ds.update_metadata(groups_ids={
            **groups, "id": list(range(1, len(groups["smiles_id"]) + 1)),
        })


class MaterialsProject(DownloadableDataModule):
    """Bulk crystals from the Materials Project API.

    Parity: ``datasets/materials_project.py``; requires an API key and
    network access — offline use requires a pre-built DB."""

    def __init__(self, *args, apikey: Optional[str] = None,
                 timestamp: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.apikey = apikey
        self.timestamp = timestamp

    def _build_database(self) -> None:
        if self.apikey is None:
            raise RuntimeError(
                "MaterialsProject requires an API key (and network access); "
                "pre-build the ASE DB offline instead."
            )
        try:
            from pymatgen.ext.matproj import MPRester  # optional dependency
        except ImportError as e:
            raise RuntimeError("pymatgen is required for MaterialsProject") from e
        ds = ASEAtomsData.create(
            self.datapath,
            distance_unit="Ang",
            property_unit_dict={
                "formation_energy_per_atom": "eV", "energy_per_atom": "eV",
                "band_gap": "eV", "total_magnetization": "1",
            },
        )
        with MPRester(self.apikey) as m:
            for q in m.query(
                criteria={}, properties=[
                    "structure", "formation_energy_per_atom", "energy_per_atom",
                    "band_gap", "total_magnetization",
                ],
            ):
                s = q["structure"]
                ds.add_system(
                    numbers=np.array([sp.Z for sp in s.species]),
                    positions=s.cart_coords,
                    cell=s.lattice.matrix,
                    pbc=np.ones(3, bool),
                    formation_energy_per_atom=np.array([q["formation_energy_per_atom"]]),
                    energy_per_atom=np.array([q["energy_per_atom"]]),
                    band_gap=np.array([q["band_gap"]]),
                    total_magnetization=np.array([q["total_magnetization"]]),
                )


class OrganicMaterialsDatabase(DownloadableDataModule):
    """OMDB: band gaps of organic crystals (parity: ``datasets/omdb.py``)."""

    download_url = "https://omdb.mathub.io/dataset"

    def _build_database(self) -> None:
        path = self._fetch(self.download_url, "OMDB-GAP1_v1.1.tar.gz")
        import tarfile

        ds = ASEAtomsData.create(
            self.datapath, distance_unit="Ang",
            property_unit_dict={"band_gap": "eV"},
        )
        with tarfile.open(path) as tar:
            tar.extractall(self.raw_dir, filter="data")
        from .xyz import read_extxyz_file

        structures = read_extxyz_file(os.path.join(self.raw_dir, "structures.xyz"))
        gaps = np.loadtxt(os.path.join(self.raw_dir, "bandgaps.csv"))
        systems = [
            dict(numbers=s["numbers"], positions=s["positions"],
                 cell=s.get("cell"), pbc=np.ones(3, bool),
                 band_gap=np.array([g]))
            for s, g in zip(structures, gaps)
        ]
        ds.add_systems(systems)


class TMQM(DownloadableDataModule):
    """tmQM: 86k transition-metal complexes (parity: ``datasets/tmqm.py``)."""

    base_url = "https://raw.githubusercontent.com/bbskjelstad/tmqm/master/data/"
    files = ["tmQM_X1.xyz.gz", "tmQM_X2.xyz.gz", "tmQM_y.csv"]

    def _build_database(self) -> None:
        import csv
        import gzip

        from .xyz import parse_extxyz_blocks, symbol_to_z

        props = {}
        ycsv = self._fetch(self.base_url + "tmQM_y.csv", "tmQM_y.csv")
        with open(ycsv) as f:
            reader = csv.DictReader(f, delimiter=";")
            for row in reader:
                props[row["CSD_code"]] = row

        ds = ASEAtomsData.create(
            self.datapath, distance_unit="Ang",
            property_unit_dict={
                "electronic_energy": "Ha", "dispersion_energy": "Ha",
                "dipole_moment": "D", "homo": "Ha", "lumo": "Ha", "gap": "Ha",
                "polarizability": "a0^3",
            },
        )
        systems = []
        for fname in self.files[:2]:
            path = self._fetch(self.base_url + fname, fname)
            with gzip.open(path, "rt") as f:
                text = f.read()
            for block in parse_extxyz_blocks(text):
                code = None
                for token in block["comment"].split("|"):
                    token = token.strip()
                    if token.startswith("CSD_code"):
                        code = token.split("=")[1].strip()
                row = props.get(code)
                if row is None:
                    continue
                systems.append(
                    dict(
                        numbers=block["numbers"], positions=block["positions"],
                        electronic_energy=np.array([float(row["Electronic_E"])]),
                        dispersion_energy=np.array([float(row["Dispersion_E"])]),
                        dipole_moment=np.array([float(row["Dipole_M"])]),
                        homo=np.array([float(row["HOMO_Energy"])]),
                        lumo=np.array([float(row["LUMO_Energy"])]),
                        gap=np.array([float(row["HL_Gap"])]),
                        polarizability=np.array([float(row["Polarizability"])]),
                    )
                )
                if len(systems) > 20000:
                    ds.add_systems(systems)
                    systems = []
        if systems:
            ds.add_systems(systems)
