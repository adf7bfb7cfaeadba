"""QM9: 134k small organic molecules with DFT properties (a copy of
``schnetpack_tpu/datasets/qm9.py``).

Parity: ``src/schnetpack/datasets/qm9.py:24-262``: the per-molecule xyz
files of the figshare archive (QM9's flavour of xyz, with a comment line
of a tag, the index and 15 properties, and ``*^`` exponents), the atom
references, and the removal of the 3,054 uncharacterized molecules.  The
port builds the database from ``dsgdb9nsd.xyz.tar.bz2`` (and
``uncharacterized.txt``, where present) in ``raw_dir``; it does not
download them.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from ..data.atoms import ASEAtomsData
from .base import DownloadableDataModule

#: property keys and units, in the order of the QM9 comment line
QM9_PROPERTIES = [
    ("rotational_constant_A", "GHz"),
    ("rotational_constant_B", "GHz"),
    ("rotational_constant_C", "GHz"),
    ("dipole_moment", "D"),
    ("isotropic_polarizability", "a0^3"),
    ("homo", "Ha"),
    ("lumo", "Ha"),
    ("gap", "Ha"),
    ("electronic_spatial_extent", "a0^2"),
    ("zpve", "Ha"),
    ("energy_U0", "Ha"),
    ("energy_U", "Ha"),
    ("enthalpy_H", "Ha"),
    ("free_energy", "Ha"),
    ("heat_capacity", "cal/mol/K"),
]

#: single-atom reference values (Ha) of H, C, N, O and F (QM9's atomref
#: table)
QM9_ATOMREF = {
    "zpve": {1: 0.000000, 6: 0.000000, 7: 0.000000, 8: 0.000000,
             9: 0.000000},
    "energy_U0": {1: -0.500273, 6: -37.846772, 7: -54.583861,
                  8: -75.064579, 9: -99.718730},
    "energy_U": {1: -0.498857, 6: -37.845355, 7: -54.582445,
                 8: -75.063163, 9: -99.717314},
    "enthalpy_H": {1: -0.497912, 6: -37.844411, 7: -54.581501,
                   8: -75.062219, 9: -99.716370},
    "free_energy": {1: -0.510927, 6: -37.861317, 7: -54.598897,
                    8: -75.079532, 9: -99.733544},
    "heat_capacity": {1: 2.981, 6: 2.981, 7: 2.981, 8: 2.981, 9: 2.981},
}

_ELEMENTS = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
ARCHIVE = "dsgdb9nsd.xyz.tar.bz2"
UNCHARACTERIZED = "uncharacterized.txt"


def parse_qm9_xyz(text: str):
    """One QM9 xyz file -> (Z, positions, {property: [value]})."""
    lines = text.strip().splitlines()
    n = int(lines[0])
    fields = lines[1].split()
    values = [float(x) for x in fields[2:2 + len(QM9_PROPERTIES)]]
    Z, R = [], []
    for ln in lines[2:2 + n]:
        parts = ln.replace("*^", "e").split()
        Z.append(_ELEMENTS[parts[0]])
        R.append([float(x) for x in parts[1:4]])
    props = {name: np.array([v])
             for (name, _), v in zip(QM9_PROPERTIES, values)}
    return np.asarray(Z), np.asarray(R), props


class QM9(DownloadableDataModule):
    download_url = "https://figshare.com/ndownloader/files/3195389"
    uncharacterized_url = "https://figshare.com/ndownloader/files/3195404"

    def __init__(self, *args, remove_uncharacterized: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.remove_uncharacterized = remove_uncharacterized

    def _skipped(self) -> set:
        """The 1-based indices of the uncharacterized molecules, from
        ``uncharacterized.txt`` where ``raw_dir`` holds it (none
        otherwise, as the JAX package does when its download fails)."""
        path = os.path.join(self.raw_dir, UNCHARACTERIZED)
        if not (self.remove_uncharacterized and os.path.exists(path)):
            return set()
        with open(path) as f:
            return {int(line.split()[0]) for line in f.readlines()[9:-1]
                    if line.split()}

    def _build_database(self) -> None:
        archive = self._fetch(self.download_url, ARCHIVE)
        skip = self._skipped()
        ds = ASEAtomsData.create(
            self.datapath, distance_unit="Ang",
            property_unit_dict=dict(QM9_PROPERTIES),
            atomrefs={k: [refs.get(z, 0.0) for z in range(101)]
                      for k, refs in QM9_ATOMREF.items()})
        systems = []
        with tarfile.open(archive, "r:bz2") as tar:
            for i, member in enumerate(sorted(tar.getnames())):
                if i + 1 in skip:
                    continue
                Z, R, props = parse_qm9_xyz(
                    tar.extractfile(member).read().decode())
                systems.append(dict(numbers=Z, positions=R, **props))
                if len(systems) >= 5000:
                    ds.add_systems(systems)
                    systems = []
        if systems:
            ds.add_systems(systems)
