"""MD system state (parity: ``schnetpack_tpu/md/system.py``).

``System`` holds tensors shaped like the JAX package's: positions, momenta
and forces [R, A, 3] (R replicas: ring-polymer beads or independent
copies), energy [R, M], stress and cells [R, M, 3, 3], the static
per-atom arrays, and ``properties``: further calculator outputs by name
(an ensemble's ``*_uncertainty`` streams), which the simulator logs
(``system.py:52``).  It is a dataclass; steps return new instances
through ``replace``.  Quantities are in the MD unit frame (kJ/mol, nm,
Dalton), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from .. import properties as structure
from ..transform.atomistic import ATOMIC_MASSES
from ..units import _parse_unit, md_units


@dataclasses.dataclass
class System:
    positions: torch.Tensor       # [R, A, 3]
    momenta: torch.Tensor         # [R, A, 3]
    forces: torch.Tensor          # [R, A, 3]
    energy: torch.Tensor          # [R, M]
    stress: torch.Tensor          # [R, M, 3, 3]
    cells: torch.Tensor           # [R, M, 3, 3]; zero when non-periodic
    masses: torch.Tensor          # [A]
    atomic_numbers: torch.Tensor  # [A] int64
    idx_m: torch.Tensor           # [A] int64 molecule id
    atom_mask: torch.Tensor       # [A] 1/0
    pbc: torch.Tensor             # [M, 3] bool
    n_atoms_per_mol: torch.Tensor  # [M]
    properties: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    @property
    def n_replicas(self) -> int:
        return self.positions.shape[0]

    @property
    def total_atoms(self) -> int:
        return self.positions.shape[1]

    @property
    def n_molecules(self) -> int:
        return self.energy.shape[1]

    def sum_atoms(self, x: torch.Tensor) -> torch.Tensor:
        """Masked per-molecule sum: [R, A, ...] -> [R, M, ...]."""
        mask = self.atom_mask.reshape((1, -1) + (1,) * (x.ndim - 2))
        out = x.new_zeros((x.shape[0], self.n_molecules) + x.shape[2:])
        return out.index_add(1, self.idx_m, x * mask)

    def expand_atoms(self, x: torch.Tensor) -> torch.Tensor:
        """Per-molecule [R, M, ...] -> per-atom [R, A, ...]."""
        return x[:, self.idx_m]

    @property
    def velocities(self) -> torch.Tensor:
        return self.momenta / self.masses[None, :, None]

    @property
    def kinetic_energy_tensor(self) -> torch.Tensor:
        """[R, M, 3, 3]: 0.5 * sum p p^T / m."""
        ppt = (self.momenta[:, :, :, None] * self.momenta[:, :, None, :]
               / self.masses[None, :, None, None])
        return 0.5 * self.sum_atoms(ppt)

    @property
    def kinetic_energy(self) -> torch.Tensor:
        """[R, M]"""
        ke = 0.5 * (self.momenta ** 2).sum(-1) / self.masses[None, :]
        return self.sum_atoms(ke[..., None])[..., 0]

    @property
    def degrees_of_freedom(self) -> torch.Tensor:
        """[M]"""
        return 3.0 * self.n_atoms_per_mol.to(self.positions.dtype)

    @property
    def temperature(self) -> torch.Tensor:
        """[R, M] instantaneous temperature."""
        dof = self.degrees_of_freedom.clamp(min=1.0)
        return 2.0 * self.kinetic_energy / (dof[None, :] * md_units().kB)

    @property
    def centroid_positions(self) -> torch.Tensor:
        """[1, A, 3] bead average."""
        return self.positions.mean(0, keepdim=True)

    @property
    def centroid_momenta(self) -> torch.Tensor:
        return self.momenta.mean(0, keepdim=True)

    @property
    def centroid_kinetic_energy(self) -> torch.Tensor:
        """[1, M]"""
        ke = 0.5 * (self.centroid_momenta ** 2).sum(-1) / self.masses[None, :]
        return self.sum_atoms(ke[..., None])[..., 0]

    @property
    def centroid_temperature(self) -> torch.Tensor:
        """[1, M]"""
        dof = self.degrees_of_freedom.clamp(min=1.0)
        return (2.0 * self.centroid_kinetic_energy
                / (dof[None, :] * md_units().kB))

    @property
    def volume(self) -> torch.Tensor:
        """[R, M]"""
        return torch.linalg.det(self.cells).abs()

    @property
    def pressure(self) -> torch.Tensor:
        """[R, M] isotropic pressure: the stress's and the kinetic part."""
        vol = self.volume.clamp(min=1e-12)
        p_pot = -torch.diagonal(self.stress, dim1=-2, dim2=-1).sum(-1) / 3.0
        return p_pot + 2.0 / 3.0 * self.kinetic_energy / vol

    def _mass_sum(self) -> torch.Tensor:
        m = self.masses[None, :, None].expand(self.positions.shape[:2] + (1,))
        return self.sum_atoms(m).clamp(min=1e-12)

    def center_of_mass(self) -> torch.Tensor:
        """[R, M, 3]"""
        return (self.sum_atoms(self.positions * self.masses[None, :, None])
                / self._mass_sum())

    def remove_com_motion(self) -> "System":
        """Zero the total momentum of every molecule."""
        v_com = self.sum_atoms(self.momenta) / self._mass_sum()
        p = self.momenta - self.expand_atoms(v_com) * self.masses[None, :, None]
        return self.replace(momenta=p * self.atom_mask[None, :, None])

    def wrap_positions(self) -> "System":
        """Wrap positions into their cells (periodic molecules only)."""
        eye = torch.eye(3, dtype=self.positions.dtype,
                        device=self.positions.device)
        cell_atom = self.cells[:, self.idx_m]                 # [R, A, 3, 3]
        has_cell = torch.linalg.det(cell_atom).abs() > 1e-12
        safe = cell_atom + eye * (~has_cell)[..., None, None]
        frac = torch.einsum("raj,rajk->rak", self.positions,
                            torch.linalg.inv(safe))
        pbc_atom = self.pbc[self.idx_m][None]                 # [1, A, 3]
        frac = torch.where(pbc_atom, torch.remainder(frac, 1.0), frac)
        wrapped = torch.einsum("rak,rakj->raj", frac, safe)
        return self.replace(positions=torch.where(
            has_cell[..., None], wrapped, self.positions))


def load_molecules(molecules: Sequence[Dict[str, np.ndarray]],
                   n_replicas: int = 1, position_unit_input: str = "Ang",
                   mass_unit_input: str = "Dalton",
                   dtype: torch.dtype = torch.float32,
                   device="cuda") -> System:
    """Build a System from sample dicts (positions in ``position_unit_input``),
    converted into the MD unit frame, on ``device``: the card unless the
    caller asks for the CPU (``device="cpu"``).  Everything downstream (the
    neighbor list, the calculator and its model, the integrator) follows the
    device of the system's tensors."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_molecules: no CUDA device; pass device='cpu' to run on "
            "the CPU")
    md = md_units()
    pos_conv = _parse_unit(position_unit_input) * md.length
    mass_conv = _parse_unit(mass_unit_input) * md.mass
    n_atoms = [len(m[structure.Z]) for m in molecules]
    A, M = sum(n_atoms), len(molecules)
    Z = np.concatenate([np.asarray(m[structure.Z]) for m in molecules])
    R = np.concatenate([np.asarray(m[structure.R], np.float64)
                        for m in molecules])
    cells = np.stack([np.asarray(m.get(structure.cell, np.zeros((3, 3))),
                                 np.float64) for m in molecules])
    pbc = np.stack([np.asarray(m.get(structure.pbc, np.zeros(3, bool)), bool)
                    for m in molecules])

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    zeros = torch.zeros((n_replicas, A, 3), dtype=dtype, device=device)
    return System(
        positions=t(R * pos_conv).expand(n_replicas, A, 3).clone(),
        momenta=zeros.clone(),
        forces=zeros.clone(),
        energy=torch.zeros((n_replicas, M), dtype=dtype, device=device),
        stress=torch.zeros((n_replicas, M, 3, 3), dtype=dtype,
                           device=device),
        cells=t(cells * pos_conv).expand(n_replicas, M, 3, 3).clone(),
        masses=t(ATOMIC_MASSES[Z] * mass_conv),
        atomic_numbers=t(Z, torch.int64),
        idx_m=t(np.repeat(np.arange(M), n_atoms), torch.int64),
        atom_mask=torch.ones(A, dtype=dtype, device=device),
        pbc=t(pbc, torch.bool),
        n_atoms_per_mol=t(n_atoms, torch.int64),
    )
