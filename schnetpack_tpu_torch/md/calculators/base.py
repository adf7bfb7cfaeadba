"""MD calculator base: unit conversion (parity:
``schnetpack_tpu/md/calculators/base.py``).

The calculator converts positions from MD units into the model's units,
runs the model, and writes forces, energy and stress back in MD units.
``PairwiseMDCalculator`` holds an ``AllPairsNeighborListMD`` in MD units
and gives a potential the pair list of every replica, flattened into R * A
atoms with replica-shifted indices and the offsets in model units
(``base.py:112-152``, ``_pair_inputs``): every ordered same-molecule pair,
its minimum-image offset and its mask ``d < cutoff + cutoff_shell``, all
on the device.  The analytic potentials (``LJCalculator``,
``SPCFwCalculator``) read ``_image_pairs`` instead: the port's host cell
list (``transform/neighborlist.py``) at each call, every periodic image
within the cutoff, sorted by (i, j), which is the JAX package's pair set
where the cutoff is under half the box's height.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ... import properties as structure
from ...transform.neighborlist import cell_list_neighbor_list
from ...units import _parse_unit, md_units
from ..neighborlist_md import AllPairsNeighborListMD
from ..system import System


class MDCalculator:
    def __init__(self, required_properties: Sequence[str] = (),
                 force_key: str = structure.forces,
                 energy_unit: str = "eV", position_unit: str = "Ang",
                 energy_key: Optional[str] = structure.energy,
                 stress_key: Optional[str] = None):
        # ``required_properties`` is the JAX config's key; there it only
        # filters model outputs that never reach the system, so the port
        # takes it and keeps nothing
        md = md_units()
        self.force_key = force_key
        self.energy_key = energy_key
        self.stress_key = stress_key
        # model unit -> MD internal unit conversions
        self.energy_conversion = _parse_unit(energy_unit) * md.energy
        self.position_conversion = _parse_unit(position_unit) * md.length
        self.force_conversion = self.energy_conversion / self.position_conversion
        self.stress_conversion = (self.energy_conversion
                                  / self.position_conversion ** 3)

    def _update_system(self, system: System,
                       outputs: Dict[str, torch.Tensor]) -> System:
        R_, A, M = system.n_replicas, system.total_atoms, system.n_molecules
        updates = {}
        if self.force_key is not None and self.force_key in outputs:
            f = outputs[self.force_key].reshape(R_, A, 3) * self.force_conversion
            updates["forces"] = f * system.atom_mask[None, :, None]
        if self.energy_key is not None and self.energy_key in outputs:
            updates["energy"] = (outputs[self.energy_key].reshape(R_, M)
                                 * self.energy_conversion)
        if self.stress_key is not None and self.stress_key in outputs:
            updates["stress"] = (outputs[self.stress_key].reshape(R_, M, 3, 3)
                                 * self.stress_conversion)
        return system.replace(**updates)

    def init_state(self, system: System):
        """The calculator's neighbor state; None where it keeps none."""
        return None

    def update_state(self, system: System, calc_state):
        return calc_state

    def calculate(self, system: System, calc_state=None) -> System:
        raise NotImplementedError


class PairwiseMDCalculator(MDCalculator):
    """Base for potentials evaluated over on-device pair lists."""

    def __init__(self, cutoff: float, cutoff_shell: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        # cutoff in the model's length unit; the list's in MD units
        self.cutoff_model_units = cutoff
        self.neighbor_list = AllPairsNeighborListMD(
            cutoff * self.position_conversion,
            cutoff_shell * self.position_conversion)
        self.pair_cutoff = (cutoff + cutoff_shell) * self.position_conversion

    def _get_system_molecules(self, system: System) -> Dict[str, torch.Tensor]:
        """Replicas flattened into one batch of R * M molecules
        (``base.py:49-80``), positions and cells in model units."""
        R_, A, M = system.n_replicas, system.total_atoms, system.n_molecules
        inv = 1.0 / self.position_conversion
        dev = system.positions.device
        shift = torch.arange(R_, dtype=system.idx_m.dtype, device=dev) * M
        return {
            structure.R: (system.positions * inv).reshape(R_ * A, 3),
            structure.Z: system.atomic_numbers.repeat(R_),
            structure.idx_m: (system.idx_m.repeat(R_)
                              + shift.repeat_interleave(A)),
            structure.atom_mask: system.atom_mask.repeat(R_),
            structure.cell: (system.cells * inv).reshape(R_ * M, 3, 3),
            structure.pbc: system.pbc.repeat(R_, 1),
            structure.n_atoms: system.n_atoms_per_mol.repeat(R_),
            structure.mol_mask: system.positions.new_ones(R_ * M),
        }

    def _pair_inputs(self, system: System) -> Dict[str, torch.Tensor]:
        """Every replica's pairs, flattened with replica-shifted indices;
        offsets in model units."""
        R_, A = system.n_replicas, system.total_atoms
        per = self.neighbor_list.get_neighbors(
            system.positions, system.cells, system.idx_m, system.pbc)
        P = per[structure.idx_i].shape[0]
        shift = (torch.arange(R_, dtype=per[structure.idx_i].dtype,
                              device=system.positions.device) * A)[:, None]
        return {
            structure.idx_i: (per[structure.idx_i] + shift).reshape(R_ * P),
            structure.idx_j: (per[structure.idx_j] + shift).reshape(R_ * P),
            structure.offsets: per[structure.offsets].reshape(R_ * P, 3)
            / self.position_conversion,
            structure.pair_mask: per[structure.pair_mask].reshape(R_ * P),
        }

    def _image_pairs(self, system: System) -> Dict[str, torch.Tensor]:
        """Each replica's pairs within the cutoff (a host cell list per
        replica and molecule: every periodic image), flattened with
        replica-shifted indices; offsets in model units."""
        R_, A = system.n_replicas, system.total_atoms
        pos = system.positions.detach().double().cpu().numpy()
        cells = system.cells.detach().double().cpu().numpy()
        pbc = system.pbc.cpu().numpy()
        idx_m = system.idx_m.cpu().numpy()
        ii, jj, off = [], [], []
        for r in range(R_):
            for m in range(system.n_molecules):
                sel = np.nonzero(idx_m == m)[0]
                periodic = bool(pbc[m].any())
                cell = cells[r, m] if periodic else None
                i, j, S = cell_list_neighbor_list(
                    pos[r, sel], self.pair_cutoff, cell,
                    pbc[m] if periodic else None)
                ii.append(sel[i] + r * A)
                jj.append(sel[j] + r * A)
                off.append(S @ cell if periodic else np.zeros((len(i), 3)))
        t = dict(device=system.positions.device)
        return {
            structure.idx_i: torch.as_tensor(np.concatenate(ii), **t),
            structure.idx_j: torch.as_tensor(np.concatenate(jj), **t),
            structure.offsets: torch.as_tensor(
                np.concatenate(off) / self.position_conversion,
                dtype=system.positions.dtype, **t),
        }
