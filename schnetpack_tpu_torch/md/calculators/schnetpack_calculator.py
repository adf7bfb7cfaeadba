"""Machine-learning potential calculator for MD (parity:
``schnetpack_tpu/md/calculators/schnetpack_calculator.py``, column-layout
path).

The model runs in the neighbor list's sorted space: positions are taken
in ``cell_order`` (converted to model units), and forces come back to the
original atom order through ``cell_rank``.  A rebuild on the device
re-bins the atoms, so after one the whole sorted-space state (order,
rank, Z, idx_m, atom mask, qcol/dcol, offsets) is the neighbor list's new
state, exactly as after a host build.  The potential's parameters are
frozen: MD differentiates with respect to positions only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ... import properties as structure
from ..neighborlist_md import CellBlockNeighborListMD
from ..system import System
from .base import MDCalculator


class SchNetPackCalculator(MDCalculator):
    def __init__(
        self,
        model,                      # NeuralNetworkPotential
        params: Optional[Dict[str, torch.Tensor]] = None,
        cutoff: float = 5.0,        # model units
        force_key: str = structure.forces,
        energy_unit: str = "eV",
        position_unit: str = "Ang",
        energy_key: str = structure.energy,
        cutoff_shell: float = 0.0,
        neighbor_list: Optional[CellBlockNeighborListMD] = None,
    ):
        super().__init__(force_key=force_key, energy_unit=energy_unit,
                         position_unit=position_unit, energy_key=energy_key)
        self.model = model
        if params is not None:
            self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        self.cutoff_model_units = float(cutoff)
        self.nbl = neighbor_list or CellBlockNeighborListMD(
            cutoff * self.position_conversion,
            skin=max(cutoff_shell, 0.3) * self.position_conversion)

    def init_state(self, system: System):
        self.model.to(system.positions.device)
        self.nbl.build(system)
        return self.nbl.state()

    def update_state(self, system: System, calc_state):
        """Per-step skin check; the new state after a rebuild."""
        return self.nbl.state() if self.nbl.maybe_rebuild(system) else calc_state

    def model_inputs(self, system: System, calc_state) -> Dict[str, torch.Tensor]:
        inv = 1.0 / self.position_conversion
        order = calc_state["cell_order"]
        M = system.n_molecules
        return {
            structure.R: system.positions[0, order] * inv,
            structure.Z: calc_state["cell_Z"],
            structure.idx_m: calc_state["cell_idx_m"],
            structure.atom_mask: calc_state["cell_atom_mask"],
            structure.n_atoms: system.n_atoms_per_mol,
            structure.mol_mask: system.positions.new_ones(M),
            structure.cell_qcol: calc_state[structure.cell_qcol],
            structure.cell_dcol: calc_state[structure.cell_dcol],
            structure.cell_coff_fm: calc_state[structure.cell_coff_fm] * inv,
            structure.cell_ksz: calc_state[structure.cell_ksz],
        }

    def calculate(self, system: System, calc_state) -> System:
        out = self.model(self.model_inputs(system, calc_state))
        rank = calc_state["cell_rank"]
        outputs = {self.energy_key: out[self.energy_key].detach()}
        if self.force_key in out:
            outputs[self.force_key] = out[self.force_key].detach()[rank]
        return self._update_system(system, outputs)
