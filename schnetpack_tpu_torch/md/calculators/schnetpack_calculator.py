"""Machine-learning potential calculator for MD (parity:
``schnetpack_tpu/md/calculators/schnetpack_calculator.py``, blocked-layout
paths).

The model runs in the neighbor list's sorted space: positions are taken
in ``cell_order`` (converted to model units), and forces come back to the
original atom order through ``cell_rank``.  A rebuild on the device
re-bins the atoms, so after one the whole sorted-space state (order,
rank, Z, idx_m, atom mask, qcol/dcol, offsets) is the neighbor list's new
state, exactly as after a host build.  ``neighbor_list`` is a
``CellBlockNeighborListMD`` or one of the reference's strings
``"cellblock"`` (the column layout, also the default) and
``"cellblock_atom"`` (the 27-cell atom layout, whose state passes
``cell_qidx``, ``nbh_idx``, ``nbh_mask`` and ``nbh_offsets``,
``schnetpack_calculator.py:192-199``, and the neighbor state's
``CellRefs``, so that its cached schedules outlive the step).  With the
default ``wgrad=False`` the potential's parameters are frozen: MD
differentiates with respect to positions only, and the kernels' plain
backward instances run.  ``wgrad=True`` leaves ``requires_grad`` as it is
(``schnetpack_calculator.py:43, 68-75``), so a parameter that requires
grad gets its cotangent from the kernels' wgrad instances.

Ring-polymer beads (``n_replicas > 1``, column layout) share one layout
(``schnetpack_calculator.py:210-276``): each bead's positions, in
``cell_order``, go through the model with the same tables, one bead after
another, and its forces come back through ``cell_rank``; energy is
written per bead.  The JAX package vmaps the model, and the Pallas
batching rule adds the bead axis to each kernel's grid; here the kernels
run once per bead, with one ``ColRefs`` (and its cached schedules) shared
by all beads of a step, and each bead's autograd graph is freed before the
next bead runs, so peak memory stays that of one replica.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ... import properties as structure
from ...atomistic.distances import column_refs
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
        neighbor_list: Union[CellBlockNeighborListMD, str, None] = None,
        wgrad: bool = False,
    ):
        super().__init__(force_key=force_key, energy_unit=energy_unit,
                         position_unit=position_unit, energy_key=energy_key)
        self.model = model
        if params is not None:
            self.model.load_state_dict(params)
        if not wgrad:
            self.model.requires_grad_(False)
        self.cutoff_model_units = float(cutoff)
        if neighbor_list is None or isinstance(neighbor_list, str):
            layouts = {None: "column", "cellblock": "column",
                       "cellblock_atom": "atom"}
            if neighbor_list not in layouts:
                raise NotImplementedError(
                    "the port's calculator takes neighbor_list='cellblock', "
                    "'cellblock_atom' or a CellBlockNeighborListMD, not "
                    f"{neighbor_list!r}")
            neighbor_list = CellBlockNeighborListMD(
                cutoff * self.position_conversion,
                skin=max(cutoff_shell, 0.3) * self.position_conversion,
                layout=layouts[neighbor_list])
        self.nbl = neighbor_list

    def init_state(self, system: System):
        self.model.to(system.positions.device)
        self.nbl.build(system)
        return self.nbl.state()

    def update_state(self, system: System, calc_state):
        """Per-step skin check; the new state after a rebuild."""
        return self.nbl.state() if self.nbl.maybe_rebuild(system) else calc_state

    def model_inputs(self, system: System, calc_state) -> Dict[str, torch.Tensor]:
        """The model's inputs (replica 0's positions) in sorted space."""
        inv = 1.0 / self.position_conversion
        order = calc_state["cell_order"]
        M = system.n_molecules
        inputs = {
            structure.R: system.positions[0, order] * inv,
            structure.Z: calc_state["cell_Z"],
            structure.idx_m: calc_state["cell_idx_m"],
            structure.atom_mask: calc_state["cell_atom_mask"],
            structure.n_atoms: system.n_atoms_per_mol,
            structure.mol_mask: system.positions.new_ones(M),
        }
        if structure.cell_qidx in calc_state:
            inputs.update({
                structure.cell_qidx: calc_state[structure.cell_qidx],
                structure.cell_refs: calc_state[structure.cell_refs],
                structure.nbh_idx: calc_state[structure.nbh_idx],
                structure.nbh_mask: calc_state[structure.nbh_mask],
                structure.nbh_offsets: calc_state[structure.nbh_offsets] * inv,
            })
        else:
            inputs.update({
                structure.cell_qcol: calc_state[structure.cell_qcol],
                structure.cell_dcol: calc_state[structure.cell_dcol],
                structure.cell_coff_fm:
                    calc_state[structure.cell_coff_fm] * inv,
                structure.cell_ksz: calc_state[structure.cell_ksz],
            })
        return inputs

    def calculate(self, system: System, calc_state) -> System:
        """Energy and forces of every replica, one model evaluation each
        (see the module's docstring for beads)."""
        base = self.model_inputs(system, calc_state)
        if system.n_replicas > 1:
            column_refs(base)       # one refs for every bead of the step
        order, rank = calc_state["cell_order"], calc_state["cell_rank"]
        inv = 1.0 / self.position_conversion
        energy, forces = [], []
        for r in range(system.n_replicas):
            inputs = dict(base)
            if r:
                inputs[structure.R] = system.positions[r, order] * inv
            out = self.model(inputs)
            energy.append(out[self.energy_key].detach())
            if self.force_key in out:
                forces.append(out[self.force_key].detach()[rank])
        outputs = {self.energy_key: torch.stack(energy)}
        if forces:
            outputs[self.force_key] = torch.stack(forces)
        return self._update_system(system, outputs)
