"""MD calculator base: unit conversion (parity:
``schnetpack_tpu/md/calculators/base.py:26-96``).

The calculator converts positions from MD units into the model's units,
runs the model, and writes forces and energy back in MD units.
"""
from __future__ import annotations

from typing import Dict

import torch

from ... import properties as structure
from ...units import _parse_unit, md_units
from ..system import System


class MDCalculator:
    def __init__(self, force_key: str = structure.forces,
                 energy_unit: str = "eV", position_unit: str = "Ang",
                 energy_key: str = structure.energy):
        md = md_units()
        self.force_key = force_key
        self.energy_key = energy_key
        # model unit -> MD internal unit conversions
        self.energy_conversion = _parse_unit(energy_unit) * md.energy
        self.position_conversion = _parse_unit(position_unit) * md.length
        self.force_conversion = self.energy_conversion / self.position_conversion

    def _update_system(self, system: System,
                       outputs: Dict[str, torch.Tensor]) -> System:
        R_, A, M = system.n_replicas, system.total_atoms, system.n_molecules
        updates = {}
        if self.force_key in outputs:
            f = outputs[self.force_key].reshape(R_, A, 3) * self.force_conversion
            updates["forces"] = f * system.atom_mask[None, :, None]
        if self.energy_key in outputs:
            updates["energy"] = (outputs[self.energy_key].reshape(R_, M)
                                 * self.energy_conversion)
        return system.replace(**updates)

    def calculate(self, system: System, calc_state=None) -> System:
        raise NotImplementedError
