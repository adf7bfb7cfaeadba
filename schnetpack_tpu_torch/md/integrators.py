"""Velocity Verlet (parity: ``schnetpack_tpu/md/integrators.py:27-44``)."""
from __future__ import annotations

from ..units import _parse_unit, md_units
from .system import System


class VelocityVerlet:
    """``dt`` is given in ``time_unit`` and stored in the MD unit frame."""

    def __init__(self, time_step: float, time_unit: str = "fs"):
        self.dt = time_step * _parse_unit(time_unit) * md_units().time

    def half_step(self, system: System) -> System:
        p = system.momenta + 0.5 * self.dt * system.forces
        return system.replace(momenta=p * system.atom_mask[None, :, None])

    def main_step(self, system: System) -> System:
        q = system.positions + self.dt * system.momenta / system.masses[None, :, None]
        return system.replace(positions=q)
