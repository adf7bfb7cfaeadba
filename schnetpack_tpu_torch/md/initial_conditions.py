"""Initial momenta (parity: ``schnetpack_tpu/md/initial_conditions.py``).

Sampling draws from an explicit ``torch.Generator``; it gives other numbers
than ``jax.random`` for the same seed (tests hand both packages the same
numpy momenta instead).
"""
from __future__ import annotations

import torch

from ..units import md_units
from .system import System


class MaxwellBoltzmannInit:
    def __init__(self, temperature: float, remove_center_of_mass: bool = True,
                 remove_translation: bool = True):
        self.temperature = float(temperature)
        self.remove_center_of_mass = remove_center_of_mass
        self.remove_translation = remove_translation

    def initialize_system(self, system: System,
                          generator: torch.Generator) -> System:
        sigma = torch.sqrt(system.masses * md_units().kB * self.temperature)
        noise = torch.randn(system.momenta.shape, generator=generator,
                            dtype=system.momenta.dtype,
                            device=generator.device)
        p = sigma[None, :, None] * noise.to(system.momenta.device)
        system = system.replace(momenta=p * system.atom_mask[None, :, None])
        if self.remove_translation:
            system = system.remove_com_motion()
        if self.remove_center_of_mass:
            com = system.center_of_mass()
            system = system.replace(
                positions=system.positions - system.expand_atoms(com))
        # rescale so the instantaneous temperature matches the target
        scale = torch.sqrt(self.temperature
                           / system.temperature.clamp(min=1e-12))
        return system.replace(
            momenta=system.momenta * system.expand_atoms(scale[..., None]))
