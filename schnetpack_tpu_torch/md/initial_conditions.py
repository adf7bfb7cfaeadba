"""Initial momenta (parity: ``schnetpack_tpu/md/initial_conditions.py``).

Sampling draws from an explicit ``torch.Generator``, over every replica;
it gives other numbers than ``jax.random`` for the same seed (tests hand
both packages the same numpy momenta instead).
"""
from __future__ import annotations

import torch

from ..units import md_units
from .system import System


class Initializer:
    def __init__(self, temperature: float, remove_center_of_mass: bool = True,
                 remove_translation: bool = True,
                 remove_rotation: bool = False,
                 wrap_positions: bool = False):
        self.temperature = float(temperature)
        self.remove_center_of_mass = remove_center_of_mass
        self.remove_translation = remove_translation
        self.remove_rotation = remove_rotation
        self.wrap_positions = wrap_positions

    def _sample(self, system: System,
                generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def _sigma(self, system: System) -> torch.Tensor:
        return torch.sqrt(system.masses * md_units().kB
                          * self.temperature)[None, :, None]

    def initialize_system(self, system: System,
                          generator: torch.Generator) -> System:
        p = self._sample(system, generator).to(system.momenta.device)
        system = system.replace(momenta=p * system.atom_mask[None, :, None])
        if self.remove_translation:
            system = system.remove_com_motion()
        if self.remove_rotation:
            system = remove_rotation(system)
        if self.remove_center_of_mass:
            com = system.center_of_mass()
            system = system.replace(
                positions=system.positions - system.expand_atoms(com))
        if self.wrap_positions:
            system = system.wrap_positions()
        # rescale so the instantaneous temperature matches the target
        scale = torch.sqrt(self.temperature
                           / system.temperature.clamp(min=1e-12))
        return system.replace(
            momenta=system.momenta * system.expand_atoms(scale[..., None]))


def remove_rotation(system: System) -> System:
    """Zero the angular momentum of every molecule of every replica."""
    com = system.expand_atoms(system.center_of_mass())
    r = system.positions - com                                # [R, A, 3]
    m = system.masses[None, :, None]
    L = system.sum_atoms(torch.cross(r, system.momenta, dim=-1))
    r2 = (r * r).sum(-1, keepdim=True)[..., None]              # [R, A, 1, 1]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    inertia = system.sum_atoms(
        m[..., None] * (r2 * eye - r[..., :, None] * r[..., None, :]))
    omega = torch.linalg.solve(inertia + eye * 1e-9, L[..., None])[..., 0]
    v_rot = torch.cross(system.expand_atoms(omega), r, dim=-1)
    p = (system.momenta - v_rot * m) * system.atom_mask[None, :, None]
    return system.replace(momenta=p)


class MaxwellBoltzmannInit(Initializer):
    def _sample(self, system, generator):
        noise = torch.randn(system.momenta.shape, generator=generator,
                            dtype=system.momenta.dtype,
                            device=generator.device)
        return self._sigma(system).to(noise.device) * noise


class UniformInit(Initializer):
    def _sample(self, system, generator):
        u = torch.rand(system.momenta.shape, generator=generator,
                       dtype=system.momenta.dtype, device=generator.device)
        return (self._sigma(system).to(u.device) * (2.0 * u - 1.0)
                * 3.0 ** 0.5)
