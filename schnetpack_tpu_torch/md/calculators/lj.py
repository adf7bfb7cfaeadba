"""Lennard-Jones calculator (parity: ``schnetpack_tpu/md/calculators/
lj.py``): an analytic potential with a smooth healing-length cutoff, to
test integrators and thermostats without a trained model.  Forces (and,
with ``calc_stress``, the strain derivative) come from
``torch.autograd.grad`` of the energy."""
from __future__ import annotations

import torch

from ... import properties as structure
from ..system import System
from .base import PairwiseMDCalculator


class LJCalculator(PairwiseMDCalculator):
    def __init__(self, r_equilibrium: float, well_depth: float,
                 cutoff: float, healing_length: float = 0.5,
                 calc_stress: bool = False, energy_unit: str = "eV",
                 position_unit: str = "Ang", **kwargs):
        super().__init__(cutoff=cutoff, energy_unit=energy_unit,
                         position_unit=position_unit,
                         stress_key=structure.stress if calc_stress else None,
                         **kwargs)
        # sigma from r_min = 2^(1/6) sigma
        self.sigma = r_equilibrium / 2.0 ** (1.0 / 6.0)
        self.epsilon = well_depth
        self.cutoff = cutoff
        self.healing_length = healing_length
        self.calc_stress = calc_stress

    def _energy(self, positions, pairs, idx_m, n_mol, atom_mask):
        idx_i, idx_j = pairs[structure.idx_i], pairs[structure.idx_j]
        Rij = positions[idx_j] - positions[idx_i] + pairs[structure.offsets]
        d = torch.sqrt((Rij * Rij).sum(-1) + 1e-16)
        sr6 = (self.sigma / d) ** 6
        e_pair = 4.0 * self.epsilon * (sr6 * sr6 - sr6)
        # smooth healing to zero between rc - h and rc
        r_on = self.cutoff - self.healing_length
        x = torch.clamp((d - r_on) / self.healing_length, 0.0, 1.0)
        e_pair = 0.5 * e_pair * (1.0 - x * x * (3.0 - 2.0 * x))
        e_atom = positions.new_zeros(positions.shape[0]).index_add(
            0, idx_i, e_pair)
        return positions.new_zeros(n_mol).index_add(0, idx_m,
                                                     e_atom * atom_mask)

    @torch.enable_grad()
    def calculate(self, system: System, calc_state=None) -> System:
        inputs = self._get_system_molecules(system)
        pairs = self._image_pairs(system)
        n_mol = system.n_replicas * system.n_molecules
        idx_m = inputs[structure.idx_m]
        mask = inputs[structure.atom_mask]
        pos = inputs[structure.R].detach().requires_grad_(True)
        e_mol = self._energy(pos, pairs, idx_m, n_mol, mask)
        (grad,) = torch.autograd.grad(e_mol.sum(), pos)
        outputs = {structure.energy: e_mol.detach(),
                   structure.forces: -grad}
        if self.calc_stress:
            # stress from the strain derivative of the pair energy
            pos0 = inputs[structure.R]
            eps = pos0.new_zeros((n_mol, 3, 3), requires_grad=True)
            eps_p = eps[idx_m[pairs[structure.idx_i]]]
            strained = dict(pairs)
            strained[structure.offsets] = pairs[structure.offsets] + torch.einsum(
                "pi,pij->pj", pairs[structure.offsets], eps_p)
            pos2 = pos0 + torch.einsum("ai,aij->aj", pos0, eps[idx_m])
            (dEdeps,) = torch.autograd.grad(
                self._energy(pos2, strained, idx_m, n_mol, mask).sum(), eps)
            vol = torch.linalg.det(inputs[structure.cell]).abs().clamp(
                min=1e-9)
            sigma = dEdeps / vol[:, None, None]
            outputs[structure.stress] = 0.5 * (sigma + sigma.transpose(1, 2))
        return self._update_system(system, outputs)
