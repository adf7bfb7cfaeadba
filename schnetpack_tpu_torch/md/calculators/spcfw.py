"""Flexible SPC/Fw water (parity: ``schnetpack_tpu/md/calculators/
spcfw.py``): Wu, Tepper & Voth, JCP 124, 024503 (2006).  Harmonic O-H
bonds and H-O-H angle, O-O Lennard-Jones, and a force-shifted point-charge
Coulomb between different waters, all healed to zero between
``cutoff - healing_length`` and ``cutoff``.  It runs the gate-5 water
runs (NVT with Nose-Hoover chains, 16-bead PIMD) through ``spkmd``
without a trained model.

Atoms come in O, H, H triplets; pairs within one triplet are left out of
the nonbonded terms.  The bonds and the angle read the minimum image in
the first cell of the batch, as the JAX calculator does.  The nonbonded
pairs are the port's host cell list (``PairwiseMDCalculator``), read from
``system.cells`` at every call, so NPT moves them with the box: every
image within the cutoff.  The JAX calculator takes one image per pair
(the minimum image of its all-pairs set, ``neighborlist_md.py:670-730``);
both give the same pairs where the cutoff is under half the box's height.
Forces and, with ``calc_stress``, the stress (the strain derivative of the
energy over the volume, symmetrised, as ``LJCalculator`` has it; the JAX
calculator computes none) come from ``torch.autograd.grad``.
"""
from __future__ import annotations

import math

import torch

from ... import properties as structure
from ..system import System
from .base import PairwiseMDCalculator

# SPC/Fw parameters (kcal/mol, Angstrom, radians, elementary charges)
R_OH0 = 1.012
K_BOND = 1059.162          # kcal/mol/A^2
THETA0 = math.radians(113.24)
K_ANGLE = 75.90            # kcal/mol/rad^2
Q_O = -0.82
Q_H = 0.41
EPS_OO = 0.1554253         # kcal/mol
SIG_OO = 3.165492          # A
COULOMB_KE = 332.0637128   # kcal/mol * A / e^2


class SPCFwCalculator(PairwiseMDCalculator):
    """SPC/Fw flexible water (O, H, H atom triplets)."""

    def __init__(self, cutoff: float = 6.0, healing_length: float = 0.8,
                 calc_stress: bool = False, **kwargs):
        kwargs.setdefault("energy_unit", "kcal/mol")
        kwargs.setdefault("position_unit", "Ang")
        super().__init__(
            cutoff=cutoff,
            stress_key=structure.stress if calc_stress else None, **kwargs)
        self.cutoff = cutoff
        self.healing_length = healing_length
        self.calc_stress = calc_stress

    def _bonded_energy(self, positions, cell, idx_m, n_mol, atom_mask,
                       eps=None):
        """Bonds and angles; ``eps`` [n_mol, 3, 3] strains the cell of each
        water's molecule (the stress's derivative)."""
        n_w = positions.shape[0] // 3
        O, H1, H2 = (positions[k::3][:n_w] for k in range(3))
        w_mask = atom_mask[0::3][:n_w]
        mol_w = idx_m[0::3][:n_w]
        d1, d2 = H1 - O, H2 - O
        if cell.abs().sum() > 1e-12:
            inv = torch.linalg.inv(cell)
            cell_w = (cell if eps is None
                      else cell + cell @ eps[mol_w]).expand(n_w, 3, 3)

            def min_image(d):
                # the image shift is piecewise constant in the positions
                n = torch.round(d.detach() @ inv)
                return d - torch.einsum("wi,wij->wj", n, cell_w)
            d1, d2 = min_image(d1), min_image(d2)
        r1 = torch.sqrt((d1 * d1).sum(-1) + 1e-16)
        r2 = torch.sqrt((d2 * d2).sum(-1) + 1e-16)
        cos_t = (d1 * d2).sum(-1) / (r1 * r2)
        theta = torch.arccos(cos_t.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
        e_w = (0.5 * K_BOND * ((r1 - R_OH0) ** 2 + (r2 - R_OH0) ** 2)
               + 0.5 * K_ANGLE * (theta - THETA0) ** 2) * w_mask
        return positions.new_zeros(n_mol).index_add(0, mol_w, e_w)

    def _nonbonded_energy(self, positions, pairs, idx_m, n_mol, atom_mask):
        idx_i, idx_j = pairs[structure.idx_i], pairs[structure.idx_j]
        offsets = pairs[structure.offsets]
        Rij = positions[idx_j] - positions[idx_i] + offsets
        d = torch.sqrt((Rij * Rij).sum(-1) + 1e-16)
        is_O = torch.arange(positions.shape[0],
                            device=positions.device) % 3 == 0
        q = torch.where(is_O, positions.new_tensor(Q_O),
                        positions.new_tensor(Q_H))
        rc = self.cutoff
        # force-shifted Coulomb: energy and force continuous at rc
        e_coul = COULOMB_KE * q[idx_i] * q[idx_j] * (
            1.0 / d - 1.0 / rc + (d - rc) / (rc * rc))
        sr6 = (SIG_OO / d) ** 6
        e_lj = 4.0 * EPS_OO * (sr6 * sr6 - sr6) * (is_O[idx_i] & is_O[idx_j])
        r_on = rc - self.healing_length
        x = ((d - r_on) / self.healing_length).clamp(0.0, 1.0)
        other = (idx_i // 3 != idx_j // 3) & (d < rc)
        e_pair = (0.5 * (e_coul + e_lj) * (1.0 - x * x * (3.0 - 2.0 * x))
                  * other)
        e_atom = positions.new_zeros(positions.shape[0]).index_add(
            0, idx_i, e_pair)
        return positions.new_zeros(n_mol).index_add(0, idx_m,
                                                     e_atom * atom_mask)

    def _energy(self, positions, pairs, idx_m, n_mol, atom_mask, cell,
                eps=None):
        return (self._bonded_energy(positions, cell, idx_m, n_mol, atom_mask,
                                    eps)
                + self._nonbonded_energy(positions, pairs, idx_m, n_mol,
                                         atom_mask))

    @torch.enable_grad()
    def calculate(self, system: System, calc_state=None) -> System:
        inputs = self._get_system_molecules(system)
        pairs = self._image_pairs(system)
        n_mol = system.n_replicas * system.n_molecules
        idx_m = inputs[structure.idx_m]
        mask = inputs[structure.atom_mask]
        cells = inputs[structure.cell]
        pos = inputs[structure.R].detach().requires_grad_(True)
        e_mol = self._energy(pos, pairs, idx_m, n_mol, mask, cells[0])
        (grad,) = torch.autograd.grad(e_mol.sum(), pos)
        outputs = {structure.energy: e_mol.detach(),
                   structure.forces: -grad * mask[:, None]}
        if self.calc_stress:
            pos0 = inputs[structure.R]
            eps = pos0.new_zeros((n_mol, 3, 3), requires_grad=True)
            strained = dict(pairs)
            strained[structure.offsets] = pairs[structure.offsets] + (
                torch.einsum("pi,pij->pj", pairs[structure.offsets],
                             eps[idx_m[pairs[structure.idx_i]]]))
            pos2 = pos0 + torch.einsum("ai,aij->aj", pos0, eps[idx_m])
            (dEdeps,) = torch.autograd.grad(
                self._energy(pos2, strained, idx_m, n_mol, mask, cells[0],
                             eps).sum(), eps)
            vol = torch.linalg.det(cells).abs().clamp(min=1e-9)
            sigma = dEdeps / vol[:, None, None]
            outputs[structure.stress] = 0.5 * (sigma + sigma.transpose(1, 2))
        return self._update_system(system, outputs)
