"""Electrostatic energies: the direct Coulomb sum and Ewald summation
(parity: ``schnetpack_tpu/atomistic/electrostatic.py``).

``EnergyCoulomb`` sums a 1/r or PhysNet-damped pair potential of the
partial charges, optionally shifted to zero at a cutoff, over the long-
range pair list where the inputs hold one, else the flat one.
``EnergyEwald`` is the erfc-screened real-space sum over the pair list
(or the dense [A, K] list), the reciprocal sum over a fixed integer k-grid
(``build_kgrid``) as [M, K, A] products, and the self term.  Plain
PyTorch on the flat layout's ops: they launch no kernel of this package.
"""
from __future__ import annotations

import itertools
import math
import warnings
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import properties
from ..ops.cutoff import switch_function
from ..ops.math import safe_norm
from ..ops.scatter import pair_sum, pair_take, segment_sum, take
from ..units import ke as KE_ASE


class CoulombPotential(nn.Module):
    """Plain 1/r (``electrostatic.py:34-38``)."""

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return 1.0 / d.clamp(min=1e-10)


class DampedCoulombPotential(nn.Module):
    """PhysNet's damped potential: f(d) / sqrt(d^2 + 1) + (1 - f(d)) / d
    with a smooth switch f from ``switch_on`` to ``switch_off``
    (``electrostatic.py:41-52``)."""

    def __init__(self, switch_on: float = 0.0, switch_off: float = 1.0):
        super().__init__()
        self.switch_on, self.switch_off = switch_on, switch_off

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        f = switch_function(d, self.switch_on, self.switch_off)
        return f / torch.sqrt(d * d + 1.0) + (1.0 - f) / d.clamp(min=1e-10)


def _pair_list(inputs, use_long_range: bool, like: torch.Tensor):
    """(idx_i, idx_j, Rij, mask) of the long-range list where the inputs
    hold one and ``use_long_range``, else of the flat list."""
    if use_long_range and properties.idx_i_lr in inputs:
        idx_i = inputs[properties.idx_i_lr]
        mask = inputs.get(properties.pair_mask_lr)
        return (idx_i, inputs[properties.idx_j_lr], inputs[properties.Rij_lr],
                like.new_ones(idx_i.shape[0]) if mask is None else mask)
    return (inputs[properties.idx_i], inputs[properties.idx_j],
            inputs[properties.Rij], inputs[properties.pair_mask])


class EnergyCoulomb(nn.Module):
    """Point-charge electrostatics of ``charges_key`` into ``output_key``
    [M] (``electrostatic.py:55-111``); ``energy_unit`` converts e^2/A to
    the model's energy unit."""

    def __init__(self, energy_unit: float = 1.0,
                 charges_key: str = properties.partial_charges,
                 output_key: str = "energy_coulomb",
                 cutoff: Optional[float] = None, shielded: bool = False,
                 use_long_range: bool = True):
        super().__init__()
        self.energy_unit = energy_unit
        self.charges_key = charges_key
        self.output_key = output_key
        self.cutoff = cutoff
        self.use_long_range = use_long_range
        self.potential = (DampedCoulombPotential() if shielded
                          else CoulombPotential())

    def forward(self, inputs: Dict[str, torch.Tensor]):
        q = inputs[self.charges_key]
        M = inputs[properties.n_atoms].shape[0]
        idx_i, idx_j, Rij, mask = _pair_list(inputs, self.use_long_range, q)
        mesh = inputs.get(properties.pair_mesh)
        d = safe_norm(Rij)
        pot = self.potential(d)
        if self.cutoff is not None:
            pot_rc = self.potential(torch.full_like(d, self.cutoff))
            pot = torch.where(d < self.cutoff, pot - pot_rc,
                              torch.zeros_like(pot))
        # each pair appears in both directions: the factor 1/2
        e_pair = (0.5 * KE_ASE * self.energy_unit * pair_take(q, idx_i, mesh)
                  * pair_take(q, idx_j, mesh) * pot * mask)
        e_atom = pair_sum(e_pair, idx_i, q.shape[0], mesh)
        inputs[self.output_key] = segment_sum(e_atom, inputs[properties.idx_m],
                                              M)
        return inputs


def build_kgrid(k_max: int) -> np.ndarray:
    """The integer k-points with ||n||_inf <= k_max but 0, [K, 3] float64
    (``electrostatic.py:114-124``)."""
    return np.asarray([p for p in itertools.product(
        range(-k_max, k_max + 1), repeat=3) if p != (0, 0, 0)], np.float64)


class EnergyEwald(nn.Module):
    """Ewald summation of periodic point charges into ``output_key`` [M]:
    E = E_real + E_recip - E_self (``electrostatic.py:127-238``), with the
    Gaussian screening ``alpha`` [1/A] and the k-grid of ``k_max``.  A
    molecule without a cell (|det| <= 1e-12) gets the real-space sum
    alone."""

    def __init__(self, alpha: float = 0.3, k_max: int = 5,
                 energy_unit: float = 1.0,
                 charges_key: str = properties.partial_charges,
                 output_key: str = "energy_ewald", use_long_range: bool = True,
                 screening_cutoff: Optional[float] = None):
        super().__init__()
        self.alpha = alpha
        self.k_max = k_max
        self.energy_unit = energy_unit
        self.charges_key = charges_key
        self.output_key = output_key
        self.use_long_range = use_long_range
        self.screening_cutoff = screening_cutoff

    def _screen(self, d: torch.Tensor) -> torch.Tensor:
        screen = torch.erfc(self.alpha * d) / d.clamp(min=1e-10)
        if self.screening_cutoff is not None:
            screen = torch.where(d < self.screening_cutoff, screen,
                                 torch.zeros_like(screen))
        return screen

    def _real(self, inputs, q, ke, M):
        idx_m = inputs[properties.idx_m]
        if (properties.nbh_rij in inputs
                and properties.idx_i_lr not in inputs):
            # the dense layout: its flat list carries no pair
            rc = inputs.get(properties.nbh_cutoff)
            if (self.screening_cutoff is not None and rc is not None
                    and self.screening_cutoff > float(rc) + 1e-6):
                warnings.warn(
                    f"EnergyEwald: screening_cutoff {self.screening_cutoff} "
                    f"exceeds the dense neighbor matrix build cutoff "
                    f"{float(rc)}; real-space erfc tail terms beyond it are "
                    "lost. Increase the MD cutoff_shell or use the flat "
                    "long-range pair list.", stacklevel=3)
            screen = self._screen(safe_norm(inputs[properties.nbh_rij]))
            qj = take(q, inputs[properties.nbh_idx])
            e_atom = 0.5 * ke * q * (qj * screen
                                     * inputs[properties.nbh_mask]).sum(1)
            return segment_sum(e_atom * inputs[properties.atom_mask], idx_m,
                               M)
        idx_i, idx_j, Rij, mask = _pair_list(inputs, self.use_long_range, q)
        mesh = inputs.get(properties.pair_mesh)
        e_pair = (0.5 * ke * pair_take(q, idx_i, mesh)
                  * pair_take(q, idx_j, mesh)
                  * self._screen(safe_norm(Rij)) * mask)
        return segment_sum(pair_sum(e_pair, idx_i, q.shape[0], mesh), idx_m,
                           M)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        q = inputs[self.charges_key]
        M = inputs[properties.n_atoms].shape[0]
        R = inputs[properties.R]
        cell = inputs[properties.cell]
        atom_mask = inputs[properties.atom_mask]
        idx_m = inputs[properties.idx_m].long()
        ke = KE_ASE * self.energy_unit
        e_real = self._real(inputs, q, ke, M)

        kgrid = torch.as_tensor(build_kgrid(self.k_max), dtype=q.dtype,
                                device=q.device)
        det = torch.linalg.det(cell).abs()
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        safe_cell = cell + eye * (det < 1e-12).to(q.dtype)[:, None, None]
        recip = 2.0 * math.pi * torch.linalg.inv(safe_cell).transpose(1, 2)
        kvecs = torch.einsum("ki,mij->mkj", kgrid, recip)      # [M, K, 3]
        k2 = (kvecs * kvecs).sum(-1)
        prefac = torch.exp(-k2 / (4.0 * self.alpha ** 2)) / k2.clamp(
            min=1e-12)
        phase = torch.einsum("mkj,aj->mka", kvecs, R)           # [M, K, A]
        onehot = (idx_m[None, :] == torch.arange(
            M, device=q.device)[:, None]).to(q.dtype)           # [M, A]
        qm = onehot * (q * atom_mask)[None, :]
        re = torch.einsum("mka,ma->mk", torch.cos(phase), qm)
        im = torch.einsum("mka,ma->mk", torch.sin(phase), qm)
        has_cell = (det > 1e-12).to(q.dtype)
        volume = det.clamp(min=1.0)
        e_recip = (ke * (2.0 * math.pi / volume)
                   * (prefac * (re * re + im * im)).sum(-1) * has_cell)
        e_self = (ke * (self.alpha / math.sqrt(math.pi))
                  * segment_sum(q * q * atom_mask, idx_m, M) * has_cell)
        inputs[self.output_key] = e_real + e_recip - e_self
        return inputs
