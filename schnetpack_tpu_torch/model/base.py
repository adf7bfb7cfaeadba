"""Model composition (parity: ``schnetpack_tpu/model/base.py``).

``NeuralNetworkPotential`` runs input modules -> representation -> output
heads over the flat batch dict (the input modules after the positions
require grad, so that e.g. ``PairwiseDistances`` is differentiated) and,
when a ``Forces`` spec is among the outputs, returns forces = -dE/dR from
one ``torch.autograd.grad`` call (no second-order graph is kept: MD needs
forces only).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .. import properties
from ..atomistic.response import Forces


class NeuralNetworkPotential(nn.Module):
    def __init__(self, representation: nn.Module, output_modules: Sequence,
                 input_modules: Sequence[nn.Module] = ()):
        super().__init__()
        self.input_modules = nn.ModuleList(input_modules)
        self.representation = representation
        self.response_specs = [m for m in output_modules
                               if isinstance(m, Forces)]
        self.output_modules = nn.ModuleList(
            m for m in output_modules if not isinstance(m, Forces))

    def forward(self, inputs: Dict[str, torch.Tensor]):
        inputs = dict(inputs)
        R = inputs[properties.R]
        with torch.enable_grad():
            if self.response_specs:
                R = R.detach().requires_grad_(True)
                inputs[properties.R] = R
            for m in self.input_modules:
                inputs = m(inputs)
            out = self.representation(inputs)
            for m in self.output_modules:
                out = m(out)
            for spec in self.response_specs:
                M = out[spec.energy_key].shape[0]
                mol_mask = inputs.get(properties.mol_mask,
                                      R.new_ones(M))
                E = (out[spec.energy_key] * mol_mask).sum()
                (dE,) = torch.autograd.grad(E, R)
                out[spec.energy_key] = out[spec.energy_key].detach()
                out[spec.force_key] = (
                    -dE * inputs[properties.atom_mask][:, None])
        return out
