"""Atomwise output head (parity: ``schnetpack_tpu/atomistic/atomwise.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import properties
from ..nn.base import MLP
from ..ops.activations import ACTIVATIONS


class Atomwise(nn.Module):
    """Per-atom MLP, masked, summed per molecule -> ``output_key`` [M]."""

    def __init__(self, n_in: int = 128, output_key: str = properties.energy,
                 n_layers: int = 2, n_hidden: Optional[Sequence[int]] = None,
                 activation: str = "ssp",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_key = output_key
        self.outnet = MLP(n_in, 1, hidden=n_hidden, n_layers=n_layers,
                          activation=ACTIVATIONS[activation],
                          generator=generator)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        x = inputs[properties.scalar_representation]
        y = self.outnet(x)[:, 0] * inputs[properties.atom_mask]
        M = inputs[properties.n_atoms].shape[0]
        # summed in float64: the f32 sum of ~1e4 atomic adds on the GPU
        # would depend on their order at the 1e-6 level
        agg = y.new_zeros(M, dtype=torch.float64).index_add(
            0, inputs[properties.idx_m].long(), y.double())
        inputs[self.output_key] = agg.to(y.dtype)
        return inputs
