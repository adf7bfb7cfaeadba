"""Gated equivariant block (parity: ``schnetpack_tpu/nn/equivariant.py``).

Mixes the vector channels with two linear maps and gates them by an MLP
on the scalar features and the norms of the second mix.  PaiNN's
tensorial heads (``DipoleMoment(use_vector_representation=True)``,
``Polarizability``) run a pyramid of these blocks.  The block and layer
names are the flax ones (``gated_{i}/{vmix1, vmix2, scalar_0,
scalar_1}``), so ``convert.py`` maps them by name.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.activations import shifted_softplus
from ..ops.math import safe_norm
from .base import Dense


class GatedEquivariantBlock(nn.Module):
    """(s [N, n_sin], v [N, 3, n_vin]) -> ([N, n_sout], [N, 3, n_vout])
    (``nn/equivariant.py:20-48``)."""

    def __init__(self, n_sin: int, n_vin: int, n_sout: int, n_vout: int,
                 n_hidden: int, activation: Callable = shifted_softplus,
                 sactivation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_sout = n_sout
        self.sactivation = sactivation
        self.vmix1 = Dense(n_vin, n_vout, bias=False, generator=generator)
        self.vmix2 = Dense(n_vin, n_vout, bias=False, generator=generator)
        self.scalar_0 = Dense(n_sin + n_vout, n_hidden, activation=activation,
                              generator=generator)
        self.scalar_1 = Dense(n_hidden, n_sout + n_vout, generator=generator)

    def forward(self, s: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        vmix1 = self.vmix1(v)
        v_norm = safe_norm(self.vmix2(v).transpose(-1, -2))    # [N, n_vout]
        h = self.scalar_1(self.scalar_0(torch.cat([s, v_norm], dim=-1)))
        s_out, gate = h[..., :self.n_sout], h[..., self.n_sout:]
        if self.sactivation is not None:
            s_out = self.sactivation(s_out)
        return s_out, vmix1 * gate[..., None, :]


class GatedEquivariantMLP(nn.Module):
    """Blocks ``gated_{i}`` with pyramidal widths: halving from ``n_in``
    over ``n_layers`` down to ``n_out`` (``nn/equivariant.py:51-77``)."""

    def __init__(self, n_in: int, n_out: int, n_layers: int = 2,
                 activation: Callable = shifted_softplus,
                 sactivation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths, w = [], n_in
        for _ in range(n_layers - 1):
            w = max(n_out, w // 2)
            widths.append(w)
        widths.append(n_out)
        w_in = n_in
        for i, wd in enumerate(widths):
            last = i == len(widths) - 1
            self.add_module(f"gated_{i}", GatedEquivariantBlock(
                w_in, w_in, wd, wd, wd if last else max(wd, n_out),
                activation, None if last else (sactivation or activation),
                generator))
            w_in = wd

    def forward(self, s: torch.Tensor, v: torch.Tensor):
        for block in self.children():
            s, v = block(s, v)
        return s, v


def build_gated_equivariant_mlp(n_in: int, n_out: int, n_layers: int = 2,
                                activation: Callable = shifted_softplus,
                                sactivation: Optional[Callable] = None,
                                generator: Optional[torch.Generator] = None
                                ) -> GatedEquivariantMLP:
    """The JAX package's builder name for ``GatedEquivariantMLP``."""
    return GatedEquivariantMLP(n_in, n_out, n_layers, activation,
                               sactivation, generator)
