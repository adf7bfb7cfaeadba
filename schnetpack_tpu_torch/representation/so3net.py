"""SO3net on every layout (port of
``schnetpack_tpu/representation/so3net.py``): the per-edge displacements
of ``atomistic.PairwiseDistances`` (``col_rij`` on the column layout,
``nbh_rij`` on the dense and 27-cell layouts, else the flat ``Rij``;
``so3net.py:46, 51-83``) -> safe distance, unit direction, radial basis
and cosine cutoff (times the real slots, ``nbh_mask`` or ``pair_mask``)
-> embedding -> ``scalar2rsh`` -> n_interactions x (SO3Convolution ->
mix1 -> + tensor product -> mix2 -> parametric gate -> mix3, residual
add) -> ``scalar_representation`` [A', F] and ``multipole_representation``
[A', (lmax+1)^2, F].

On the column layout each convolution gathers the [A', (lmax+1)^2 * F]
feature table with K11 and folds its messages with K14; autograd runs
their VJPs (K12, K13).  On the dense and flat layouts the gather and sum
are plain PyTorch (``nn/so3.py``); on the 27-cell layout the displacements
come from K16 (VJP K17) and the features take the dense layout's plain
gather.  The basis and the cosine cutoff are plain PyTorch, so any of
``nn.radial``'s bases runs (a trainable one's centers and widths are
parameters, ``radial_basis.{centers, widths}``).  With
``shared_interactions`` one block (flax ``so3conv_shared``, ``mix*_
shared``, ``gate_shared``; here index 0 of each list) runs n_interactions
times (``so3net.py:92-97``); ``return_vector_representation`` adds the
l = 1 channels, rolled from (y, z, x) to (x, y, z), as
``vector_representation`` [A', 3, F] (``so3net.py:122-125``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import edge_geometry, edge_layout
from ..nn.base import Dense
from ..nn.radial import GaussianRBF
from ..nn.so3 import (
    SO3Convolution, SO3ParametricGatedNonlinearity, SO3TensorProduct,
)
from ..ops import so3 as so3_ops
from ..ops.cutoff import cosine_cutoff


class SO3net(nn.Module):
    """SO3net representation."""

    def __init__(self, n_atom_basis: int = 64, n_interactions: int = 3,
                 lmax: int = 2, n_rbf: int = 20, cutoff: float = 5.0,
                 max_z: int = 100, return_vector_representation: bool = False,
                 shared_interactions: bool = False,
                 radial_basis: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        #: one interaction block for all (flax ``*_shared``)
        self.shared_interactions = shared_interactions
        F = n_atom_basis
        self.n_atom_basis = F
        self.n_interactions = n_interactions
        self.lmax = lmax
        self.return_vector_representation = return_vector_representation
        self.cutoff = float(cutoff)
        self.radial_basis = (GaussianRBF(n_rbf, cutoff) if radial_basis is None
                             else radial_basis)
        self.n_rbf = self.radial_basis.n_rbf
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5, generator=generator)
        T = range(1 if shared_interactions else n_interactions)
        self.convs = nn.ModuleList(
            SO3Convolution(lmax, F, self.n_rbf, generator) for _ in T)
        self.mix1 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.mix2 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.mix3 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.gates = nn.ModuleList(
            SO3ParametricGatedNonlinearity(F, lmax, generator) for _ in T)
        self.tp = SO3TensorProduct(lmax)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        edges, Rij, mask = edge_layout(inputs)
        d, dirs = edge_geometry(Rij)
        fcut = cosine_cutoff(d, self.cutoff) * mask.to(d.dtype)
        radial = self.radial_basis(d)

        x = so3_ops.scalar2rsh(self.embedding(inputs[properties.Z]),
                               self.lmax)
        for t in range(self.n_interactions):
            b = t % len(self.convs)
            dx = self.convs[b](x, radial, dirs, fcut, edges)
            dx = self.mix2[b](dx + self.tp(dx, self.mix1[b](dx)))
            x = x + self.mix3[b](self.gates[b](dx))
        inputs[properties.scalar_representation] = x[:, 0, :]
        inputs[properties.multipole_representation] = x
        if self.return_vector_representation:
            inputs[properties.vector_representation] = torch.roll(
                x[:, 1:4, :], 1, dims=1)
        return inputs
