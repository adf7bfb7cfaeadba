"""SO3net on the column-bucketed layout (the MD path).

Port of ``schnetpack_tpu/representation/so3net.py`` on its column path
(``so3net.py:51-69, 89-126``): the per-edge displacements ``col_rij`` of
``atomistic.PairwiseDistances`` -> safe distance, unit direction, Gaussian
radial basis and cosine cutoff (masked by the edge mask) -> embedding ->
``scalar2rsh`` -> n_interactions x (SO3Convolution -> mix1 -> + tensor
product -> mix2 -> parametric gate -> mix3, residual add) ->
``scalar_representation`` [A', F] and ``multipole_representation`` [A',
(lmax+1)^2, F].

Each convolution gathers the [A', (lmax+1)^2 * F] feature table with K11
and folds its messages with K14; autograd runs their VJPs (K12, K13).
Only the column layout with a non-trainable Gaussian basis and the cosine
cutoff is implemented; shared interactions, the vector representation and
the flat and dense layouts raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..atomistic.distances import column_refs
from ..nn.base import Dense
from ..nn.so3 import (
    SO3Convolution, SO3ParametricGatedNonlinearity, SO3TensorProduct,
)
from ..ops import so3 as so3_ops
from ..ops.cutoff import cosine_cutoff
from ..ops.math import safe_norm
from ..ops.radial import gaussian_rbf_table


class SO3net(nn.Module):
    """SO3net representation on the column layout."""

    def __init__(self, n_atom_basis: int = 64, n_interactions: int = 3,
                 lmax: int = 2, n_rbf: int = 20, cutoff: float = 5.0,
                 max_z: int = 100, return_vector_representation: bool = False,
                 shared_interactions: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if return_vector_representation or shared_interactions:
            raise NotImplementedError(
                "the port's SO3net has no vector representation and no "
                "shared interactions")
        F = n_atom_basis
        self.n_atom_basis = F
        self.lmax = lmax
        self.n_rbf = n_rbf
        self.cutoff = float(cutoff)
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5, generator=generator)
        T = range(n_interactions)
        self.convs = nn.ModuleList(
            SO3Convolution(lmax, F, n_rbf, generator) for _ in T)
        self.mix1 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.mix2 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.mix3 = nn.ModuleList(
            Dense(F, F, bias=False, generator=generator) for _ in T)
        self.gates = nn.ModuleList(
            SO3ParametricGatedNonlinearity(F, lmax, generator) for _ in T)
        self.tp = SO3TensorProduct(lmax)
        self.register_buffer("cw", gaussian_rbf_table(n_rbf, cutoff),
                             persistent=False)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.col_rij not in inputs:
            raise NotImplementedError(
                "the port implements SO3net on the column layout only "
                "(run atomistic.PairwiseDistances as an input module on "
                "inputs with the cell_qcol/cell_dcol/cell_coff_fm keys)")
        refs = column_refs(inputs)
        Rij = inputs[properties.col_rij]
        d = safe_norm(Rij)
        dirs = Rij / d[..., None]
        emask = (refs.qcol >= 0).to(Rij.dtype)
        fcut = cosine_cutoff(d, self.cutoff) * emask
        radial = torch.exp(self.cw[:, 1] * (d[..., None] - self.cw[:, 0]) ** 2)

        x = so3_ops.scalar2rsh(self.embedding(inputs[properties.Z]),
                               self.lmax)
        for conv, m1, m2, m3, gate in zip(self.convs, self.mix1, self.mix2,
                                          self.mix3, self.gates):
            dx = conv(x, radial, dirs, fcut, refs)
            dx = m2(dx + self.tp(dx, m1(dx)))
            x = x + m3(gate(dx))
        inputs[properties.scalar_representation] = x[:, 0, :]
        inputs[properties.multipole_representation] = x
        return inputs
