"""SchNet on the column-bucketed layout (the MD path).

Port of ``schnetpack_tpu/representation/schnet.py`` on its column path
(``schnet.py:131-175, 56-69``): embedding -> the raw-phi geometry, once
per forward and differentiable in the positions
(``colblock_geo.column_geometry_raw``) -> n_interactions x (in2f -> fused
cfconv -> f2out_0 (ssp) -> f2out_1, residual add) -> scalar_representation
[A', F].  Forces come from autograd: the three cfconv backwards (K10) add
their geometry cotangents, and the geometry backward (K8) turns the sum
into dR.

The filter network's Dense layers (``filter_0`` [B -> F], ``filter_1``
[F -> F]) are ``nn.Linear`` modules; the cfconv op takes their weights
transposed, in flax's [in, out] layout.  Only the column layout with a
non-trainable Gaussian basis and the cosine cutoff is implemented; shared
interactions, nuclear and electronic embeddings and the flat and dense
layouts are not ported, and any other input raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..nn.base import Dense
from ..ops.activations import shifted_softplus
from ..ops.colblock import ColRefs
from ..ops.colblock_geo import column_geometry_raw
from ..ops.radial import gaussian_rbf_table
from ..ops.schnet_columns import schnet_cfconv_columns


class SchNetInteraction(nn.Module):
    """One continuous-filter convolution block (``SchNetInteraction``)."""

    def __init__(self, n_atom_basis: int, n_rbf: int, n_filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F, A = n_filters, n_atom_basis
        self.filter_0 = Dense(n_rbf, F, generator=generator)
        self.filter_1 = Dense(F, F, generator=generator)
        self.in2f = Dense(A, F, bias=False, generator=generator)
        self.f2out_0 = Dense(F, A, activation=shifted_softplus,
                             generator=generator)
        self.f2out_1 = Dense(A, A, generator=generator)

    def forward(self, x, geo, refs: ColRefs):
        agg = schnet_cfconv_columns(
            self.in2f(x), geo, self.filter_0.weight.t(), self.filter_0.bias,
            self.filter_1.weight.t(), self.filter_1.bias, refs)
        return self.f2out_1(self.f2out_0(agg))


class SchNet(nn.Module):
    """SchNet representation -> scalar_representation [A', F]."""

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0,
                 n_filters: Optional[int] = None, max_z: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.n_atom_basis = F
        self.n_rbf = n_rbf
        self.cutoff = float(cutoff)
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5,
                                          generator=generator)
        self.interactions = nn.ModuleList(
            SchNetInteraction(F, n_rbf, n_filters or F, generator)
            for _ in range(n_interactions))
        self.register_buffer("cw", gaussian_rbf_table(n_rbf, cutoff),
                             persistent=False)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            raise NotImplementedError(
                "the port implements SchNet on the column layout only "
                "(inputs need the cell_qcol/cell_dcol/cell_coff_fm keys)")
        R = inputs[properties.R]
        qcol = inputs[properties.cell_qcol]
        P = R.shape[0] // (qcol.shape[0] * qcol.shape[1])
        refs = ColRefs(qcol, inputs[properties.cell_dcol], P,
                       tuple(inputs[properties.cell_ksz]))
        geo = column_geometry_raw(R, inputs[properties.cell_coff_fm], refs,
                                  self.cw, self.cutoff)
        x = self.embedding(inputs[properties.Z])
        for inter in self.interactions:
            x = x + inter(x, geo, refs)
        inputs[properties.scalar_representation] = x
        return inputs
