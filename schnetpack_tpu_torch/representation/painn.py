"""PaiNN on the column-bucketed layout (the MD path).

Port of ``schnetpack_tpu/representation/painn.py`` on its column path:
embedding -> n_interactions x (context MLP ctx_0/ctx_1 -> fused message ->
fused residual + mixing) -> scalar features q [A', F] and vector features
mu [A', 3, F].  ``mu`` stays flat [A', 3F] between blocks, the kernels'
layout.  ``fuse`` picks the message form, the JAX package's ``FUSE``
(``ops/cellblock.py:80-92``) as an argument:

* ``"hybrid"``: the packed geometry is computed once per forward under
  ``torch.no_grad()`` (the JAX ``stop_gradient``, ``painn.py:340-358``)
  and every interaction's message reads it, forward and backward; dR comes
  out of the message backward only;
* ``"full"``: the geometry is recomputed inside both message kernels.

The default is ``"full"``, unlike the JAX package's ``"hybrid"``: on the
H100 at the 10,976-atom bench shapes the full step measured 0.8-3% faster
(PERF.md, PR 2); the TPU's reason for hybrid, a geometry recompute that
cost more than the geo reads, does not hold there.

Parameters are held the way the kernels read them: ``FW_aug`` [T, B+1, 3F]
(the filter network's weights per interaction with its bias as the last
row, ``painn.py:403-416``) and, per mixing block, ``kmix`` [F, 2F],
``k0`` [2F, F], ``b0``, ``k1`` [F, 3F], ``b1`` (flax kernel layout).
Only the column layout with a non-trainable Gaussian basis and the cosine
cutoff is implemented; any other input raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import properties
from ..nn.base import Dense
from ..ops.activations import ACTIVATIONS
from ..ops.colblock import ColRefs
from ..ops.colblock_geo import column_geometry_packed
from ..ops.colblock_message import (
    painn_message_columns_fm_geores, painn_message_columns_full_fused,
)
from ..ops.painn_mixing import painn_mixing_fused
from ..ops.radial import gaussian_rbf_table


class PaiNNInteraction(nn.Module):
    """Context MLP of the inter-atomic block (``PaiNNInteraction``)."""

    def __init__(self, n_atom_basis: int, activation: str = "ssp",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.ctx_0 = Dense(F, F, activation=ACTIVATIONS[activation],
                           generator=generator)
        self.ctx_1 = Dense(F, 3 * F, generator=generator)

    def forward(self, q, mu, R, geo, FW_aug, coff_fm, cw, refs: ColRefs,
                rc: float):
        """Message of this block; ``geo`` is the packed geometry (hybrid)
        or None (full: geometry recomputed in the kernels)."""
        x = self.ctx_1(self.ctx_0(q))
        if geo is None:
            return painn_message_columns_full_fused(x, mu, R, FW_aug,
                                                    coff_fm, cw, refs, rc)
        return painn_message_columns_fm_geores(x, mu, R, geo, FW_aug,
                                               coff_fm, cw, refs, rc)


class PaiNNMixing(nn.Module):
    """Intra-atomic block with the residual add fused (``PaiNNMixing``)."""

    def __init__(self, n_atom_basis: int, activation: str = "ssp",
                 epsilon: float = 1e-8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        F = n_atom_basis
        self.activation = activation
        self.epsilon = float(epsilon)
        self.kmix = nn.Parameter(_xavier((F, 2 * F), generator))
        self.k0 = nn.Parameter(_xavier((2 * F, F), generator))
        self.b0 = nn.Parameter(torch.zeros(F))
        self.k1 = nn.Parameter(_xavier((F, 3 * F), generator))
        self.b1 = nn.Parameter(torch.zeros(3 * F))

    def forward(self, q, mu, dq, dmu):
        return painn_mixing_fused(q, mu, dq, dmu, self.kmix, self.k0,
                                  self.b0, self.k1, self.b1, self.epsilon,
                                  self.activation)


def _xavier(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Xavier-uniform [fan_in, fan_out] (flax kernel layout)."""
    a = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


class PaiNN(nn.Module):
    """PaiNN representation -> scalar_representation [A', F] and
    vector_representation [A', 3, F]."""

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0, max_z: int = 100,
                 activation: str = "ssp", epsilon: float = 1e-8,
                 fuse: str = "full",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fuse not in ("hybrid", "full"):
            raise ValueError(f"fuse must be 'hybrid' or 'full', got {fuse!r}")
        F = n_atom_basis
        self.fuse = fuse
        self.n_atom_basis = F
        self.n_rbf = n_rbf
        self.cutoff = float(cutoff)
        self.embedding = nn.Embedding(max_z + 1, F)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, F ** -0.5,
                                          generator=generator)
        w = _xavier((n_rbf, n_interactions * 3 * F), generator)
        self.FW_aug = nn.Parameter(torch.cat(
            [w.reshape(n_rbf, n_interactions, 3 * F),
             torch.zeros(1, n_interactions, 3 * F)], 0).transpose(0, 1)
            .contiguous())
        self.interactions = nn.ModuleList(
            PaiNNInteraction(F, activation, generator)
            for _ in range(n_interactions))
        self.mixing = nn.ModuleList(
            PaiNNMixing(F, activation, epsilon, generator)
            for _ in range(n_interactions))
        self.register_buffer("cw", gaussian_rbf_table(n_rbf, cutoff),
                             persistent=False)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            raise NotImplementedError(
                "the port implements PaiNN on the column layout only "
                "(inputs need the cell_qcol/cell_dcol/cell_coff_fm keys)")
        R = inputs[properties.R]
        qcol = inputs[properties.cell_qcol]
        P = R.shape[0] // (qcol.shape[0] * qcol.shape[1])
        refs = ColRefs(qcol, inputs[properties.cell_dcol], P,
                       tuple(inputs[properties.cell_ksz]))
        coff_fm = inputs[properties.cell_coff_fm]
        geo = None
        if self.fuse == "hybrid":
            with torch.no_grad():
                geo = column_geometry_packed(R, coff_fm, refs, self.cw,
                                             self.cutoff, with_d=True)
        F = self.n_atom_basis
        q = self.embedding(inputs[properties.Z])
        mu = q.new_zeros((q.shape[0], 3 * F))
        for t, (inter, mix) in enumerate(zip(self.interactions,
                                             self.mixing)):
            dq, dmu = inter(q, mu, R, geo, self.FW_aug[t], coff_fm, self.cw,
                            refs, self.cutoff)
            q, mu = mix(q, mu, dq, dmu)
        inputs[properties.scalar_representation] = q
        inputs[properties.vector_representation] = mu.reshape(-1, 3, F)
        return inputs
