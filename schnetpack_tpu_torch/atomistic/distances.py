"""Input module computing pairwise displacements (port of
``schnetpack_tpu/atomistic/distances.py``, column branch).

``NeuralNetworkPotential`` runs it after the positions require grad, so
forces flow back through it.  On the column layout the per-edge
displacements are ``col_rij = gather(R) + coff - expand(R)``
[nx, ny, Ktot, 3] from K11 and K13 (``ops/colblock_select.py``); their
VJPs, K12 and K14, carry dR.  The periodic offsets are zero at padded
slots, where both selections give zero rows.  The flat ``Rij`` of the JAX
module is not computed: the MD calculator's flat pair list is empty.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import properties
from ..ops.colblock import ColRefs
from ..ops.colblock_select import column_expand_op, column_gather_op


class PairwiseDistances(nn.Module):
    """Adds ``col_rij`` [nx, ny, Ktot, 3] to column-layout inputs."""

    def forward(self, inputs: Dict[str, torch.Tensor]):
        if properties.cell_qcol not in inputs:
            raise NotImplementedError(
                "the port implements PairwiseDistances on the column layout "
                "only (inputs need the cell_qcol/cell_dcol/cell_coff_fm "
                "keys)")
        R = inputs[properties.R]
        refs = column_refs(inputs)
        inputs[properties.col_rij] = (
            column_gather_op(R, refs)
            + inputs[properties.cell_coff_fm].movedim(2, 3)
            - column_expand_op(R, refs))
        return inputs


def column_refs(inputs: Dict[str, torch.Tensor]) -> ColRefs:
    """The column-layout refs of a model's inputs, built once per forward
    and kept in the inputs, so that every op of the forward shares the
    index schedules cached on them."""
    refs = inputs.get(properties.col_refs)
    if refs is None:
        qcol = inputs[properties.cell_qcol]
        P = inputs[properties.R].shape[0] // (qcol.shape[0] * qcol.shape[1])
        refs = ColRefs(qcol, inputs[properties.cell_dcol], P,
                       tuple(inputs[properties.cell_ksz]))
        inputs[properties.col_refs] = refs
    return refs
