"""Input module computing pairwise displacements (port of
``schnetpack_tpu/atomistic/distances.py``, column and 27-cell branches).

``NeuralNetworkPotential`` runs it after the positions require grad, so
forces flow back through it.  On the column layout the per-edge
displacements are ``col_rij = gather(R) + coff - expand(R)``
[nx, ny, Ktot, 3] from K11 and K13 (``ops/colblock_select.py``); their
VJPs, K12 and K14, carry dR.  The periodic offsets are zero at padded
slots, where both selections give zero rows.  On the 27-cell atom layout
they are ``nbh_rij = cell_gather(R) + nbh_offsets - R * nbh_mask``
[A', K, 3] from K16 (``ops/cellblock_gather.py``, VJP K17), exactly 0 at
padded slots (``distances.py:54-62``).  The flat ``Rij`` of the JAX module
is not computed: the MD calculator's flat pair list is empty.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import properties
from ..ops.cellblock_gather import CellRefs, cell_gather
from ..ops.colblock import ColRefs
from ..ops.colblock_select import column_expand_op, column_gather_op


class PairwiseDistances(nn.Module):
    """Adds ``col_rij`` [nx, ny, Ktot, 3] to column-layout inputs and
    ``nbh_rij`` [A', K, 3] to 27-cell-layout inputs."""

    def forward(self, inputs: Dict[str, torch.Tensor]):
        R = inputs[properties.R]
        if properties.cell_qcol in inputs:
            refs = column_refs(inputs)
            inputs[properties.col_rij] = (
                column_gather_op(R, refs)
                + inputs[properties.cell_coff_fm].movedim(2, 3)
                - column_expand_op(R, refs))
        elif properties.cell_qidx in inputs:
            inputs[properties.nbh_rij] = (
                cell_gather(R, cell_refs(inputs))
                + inputs[properties.nbh_offsets]
                - R[:, None, :] * inputs[properties.nbh_mask][..., None])
        else:
            raise NotImplementedError(
                "the port implements PairwiseDistances on the column layout "
                "(inputs with cell_qcol/cell_dcol/cell_coff_fm) and the "
                "27-cell layout (cell_qidx/nbh_offsets/nbh_mask) only")
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


def cell_refs(inputs: Dict[str, torch.Tensor]) -> CellRefs:
    """The 27-cell refs of a model's inputs: the MD neighbor list's, made
    once per build and passed in by the calculator, else built once per
    forward (as ``column_refs``)."""
    refs = inputs.get(properties.cell_refs)
    if refs is None:
        refs = CellRefs(inputs[properties.cell_qidx])
        inputs[properties.cell_refs] = refs
    return refs
