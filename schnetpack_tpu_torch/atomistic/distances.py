"""Input module computing pairwise displacements (port of
``schnetpack_tpu/atomistic/distances.py``, column and 27-cell branches).

``NeuralNetworkPotential`` runs it after the positions require grad, so
forces flow back through it.  On the column layout the per-edge
displacements are ``col_rij = gather(R) + coff - expand(R)``
[nx, ny, Ktot, 3] from K11 and K13 (``ops/colblock_select.py``); their
VJPs, K12 and K14, carry dR.  The periodic offsets are zero at padded
slots, where both selections give zero rows.  Inputs with ``cell_shard``
(the slab path of ``parallel/columns.py``) take the JAX package's sharded
branch (``distances.py:37-53``): the gather reads the halo'd slab (K11/K12
in a halo mode, ``ops/colblock_shard.py``), the expand stays local, and
the offsets are ``cell_coff`` [nx, ny, Ktot, 3] times ``cell_emask``.  On
the 27-cell atom layout
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
from ..ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y


class PairwiseDistances(nn.Module):
    """Adds ``col_rij`` [nx, ny, Ktot, 3] to column-layout inputs and
    ``nbh_rij`` [A', K, 3] to 27-cell-layout inputs.  ``columns=False``
    skips the unsharded column layout, for a representation whose kernels
    there take the positions (``reads_column_rij``: PaiNN's fused paths,
    SchNet), as XLA drops the JAX model's dead ``col_rij``."""

    def __init__(self, columns: bool = True):
        super().__init__()
        self.columns = columns

    def forward(self, inputs: Dict[str, torch.Tensor]):
        R = inputs[properties.R]
        if (properties.cell_qcol in inputs and not self.columns
                and properties.cell_shard not in inputs):
            return inputs
        if properties.cell_qcol in inputs:
            refs = column_refs(inputs)
            if properties.cell_shard in inputs:
                coff = (inputs[properties.cell_coff]
                        * inputs[properties.cell_emask][..., None])
            else:
                coff = inputs[properties.cell_coff_fm].movedim(2, 3)
            inputs[properties.col_rij] = (column_gather_op(R, refs) + coff
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
    index schedules cached on them.  A ``cell_shard`` marker of length 1
    (2) makes them x-slab ((x, y)-block) refs (``painn.py:301-309``)."""
    refs = inputs.get(properties.col_refs)
    if refs is None:
        qcol = inputs[properties.cell_qcol]
        P = inputs[properties.R].shape[0] // (qcol.shape[0] * qcol.shape[1])
        shard = None
        if properties.cell_shard in inputs:
            shard = ((COLS_AXIS, COLS_AXIS_Y)
                     if inputs[properties.cell_shard].shape[0] >= 2
                     else COLS_AXIS)
        refs = ColRefs(qcol, inputs[properties.cell_dcol], P,
                       tuple(inputs[properties.cell_ksz]), shard)
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
