"""Input modules computing pairwise displacements (port of
``schnetpack_tpu/atomistic/distances.py``), and the edge layouts that the
representations' plain per-edge passes read.

``NeuralNetworkPotential`` runs them after the positions require grad, so
forces flow back through them.  ``PairwiseDistances`` writes, per layout:

* the flat pair list (``idx_i``, ``idx_j``, ``offsets``): ``Rij =
  R[idx_j] - R[idx_i] + offsets`` [P, 3] (``distances.py:22-27``), and
  for a long-range list (``idx_i_lr``, ...) ``Rij_lr`` (``:72-78``);
* the dense [A, K] list (``nbh_idx``, ``nbh_offsets``): ``nbh_rij =
  R[nbh_idx] + nbh_offsets - R`` [A, K, 3] (``:64-71``), 0 at a padded
  slot whose index is the atom itself and whose offset is 0;
* the column layout: ``col_rij = gather(R) + coff - expand(R)`` [nx, ny,
  Ktot, 3] from K11 and K13 (``ops/colblock_select.py``), whose VJPs, K12
  and K14, carry dR.  The periodic offsets are zero at padded slots,
  where both selections give zero rows.  Inputs with ``cell_shard`` (the
  slab path of ``parallel/columns.py``) take the JAX package's sharded
  branch (``distances.py:37-53``): the gather reads the halo'd slab
  (K11/K12 in a halo mode, ``ops/colblock_shard.py``), the expand stays
  local, and the offsets are ``cell_coff`` [nx, ny, Ktot, 3] times
  ``cell_emask``;
* the 27-cell atom layout: ``nbh_rij = cell_gather(R) + nbh_offsets - R *
  nbh_mask`` [A', K, 3] from K16 (``ops/cellblock_gather.py``, VJP K17),
  exactly 0 at padded slots (``distances.py:54-62``).

``edge_layout`` hands a representation the per-edge displacements of its
inputs' layout with the two operations its plain passes need: ``gather``
(a per-atom table to every edge's source) and ``fold`` (per-edge values
summed onto each edge's destination): K11/K14 on the column layout,
``x[nbh_idx]`` (or ``ops/neighbor_gather.py`` with a reverse map) and a
sum over K on the dense layout, ``x[idx_j]`` and ``ops/scatter.py``'s
``segment_sum`` over ``idx_i`` on the flat layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import properties
from ..ops.cellblock_gather import CellRefs, cell_gather
from ..ops.colblock import ColRefs
from ..ops.colblock_select import (
    column_expand_op, column_fold_op, column_gather_op,
)
from ..ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y
from ..ops.math import safe_norm
from ..ops.neighbor_gather import neighbor_gather
from ..ops.scatter import enter_pairs, leave_pairs, segment_sum, take


class PairwiseDistances(nn.Module):
    """Adds the per-edge displacements of every layout in the inputs (see
    the module's docstring).  ``columns=False`` skips the unsharded column
    layout, for a representation whose kernels there take the positions
    (``reads_column_rij``: PaiNN's fused paths, SchNet), as XLA drops the
    JAX model's dead ``col_rij``."""

    def __init__(self, columns: bool = True):
        super().__init__()
        self.columns = columns

    def forward(self, inputs: Dict[str, torch.Tensor]):
        R = inputs[properties.R]
        Rp = enter_pairs(R, inputs.get(properties.pair_mesh))
        if properties.idx_i in inputs:
            inputs[properties.Rij] = (take(Rp, inputs[properties.idx_j])
                                      - take(Rp, inputs[properties.idx_i])
                                      + inputs[properties.offsets])
        if properties.cell_qcol in inputs:
            if self.columns or properties.cell_shard in inputs:
                refs = column_refs(inputs)
                if properties.cell_shard in inputs:
                    coff = (inputs[properties.cell_coff]
                            * inputs[properties.cell_emask][..., None])
                else:
                    coff = inputs[properties.cell_coff_fm].movedim(2, 3)
                inputs[properties.col_rij] = (
                    column_gather_op(R, refs) + coff
                    - column_expand_op(R, refs))
        elif properties.cell_qidx in inputs:
            inputs[properties.nbh_rij] = (
                cell_gather(R, cell_refs(inputs))
                + inputs[properties.nbh_offsets]
                - R[:, None, :] * inputs[properties.nbh_mask][..., None])
        elif properties.nbh_idx in inputs:
            inputs[properties.nbh_rij] = (
                take(R, inputs[properties.nbh_idx])
                + inputs[properties.nbh_offsets] - R[:, None, :])
        elif properties.idx_i not in inputs:
            raise NotImplementedError(
                "PairwiseDistances needs a neighbor layout: a flat pair "
                "list (idx_i/idx_j/offsets), a dense one (nbh_idx/"
                "nbh_offsets), the column layout (cell_qcol/cell_dcol/"
                "cell_coff_fm) or the 27-cell layout (cell_qidx)")
        if properties.idx_i_lr in inputs:
            inputs[properties.Rij_lr] = (
                take(Rp, inputs[properties.idx_j_lr])
                - take(Rp, inputs[properties.idx_i_lr])
                + inputs[properties.offsets_lr])
        return inputs


class FilterShortRange(nn.Module):
    """The short-range view of one full pair list as the same arrays with
    a tightened ``pair_mask``; the full list becomes the long-range one
    (``distances.py:81-104``)."""

    def __init__(self, short_range_cutoff: float):
        super().__init__()
        self.short_range_cutoff = float(short_range_cutoff)

    def forward(self, inputs: Dict[str, torch.Tensor]):
        Rij = inputs[properties.Rij]
        d = torch.linalg.vector_norm(Rij, dim=-1)
        mask = inputs[properties.pair_mask]
        inputs[properties.idx_i_lr] = inputs[properties.idx_i]
        inputs[properties.idx_j_lr] = inputs[properties.idx_j]
        inputs[properties.Rij_lr] = Rij
        inputs[properties.pair_mask_lr] = mask
        inputs[properties.pair_mask] = mask * (
            d < self.short_range_cutoff).to(mask.dtype)
        return inputs


class ColumnEdges:
    """Edges [nx, ny, Ktot, ...] of the column layout: K11 gathers, K14
    folds (their VJPs K12 and K13)."""

    def __init__(self, refs: ColRefs):
        self.refs = refs

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        out = column_gather_op(x.reshape(x.shape[0], -1), self.refs)
        return out.reshape(out.shape[:3] + x.shape[1:])

    def fold(self, m: torch.Tensor) -> torch.Tensor:
        out = column_fold_op(m.flatten(3), self.refs)
        return out.reshape((out.shape[0],) + m.shape[3:])


class DenseEdges:
    """Edges [A, K, ...] of the dense layout: ``x[nbh_idx]``, or with a
    reverse map the scatter-free ``neighbor_gather``; a sum over K."""

    def __init__(self, nbh_idx: torch.Tensor,
                 nbh_rev: Optional[torch.Tensor] = None,
                 nbh_mask: Optional[torch.Tensor] = None):
        self.nbh_idx, self.nbh_rev, self.nbh_mask = nbh_idx, nbh_rev, nbh_mask

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.nbh_rev is not None:
            return neighbor_gather(x, self.nbh_idx, self.nbh_rev,
                                   self.nbh_mask)
        return take(x, self.nbh_idx)

    def fold(self, m: torch.Tensor) -> torch.Tensor:
        return m.sum(1)


class FlatEdges:
    """Edges [P, ...] of the flat pair list: ``x[idx_j]``, a segment sum
    over ``idx_i`` into ``n_atoms`` rows."""

    def __init__(self, idx_i: torch.Tensor, idx_j: torch.Tensor,
                 n_atoms: int, mesh=None):
        self.idx_i, self.idx_j, self.n_atoms = idx_i, idx_j, n_atoms
        #: the mesh whose ranks split the pairs (``parallel/spatial.py``)
        self.mesh = mesh

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return take(enter_pairs(x, self.mesh), self.idx_j)

    def fold(self, m: torch.Tensor) -> torch.Tensor:
        return leave_pairs(segment_sum(m, self.idx_i, self.n_atoms),
                           self.mesh)


def as_edges(layout):
    """An edges object of a layout: ``ColRefs`` stand for their column
    edges."""
    return ColumnEdges(layout) if isinstance(layout, ColRefs) else layout


def edge_layout(inputs: Dict[str, torch.Tensor], reverse: bool = True,
                dense: Optional[bool] = None):
    """(edges, displacements [E..., 3], mask [E...]) of the inputs' layout,
    in the JAX representations' order of choice: the column layout
    (``col_rij``, real slots), else the dense one where ``nbh_rij`` is in
    the inputs (the 27-cell layout's too; ``dense`` overrides that test),
    else the flat one (``Rij``, ``pair_mask``).  ``reverse=False`` ignores
    a reverse map."""
    if not any(k in inputs for k in (
            properties.cell_qcol, properties.nbh_rij, properties.nbh_idx,
            properties.idx_i, properties.Rij)):
        raise NotImplementedError(
            "the inputs carry no neighbor layout: the port's representations "
            "take the column layout (cell_qcol/cell_dcol/cell_coff_fm), the "
            "27-cell layout (cell_qidx), the dense layout (nbh_idx/nbh_mask/"
            "nbh_offsets) or the flat pair list (idx_i/idx_j/offsets/"
            "pair_mask)")
    if properties.cell_qcol in inputs:
        if properties.col_rij not in inputs:
            raise ValueError(
                "this representation reads the column layout's per-edge "
                "displacements col_rij: run atomistic.PairwiseDistances as "
                "an input module")
        refs = column_refs(inputs)
        Rij = inputs[properties.col_rij]
        return ColumnEdges(refs), Rij, (refs.qcol >= 0).to(Rij.dtype)
    if dense is None:
        dense = properties.nbh_rij in inputs
    if dense:
        mask = inputs[properties.nbh_mask]
        rev = inputs.get(properties.nbh_rev) if reverse else None
        return (DenseEdges(inputs[properties.nbh_idx], rev, mask),
                inputs[properties.nbh_rij], mask)
    if properties.Rij not in inputs:
        raise ValueError(
            "this representation reads the per-edge displacements Rij of "
            "the flat pair list (or nbh_rij of a dense one): run "
            "atomistic.PairwiseDistances as an input module")
    return (FlatEdges(inputs[properties.idx_i], inputs[properties.idx_j],
                      inputs[properties.R].shape[0],
                      inputs.get(properties.pair_mesh)),
            inputs[properties.Rij], inputs[properties.pair_mask])


def edge_geometry(Rij: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(safe distance, unit direction) of per-edge displacements; a
    padded slot's zero displacement gives d = sqrt(1e-15) and a zero
    direction, with finite gradients."""
    d = safe_norm(Rij)
    return d, Rij / d[..., None]


def column_refs(inputs: Dict[str, torch.Tensor]) -> ColRefs:
    """The column-layout refs of a model's inputs, built once per forward
    and kept in the inputs, so that every op of the forward shares the
    index schedules cached on them.  A ``cell_shard`` marker of length 1
    (2) makes them x-slab ((x, y)-block) refs (``painn.py:301-309``), whose
    halo planes come from the ranks of ``cell_mesh`` where the inputs
    carry one."""
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
                       tuple(inputs[properties.cell_ksz]), shard,
                       inputs.get(properties.cell_mesh))
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
