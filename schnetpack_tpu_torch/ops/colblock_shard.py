"""Slab-decomposed column ops on one card (port of
``schnetpack_tpu/ops/colblock_shard.py``).

The JAX package shards the column layout over a device mesh: each device
owns a slab of xy-columns, and before every gather the two x-boundary
column planes (and for (x, y) blocks the y planes first) are exchanged
with the neighbouring devices (``halo_x``/``halo_xy``); the kernels then
read their sources from the halo'd slab [nx+2, ny(+2), P, D] with no
wrap.  With one shard the exchanges are self-loops and the halo is the
periodic wrap of the slab's own edge planes, "exact for any device count"
(``colblock_shard.py:43-54``).  That is the case ported here: the halo is
a concatenation whose autograd adds both halo planes' cotangents back onto
the planes they copy (with nx = 2 one plane is both the left and the right
halo, and gets both).  More shards need the exchange between cards
(ROADMAP.md, Queue 1 item 9) and raise.

On CUDA tensors the ops launch K11/K12 (``colblock_select.py``) and K20/K21
(``colblock_edge.py``) in their halo modes; on CPU tensors they run the
twins, the decoded-index gather of ``ops/colblock.py`` (``_gather_hx_xla``)
and ``painn_message`` on the halo'd table (``_msg_hx_xla``).  The kernels
return the halo'd table's cotangent directly, so the JAX package's fold of
nine per-source-column partials (``_fold_partials_hx``) has no
counterpart.
"""
from __future__ import annotations

import torch

from .colblock import ColRefs

#: the mesh axis names of the slab path (x slabs; (x, y) blocks)
COLS_AXIS = "cols"
COLS_AXIS_Y = "cols_y"


def _is_2d(axes) -> bool:
    return isinstance(axes, (tuple, list)) and len(axes) == 2


def halo_x(cols: torch.Tensor) -> torch.Tensor:
    """[nx, ny, P, D] -> [nx+2, ny, P, D]: the x-halo planes of one shard,
    the periodic wrap of the slab's own edge planes."""
    return torch.cat([cols[-1:], cols, cols[:1]], dim=0)


def halo_xy(cols: torch.Tensor, axes):
    """The halo of an x slab (``axes`` one axis name; y stays periodic in
    the kernels) or an (x, y) block (a pair: the y planes first, then the
    x planes of the y-extended slab, which brings the corners).  Returns
    ``(halo'd cols, hy)``."""
    if _is_2d(axes):
        cols = torch.cat([cols[:, -1:], cols, cols[:, :1]], dim=1)
        return halo_x(cols), True
    return halo_x(cols), False


def _decode_hx(qcol: torch.Tensor, koffs, ny: int, P: int, hy: bool = False):
    """Edge -> row of the (x[, y])-halo'd flattened table, and the edge
    mask; the bucket of each slot is counted on the device from the
    bucket offsets, as in ``colblock.decode_j``."""
    q = qcol.long()
    nx_loc, _, Ktot = q.shape
    dev = q.device
    valid = q >= 0
    slot = torch.arange(Ktot, device=dev)
    c9 = sum((slot >= o).long() for o in koffs[1:9])
    x = torch.arange(nx_loc, device=dev)[:, None, None]
    y = torch.arange(ny, device=dev)[None, :, None]
    xs = x + c9 // 3 - 1 + 1                 # into the halo'd x axis
    if hy:
        ys = y + c9 % 3 - 1 + 1              # into the halo'd y axis
        j = (xs * (ny + 2) + ys) * P + q.clamp(min=0)
    else:
        ys = torch.remainder(y + c9 % 3 - 1, ny)
        j = (xs * ny + ys) * P + q.clamp(min=0)
    return j, valid


def _halo_table(table: torch.Tensor, refs: ColRefs) -> torch.Tensor:
    """The halo'd source table [(nx+2)(ny[+2]) P, D] of a slab table."""
    nx, ny, _ = refs.qcol.shape
    D = table.shape[-1]
    table_h, _ = halo_xy(table.reshape(nx, ny, refs.P, D), refs.shard_axis)
    return table_h.reshape(-1, D)


def column_gather_sharded(table: torch.Tensor, refs: ColRefs):
    """Per-edge source rows [nx, ny, Ktot, D] of a slab table [A', D]:
    the halo, then K11 in the halo mode of ``refs`` (its VJP K12 returns
    the halo'd cotangent, which the concatenation folds back)."""
    from .colblock_select import ColumnGather

    return ColumnGather.apply(_halo_table(table, refs).contiguous(), refs)


def painn_message_columns_sharded(xmu, rbf_aug, dir_e, FW_aug,
                                  refs: ColRefs):
    """The PaiNN message on a slab: the halo of xmu = [x, mu] [A', 6F],
    then K20/K21 in the halo mode of ``refs``.  Returns dq [A', F], dmu
    [A', 3F]."""
    from .colblock_edge import PaiNNMessageEdge

    return PaiNNMessageEdge.apply(_halo_table(xmu, refs).contiguous(),
                                  rbf_aug.contiguous(), dir_e.contiguous(),
                                  FW_aug, refs)
