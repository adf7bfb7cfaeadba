"""Slab-decomposed column ops (port of ``schnetpack_tpu/ops/colblock_shard.py``).

The column layout is split over a mesh of ranks: each rank owns a slab of
xy-columns (x slabs, or (x, y) blocks), and before every gather the two
x-boundary column planes (for (x, y) blocks the y planes first, then the
x planes of the y-extended slab, which brings the corners) are exchanged
with the neighbouring ranks (``halo_x``/``halo_xy``); the kernels then
read their sources from the halo'd slab [nx+2, ny(+2), P, D] with no
wrap.  ``HaloExchange`` is that exchange as an autograd function: its
forward sends the slab's two edge planes along one mesh axis and receives
the neighbours' (``dist.batch_isend_irecv``, through host buffers under
gloo on a card, the card's tensors directly under NCCL), its backward
sends each halo plane's cotangent back to the rank that owns the plane
and adds the cotangents it receives onto its own edge planes: the
transpose of JAX's ``ppermute``.  So each rank can differentiate its own
energy, and the cross-rank force terms come back through the exchange.
Every rank must run the same exchanges in the same order, forward and
backward.  A mesh axis of one rank keeps the periodic wrap of the slab's
own edge planes, a concatenation whose autograd adds both halo planes'
cotangents back (with nx = 2 one plane is both the left and the right
halo, and gets both): "exact for any device count"
(``colblock_shard.py:43-54``).

On CUDA tensors the ops launch K11/K12 (``colblock_select.py``) and K20/K21
(``colblock_edge.py``) in their halo modes; on CPU tensors they run the
twins, the decoded-index gather of ``ops/colblock.py`` (``_gather_hx_xla``)
and ``painn_message`` on the halo'd table (``_msg_hx_xla``).  The kernels
return the halo'd table's cotangent directly, so the JAX package's fold of
nine per-source-column partials (``_fold_partials_hx``) has no
counterpart.
"""
from __future__ import annotations

import time

import torch
from torch.autograd.function import once_differentiable

from .colblock import ColRefs

#: the mesh axis names of the slab path (x slabs; (x, y) blocks)
COLS_AXIS = "cols"
COLS_AXIS_Y = "cols_y"
#: exchanges between ranks (each a pair of planes each way, forward or
#: backward) and the host's wall seconds inside them, waits included
EXCHANGES = {"calls": 0, "seconds": 0.0}


def _is_2d(axes) -> bool:
    return isinstance(axes, (tuple, list)) and len(axes) == 2


def _exchange(to_next: torch.Tensor, to_prev: torch.Tensor, mesh,
              axis: str):
    """Send ``to_next`` to the next rank along ``axis`` and ``to_prev`` to
    the previous one; return (what the previous rank sent its next, what
    the next rank sent its previous).  The sends and receives are posted
    in one order on every rank and tagged, so that with two ranks on the
    axis, where both neighbours are one rank, the two planes keep their
    sides."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    nxt, prev = mesh.neighbour(axis, 1), mesh.neighbour(axis, -1)
    # gloo sends and receives host tensors only
    host = mesh.backend == "gloo" and to_next.device.type == "cuda"
    dev = to_next.device

    def wire(t):
        t = t.detach().contiguous()
        return t.cpu() if host else t

    out_next, out_prev = wire(to_next), wire(to_prev)
    from_prev = torch.empty_like(out_next)
    from_next = torch.empty_like(out_prev)
    ops = [dist.P2POp(dist.isend, out_next, nxt, mesh.group, 0),
           dist.P2POp(dist.isend, out_prev, prev, mesh.group, 1),
           dist.P2POp(dist.irecv, from_prev, prev, mesh.group, 0),
           dist.P2POp(dist.irecv, from_next, nxt, mesh.group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    from_prev, from_next = from_prev.to(dev), from_next.to(dev)
    EXCHANGES["calls"] += 1
    EXCHANGES["seconds"] += time.perf_counter() - t0
    return from_prev, from_next


class HaloExchange(torch.autograd.Function):
    """[..., n, ...] -> [..., n+2, ...] along ``dim``: the slab with the
    previous rank's last plane before it and the next rank's first plane
    after it (mesh axis ``axis``); the backward returns each halo plane's
    cotangent to its owner (see the module's docstring)."""

    @staticmethod
    def forward(ctx, cols, dim: int, mesh, axis: str):
        n = cols.shape[dim]
        left, right = _exchange(cols.narrow(dim, n - 1, 1),
                                cols.narrow(dim, 0, 1), mesh, axis)
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return torch.cat([left, cols, right], dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # the exchange detaches its planes: a double backward through it
        # raises, as the slab path's kernels have no second derivative
        dim = ctx.dim
        n = g.shape[dim] - 2
        d_first, d_last = _exchange(g.narrow(dim, n + 1, 1),
                                    g.narrow(dim, 0, 1), ctx.mesh, ctx.axis)
        dcols = g.narrow(dim, 1, n).clone()
        dcols.narrow(dim, 0, 1).add_(d_first)
        dcols.narrow(dim, n - 1, 1).add_(d_last)
        return dcols, None, None, None


def _halo(cols: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    if mesh is None or mesh.axis_size(axis) == 1:
        n = cols.shape[dim]
        return torch.cat([cols.narrow(dim, n - 1, 1), cols,
                          cols.narrow(dim, 0, 1)], dim)
    return HaloExchange.apply(cols, dim, mesh, axis)


def halo_x(cols: torch.Tensor, mesh=None) -> torch.Tensor:
    """[nx, ny, P, D] -> [nx+2, ny, P, D]: the x-halo planes of a slab,
    from the neighbouring ranks of ``mesh`` along ``COLS_AXIS`` (the
    periodic wrap of the slab's own edge planes on one rank)."""
    return _halo(cols, 0, mesh, COLS_AXIS)


def halo_xy(cols: torch.Tensor, axes, mesh=None):
    """The halo of an x slab (``axes`` one axis name; y stays periodic in
    the kernels) or an (x, y) block (a pair: the y planes first, then the
    x planes of the y-extended slab, which brings the corners).  Returns
    ``(halo'd cols, hy)``."""
    if _is_2d(axes):
        cols = _halo(cols, 1, mesh, COLS_AXIS_Y)
        return halo_x(cols, mesh), True
    return halo_x(cols, mesh), False


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
    table_h, _ = halo_xy(table.reshape(nx, ny, refs.P, D), refs.shard_axis,
                         refs.mesh)
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
