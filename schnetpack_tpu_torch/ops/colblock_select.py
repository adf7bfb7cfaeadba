"""Generic column gather, its VJP, expand and fold: CUDA kernels K11-K14
and their twins.

Port of the row-11 TPU kernels of ``schnetpack_tpu/ops/colblock_pallas.py``
(``column_gather_pallas``, ``column_expand_pallas``,
``column_fold_pallas``), which SO3net's positions and convolutions run
through on the column layout:

* gather: per-edge source rows [nx, ny, Ktot, D] of a table [A', D];
  forward K11, backward K12 (the per-source-row sum);
* expand: per-edge destination rows; forward K13, backward K14;
* fold: sum per destination row [A', D]; forward K14, backward K13;

paired as the JAX package's ``custom_vjp``s pair them
(``colblock_pallas.py:188-318``).  The gather and its VJP also run on the
slab path's halo'd tables (``_gather_hx_call``/``_gather_hx_bwd_call``,
``colblock_shard.py:131-199``), in the source-index mode of the refs.
The kernels (``csrc/colblock_select.cu``) take any width D and any
capacity P: the positions (D = 3, which K11 and K13 copy one slot a
thread and K12 and K14 sum ``ROW_LANES`` lanes a row) and SO3net's
flattened features (D = 9 x F).  K12 and K14 are one kernel, a sum of
each row's run of sorted slots, on the source order and on the
destination order of the refs.  The 27-cell layout's gather and its VJP
(K16/K17, ``ops/cellblock_gather.py``) run on the same kernels.  On CPU
tensors the ops run the twins: the plain gather, expand and fold of
``ops/colblock.py`` and the gather's transpose.  On CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .colblock import (
    ColRefs, column_expand, column_fold, column_gather, decode_src,
    destination_order, source_order,
)

#: kernel launches since the last reset, in any source-index mode (SO3net
#: MD: K11 4, K12 3, K13 4, K14 4 per step; painn_slab: 1 each, K11/K12 in
#: the halo_x mode)
LAUNCHES = {"gather_fwd": 0, "gather_bwd": 0, "expand_fwd": 0, "fold_fwd": 0}
#: lanes of the group that sums a row at a narrow width (D < 8, D % 4 != 0;
#: ``kRowLanes`` of ``csrc/colblock_select.cu``)
ROW_LANES = 4


class SelectArgs(ctypes.Structure):
    """K11/K13/K16's launch arguments that the layout fixes (``SelectArgs``
    in ``csrc/colblock_select.cu``), made once per layout and mode and
    passed by address: one argument where there would be seven to convert
    on every launch.  nz, C and K are the 27-cell layout's (0 on the
    column layout)."""

    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("P", ctypes.c_int), ("Ktot", ctypes.c_int),
                ("koffs", ctypes.c_int * 10), ("hx", ctypes.c_int),
                ("hy", ctypes.c_int), ("nz", ctypes.c_int),
                ("C", ctypes.c_int), ("K", ctypes.c_int)]


def _check_refs(refs: ColRefs):
    """(nx, ny, Ktot, A', source rows, address of the ``SelectArgs``) of
    the refs, made and their index tensors checked once per (qcol, dcol,
    P, ksizes, mode): the cache outlives a ``dataclasses.replace``."""
    hit = refs.cache.get("select_dims")
    key = (refs.P, refs.ksizes, refs.shard_axis)
    if (hit is None or hit[0] is not refs.qcol or hit[1] is not refs.dcol
            or hit[2] != key):
        nx, ny, Ktot = refs.qcol.shape
        _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
        _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)
        args = SelectArgs(nx, ny, refs.P, Ktot, refs.koffs_arg, *refs.halo)
        hit = refs.cache["select_dims"] = (
            refs.qcol, refs.dcol, key, args,
            (nx, ny, Ktot, nx * ny * refs.P, refs.src_rows,
             ctypes.addressof(args)))
    return hit[4]


def gather_fwd_kernel(table, refs: ColRefs):
    """K11: out[x, y, k] = table[j(x, y, k)], 0 at padded slots; ``table``
    is the source table of the refs' mode (halo'd for sharded refs)."""
    nx, ny, Ktot, _, n_src, args = _check_refs(refs)
    D = table.shape[-1]
    _build.check(table, "table", (n_src, D))
    out = table.new_empty((nx, ny, Ktot, D))
    _build.launch("spk_gather_fwd", table.data_ptr(), refs.qcol.data_ptr(),
                  out.data_ptr(), args, D)
    LAUNCHES["gather_fwd"] += 1
    return out


def expand_fwd_kernel(table, refs: ColRefs):
    """K13: out[x, y, k] = table[i(x, y, k)], 0 at padded slots."""
    nx, ny, Ktot, Ap, _, args = _check_refs(refs)
    D = table.shape[-1]
    _build.check(table, "table", (Ap, D))
    out = table.new_empty((nx, ny, Ktot, D))
    _build.launch("spk_expand_fwd", table.data_ptr(), refs.dcol.data_ptr(),
                  out.data_ptr(), args, D)
    LAUNCHES["expand_fwd"] += 1
    return out


def gather_bwd_kernel(g, refs: ColRefs):
    """K12: the gather's VJP, dT [A'_src, D] = per-source-row sums of g
    over the source table of the refs' mode."""
    nx, ny, Ktot, *_ = _check_refs(refs)
    D = g.shape[-1]
    _build.check(g, "g", (nx, ny, Ktot, D))
    esorted, _, rowptr = source_order(refs)
    n = refs.src_rows
    dT = g.new_empty((n, D))
    p = _build.ptr
    _build.launch("spk_row_sums", p(g), p(esorted), p(rowptr), p(dT), n, D)
    LAUNCHES["gather_bwd"] += 1
    return dT


def fold_fwd_kernel(edge_vals, refs: ColRefs):
    """K14: out [A', D] = per-destination-row sums of edge_vals, K12's
    row sums on the destination order (``destination_order``)."""
    nx, ny, Ktot, Ap, _, _ = _check_refs(refs)
    D = edge_vals.shape[-1]
    _build.check(edge_vals, "edge_vals", (nx, ny, Ktot, D))
    dsorted, _, rowptr = destination_order(refs)
    out = edge_vals.new_empty((Ap, D))
    p = _build.ptr
    _build.launch("spk_row_sums", p(edge_vals), p(dsorted), p(rowptr), p(out),
                  Ap, D)
    LAUNCHES["fold_fwd"] += 1
    return out


#: plain twins of K11, K13 and K14: ``_column_gather_xla`` (on a halo'd
#: table ``_gather_hx_xla``), ``_column_expand_xla`` and
#: ``_column_fold_xla``
gather_fwd_plain = column_gather
expand_fwd_plain = column_expand
fold_fwd_plain = column_fold


def gather_bwd_plain(g, refs: ColRefs):
    """Plain twin of K12: the transpose of the gather."""
    j, valid = decode_src(refs)
    D = g.shape[-1]
    v = (g * valid[..., None].to(g.dtype)).reshape(-1, D)
    return g.new_zeros((refs.src_rows, D)).index_add(0, j.reshape(-1), v)


class ColumnGather(torch.autograd.Function):
    """Forward K11, backward K12 on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, table, refs):
        ctx.refs = refs
        if table.is_cuda:
            return gather_fwd_kernel(table, refs)
        return gather_fwd_plain(table, refs)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.is_cuda:
            return gather_bwd_kernel(g, ctx.refs), None
        return gather_bwd_plain(g, ctx.refs), None


class ColumnExpand(torch.autograd.Function):
    """Forward K13, backward K14 on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, table, refs):
        ctx.refs = refs
        if table.is_cuda:
            return expand_fwd_kernel(table, refs)
        return expand_fwd_plain(table, refs)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.is_cuda:
            return fold_fwd_kernel(g, ctx.refs), None
        return fold_fwd_plain(g, ctx.refs), None


class ColumnFold(torch.autograd.Function):
    """Forward K14, backward K13 on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, edge_vals, refs):
        ctx.refs = refs
        if edge_vals.is_cuda:
            return fold_fwd_kernel(edge_vals, refs)
        return fold_fwd_plain(edge_vals, refs)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.is_cuda:
            return expand_fwd_kernel(g, ctx.refs), None
        return expand_fwd_plain(g, ctx.refs), None


def column_gather_op(table, refs: ColRefs):
    """Per-edge source rows [nx, ny, Ktot, D] of ``table`` [A', D]
    (``schnetpack_tpu.ops.colblock.column_gather``: sharded refs take the
    slab path of ``colblock_shard``)."""
    if refs.shard_axis is not None:
        from .colblock_shard import column_gather_sharded

        return column_gather_sharded(table, refs)
    return ColumnGather.apply(table.contiguous(), refs)


def column_expand_op(table, refs: ColRefs):
    """Per-edge destination rows [nx, ny, Ktot, D] of ``table`` [A', D]
    (``schnetpack_tpu.ops.colblock.column_expand``)."""
    return ColumnExpand.apply(table.contiguous(), refs)


def column_fold_op(edge_vals, refs: ColRefs):
    """Sum per destination row: [nx, ny, Ktot, D] -> [A', D]
    (``schnetpack_tpu.ops.colblock.column_fold``)."""
    return ColumnFold.apply(edge_vals.contiguous(), refs)
