"""Row 12, the PaiNN column message on edge-major geometry: CUDA kernels
K20/K21 and their twins.

Port of ``schnetpack_tpu/ops/colblock_pallas.py::painn_message_columns_
pallas`` (the kernels ``_msg_fwd_kernel``, ``_msg_bwd_kernel``) and of its
halo'd launches ``colblock_shard.py::_msg_hx_fwd_call``/``_msg_hx_bwd_
call``.  The message reads xmu = [x, mu] [A'_src, 6F] (rows of the source
table: the slab's own [nx, ny] table, wrapped, or its halo'd one),
per-slot rbf_aug [nx, ny, Ktot, B+1] = [phi*fcut, fcut] and directions
[nx, ny, Ktot, 3] that autograd differentiates, and FW_aug [B+1, 3F]:

* K20 (``csrc/colblock_message.cu::msg_fwd_kernel<true, .>`` on an
  edge-major view) sums dq [A', F] and dmu [A', 3F] per destination atom,
  K6's destination-sorted schedule;
* K21 (``csrc/colblock_message_bwd.cu::msg_bwd_kernel<kSrc, W, .>`` on the
  same view) returns dxmu over the whole source table (the ``dxmu_h`` of
  ``_msg_hx_bwd_call:354-357``), the geometry cotangents grbf and gdir (0
  at padded slots), and in its wgrad instance, which the op launches when
  FW_aug requires grad, gFW: K15's source-centric schedule over the slots
  sorted by source-table row.

The source-index mode comes from the refs (``ColRefs.halo``).  On CPU
tensors the op runs the twins: ``painn_message`` on the two halves of
xmu, which gathers in the refs' mode (``_painn_message_xla``, and on the
halo'd table ``_msg_hx_xla``), and its autograd VJP.
"""
from __future__ import annotations

import torch

from . import _build
from .colblock import (
    ColRefs, destination_schedule, painn_message, source_schedule,
)
from .colblock_message import (
    BWD_SRC, FWD_GEO, _bwd_schedule, _fwd_schedule, _gfw_partials,
    _tuned_bwd, _tuned_fwd, _with_gfw, bwd_gen, fwd_gen, gen_groups,
    gen_tiles, with_gen_gfw,
)

#: kernel launches since the last reset (painn_slab MD: 3 each per step;
#: ``msg_bwd_edge_wgrad`` counts K21's wgrad instance, ``_gen`` the
#: general instances of widths the tuned bodies do not take)
LAUNCHES = {"msg_fwd_edge": 0, "msg_bwd_edge": 0, "msg_bwd_edge_wgrad": 0,
            "msg_fwd_edge_gen": 0, "msg_bwd_edge_gen": 0,
            "msg_bwd_edge_wgrad_gen": 0}


def _check(xmu, rbf_aug, dirs, FW_aug, refs: ColRefs):
    nx, ny, Ktot = refs.qcol.shape
    F, B = xmu.shape[1] // 6, FW_aug.shape[0] - 1
    if any(k % 8 for k in refs.ksizes):
        raise ValueError(f"bucket sizes must be multiples of 8: {refs.ksizes}")
    _build.check(xmu, "xmu", (refs.src_rows, 6 * F))
    _build.check(rbf_aug, "rbf_aug", (nx, ny, Ktot, B + 1))
    _build.check(dirs, "dir", (nx, ny, Ktot, 3))
    _build.check(FW_aug, "FW_aug", (B + 1, 3 * F))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)
    sx, sy = refs.src_cols
    return nx, ny, Ktot, F, B, sx * sy


def msg_fwd_edge_kernel(xmu, rbf_aug, dirs, FW_aug, refs: ColRefs):
    """K20: dq [A', F], dmu [A', 3F] summed per destination atom."""
    nx, ny, Ktot, F, B, _ = _check(xmu, rbf_aug, dirs, FW_aug, refs)
    Ap = nx * ny * refs.P
    dq = xmu.new_empty((Ap, F))
    dmu = xmu.new_empty((Ap, 3 * F))
    hx, hy = refs.halo
    if not _tuned_fwd(FWD_GEO, F, B, refs.P):
        G = gen_groups(xmu.device, refs.P, nx * ny, False, FWD_GEO, False, F,
                       B)
        fwd_gen(FWD_GEO, 3, xmu, xmu[:, 3 * F:], FW_aug,
                *destination_schedule(refs, G), G, dq, dmu,
                (nx, ny, refs.P, Ktot), F, B, 6 * F, rbf=rbf_aug, dirs=dirs,
                edge=1, qcol=refs.qcol, dcol=refs.dcol,
                koffs=refs.koffs_arg, halo=(hx, hy))
        LAUNCHES["msg_fwd_edge_gen"] += 1
        return dq, dmu
    dsorted, dgrp, G = _fwd_schedule(refs, FWD_GEO, F, B)
    p = _build.ptr
    _build.launch("spk_msg_fwd_edge", p(xmu), p(rbf_aug), p(dirs), p(FW_aug),
                  p(refs.qcol), p(refs.dcol), p(dsorted), p(dgrp), p(dq),
                  p(dmu), nx, ny, refs.P, Ktot, refs.koffs_arg, G, F, B, hx,
                  hy)
    LAUNCHES["msg_fwd_edge"] += 1
    return dq, dmu


def msg_bwd_edge_kernel(xmu, rbf_aug, dirs, FW_aug, refs: ColRefs, g_dq,
                        g_dmu, wgrad: bool = False):
    """K21: cotangents (dxmu [A'_src, 6F], grbf, gdir) of K20's outputs for
    (g_dq, g_dmu), and with ``wgrad`` also gFW [B+1, 3F] (the blocks' f64
    partials summed here)."""
    nx, ny, Ktot, F, B, n_src = _check(xmu, rbf_aug, dirs, FW_aug, refs)
    Ap = nx * ny * refs.P
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    dxmu = torch.empty_like(xmu)
    if not _tuned_bwd(BWD_SRC, wgrad, F, B):
        G = gen_groups(xmu.device, refs.P, n_src, True, BWD_SRC, wgrad, F, B)
        Z = gen_tiles(F)
        grbf = rbf_aug.new_zeros((Z, *rbf_aug.shape))
        gdir = dirs.new_zeros((Z, *dirs.shape))
        gFW = bwd_gen(BWD_SRC, 3, xmu, xmu[:, 3 * F:], FW_aug,
                      *source_schedule(refs, G), G, g_dq, g_dmu, dxmu,
                      dxmu[:, 3 * F:], n_src, (nx, ny, refs.P, Ktot), F, B,
                      6 * F, wgrad, rbf=rbf_aug, dirs=dirs, edge=1,
                      qcol=refs.qcol, dcol=refs.dcol, koffs=refs.koffs_arg,
                      grbf=grbf, gdir=gdir)
        LAUNCHES["msg_bwd_edge_wgrad_gen" if wgrad
                 else "msg_bwd_edge_gen"] += 1
        return with_gen_gfw((dxmu, grbf.sum(0), gdir.sum(0)), gFW)
    esorted, grp, G = _bwd_schedule(refs, n_src, BWD_SRC, wgrad, F, B)
    grbf = torch.zeros_like(rbf_aug)
    gdir = torch.zeros_like(dirs)
    gFWp = _gfw_partials(xmu, FW_aug, n_src * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd_edge", p(xmu), p(rbf_aug), p(dirs),
                  p(FW_aug), p(refs.qcol), p(refs.dcol), p(esorted), p(grp),
                  p(g_dq), p(g_dmu), p(dxmu), p(grbf), p(gdir),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, n_src)
    LAUNCHES["msg_bwd_edge_wgrad" if wgrad else "msg_bwd_edge"] += 1
    return _with_gfw((dxmu, grbf, gdir), gFWp)


def msg_fwd_edge_plain(xmu, rbf_aug, dirs, FW_aug, refs: ColRefs):
    """Plain twin of K20 (autograd-able in every input)."""
    F = xmu.shape[1] // 6
    return painn_message(xmu[:, :3 * F], xmu[:, 3 * F:], rbf_aug, dirs,
                         FW_aug, refs)


def msg_bwd_edge_plain(xmu, rbf_aug, dirs, FW_aug, refs: ColRefs, g_dq,
                       g_dmu):
    """Plain twin of K21: the VJP of ``msg_fwd_edge_plain`` w.r.t. (xmu,
    rbf_aug, dirs, FW_aug), i.e. (dxmu, grbf, gdir, gFW)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (xmu, rbf_aug, dirs, FW_aug)]
        out = msg_fwd_edge_plain(*ins, refs)
        return torch.autograd.grad(out, ins, (g_dq, g_dmu))


class PaiNNMessageEdge(torch.autograd.Function):
    """K20 forward, K21 backward (its wgrad instance when FW_aug needs a
    gradient) on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, xmu, rbf_aug, dirs, FW_aug, refs):
        ctx.save_for_backward(xmu, rbf_aug, dirs, FW_aug)
        ctx.refs = refs
        if xmu.is_cuda:
            return msg_fwd_edge_kernel(xmu, rbf_aug, dirs, FW_aug, refs)
        return msg_fwd_edge_plain(xmu, rbf_aug, dirs, FW_aug, refs)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        xmu, rbf_aug, dirs, FW_aug = ctx.saved_tensors
        g_dq, g_dmu = g_dq.contiguous(), g_dmu.contiguous()
        wgrad = ctx.needs_input_grad[3]
        if xmu.is_cuda:
            dxmu, grbf, gdir, *gFW = msg_bwd_edge_kernel(
                xmu, rbf_aug, dirs, FW_aug, ctx.refs, g_dq, g_dmu, wgrad)
        else:
            dxmu, grbf, gdir, *gFW = msg_bwd_edge_plain(
                xmu, rbf_aug, dirs, FW_aug, ctx.refs, g_dq, g_dmu)
        return dxmu, grbf, gdir, gFW[0] if wgrad else None, None


def painn_message_columns(xmu, rbf_aug, dir_e, FW_aug, refs: ColRefs):
    """PaiNN inter-atomic message over the column layout (signature of
    ``schnetpack_tpu.ops.colblock.painn_message_columns``): xmu [A', 6F],
    rbf_aug [nx, ny, Ktot, B+1], dir_e [nx, ny, Ktot, 3], FW_aug [B+1,
    3F].  Sharded refs take the slab path (``colblock_shard``), others
    K20/K21 in the wrap mode.  Returns dq [A', F], dmu [A', 3F]."""
    if refs.shard_axis is not None:
        from .colblock_shard import painn_message_columns_sharded

        return painn_message_columns_sharded(xmu, rbf_aug, dir_e, FW_aug,
                                             refs)
    return PaiNNMessageEdge.apply(xmu.contiguous(), rbf_aug.contiguous(),
                                  dir_e.contiguous(), FW_aug, refs)
