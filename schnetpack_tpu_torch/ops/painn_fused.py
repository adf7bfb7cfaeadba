"""PaiNN message of the 27-cell atom layout: CUDA kernels K18/K19 and their
twins.

Port of ``schnetpack_tpu/ops/painn_fused.py``:
``painn_message_cellblock(xmu [A', 6F], rbf_aug [A', K, B+1], dir_ij
[A', K, 3], FW_aug [B+1, 3F], qidx) -> dq [A', F], dmu [A', 3F]``, with
xmu = [x, mu] (the context x [A', 3F] and the flat vector features mu),
rbf_aug = [phi * fcut, fcut] (masked) and FW_aug the filter network's
weights with its bias as the last row.  Per edge slot (a, k) with source
row j: W = rbf_aug @ FW_aug, [dqe, dmuR, dmumu] = x_j * W, and the sums
over k of dqe and of dmuR * dir + dmumu * mu_j (``_message_xla``,
``painn_fused.py:63-75``).

The forward is K18, the backward K19, which returns dxmu, grbf [A', K,
B+1] and gdir [A', K, 3], and in its wgrad instance gFW [B+1, 3F]; the
op launches that instance only when ``FW_aug`` requires grad (MD freezes
the model).  Both are the column message bodies of K20/K21 in their cell
index mode (``csrc/colblock_message.cu::msg_fwd_kernel<kCellIn, .>``,
``csrc/colblock_message_bwd.cu::msg_bwd_kernel<kCell, W, .>``): the
layout's nx*ny stacks of nz cells are the columns (``CellRefs.stack``),
the kernels decode each slot's code in place of the column refs, and walk
the stack schedules cached on the refs (``cellblock_gather.
stack_destination_schedule``, ``stack_source_schedule``), with the row
ranges per stack sized as the column kernels' (``colblock_message.
_groups``).  The tuned bodies take F % 32 == 0, F <= 256 and, in the
wgrad instance, B+1 <= 32 within its shared memory; every other shape
runs the general instances (``csrc/colblock_message_gen.cu`` in the cell
index mode, counted as ``cell_msg_fwd_gen`` and ``cell_msg_bwd_gen``).
On CPU tensors the op runs the twins, on CUDA tensors the kernels, and
it raises otherwise.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .cellblock_gather import (
    CellRefs, _check_refs, _on, as_refs, cell_gather_bwd_plain,
    cell_gather_plain, stack_destination_schedule, stack_source_schedule,
)
from .colblock_message import (
    BWD_CELL, FWD_CELL, _gfw_partials, _groups, _tuned_bwd, _tuned_fwd,
    _with_gfw, bwd_gen, fwd_gen, gen_groups, gen_tiles, with_gen_gfw,
)

#: kernel launches since the last reset (painn_cell MD: K18 3, K19 3 per
#: step; ``_gen``: the general instances)
LAUNCHES = {"cell_msg_fwd": 0, "cell_msg_bwd": 0, "cell_msg_fwd_gen": 0,
            "cell_msg_bwd_gen": 0}


def _check(xmu, rbf_aug, dir_ij, FW_aug, refs: CellRefs):
    F = xmu.shape[1] // 6
    B1 = FW_aug.shape[0]
    Ap, K = _check_refs(refs)
    _build.check(xmu, "xmu", (Ap, 6 * F))
    _build.check(rbf_aug, "rbf_aug", (Ap, K, B1))
    _build.check(dir_ij, "dir_ij", (Ap, K, 3))
    _build.check(FW_aug, "FW_aug", (B1, 3 * F))
    return Ap, F, B1 - 1


def cell_msg_fwd_kernel(xmu, rbf_aug, dir_ij, FW_aug, qidx):
    """K18: dq [A', F], dmu [A', 3F] summed per destination row; rows
    without a slot (the cells' padding rows among them) are 0."""
    refs = as_refs(qidx)
    Ap, F, B = _check(xmu, rbf_aug, dir_ij, FW_aug, refs)
    n_cols, P, Ktot = refs.stack
    dq = xmu.new_empty((Ap, F))
    dmu = xmu.new_empty((Ap, 3 * F))
    if not _tuned_fwd(FWD_CELL, F, B, P):
        nx, ny, nz, C, K = refs.dims
        G = gen_groups(xmu.device, P, n_cols, False, FWD_CELL, False, F, B)
        fwd_gen(FWD_CELL, 3, xmu, xmu[:, 3 * F:], FW_aug,
                *stack_destination_schedule(refs, G), G, dq, dmu,
                (nx, ny, P, Ktot), F, B, 6 * F, rbf=rbf_aug, dirs=dir_ij,
                edge=1, qcol=refs.qidx, cell=(nz, C, K))
        LAUNCHES["cell_msg_fwd_gen"] += 1
        return dq, dmu
    G = _groups(xmu.device, P, n_cols, "spk_msg_fwd_blocks", FWD_CELL, F, B,
                P)
    dsorted, grp = stack_destination_schedule(refs, G)
    p = _build.ptr
    _build.launch("spk_cell_msg_fwd", p(xmu), p(rbf_aug), p(dir_ij),
                  p(FW_aug), p(refs.qidx), p(dsorted), p(grp), p(dq), p(dmu),
                  *refs.dims, G, F, B)
    LAUNCHES["cell_msg_fwd"] += 1
    return dq, dmu


def cell_msg_bwd_kernel(xmu, rbf_aug, dir_ij, FW_aug, qidx, g_dq, g_dmu,
                        wgrad: bool = False):
    """K19: cotangents (dxmu, grbf, gdir) of K18's outputs for (g_dq,
    g_dmu), grbf and gdir 0 at padded slots, and with ``wgrad`` also gFW
    [B+1, 3F]: the blocks' f64 partials summed here (deterministic) and
    rounded to f32."""
    refs = as_refs(qidx)
    Ap, F, B = _check(xmu, rbf_aug, dir_ij, FW_aug, refs)
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    n_cols, P, Ktot = refs.stack
    dxmu = torch.empty_like(xmu)
    if not _tuned_bwd(BWD_CELL, wgrad, F, B):
        nx, ny, nz, C, K = refs.dims
        G = gen_groups(xmu.device, P, n_cols, True, BWD_CELL, wgrad, F, B)
        Z = gen_tiles(F)
        grbf = rbf_aug.new_zeros((Z, *rbf_aug.shape))
        gdir = dir_ij.new_zeros((Z, *dir_ij.shape))
        gFW = bwd_gen(BWD_CELL, 3, xmu, xmu[:, 3 * F:], FW_aug,
                      *stack_source_schedule(refs, G), G, g_dq, g_dmu, dxmu,
                      dxmu[:, 3 * F:], n_cols, (nx, ny, P, Ktot), F, B,
                      6 * F, wgrad, rbf=rbf_aug, dirs=dir_ij, edge=1,
                      qcol=refs.qidx, cell=(nz, C, K), grbf=grbf, gdir=gdir)
        LAUNCHES["cell_msg_bwd_gen"] += 1
        return with_gen_gfw((dxmu, grbf.sum(0), gdir.sum(0)), gFW)
    G = _groups(xmu.device, P, n_cols, "spk_msg_bwd_blocks", BWD_CELL,
                int(wgrad), F, B)
    esorted, grp = stack_source_schedule(refs, G)
    grbf = torch.zeros_like(rbf_aug)
    gdir = torch.zeros_like(dir_ij)
    gFWp = _gfw_partials(xmu, FW_aug, n_cols * G, wgrad)
    p = _build.ptr
    _build.launch("spk_cell_msg_bwd", p(xmu), p(rbf_aug), p(dir_ij),
                  p(FW_aug), p(refs.qidx), p(esorted), p(grp), p(g_dq),
                  p(g_dmu), p(dxmu), p(grbf), p(gdir),
                  gFWp.data_ptr() if wgrad else None, *refs.dims, G, F, B)
    LAUNCHES["cell_msg_bwd"] += 1
    return _with_gfw((dxmu, grbf, gdir), gFWp)


def cell_msg_fwd_plain(xmu, rbf_aug, dir_ij, FW_aug, qidx):
    """Plain twin of K18 (``_message_xla``, autograd-able)."""
    A, F = xmu.shape[0], xmu.shape[1] // 6
    g = cell_gather_plain(xmu, as_refs(qidx))           # [A', K, 6F]
    xjW = g[..., :3 * F] * (rbf_aug @ FW_aug)
    dqe, dmuR, dmumu = xjW.split(F, dim=-1)
    muj = g[..., 3 * F:].reshape(A, -1, 3, F)
    dmu = dmuR[:, :, None, :] * dir_ij[..., None] + dmumu[:, :, None, :] * muj
    return dqe.sum(1), dmu.sum(1).reshape(A, 3 * F)


def cell_msg_bwd_plain(xmu, rbf_aug, dir_ij, FW_aug, qidx, g_dq, g_dmu):
    """Plain twin of K19: the explicit VJP of ``cell_msg_fwd_plain``,
    (dxmu, grbf, gdir, gFW)."""
    refs = as_refs(qidx)
    A, F = xmu.shape[0], xmu.shape[1] // 6
    g = cell_gather_plain(xmu, refs)
    xj, muj = g[..., :3 * F], g[..., 3 * F:].reshape(A, -1, 3, F)
    W = rbf_aug @ FW_aug
    gmu = g_dmu.reshape(A, 1, 3, F)
    dmuR = xj[..., F:2 * F] * W[..., F:2 * F]
    dmumu = xj[..., 2 * F:] * W[..., 2 * F:]
    gxW = torch.cat([g_dq[:, None, :].expand(-1, W.shape[1], -1),
                     (gmu * dir_ij[..., None]).sum(2),
                     (gmu * muj).sum(2)], dim=-1)       # [A', K, 3F]
    gW = gxW * xj
    gxj = torch.cat([gxW * W, (gmu * dmumu[:, :, None, :]).flatten(2)], -1)
    dxmu = cell_gather_bwd_plain(gxj, refs)
    grbf = gW @ FW_aug.t()
    gdir = (gmu * dmuR[:, :, None, :]).sum(-1)
    gFW = rbf_aug.flatten(0, 1).t() @ gW.flatten(0, 1)
    return dxmu, grbf, gdir, gFW


class CellMessage(torch.autograd.Function):
    """K18 forward, K19 backward (its wgrad instance when FW_aug needs a
    gradient) on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, xmu, rbf_aug, dir_ij, FW_aug, refs):
        ctx.save_for_backward(xmu, rbf_aug, dir_ij, FW_aug)
        ctx.refs = refs
        return _on(xmu, cell_msg_fwd_kernel, cell_msg_fwd_plain, xmu,
                   rbf_aug, dir_ij, FW_aug, refs)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        xmu, rbf_aug, dir_ij, FW_aug = ctx.saved_tensors
        args = (xmu, rbf_aug, dir_ij, FW_aug, ctx.refs, g_dq.contiguous(),
                g_dmu.contiguous())
        wgrad = ctx.needs_input_grad[3]
        kernel = functools.partial(cell_msg_bwd_kernel, wgrad=wgrad)
        dxmu, grbf, gdir, *gFW = _on(xmu, kernel, cell_msg_bwd_plain, *args)
        return dxmu, grbf, gdir, gFW[0] if wgrad else None, None


def painn_message_cellblock(xmu, rbf_aug, dir_ij, FW_aug, qidx):
    """PaiNN inter-atomic message on the 27-cell layout (signature of
    ``schnetpack_tpu.ops.painn_fused.painn_message_cellblock``; ``qidx``
    may be its ``CellRefs``).  Returns dq [A', F], dmu [A', 3F]."""
    return CellMessage.apply(xmu.contiguous(), rbf_aug.contiguous(),
                             dir_ij.contiguous(), FW_aug.contiguous(),
                             as_refs(qidx))
