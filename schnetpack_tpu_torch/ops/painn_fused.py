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

The forward is K18, the backward K19 (``csrc/painn_fused.cu``), which
returns dxmu, grbf [A', K, B+1] and gdir [A', K, 3], and in its wgrad
instance gFW [B+1, 3F]; the op launches that instance only when
``FW_aug`` requires grad (MD freezes the model).  On CPU tensors the op
runs the twins, on CUDA tensors the kernels, and it raises otherwise.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .cellblock_gather import (
    CellRefs, _check_refs, _on, as_refs, cell_gather_bwd_plain,
    cell_gather_plain, source_order,
)

#: kernel launches since the last reset (painn_cell MD: K18 3, K19 3 per
#: step)
LAUNCHES = {"cell_msg_fwd": 0, "cell_msg_bwd": 0}
_MAX_B1 = 32   # filter rows the kernels keep in registers


def _check(xmu, rbf_aug, dir_ij, FW_aug, refs: CellRefs):
    F = xmu.shape[1] // 6
    B1 = FW_aug.shape[0]
    if F % 32 or F > 128 or xmu.shape[1] != 6 * F:
        raise ValueError(
            f"the cell message kernels take F % 32 == 0 and F <= 128, got "
            f"xmu of width {xmu.shape[1]}")
    if B1 > _MAX_B1:
        raise ValueError(f"the cell message kernels take B+1 <= {_MAX_B1}, "
                         f"got {B1}")
    Ap, K = _check_refs(refs)
    _build.check(xmu, "xmu", (Ap, 6 * F))
    _build.check(rbf_aug, "rbf_aug", (Ap, K, B1))
    _build.check(dir_ij, "dir_ij", (Ap, K, 3))
    _build.check(FW_aug, "FW_aug", (B1, 3 * F))
    return Ap, F, B1 - 1


def cell_msg_fwd_kernel(xmu, rbf_aug, dir_ij, FW_aug, qidx):
    """K18: dq [A', F], dmu [A', 3F] summed per destination row."""
    refs = as_refs(qidx)
    Ap, F, B = _check(xmu, rbf_aug, dir_ij, FW_aug, refs)
    dq = xmu.new_empty((Ap, F))
    dmu = xmu.new_empty((Ap, 3 * F))
    p = _build.ptr
    _build.launch("spk_cell_msg_fwd", p(xmu), p(rbf_aug), p(dir_ij),
                  p(FW_aug), p(refs.qidx), p(dq), p(dmu), *refs.dims, F, B)
    LAUNCHES["cell_msg_fwd"] += 1
    return dq, dmu


def cell_msg_bwd_kernel(xmu, rbf_aug, dir_ij, FW_aug, qidx, g_dq, g_dmu,
                        wgrad: bool = False):
    """K19: cotangents (dxmu, grbf, gdir) of K18's outputs for (g_dq,
    g_dmu), and with ``wgrad`` also gFW [B+1, 3F]: the blocks' f64
    partials summed here (deterministic) and rounded to f32."""
    refs = as_refs(qidx)
    Ap, F, B = _check(xmu, rbf_aug, dir_ij, FW_aug, refs)
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    esorted, rowptr = source_order(refs)
    dxmu = torch.empty_like(xmu)
    grbf = torch.zeros_like(rbf_aug)
    gdir = torch.zeros_like(dir_ij)
    n_cells = Ap // refs.dims[3]
    gFWp = (xmu.new_empty((n_cells, *FW_aug.shape), dtype=torch.float64)
            if wgrad else None)
    p = _build.ptr
    _build.launch("spk_cell_msg_bwd", p(xmu), p(rbf_aug), p(dir_ij),
                  p(FW_aug), p(refs.qidx), p(esorted), p(rowptr), p(g_dq),
                  p(g_dmu), p(dxmu), p(grbf), p(gdir),
                  gFWp.data_ptr() if wgrad else None, *refs.dims, F, B)
    LAUNCHES["cell_msg_bwd"] += 1
    out = (dxmu, grbf, gdir)
    return out if gFWp is None else (*out, gFWp.sum(0).to(torch.float32))


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
