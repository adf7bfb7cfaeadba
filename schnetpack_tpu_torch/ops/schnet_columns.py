"""SchNet's fused cfconv on the column layout: CUDA kernels K9/K10 and
their twins.

Port of ``schnetpack_tpu/ops/schnet_columns.py``.  Per interaction block
one op computes, for every edge slot of the raw-phi geometry ``geo [nx,
ny, B+4, Ktot]`` (``colblock_geo.column_geometry_raw``):

    gather h_j -> W = (ssp(phi W1 + b1) W2 + b2) * fcut -> h_j * W
    -> sum over each atom's edges

The forward is K9 and the backward K10 (``csrc/schnet_columns.cu``): the
filter network runs per edge inside the kernels, and nothing of shape
[edges, F] exists in device memory.  K10 returns dh and the geometry
cotangent (zero in the dir channels) and no filter-weight cotangents: on
CUDA the op raises when W1, b1, W2 or b2 require grad (training comes
later).  On CPU tensors the op runs the twins, the gather / filter MLP /
fold composition of ``_cfconv_xla`` (``schnet_columns.py:317-331``) and its
autograd VJP, weight cotangents included.
"""
from __future__ import annotations

import torch

from . import _build
from .activations import shifted_softplus
from .colblock import ColRefs, column_fold, column_gather

#: kernel launches since the last reset (SchNet MD: 3 each per step)
LAUNCHES = {"cf_fwd": 0, "cf_bwd": 0}
#: the kernels' filter width
N_FILTERS = 128


def _schedule(refs: ColRefs):
    """Each column's real slots first, in slot order, and their count:
    ``order`` [nx*ny, Ktot] int32 and ``nreal`` [nx*ny] int32, computed
    once per ``refs`` (cached on it) without a host sync."""
    if "cf" in refs.cache:
        return refs.cache["cf"]
    nx, ny, Ktot = refs.qcol.shape
    pad = (refs.qcol < 0).reshape(nx * ny, Ktot).to(torch.int32)
    order = torch.argsort(pad, dim=1, stable=True).to(torch.int32)
    nreal = (Ktot - pad.sum(1)).to(torch.int32)
    refs.cache["cf"] = (order.contiguous(), nreal.contiguous())
    return refs.cache["cf"]


def _check(h, geo, W1, b1, W2, b2, refs: ColRefs):
    nx, ny, Ktot = refs.qcol.shape
    B, F = W1.shape
    if F != N_FILTERS or B > 32:
        raise ValueError(f"the cfconv kernels take F = {N_FILTERS} filters "
                         f"and B <= 32 basis functions, got F={F}, B={B}")
    _build.check(h, "h", (nx * ny * refs.P, F))
    _build.check(geo, "geo", (nx, ny, B + 4, Ktot))
    _build.check(W1, "W1", (B, F))
    _build.check(b1, "b1", (F,))
    _build.check(W2, "W2", (F, F))
    _build.check(b2, "b2", (F,))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)
    return nx, ny, Ktot, B, F


def cf_fwd_kernel(h, geo, W1, b1, W2, b2, refs: ColRefs):
    """K9: the aggregated messages [A', F]."""
    nx, ny, Ktot, B, F = _check(h, geo, W1, b1, W2, b2, refs)
    order, nreal = _schedule(refs)
    out = torch.empty_like(h)
    p = _build.ptr
    _build.launch("spk_cf_fwd", p(h), p(geo), p(W1), p(b1), p(W2), p(b2),
                  p(refs.qcol), p(refs.dcol), p(order), p(nreal), p(out), nx,
                  ny, refs.P, Ktot, _build.int_array(refs.koffs), B, B + 4)
    LAUNCHES["cf_fwd"] += 1
    return out


def cf_bwd_kernel(h, geo, W1, b1, W2, b2, refs: ColRefs, g):
    """K10: (dh [A', F], ggeo [nx, ny, B+4, Ktot]) for the cotangent g of
    K9's output; dh comes as 9 per-source-column partials, added here."""
    nx, ny, Ktot, B, F = _check(h, geo, W1, b1, W2, b2, refs)
    _build.check(g, "g", tuple(h.shape))
    order, nreal = _schedule(refs)
    part = h.new_empty((9,) + tuple(h.shape))
    ggeo = torch.empty_like(geo)
    p = _build.ptr
    _build.launch("spk_cf_bwd", p(h), p(geo), p(W1), p(b1), p(W2), p(b2),
                  p(refs.qcol), p(refs.dcol), p(order), p(nreal), p(g),
                  p(part), p(ggeo), nx, ny, refs.P, Ktot,
                  _build.int_array(refs.koffs), B, B + 4)
    LAUNCHES["cf_bwd"] += 1
    return part.sum(0), ggeo


def cf_fwd_plain(h, geo, W1, b1, W2, b2, refs: ColRefs):
    """Plain twin of K9 (``_cfconv_xla``; autograd-able in every input)."""
    B = W1.shape[0]
    g = geo.movedim(2, -1)                         # [nx, ny, Ktot, B+4]
    phi, fcut = g[..., :B], g[..., B:B + 1]
    W = (shifted_softplus(phi @ W1 + b1) @ W2 + b2) * fcut
    return column_fold(column_gather(h, refs) * W, refs)


def cf_bwd_plain(h, geo, W1, b1, W2, b2, refs: ColRefs, g):
    """Plain twin of K10: the VJP of ``cf_fwd_plain`` w.r.t. (h, geo, W1,
    b1, W2, b2)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (h, geo, W1, b1, W2, b2)]
        out = cf_fwd_plain(*ins, refs)
        return torch.autograd.grad(out, ins, g)


class SchNetCFConv(torch.autograd.Function):
    """K9 forward, K10 backward on CUDA; their twins on the CPU (which also
    return the filter-weight cotangents)."""

    @staticmethod
    def forward(ctx, h, geo, W1, b1, W2, b2, refs):
        ctx.save_for_backward(h, geo, W1, b1, W2, b2)
        ctx.refs = refs
        fwd = cf_fwd_kernel if h.is_cuda else cf_fwd_plain
        return fwd(h, geo, W1, b1, W2, b2, refs)

    @staticmethod
    def backward(ctx, g):
        h, geo, W1, b1, W2, b2 = ctx.saved_tensors
        g = g.contiguous()
        if h.is_cuda:
            dh, ggeo = cf_bwd_kernel(h, geo, W1, b1, W2, b2, ctx.refs, g)
            return dh, ggeo, None, None, None, None, None
        return (*cf_bwd_plain(h, geo, W1, b1, W2, b2, ctx.refs, g), None)


def schnet_cfconv_columns(h, geo, W1, b1, W2, b2, refs: ColRefs):
    """Fused cfconv over the column layout (signature of ``schnetpack_tpu.
    ops.schnet_columns.schnet_cfconv_columns`` with the packed geo).

    h [A', F] in2f output, geo [nx, ny, B+4, Ktot] raw-phi geometry, W1
    [B, F], b1 [F], W2 [F, F], b2 [F] the filter network in flax's [in,
    out] layout.  Returns the per-atom sums [A', F]."""
    if h.is_cuda and any(t.requires_grad for t in (W1, b1, W2, b2)):
        raise NotImplementedError(
            "the CUDA cfconv backward has no filter-weight cotangents yet; "
            "freeze the parameters (requires_grad_(False)) for MD")
    args = [t.contiguous() for t in (h, geo, W1, b1, W2, b2)]
    return SchNetCFConv.apply(*args, refs)
