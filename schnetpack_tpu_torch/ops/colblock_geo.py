"""Packed per-edge geometry of the column layout: CUDA kernels K5 and K8
and their twins.

Counterpart of ``schnetpack_tpu/ops/colblock_geo.py`` with its per-bucket
tuple concatenated along the edge axis (``concat_geo``): one feature-major
tensor ``geo [nx, ny, nch, Ktot]``, the buckets at their static edge
offsets ``ColRefs.koffs``, in two forms:

* PaiNN's (``column_geometry_packed``): channels [phi*fcut (B), fcut,
  dir (3)] and, ``with_d``, the distance d (nch = B+5).  It has no
  backward: the hybrid message op (``colblock_message.
  painn_message_columns_fm_geores``) reads it as a constant and returns the
  position cotangent itself, so the caller computes it under
  ``torch.no_grad()`` (the JAX package's ``stop_gradient``).
* SchNet's raw-phi form (``column_geometry_raw``): channels [phi*emask
  (B), fcut, dir (3)], phi not multiplied by fcut since SchNet's filter
  network is nonlinear in it.  It is differentiable in R: its backward
  (K8) turns the geo cotangent into dR, as the JAX ``custom_vjp``
  (``colblock_geo.py:309-334``) does, with per-row sums on the source and
  destination orders of the refs.

Padded slots carry d = 1 and zeros elsewhere, as ``column_geometry_xla``
produces them.  On CUDA tensors the ops launch K5 / K8
(``csrc/colblock_geo.cu``) or raise; on CPU tensors they run the twins.
"""
from __future__ import annotations

import torch

from . import _build
from .colblock import (
    ColRefs, column_geometry, destination_order, source_order,
)

#: kernel launches since the last reset (PaiNN hybrid: geo_fwd once per
#: step; SchNet: geo_fwd_raw and geo_bwd once per step)
LAUNCHES = {"geo_fwd": 0, "geo_fwd_raw": 0, "geo_bwd": 0}


def _check(R, coff_fm, refs: ColRefs, cw):
    nx, ny, Ktot = refs.qcol.shape
    _build.check(R, "R", (nx * ny * refs.P, 3))
    _build.check(coff_fm, "coff_fm", (nx, ny, 3, Ktot))
    _build.check(cw, "cw", (cw.shape[0], 2))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)


def geo_fwd_kernel(R, coff_fm, refs: ColRefs, cw, rc: float,
                   with_d: bool = True, raw_phi: bool = False):
    """K5: the packed geometry [nx, ny, B+4+with_d, Ktot]."""
    _check(R, coff_fm, refs, cw)
    nx, ny, Ktot = refs.qcol.shape
    B = cw.shape[0]
    nch = B + 4 + int(with_d)
    geo = R.new_empty((nx, ny, nch, Ktot))
    p = _build.ptr
    _build.launch("spk_geo_fwd", p(R), p(coff_fm), p(cw), p(refs.qcol),
                  p(refs.dcol), p(geo), nx, ny, refs.P, Ktot,
                  refs.koffs_arg, B, nch, int(raw_phi), float(rc))
    LAUNCHES["geo_fwd_raw" if raw_phi else "geo_fwd"] += 1
    return geo


def geo_fwd_plain(R, coff_fm, refs: ColRefs, cw, rc: float,
                  with_d: bool = True, raw_phi: bool = False):
    """Plain twin of K5 (the gather / per-edge math of ``column_geometry``,
    packed channel-major)."""
    rbf_aug, dirs, d = column_geometry(R, coff_fm, refs, cw, rc, with_d=True,
                                       raw_phi=raw_phi)
    parts = [rbf_aug, dirs] + ([d] if with_d else [])
    return torch.cat(parts, dim=-1).movedim(-1, 2).contiguous()


def geo_bwd_kernel(g, R, coff_fm, refs: ColRefs, cw, rc: float):
    """K8: dR [A', 3] of the raw-phi geometry [nx, ny, B+4, Ktot] for its
    cotangent ``g``: each real slot's grij into a scratch, then per atom
    row its source run's grij less its destination run's, on the orders
    that K10 and K9 cached on the refs (``source_order``,
    ``destination_order``)."""
    _check(R, coff_fm, refs, cw)
    nx, ny, Ktot = refs.qcol.shape
    B = cw.shape[0]
    _build.check(g, "g", (nx, ny, B + 4, Ktot))
    esorted, _, rowptr = source_order(refs)
    dsorted, _, rowptr_dst = destination_order(refs)
    grij = R.new_empty((nx * ny * Ktot, 4))
    dR = R.new_empty(R.shape)
    p = _build.ptr
    _build.launch("spk_geo_bwd", p(R), p(coff_fm), p(cw), p(refs.qcol),
                  p(refs.dcol), p(g), p(grij), p(esorted), p(rowptr),
                  p(dsorted), p(rowptr_dst), p(dR), nx, ny, refs.P, Ktot,
                  refs.koffs_arg, B, float(rc))
    LAUNCHES["geo_bwd"] += 1
    return dR


def geo_bwd_plain(g, R, coff_fm, refs: ColRefs, cw, rc: float):
    """Plain twin of K8: the VJP of the raw-phi ``geo_fwd_plain`` w.r.t. R
    (autograd through the plain ``column_geometry`` chain)."""
    with torch.enable_grad():
        Rg = R.detach().requires_grad_(True)
        geo = geo_fwd_plain(Rg, coff_fm, refs, cw, rc, with_d=False,
                            raw_phi=True)
        (dR,) = torch.autograd.grad(geo, Rg, g)
    return dR


def column_geometry_packed(R, coff_fm, refs: ColRefs, cw, rc: float,
                           with_d: bool = True):
    """Packed geometry ``geo [nx, ny, B+4+with_d, Ktot]`` of the sorted
    positions ``R [A', 3]`` (signature of ``schnetpack_tpu.ops.
    colblock_geo.column_geometry_packed`` with the Gaussian table ``cw``
    [B, 2] of centers and -0.5/width^2).  No backward: call it under
    ``torch.no_grad()``."""
    if R.is_cuda:
        return geo_fwd_kernel(R, coff_fm, refs, cw, rc, with_d)
    return geo_fwd_plain(R, coff_fm, refs, cw, rc, with_d)


class ColumnGeometryRaw(torch.autograd.Function):
    """K5 raw forward, K8 backward on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, R, coff_fm, cw, refs, rc):
        ctx.save_for_backward(R, coff_fm, cw)
        ctx.refs, ctx.rc = refs, rc
        if R.is_cuda:
            return geo_fwd_kernel(R, coff_fm, refs, cw, rc, with_d=False,
                                  raw_phi=True)
        return geo_fwd_plain(R, coff_fm, refs, cw, rc, with_d=False,
                             raw_phi=True)

    @staticmethod
    def backward(ctx, g):
        R, coff_fm, cw = ctx.saved_tensors
        bwd = geo_bwd_kernel if R.is_cuda else geo_bwd_plain
        dR = bwd(g.contiguous(), R, coff_fm, ctx.refs, cw, ctx.rc)
        return dR, None, None, None, None


def column_geometry_raw(R, coff_fm, refs: ColRefs, cw, rc: float):
    """Raw-phi geometry ``geo [nx, ny, B+4, Ktot]`` (channels [phi*emask,
    fcut, dir]) of the sorted positions ``R [A', 3]``, differentiable in R
    (``schnetpack_tpu.ops.colblock_geo.column_geometry(..., raw_phi=True)``
    packed); the per-edge offsets and the basis are constants."""
    return ColumnGeometryRaw.apply(R, coff_fm, cw, refs, float(rc))
