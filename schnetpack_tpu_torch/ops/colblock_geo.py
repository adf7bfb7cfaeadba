"""Packed per-edge geometry of the column layout: CUDA kernel K5 and its
twin.

Counterpart of ``schnetpack_tpu/ops/colblock_geo.py``
(``column_geometry_packed``) in the form the hybrid PaiNN path uses: one
feature-major tensor ``geo [nx, ny, nch, Ktot]`` with channels
[phi*fcut (B), fcut, dir (3)] and, ``with_d``, the distance d (nch = B+5),
the buckets at their static edge offsets ``ColRefs.koffs``.  Padded slots
carry d = 1 and zeros elsewhere, as ``column_geometry_xla(..., with_d=
True)`` produces them.

The tensor has no backward: the hybrid message op
(``colblock_message.painn_message_columns_fm_geores``) reads it as a
constant and returns the position cotangent itself, so the caller
computes it under ``torch.no_grad()`` (the JAX package's
``stop_gradient``).  On CUDA tensors ``column_geometry_packed`` launches K5
(``csrc/colblock_geo.cu``) or raises; on CPU tensors it runs the twin.
"""
from __future__ import annotations

import torch

from . import _build
from .colblock import ColRefs, column_geometry

#: kernel launches since the last reset (the hybrid path adds one per step)
LAUNCHES = {"geo_fwd": 0}


def geo_fwd_kernel(R, coff_fm, refs: ColRefs, cw, rc: float,
                   with_d: bool = True):
    """K5: the packed geometry [nx, ny, B+4+with_d, Ktot]."""
    nx, ny, Ktot = refs.qcol.shape
    B = cw.shape[0]
    nch = B + 4 + int(with_d)
    _build.check(R, "R", (nx * ny * refs.P, 3))
    _build.check(coff_fm, "coff_fm", (nx, ny, 3, Ktot))
    _build.check(cw, "cw", (B, 2))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)
    geo = R.new_empty((nx, ny, nch, Ktot))
    p = _build.ptr
    _build.launch("spk_geo_fwd", p(R), p(coff_fm), p(cw), p(refs.qcol),
                  p(refs.dcol), p(geo), nx, ny, refs.P, Ktot,
                  _build.int_array(refs.koffs), B, nch, float(rc))
    LAUNCHES["geo_fwd"] += 1
    return geo


def geo_fwd_plain(R, coff_fm, refs: ColRefs, cw, rc: float,
                  with_d: bool = True):
    """Plain twin of K5 (the gather / per-edge math of ``column_geometry``,
    packed channel-major)."""
    rbf_aug, dirs, d = column_geometry(R, coff_fm, refs, cw, rc, with_d=True)
    parts = [rbf_aug, dirs] + ([d] if with_d else [])
    return torch.cat(parts, dim=-1).movedim(-1, 2).contiguous()


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
