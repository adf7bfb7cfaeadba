"""PaiNN column message: CUDA kernels K1/K2, K6/K7 and K15 and their twins.

The forward kernels (``csrc/colblock_message.cu``) run on the
destination-sorted schedule of ``colblock.destination_schedule``, the
backward kernels (``csrc/colblock_message_bwd.cu``) on the source-sorted
one of ``_bwd_schedule``; both cut each column's rows into G ranges, with
G chosen from the blocks of the kernel instance that fit an SM
(``_groups``).

Three forms of the message, as in ``schnetpack_tpu/ops/colblock_pallas.py``:

* FUSE="full" (``painn_message_columns_full_fused_pallas``): the per-edge
  geometry is recomputed from the positions inside both the forward
  kernel (K1, ``csrc/colblock_message.cu::msg_fwd_kernel<false, .>``) and
  the backward kernel (K2, ``csrc/colblock_message_bwd.cu::
  msg_bwd_kernel<kFused, W, .>``), and the position
  cotangent comes straight out of K2.  No per-edge tensor exists in
  device memory.
* FUSE="hybrid" (``painn_message_columns_fm_geores_pallas``): the forward
  (K6, ``msg_fwd_kernel<true, .>``) reads the packed geo tensor that K5
  (``colblock_geo.py``) computes once per step, and the geo-resident
  backward (K7, ``msg_bwd_kernel<kGeoRes, W, .>``) derives the geometry
  chain from the stored channels and emits dR without reading the
  positions.
* any other radial basis or cutoff (``painn_message_columns_fm_pallas``,
  row 9): the forward (K6) reads a geo [nx, ny, B+4, Ktot] that autograd
  differentiates, and the backward (K15, ``msg_bwd_kernel<kSrc, W, .>``)
  returns the per-slot geometry cotangent ggeo instead of dR; autograd
  carries it through the basis and the cutoff to the positions (and to
  trainable basis parameters).

In the first two the geometry has no second autograd path, so forces are
counted once.  The full op launches the kernels on CUDA tensors (or
raises) and runs the plain twin, the gather / per-edge math / fold
composition of ``ops/colblock.py``, under ordinary autograd on CPU
tensors.  The hybrid and row-9 ops are each one ``torch.autograd.Function``
on both devices: kernels on CUDA, twins on the CPU, so the CPU tests run
their wiring.  Every backward kernel has a ``wgrad`` instance that also
returns the filter-weight cotangent gFW [B+1, 3F]; the ops launch it when
``FW_aug`` requires grad.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .colblock import (
    ColRefs, column_geometry, decode_i, decode_j, destination_schedule,
    painn_message, row_groups, source_order,
)

#: kernel launches since the last reset (the main path adds one per call)
LAUNCHES = {"msg_fwd": 0, "msg_bwd": 0, "msg_fwd_geo": 0,
            "msg_bwd_geores": 0, "msg_bwd_src": 0}
MAX_F = 256         # one thread a feature (csrc/colblock_message.cuh)
_MAX_GROUPS = 16    # row ranges per column
_MAX_WGRAD_B1 = 32  # B+1 bound of the wgrad instances' f64 partials
#: the backward kernels' forms (``kMode`` of ``msg_bwd_kernel``)
BWD_FUSED, BWD_GEORES, BWD_SRC = 0, 1, 2


def _shapes(x, cw, refs: ColRefs):
    nx, ny, Ktot = refs.qcol.shape
    return nx, ny, Ktot, nx * ny * refs.P, x.shape[1] // 3, cw.shape[0]


def _check_width(F: int):
    if F % 32 or F > MAX_F:
        raise ValueError(f"the message kernels take F % 32 == 0 and "
                         f"F <= {MAX_F}, got F={F}")


def _check_common(x, mu, FW_aug, refs: ColRefs, B: int):
    nx, ny, Ktot = refs.qcol.shape
    Ap, F = nx * ny * refs.P, x.shape[1] // 3
    _check_width(F)
    if any(k % 8 for k in refs.ksizes):
        raise ValueError(f"bucket sizes must be multiples of 8: {refs.ksizes}")
    _build.check(x, "x", (Ap, 3 * F))
    _build.check(mu, "mu", (Ap, 3 * F))
    _build.check(FW_aug, "FW_aug", (B + 1, 3 * F))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)


def _check(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs):
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    _check_common(x, mu, FW_aug, refs, B)
    _build.check(R, "R", (Ap, 3))
    _build.check(coff_fm, "coff_fm", (nx, ny, 3, Ktot))
    _build.check(cw, "cw", (B, 2))


def msg_fwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float):
    """K1: dq [A', F], dmu [A', 3F] summed per destination atom."""
    _check(x, mu, R, FW_aug, coff_fm, cw, refs)
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    dsorted, dgrp, G = _fwd_schedule(refs, 0, F, B)
    dq = x.new_empty((Ap, F))
    dmu = x.new_empty((Ap, 3 * F))
    p = _build.ptr
    _build.launch("spk_msg_fwd", p(x), p(mu), p(R), p(FW_aug), p(coff_fm),
                  p(cw), p(refs.qcol), p(refs.dcol), p(dsorted), p(dgrp),
                  p(dq), p(dmu), nx, ny, refs.P, Ktot, refs.koffs_arg, G, F,
                  B, float(rc))
    LAUNCHES["msg_fwd"] += 1
    return dq, dmu


def wave_groups(n_cols: int, slots: int, max_groups: int) -> int:
    """The G in [1, max_groups] whose n_cols * G blocks of equal work
    finish about first on ``slots`` resident block slots: the smallest G
    whose ceil(n_cols * G / slots) / G (waves times the block's share of a
    column) is within 5% of the least (fewer blocks, less fixed cost).  A G
    that overfills the last wave by a few blocks would nearly double the
    kernel's time."""
    cost = {g: -(-n_cols * g // slots) / g
            for g in range(1, max(1, max_groups) + 1)}
    best = min(cost.values())
    return min(g for g, c in cost.items() if c <= 1.05 * best)


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(query: str, *args) -> int:
    n = _build.query(query, *args)
    if n <= 0:
        raise RuntimeError(f"{query}{args}: no block fits an SM ({n})")
    return n


def _groups(refs: ColRefs, n_cols: int, query: str, *args) -> int:
    """G for a kernel instance over ``n_cols`` columns: ``wave_groups`` of
    its resident blocks per SM (``query`` with ``args``) times the SMs."""
    sms = torch.cuda.get_device_properties(
        refs.qcol.device).multi_processor_count
    return wave_groups(n_cols, _blocks_per_sm(query, *args) * sms,
                       min(_MAX_GROUPS, refs.P))


def _fwd_schedule(refs: ColRefs, geo: int, F: int, B: int):
    """The forward kernels' (dsorted, grp, G): ``destination_schedule``
    with G from the instance's occupancy (``geo``: K6/K20, else K1)."""
    nx, ny, _ = refs.qcol.shape
    G = _groups(refs, nx * ny, "spk_msg_fwd_blocks", geo, F, B, refs.P)
    return (*destination_schedule(refs, G), G)


def _bwd_schedule(refs: ColRefs, n_cols: int, mode: int, wgrad: bool,
                  F: int, B: int):
    """The backward kernels' (esorted, grp, G): the source-sorted slots of
    ``source_order`` and each of the ``n_cols`` source columns' rows cut
    into G ranges (``row_groups``), G from the occupancy of the instance
    (``mode``, ``wgrad``); made once per (refs, G), cached on the refs."""
    G = _groups(refs, n_cols, "spk_msg_bwd_blocks", mode, int(wgrad), F, B)
    key = ("src", G)
    if key not in refs.cache:
        esorted, cnt, _ = source_order(refs)
        refs.cache[key] = (esorted, row_groups(cnt.view(n_cols, refs.P), G))
    return (*refs.cache[key], G)


def _gfw_partials(x, FW_aug, n_blocks: int, wgrad: bool):
    """The wgrad instances' per-block f64 gFW partials [blocks, B+1, 3F]
    (None without wgrad)."""
    if not wgrad:
        return None
    if FW_aug.shape[0] > _MAX_WGRAD_B1:
        raise ValueError(f"the wgrad kernels take B+1 <= {_MAX_WGRAD_B1}, "
                         f"got {FW_aug.shape[0]}")
    return x.new_empty((n_blocks, *FW_aug.shape), dtype=torch.float64)


def _with_gfw(out: tuple, gFWp):
    """``out`` and, for a wgrad launch, gFW: the f64 partials summed
    (deterministic) and rounded to f32."""
    return out if gFWp is None else (*out, gFWp.sum(0).to(torch.float32))


def msg_bwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                   g_dq, g_dmu, wgrad: bool = False):
    """K2: cotangents (dx, dmu, dR) of K1's outputs for (g_dq, g_dmu), and
    with ``wgrad`` also gFW [B+1, 3F].

    Blocks own source-row ranges (``_bwd_schedule``), so dx, dmu and the
    own-column position cotangent have one writer per row; the
    destination-side position cotangents come as partials
    [G, 9, nx*ny, 3, P] (one per row range and bucket) that are summed
    here, as ``colblock_pallas.py:1494-1497`` sums them outside the TPU
    kernel, and so are the blocks' gFW partials."""
    _check(x, mu, R, FW_aug, coff_fm, cw, refs)
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_FUSED, wgrad, F, B)
    dx = torch.empty_like(x)
    dmu = torch.empty_like(mu)
    gRo = x.new_empty((nx * ny, 3, refs.P))
    gRd = x.new_empty((G, 9, nx * ny, 3, refs.P))
    gFWp = _gfw_partials(x, FW_aug, nx * ny * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd", p(x), p(mu), p(R), p(FW_aug), p(coff_fm),
                  p(cw), p(refs.qcol), p(refs.dcol), p(esorted), p(grp),
                  p(g_dq), p(g_dmu), p(dx), p(dmu), p(gRo), p(gRd),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, float(rc))
    LAUNCHES["msg_bwd"] += 1
    dR = (gRo + gRd.sum((0, 1))).transpose(1, 2).reshape(Ap, 3)
    return _with_gfw((dx, dmu, dR), gFWp)


def msg_fwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float):
    """Plain twin of K1 (autograd-able)."""
    rbf_aug, dirs = column_geometry(R, coff_fm, refs, cw, rc)
    return painn_message(x, mu, rbf_aug, dirs, FW_aug, refs)


def msg_bwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                  g_dq, g_dmu):
    """Plain twin of K2: the VJP of ``msg_fwd_plain`` w.r.t. (x, mu, R,
    FW_aug), i.e. (dx, dmu, dR, gFW)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, mu, R, FW_aug)]
        out = msg_fwd_plain(*ins, coff_fm, cw, refs, rc)
        return torch.autograd.grad(out, ins, (g_dq, g_dmu))


class PaiNNMessageFullFused(torch.autograd.Function):
    """K1 forward, K2 backward (its wgrad instance when FW_aug needs a
    gradient)."""

    @staticmethod
    def forward(ctx, x, mu, R, FW_aug, coff_fm, cw, refs, rc):
        ctx.save_for_backward(x, mu, R, FW_aug, coff_fm, cw)
        ctx.refs, ctx.rc = refs, rc
        return msg_fwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs, rc)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        x, mu, R, FW_aug, coff_fm, cw = ctx.saved_tensors
        wgrad = ctx.needs_input_grad[3]
        dx, dmu, dR, *gFW = msg_bwd_kernel(
            x, mu, R, FW_aug, coff_fm, cw, ctx.refs, ctx.rc,
            g_dq.contiguous(), g_dmu.contiguous(), wgrad)
        return (dx, dmu, dR, gFW[0] if wgrad else None, None, None, None,
                None)


def painn_message_columns_full_fused(x, mu, R, FW_aug, coff_fm, cw,
                                     refs: ColRefs, rc: float):
    """PaiNN message over the column layout with the geometry recomputed
    from ``R`` [A', 3] (signature of ``schnetpack_tpu.ops.colblock.
    painn_message_columns_full_fused``).  Returns dq [A', F], dmu [A', 3F].
    """
    if not x.is_cuda:
        return msg_fwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs, rc)
    return PaiNNMessageFullFused.apply(x, mu, R, FW_aug, coff_fm, cw, refs,
                                       float(rc))


# ------------------------------------------------------------- hybrid path
def msg_fwd_geo_kernel(x, mu, geo, FW_aug, refs: ColRefs):
    """K6: dq [A', F], dmu [A', 3F] from the stored geo [nx, ny, nch,
    Ktot] (nch = B+4 or B+5; the d channel is not read)."""
    nx, ny, Ktot = refs.qcol.shape
    B = FW_aug.shape[0] - 1
    nch = geo.shape[2]
    if nch not in (B + 4, B + 5):
        raise ValueError(f"geo has {nch} channels, want {B + 4} or {B + 5}")
    _check_common(x, mu, FW_aug, refs, B)
    _build.check(geo, "geo", (nx, ny, nch, Ktot))
    Ap, F = x.shape[0], x.shape[1] // 3
    dsorted, dgrp, G = _fwd_schedule(refs, 1, F, B)
    dq = x.new_empty((Ap, F))
    dmu = x.new_empty((Ap, 3 * F))
    p = _build.ptr
    _build.launch("spk_msg_fwd_geo", p(x), p(mu), p(geo), p(FW_aug),
                  p(refs.qcol), p(refs.dcol), p(dsorted), p(dgrp), p(dq),
                  p(dmu), nx, ny, refs.P, Ktot, refs.koffs_arg, G, F, B, nch)
    LAUNCHES["msg_fwd_geo"] += 1
    return dq, dmu


def msg_bwd_geores_kernel(x, mu, geo, FW_aug, cw, refs: ColRefs, rc: float,
                          g_dq, g_dmu, wgrad: bool = False):
    """K7: cotangents (dx, dmu, dR) of K6's outputs for (g_dq, g_dmu),
    the geometry chain taken from the stored geo [nx, ny, B+5, Ktot]; no
    positions.  Same schedule and partial sums as K2, and with ``wgrad``
    also gFW [B+1, 3F]."""
    nx, ny, Ktot = refs.qcol.shape
    B = cw.shape[0]
    _check_common(x, mu, FW_aug, refs, B)
    _build.check(geo, "geo", (nx, ny, B + 5, Ktot))
    _build.check(cw, "cw", (B, 2))
    Ap, F = x.shape[0], x.shape[1] // 3
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_GEORES, wgrad, F, B)
    dx = torch.empty_like(x)
    dmu = torch.empty_like(mu)
    gRo = x.new_empty((nx * ny, 3, refs.P))
    gRd = x.new_empty((G, 9, nx * ny, 3, refs.P))
    gFWp = _gfw_partials(x, FW_aug, nx * ny * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd_geores", p(x), p(mu), p(geo), p(FW_aug),
                  p(cw), p(refs.qcol), p(refs.dcol), p(esorted), p(grp),
                  p(g_dq), p(g_dmu), p(dx), p(dmu), p(gRo), p(gRd),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, B + 5, float(rc))
    LAUNCHES["msg_bwd_geores"] += 1
    dR = (gRo + gRd.sum((0, 1))).transpose(1, 2).reshape(Ap, 3)
    return _with_gfw((dx, dmu, dR), gFWp)


def _geo_edge_major(geo, B: int):
    """(rbf_aug [.., B+1], dirs [.., 3]) per edge slot from the packed geo."""
    g = geo.movedim(2, -1)
    return g[..., :B + 1], g[..., B + 1:B + 4]


def msg_fwd_geo_plain(x, mu, geo, FW_aug, refs: ColRefs):
    """Plain twin of K6 (autograd-able in x, mu and FW_aug)."""
    rbf_aug, dirs = _geo_edge_major(geo, FW_aug.shape[0] - 1)
    return painn_message(x, mu, rbf_aug, dirs, FW_aug, refs)


def msg_bwd_geores_plain(x, mu, geo, FW_aug, cw, refs: ColRefs, rc: float,
                         g_dq, g_dmu):
    """Plain twin of K7: (dx, dmu, dR, gFW).  The message VJP by autograd
    with the stored channels as constants, then the geometry chain from
    the stored channels with K7's formulas (``csrc/colblock_message_bwd.cu``
    header note), folded to both ends of every edge."""
    B = cw.shape[0]
    rbf_aug, dirs = _geo_edge_major(geo, B)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, mu, rbf_aug, dirs, FW_aug)]
        out = painn_message(*leaves[:4], leaves[4], refs)
        dx, dmu, grbf, gdir, gFW = torch.autograd.grad(out, leaves,
                                                       (g_dq, g_dmu))
    g = geo.movedim(2, -1)
    fcut, d = g[..., B:B + 1], g[..., B + 4:B + 5]
    pi_rc = math.pi / rc
    phi = g[..., :B] * (1.0 / fcut.clamp(min=1e-30))
    dfcut = torch.where(fcut > 0, -0.5 * pi_rc * torch.sin(d * pi_rc),
                        torch.zeros_like(d))
    dphi = 2.0 * cw[:, 1] * (d - cw[:, 0]) * phi
    gd = ((grbf[..., :B] * dphi).sum(-1, keepdim=True) * fcut
          + ((grbf[..., :B] * phi).sum(-1, keepdim=True) + grbf[..., B:])
          * dfcut)
    s = (gdir * dirs).sum(-1, keepdim=True)
    grij = (gdir - dirs * s) * (1.0 / d.clamp(min=1e-6)) + gd * dirs
    j, valid = decode_j(refs)
    i, _ = decode_i(refs)
    grij = (grij * valid[..., None].to(grij.dtype)).reshape(-1, 3)
    dR = x.new_zeros((x.shape[0], 3))
    dR = dR.index_add(0, j.reshape(-1), grij).index_add(0, i.reshape(-1),
                                                         -grij)
    return dx, dmu, dR, gFW


class PaiNNMessageGeoRes(torch.autograd.Function):
    """K6 forward, K7 backward (its wgrad instance when FW_aug needs a
    gradient) on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, x, mu, R, geo, FW_aug, cw, refs, rc):
        ctx.save_for_backward(x, mu, geo, FW_aug, cw)
        ctx.refs, ctx.rc = refs, rc
        if x.is_cuda:
            return msg_fwd_geo_kernel(x, mu, geo, FW_aug, refs)
        return msg_fwd_geo_plain(x, mu, geo, FW_aug, refs)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        x, mu, geo, FW_aug, cw = ctx.saved_tensors
        g_dq, g_dmu = g_dq.contiguous(), g_dmu.contiguous()
        wgrad = ctx.needs_input_grad[4]
        if x.is_cuda:
            dx, dmu, dR, *gFW = msg_bwd_geores_kernel(
                x, mu, geo, FW_aug, cw, ctx.refs, ctx.rc, g_dq, g_dmu, wgrad)
        else:
            dx, dmu, dR, *gFW = msg_bwd_geores_plain(
                x, mu, geo, FW_aug, cw, ctx.refs, ctx.rc, g_dq, g_dmu)
        return (dx, dmu, dR, None, gFW[0] if wgrad else None, None, None,
                None)


def painn_message_columns_fm_geores(x, mu, R, geo, FW_aug, coff_fm, cw,
                                    refs: ColRefs, rc: float):
    """PaiNN message over the column layout on the packed geo [nx, ny,
    B+5, Ktot] of ``R`` (``colblock_geo.column_geometry_packed(...,
    with_d=True)`` under ``torch.no_grad()``), with the geo-resident
    backward (signature of ``schnetpack_tpu.ops.colblock.
    painn_message_columns_fm_geores``; ``coff_fm`` is not read).  The
    position cotangent comes out of the backward only.  Returns dq [A', F],
    dmu [A', 3F]."""
    if geo.requires_grad:
        raise ValueError(
            "geo must be computed under torch.no_grad(): the message "
            "backward returns dR itself, a graph through geo would count "
            "the forces twice")
    return PaiNNMessageGeoRes.apply(x, mu, R, geo, FW_aug, cw, refs,
                                    float(rc))


# ---------------------------------------------------- row 9: geo cotangent
def msg_bwd_src_kernel(x, mu, geo, FW_aug, refs: ColRefs, g_dq, g_dmu,
                       wgrad: bool = False):
    """K15: cotangents (dx, dmu, ggeo) of K6's outputs on a geo [nx, ny,
    B+4, Ktot] = [rbf_aug, dir] for (g_dq, g_dmu), and with ``wgrad`` also
    gFW [B+1, 3F].  ggeo has the geo's layout and is 0 at padded slots.
    K2's schedule and per-edge reductions, no geometry chain."""
    nx, ny, Ktot = refs.qcol.shape
    B = FW_aug.shape[0] - 1
    _check_common(x, mu, FW_aug, refs, B)
    _build.check(geo, "geo", (nx, ny, B + 4, Ktot))
    Ap, F = x.shape[0], x.shape[1] // 3
    _build.check(g_dq, "g_dq", (Ap, F))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F))
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_SRC, wgrad, F, B)
    dx = torch.empty_like(x)
    dmu = torch.empty_like(mu)
    ggeo = torch.zeros_like(geo)
    gFWp = _gfw_partials(x, FW_aug, nx * ny * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd_src", p(x), p(mu), p(geo), p(FW_aug),
                  p(refs.qcol), p(refs.dcol), p(esorted), p(grp), p(g_dq),
                  p(g_dmu), p(dx), p(dmu), p(ggeo),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, B + 4)
    LAUNCHES["msg_bwd_src"] += 1
    return _with_gfw((dx, dmu, ggeo), gFWp)


def msg_bwd_src_plain(x, mu, geo, FW_aug, refs: ColRefs, g_dq, g_dmu):
    """Plain twin of K15: the VJP of ``msg_fwd_geo_plain`` w.r.t. (x, mu,
    geo, FW_aug), i.e. (dx, dmu, ggeo, gFW)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, mu, geo, FW_aug)]
        out = msg_fwd_geo_plain(*ins, refs)
        return torch.autograd.grad(out, ins, (g_dq, g_dmu))


class PaiNNMessageFM(torch.autograd.Function):
    """K6 forward, K15 backward (its wgrad instance when FW_aug needs a
    gradient) on CUDA; their twins on the CPU."""

    @staticmethod
    def forward(ctx, x, mu, geo, FW_aug, refs):
        ctx.save_for_backward(x, mu, geo, FW_aug)
        ctx.refs = refs
        if x.is_cuda:
            return msg_fwd_geo_kernel(x, mu, geo, FW_aug, refs)
        return msg_fwd_geo_plain(x, mu, geo, FW_aug, refs)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        x, mu, geo, FW_aug = ctx.saved_tensors
        g_dq, g_dmu = g_dq.contiguous(), g_dmu.contiguous()
        wgrad = ctx.needs_input_grad[3]
        if x.is_cuda:
            dx, dmu, ggeo, *gFW = msg_bwd_src_kernel(
                x, mu, geo, FW_aug, ctx.refs, g_dq, g_dmu, wgrad)
        else:
            dx, dmu, ggeo, *gFW = msg_bwd_src_plain(
                x, mu, geo, FW_aug, ctx.refs, g_dq, g_dmu)
        return dx, dmu, ggeo, gFW[0] if wgrad else None, None


def painn_message_columns_fm(x, mu, geo, FW_aug, refs: ColRefs):
    """PaiNN message over the column layout on a packed geo [nx, ny, B+4,
    Ktot] = [phi*fcut, fcut, dir] that may carry a gradient (the JAX
    package's ``painn_message_columns_fm`` on ``concat_geo`` of its 9-part
    geo).  The backward returns the geo cotangent, so the forces (and any
    trainable basis parameter's gradient) flow through the geometry's own
    autograd graph.  Returns dq [A', F], dmu [A', 3F]."""
    return PaiNNMessageFM.apply(x, mu, geo.contiguous(), FW_aug, refs)
