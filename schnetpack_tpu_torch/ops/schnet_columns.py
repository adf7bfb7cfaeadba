"""SchNet's fused cfconv on the column layout: CUDA kernels K9/K10 and
their twins.

Port of ``schnetpack_tpu/ops/schnet_columns.py``.  Per interaction block
one op computes, for every edge slot of the raw-phi geometry ``geo [nx,
ny, B+4, Ktot]`` (``colblock_geo.column_geometry_raw``):

    gather h_j -> W = (ssp(phi W1 + b1) W2 + b2) * fcut -> h_j * W
    -> sum over each atom's edges

The forward is K9 and the backward K10 (``csrc/schnet_columns.cu``): the
filter network runs per edge inside the kernels, and nothing of shape
[edges, F] exists in device memory.  Both walk row ranges of a schedule,
K9 the destination rows of ``colblock.destination_schedule`` (K1's), K10
the source rows of ``colblock.source_schedule`` (the message backward's),
their filter products in 3xTF32 on the tensor cores.  K10 returns dh and
the geometry cotangent (zero in the dir channels), and in its wgrad
instance, which the op launches when W1, b1, W2 or b2 require grad, also
the filter-weight cotangents.  The tuned instances take F in
``N_FILTERS`` and B <= 32 (``tuned_width``); every other shape runs the
general instances (``csrc/schnet_columns_gen.cu``, counted as
``cf_fwd_gen``, ``cf_bwd_gen`` and ``cf_bwd_wgrad_gen``) on the same
schedules, their products likewise, on the filter weights zero-padded to
their tensor-core tiles (``gen_padded_weights``).  On CPU tensors the op runs the twins, the
gather / filter MLP / fold composition of ``_cfconv_xla``
(``schnet_columns.py:317-331``) and its autograd VJP.
"""
from __future__ import annotations

import torch

from . import _build
from .activations import shifted_softplus
from .colblock import (
    ColRefs, column_fold, column_gather, destination_schedule, source_schedule,
)

#: kernel launches since the last reset (SchNet MD: 3 each per step;
#: ``cf_bwd_wgrad`` counts K10's wgrad instance)
LAUNCHES = {"cf_fwd": 0, "cf_bwd": 0, "cf_bwd_wgrad": 0, "cf_fwd_gen": 0,
            "cf_bwd_gen": 0, "cf_bwd_wgrad_gen": 0}
#: the filter widths the tuned kernels take (with B <= ``TUNED_MAX_B``)
N_FILTERS = (64, 128)
TUNED_MAX_B = 32
#: bytes of weight-cotangent partials K10's general wgrad instance may
#: allocate before it takes fewer row ranges a column
GEN_WPART_BYTES = 256 << 20
#: its row ranges a column, plain and wgrad, at most (the wgrad partials
#: may take fewer, GEN_WPART_BYTES); H100, device ms on the bench box, F =
#: 30: G = 5 0.324, 8 0.387, 10 0.322, 16 0.296, 20 0.315, 32 0.320; wgrad
#: 5 0.453, 16 0.422 (F = 64: 1.033, 0.834)
GEN_RANGES = 16
#: slots a chunk and row ranges a block of K9 and K10's plain instance
#: (``kE``, ``kGroups`` of ``csrc/schnet_columns.cu``)
SLOTS, GROUPS = 16, 3
#: K9's row ranges a column, at most (``scripts/time_cfconv_kernels.py
#: --groups fwd=G`` at the SchNet run's 100 columns on the H100, device
#: ms: 4 ranges 0.362, 5 0.494, 6 0.474, 7 0.418, 8 0.361-0.364, 9 0.408,
#: 10 0.407, 12 0.393, 16 0.376)
FWD_RANGES = 8
#: K10's row ranges a column, at most, plain and wgrad instance
#: (``scripts/time_cfconv_kernels.py --groups bwd=G``, ``wgrad=G`` at the
#: SchNet run's 100 columns on the H100: plain 11 ranges 0.758 ms, 16
#: 0.727, 24 0.788, 32 0.838; wgrad, whose ranges each write an f64
#: partial of the weight cotangents, 5 1.44 ms, 16 1.46-1.54)
BWD_RANGES, WGRAD_RANGES = 16, 5


def _bp(B: int) -> int:
    """The padded basis width: B + 1 (a column of ones for gb1) rounded up
    to 8."""
    return -(-(B + 1) // 8) * 8


def cf_smem_bytes(F: int, B: int, bwd: bool, wgrad: bool = False) -> int:
    """Dynamic shared memory of K9 (``bwd`` False) or K10 (its wgrad
    instance with ``wgrad``) at F filters and B basis functions, which
    does not depend on the column capacity: what ``csrc/schnet_columns.cu
    ::spk_cf_smem_bytes`` gives the launch, which the card tests hold it
    to.  W2 and the padded W1 [F + Bp, F + 4], and per row range that the
    block runs (``GROUPS``; wgrad: one) two buffers of the staged chunk
    (phi [E, MP + 4], fcut and four int arrays [E]), the tiles
    [E, F + 4] (K9 two, K10 three, wgrad four) and K10's gfcut partials
    [E, F / 32]; wgrad also the f32 sums [F + MP, F + 8] (MP: Bp rounded
    up to 16)."""
    E, bp = SLOTS, _bp(B)
    mp = -(-bp // 16) * 16
    tiles = 4 if wgrad else 3 if bwd else 2
    group = (2 * (E * (mp + 4) + 5 * E) + tiles * E * (F + 4)
             + (E * (F // 32) if bwd else 0))
    rest = group + (F + mp) * (F + 8) if wgrad else GROUPS * group
    return 4 * ((F + bp) * (F + 4) + rest)


def tuned_width(F: int, B: int) -> bool:
    """Whether the tuned instances take (F, B): F in ``N_FILTERS`` and B <=
    ``TUNED_MAX_B``.  Their shared memory (``cf_smem_bytes``) fits the
    opt-in limit at every shape they take, whatever the column capacity
    P; the general instances take every other shape."""
    return F in N_FILTERS and B <= TUNED_MAX_B


def check_width(F: int, B: int) -> None:
    """Raise ``ValueError`` for a shape no instance takes: F < 1 or B < 1
    (the tuned or the general instances take every other; the general
    ones keep their tiles in global scratch where they do not fit shared
    memory)."""
    if F < 1 or B < 1:
        raise ValueError(f"the cfconv kernels need F >= 1 and B >= 1, got "
                         f"F={F}, B={B}")


def gen_width(F: int) -> int:
    """Fp, the general instances' padded width: F rounded up to 32."""
    return -(-F // 32) * 32


def _mp(B: int) -> int:
    """MP: the padded basis width rounded up to 16 (the rows of the
    [gW1; gb1] sums)."""
    return -(-_bp(B) // 16) * 16


def gen_wpart_shape(F: int, B: int):
    """A row range's weight-cotangent partial in K10's general wgrad
    instance: [MP + Fp + 1, Fp + 8] f32 (gW1 | gb1 | 0 rows, gW2, gb2)."""
    Fp = gen_width(F)
    return _mp(B) + Fp + 1, Fp + 8


def gen_padded_weights(W1, b1, W2, b2):
    """``pad_gen_weights`` of these weights, made once per parameter
    version (``_build.cached_per_version``)."""
    return _build.cached_per_version(pad_gen_weights, W1, b1, W2, b2)


def pad_gen_weights(W1, b1, W2, b2):
    """The filter weights at the general instances' tiles: W1 [Bp, Fp]
    (zero rows from B: the ones column at B adds nothing, gb1 comes out of
    the wgrad product), b1 [Fp], W2 [Fp, Fp], b2 [Fp], zero-padded."""
    B, F = W1.shape
    Fp, Bp = gen_width(F), _bp(B)
    with torch.no_grad():
        W1p = W1.new_zeros((Bp, Fp))
        W1p[:B, :F] = W1
        W2p = W2.new_zeros((Fp, Fp))
        W2p[:F, :F] = W2
        b1p, b2p = W1.new_zeros(Fp), W1.new_zeros(Fp)
        b1p[:F], b2p[:F] = b1, b2
    return W1p, b1p, W2p, b2p


def _fwd_schedule(refs: ColRefs):
    """K9's (dsorted, grp, G): ``destination_schedule`` with ``FWD_RANGES``
    row ranges a column, at most one a row."""
    G = min(FWD_RANGES, refs.P)
    return (*destination_schedule(refs, G), G)


def _bwd_schedule(refs: ColRefs, wgrad: bool):
    """K10's (esorted, grp, G): ``source_schedule`` with ``BWD_RANGES``
    (wgrad: ``WGRAD_RANGES``) row ranges a column, at most one a row."""
    G = min(WGRAD_RANGES if wgrad else BWD_RANGES, refs.P)
    return (*source_schedule(refs, G), G)


def _check(h, geo, W1, b1, W2, b2, refs: ColRefs):
    nx, ny, Ktot = refs.qcol.shape
    B, F = W1.shape
    check_width(F, B)
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
    dsorted, grp, G = _fwd_schedule(refs)
    out = torch.empty_like(h)
    p = _build.ptr
    args = (p(refs.qcol), p(refs.dcol), p(dsorted), p(grp), p(out), nx, ny,
            refs.P, Ktot, refs.koffs_arg, G, B, F)
    if tuned_width(F, B):
        name = "cf_fwd"
        _build.launch("spk_cf_fwd", p(h), p(geo), p(W1), p(b1), p(W2), p(b2),
                      *args)
    else:
        name = "cf_fwd_gen"
        # the ranges' slots with fcut != 0, which the kernel writes and
        # walks: the others add exact zeros
        kept = torch.empty_like(dsorted)
        _build.launch("spk_cf_fwd_gen", p(h), p(geo),
                      *map(p, gen_padded_weights(W1, b1, W2, b2)), *args,
                      p(kept))
    LAUNCHES[name] += 1
    return out


def cf_bwd_kernel(h, geo, W1, b1, W2, b2, refs: ColRefs, g,
                  wgrad: bool = False):
    """K10: (dh [A', F], ggeo [nx, ny, B+4, Ktot]) for the cotangent g of
    K9's output, each element written once by the kernel.  With ``wgrad``
    also (gW1, gb1, gW2, gb2): the blocks' f64 partials summed here and
    rounded to f32."""
    nx, ny, Ktot, B, F = _check(h, geo, W1, b1, W2, b2, refs)
    _build.check(g, "g", tuple(h.shape))
    dh = torch.empty_like(h)
    p = _build.ptr
    nw = (B + 2) * F + F * F
    if tuned_width(F, B):
        esorted, grp, G = _bwd_schedule(refs, wgrad)
        ggeo = torch.empty_like(geo)
        wpart = (h.new_empty((nx * ny * G, nw), dtype=torch.float64)
                 if wgrad else None)
        name = "cf_bwd"
        weights = (W1, b1, W2, b2)
    else:
        G = min(GEN_RANGES, refs.P)
        rows, ld = gen_wpart_shape(F, B)
        if wgrad:   # fewer ranges where the partials would be large
            G = max(1, min(G, GEN_WPART_BYTES // (4 * rows * ld * nx * ny)))
        esorted, grp = source_schedule(refs, G)
        ggeo = torch.empty_like(geo)
        wpart = h.new_empty((nx * ny * G, rows, ld)) if wgrad else None
        weights = gen_padded_weights(W1, b1, W2, b2)
        name = "cf_bwd_gen"
    _build.launch("spk_" + name, p(h), p(geo), *map(p, weights),
                  p(refs.qcol), p(refs.dcol), p(esorted), p(grp), p(g),
                  p(dh), p(ggeo),
                  None if wpart is None else p(wpart), nx, ny, refs.P, Ktot,
                  G, B, F)
    if not wgrad:
        LAUNCHES[name] += 1
        return dh, ggeo
    LAUNCHES[name.replace("_bwd", "_bwd_wgrad")] += 1
    if wpart.dim() == 3:   # the general instance's padded partials
        w = wpart.sum(0, dtype=torch.float64).to(torch.float32)
        mp, Fp = _mp(B), gen_width(F)
        return (dh, ggeo, w[:B, :F], w[B, :F], w[mp:mp + F, :F],
                w[mp + Fp, :F])
    w = wpart.sum(0).to(torch.float32)
    return (dh, ggeo, w[:B * F].view(B, F), w[B * F:(B + 1) * F],
            w[(B + 1) * F:(B + 1) * F + F * F].view(F, F),
            w[(B + 1) * F + F * F:])


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
    """K9 forward, K10 backward (its wgrad instance when a filter weight
    needs a gradient) on CUDA; their twins on the CPU."""

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
        if not h.is_cuda:
            return (*cf_bwd_plain(h, geo, W1, b1, W2, b2, ctx.refs, g), None)
        need_w = ctx.needs_input_grad[2:6]
        dh, ggeo, *gw = cf_bwd_kernel(h, geo, W1, b1, W2, b2, ctx.refs, g,
                                      wgrad=any(need_w))
        gw = [t if n else None for t, n in zip(gw, need_w)] or [None] * 4
        return (dh, ggeo, *gw, None)


def schnet_cfconv_columns(h, geo, W1, b1, W2, b2, refs: ColRefs):
    """Fused cfconv over the column layout (signature of ``schnetpack_tpu.
    ops.schnet_columns.schnet_cfconv_columns`` with the packed geo).

    h [A', F] in2f output, geo [nx, ny, B+4, Ktot] raw-phi geometry, W1
    [B, F], b1 [F], W2 [F, F], b2 [F] the filter network in flax's [in,
    out] layout.  Returns the per-atom sums [A', F]."""
    args = [t.contiguous() for t in (h, geo, W1, b1, W2, b2)]
    return SchNetCFConv.apply(*args, refs)
