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

Every kernel has a tuned instance (one thread a feature: F % 32 == 0,
F <= 256; its wgrad instance B+1 <= 32, within the shared memory that
the size query finds) and a general one (``csrc/colblock_message_gen.cu``;
the general backward reads FW_aug zero-padded to its feature tiles,
``gen_padded_fw``) for every other width F >= 1 and basis B >= 1; the
wrappers dispatch on the shape between the two (``tuned_takes``) and
count the general instances in ``LAUNCHES`` under the tuned name with
``_gen`` appended (before a mode's suffix).

The full and hybrid forms take ``pieces`` (``ops/precision.py``), the JAX
package's ``PIECES`` as an argument: K1/K2 and K6/K7 have instances for
each (3: f32, 2: mixed, 1: bf16), counted in ``LAUNCHES`` under the
f32 name with ``_mixed`` or ``_bf16`` appended.  At one piece the wrappers
hand the kernels bf16 copies of x and mu (the forward keeps them for the
backward) and of the cotangents; at two the kernels round what they load.
The twins round at the same points (``colblock.painn_message``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .colblock import (
    ColRefs, column_geometry, decode_i, decode_j, destination_schedule,
    painn_message, source_schedule,
)
from .precision import check_pieces

#: the launch counters' suffix of each reduced mode
MODE_SUFFIX = {3: "", 2: "_mixed", 1: "_bf16"}


def gen_name(name: str) -> str:
    """The launch counter of the general instance of the kernel counted as
    ``name``: ``_gen`` before a mode's suffix (``msg_fwd_gen_bf16``)."""
    for sfx in ("_mixed", "_bf16"):
        if name.endswith(sfx):
            return name[:-len(sfx)] + "_gen" + sfx
    return name + "_gen"


#: kernel launches since the last reset (the main path adds one per call)
LAUNCHES = {"msg_fwd": 0, "msg_bwd": 0, "msg_fwd_geo": 0,
            "msg_bwd_geores": 0, "msg_bwd_src": 0,
            **{k + MODE_SUFFIX[p]: 0 for p in (2, 1)
               for k in ("msg_fwd", "msg_bwd", "msg_fwd_geo",
                         "msg_bwd_geores")}}
LAUNCHES.update({gen_name(k): 0 for k in list(LAUNCHES)})
#: the widest F of the tuned bodies, one thread a feature
#: (csrc/colblock_message.cuh); wider or F % 32 != 0 takes the general one
TUNED_MAX_F = 256
_MAX_GROUPS = 16    # row ranges per column
#: B+1 bound of the tuned wgrad instances' f64 partials in shared memory
TUNED_WGRAD_B1 = 32
#: features a block of the general instances, at most (``kGenTile``)
GEN_TILE = 256
#: what the forward kernels read (``kIn`` of ``msg_fwd_kernel``): the
#: positions (K1), a geometry (K6, K20), a geometry in the cell index mode
#: (K18, ``ops/painn_fused.py``)
FWD_POS, FWD_GEO, FWD_CELL = 0, 1, 2
#: the backward kernels' forms (``kMode`` of ``msg_bwd_kernel``; K19 is
#: BWD_CELL)
BWD_FUSED, BWD_GEORES, BWD_SRC, BWD_CELL = 0, 1, 2, 3


def _shapes(x, cw, refs: ColRefs):
    nx, ny, Ktot = refs.qcol.shape
    return nx, ny, Ktot, nx * ny * refs.P, x.shape[1] // 3, cw.shape[0]


def tuned_width(F: int, B: int, wgrad: bool = False) -> bool:
    """Whether the tuned bodies' widths take (F, B): one thread a feature,
    F % 32 == 0 and F <= ``TUNED_MAX_F``, and in a wgrad instance B+1 <=
    ``TUNED_WGRAD_B1``.  Their shared memory is the size query's
    (``tuned_takes``)."""
    return (F % 32 == 0 and F <= TUNED_MAX_F
            and (not wgrad or B + 1 <= TUNED_WGRAD_B1))


@functools.lru_cache(maxsize=256)
def _fits(query: str, *args) -> bool:
    return _build.query(query, *args) > 0


def tuned_takes(query: str, F: int, B: int, wgrad: bool, *args) -> bool:
    """Whether the tuned instance of ``query`` (its resident blocks per SM,
    with ``args``) takes (F, B): ``tuned_width`` and a block that fits the
    shared memory of an SM; else the general instance runs."""
    return tuned_width(F, B, wgrad) and _fits(query, *args)


def gen_tiles(F: int) -> int:
    """Z, the general instances' feature tiles (``gen_tiles``)."""
    return -(-F // GEN_TILE)


def gen_threads(F: int) -> int:
    """NT, the threads (features) a block of the general instances: F / Z
    rounded up to the warp (``gen_threads``)."""
    return -(-(-(-F // gen_tiles(F))) // 32) * 32


def gen_groups(device, P: int, n_cols: int, bwd: bool, mode: int,
               wgrad: bool, F: int, B: int) -> int:
    """G of a general instance: ``wave_groups`` over its n_cols * Z blocks
    a range."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slots = _blocks_per_sm("spk_msg_gen_blocks", int(bwd), mode, int(wgrad),
                           F, B) * sms
    return wave_groups(n_cols * gen_tiles(F), slots, min(_MAX_GROUPS, P))


_NO_KOFFS = (ctypes.c_int * 10)()


def fwd_gen(in_mode: int, pieces: int, x, mu, FW_aug, dsorted, grp, G: int,
            dq, dmu, dims, F: int, B: int, ldx: int, R=None, coff=None,
            cw=None, rbf=None, dirs=None, edge: int = 0, nch: int = 0,
            qcol=None, dcol=None, koffs=None, halo=(0, 0), rc: float = 0.0,
            cell=(0, 0, 0)):
    """Launch the general forward (``spk_msg_fwd_gen``) of ``in_mode``
    (FWD_POS, FWD_GEO, FWD_CELL) into dq, dmu; ``dims`` (nx, ny, P,
    Ktot)."""
    p = _opt_ptr
    nx, ny, P, Ktot = dims
    _build.launch("spk_msg_fwd_gen", in_mode, pieces, p(x), p(mu), p(R),
                  p(rbf), p(dirs), edge, nch, p(FW_aug), p(coff), p(cw),
                  p(qcol), p(dcol), p(dsorted), p(grp), p(dq), p(dmu), nx,
                  ny, P, Ktot, _NO_KOFFS if koffs is None else koffs, G, F,
                  B, ldx, *halo, float(rc), *cell)


def bwd_gen(mode: int, pieces: int, x, mu, FW_aug, esorted, grp, G: int,
            g_dq, g_dmu, dx, dmu, n_src: int, dims, F: int, B: int,
            ldx: int, wgrad: bool = False, R=None, coff=None, cw=None,
            rbf=None, dirs=None, edge: int = 0, nch: int = 0, qcol=None,
            dcol=None, koffs=None, rc: float = 0.0, cell=(0, 0, 0), gRo=None,
            gRd=None, grbf=None, gdir=None):
    """Launch the general backward (``spk_msg_bwd_gen``, the mixed and bf16
    instances under ``_mixed`` and ``_bf16``) of ``mode`` (BWD_FUSED,
    BWD_GEORES, BWD_SRC, BWD_CELL) on FW_aug padded to its feature tiles
    (``gen_padded_fw``): dx, dmu, and gRo [Z, n_src, 3, P] and gRd [Z, G,
    9, nx*ny, 3, P] (K2, K7) or the geometry cotangent grbf (and gdir) [Z,
    ...] (the others), zero-filled by the caller.  Returns gFW [B+1, 3F]
    with ``wgrad`` (the blocks' f64 partials of the padded columns summed,
    unpadded and rounded to f32), else None."""
    p = _opt_ptr
    nx, ny, P, Ktot = dims
    Z, NT = gen_tiles(F), gen_threads(F)
    gFWp = (x.new_empty((n_src * G, B + 1, Z * 3 * NT), dtype=torch.float64)
            if wgrad else None)
    gz_r = grbf[0].numel() if grbf is not None else 0
    gz_d = gdir[0].numel() if gdir is not None else gz_r   # packed: one
    _build.launch("spk_msg_bwd_gen" + MODE_SUFFIX[pieces], mode, pieces,
                  p(x), p(mu), p(R), p(rbf), p(dirs), edge, nch,
                  p(gen_padded_fw(FW_aug)), p(coff), p(cw), p(qcol), p(dcol),
                  p(esorted), p(grp), p(g_dq), p(g_dmu), p(dx), p(dmu),
                  p(gRo), p(gRd), p(grbf), p(gdir), gz_r, gz_d, p(gFWp),
                  n_src, nx, ny, P, Ktot,
                  _NO_KOFFS if koffs is None else koffs, G, F, B, ldx,
                  float(rc), *cell)
    if gFWp is None:
        return None
    w = gFWp.sum(0).view(B + 1, Z, 3, NT).transpose(1, 2)
    return w.reshape(B + 1, 3, Z * NT)[:, :, :F].reshape(B + 1, 3 * F).to(
        torch.float32)


def gen_padded_fw(FW_aug):
    """``pad_gen_fw`` of FW_aug, made once per parameter version
    (``_build.cached_per_version``)."""
    return _build.cached_per_version(pad_gen_fw, FW_aug)


def pad_gen_fw(FW_aug):
    """FW_aug [B+1, 3F] at the general backward's feature tiles: [B+1, Z,
    3, NT], part p's features z NT .. z NT + NT of tile z, zero past F."""
    B1, F = FW_aug.shape[0], FW_aug.shape[1] // 3
    Z, NT = gen_tiles(F), gen_threads(F)
    with torch.no_grad():
        out = FW_aug.new_zeros((B1, 3, Z * NT))
        out[:, :, :F] = FW_aug.view(B1, 3, F)
        return out.view(B1, 3, Z, NT).transpose(1, 2).contiguous()


def _opt_ptr(t):
    return None if t is None else t.data_ptr()


def _gen_position_partials(like, refs: ColRefs, G: int, F: int):
    """The general backward's gRo [Z, nx*ny, 3, P] and gRd [Z, G, 9, nx*ny,
    3, P] (the kernel zeroes the slices it sums into)."""
    nx, ny, _ = refs.qcol.shape
    Z, n = gen_tiles(F), nx * ny
    return (like.new_empty((Z, n, 3, refs.P)),
            like.new_empty((Z, G, 9, n, 3, refs.P)))


def _gen_dR(gRo, gRd, Ap: int):
    """dR [A', 3] from the general backward's partials."""
    return (gRo.sum(0) + gRd.sum((0, 1, 2))).transpose(1, 2).reshape(Ap, 3)


def feat(t: torch.Tensor, pieces: int) -> torch.Tensor:
    """A feature or cotangent table as the kernel instance of ``pieces``
    reads it: a bf16 copy at one piece, else itself."""
    return t.to(torch.bfloat16) if pieces == 1 else t


def _feat_dtype(pieces: int):
    return torch.bfloat16 if pieces == 1 else torch.float32


def _check_common(x, mu, FW_aug, refs: ColRefs, B: int, pieces: int = 3):
    nx, ny, Ktot = refs.qcol.shape
    Ap, F = nx * ny * refs.P, x.shape[1] // 3
    if any(k % 8 for k in refs.ksizes):
        raise ValueError(f"bucket sizes must be multiples of 8: {refs.ksizes}")
    _build.check(x, "x", (Ap, 3 * F), _feat_dtype(pieces))
    _build.check(mu, "mu", (Ap, 3 * F), _feat_dtype(pieces))
    _build.check(FW_aug, "FW_aug", (B + 1, 3 * F))
    _build.check(refs.qcol, "qcol", (nx, ny, Ktot), torch.int32)
    _build.check(refs.dcol, "dcol", (nx, ny, Ktot), torch.int32)


def _check(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, pieces: int = 3):
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    _check_common(x, mu, FW_aug, refs, B, pieces)
    _build.check(R, "R", (Ap, 3))
    _build.check(coff_fm, "coff_fm", (nx, ny, 3, Ktot))
    _build.check(cw, "cw", (B, 2))


def msg_fwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                   pieces: int = 3):
    """K1: dq [A', F], dmu [A', 3F] summed per destination atom, in the
    instance of ``pieces`` (x, mu as ``feat`` gives them)."""
    pieces = check_pieces(pieces)
    x, mu = feat(x, pieces), feat(mu, pieces)
    _check(x, mu, R, FW_aug, coff_fm, cw, refs, pieces)
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    dq = R.new_empty((Ap, F))
    dmu = R.new_empty((Ap, 3 * F))
    if not _tuned_fwd(FWD_POS, F, B, refs.P, pieces):
        G = gen_groups(R.device, refs.P, nx * ny, False, FWD_POS, False, F,
                       B)
        fwd_gen(FWD_POS, pieces, x, mu, FW_aug,
                *destination_schedule(refs, G), G, dq, dmu,
                (nx, ny, refs.P, Ktot), F, B, 3 * F, R=R, coff=coff_fm,
                cw=cw, qcol=refs.qcol, dcol=refs.dcol, koffs=refs.koffs_arg,
                rc=rc)
        LAUNCHES[gen_name("msg_fwd" + MODE_SUFFIX[pieces])] += 1
        return dq, dmu
    dsorted, dgrp, G = _fwd_schedule(refs, FWD_POS, F, B, pieces)
    p = _build.ptr
    _build.launch("spk_msg_fwd" + MODE_SUFFIX[pieces], p(x), p(mu), p(R),
                  p(FW_aug), p(coff_fm), p(cw), p(refs.qcol), p(refs.dcol),
                  p(dsorted), p(dgrp), p(dq), p(dmu), nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, float(rc))
    LAUNCHES["msg_fwd" + MODE_SUFFIX[pieces]] += 1
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


def _groups(device, P: int, n_cols: int, query: str, *args) -> int:
    """G for a kernel instance over ``n_cols`` columns of ``P`` rows on
    ``device``: ``wave_groups`` of its resident blocks per SM (``query``
    with ``args``) times the SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return wave_groups(n_cols, _blocks_per_sm(query, *args) * sms,
                       min(_MAX_GROUPS, P))


def _tuned_fwd(mode: int, F: int, B: int, P: int, pieces: int = 3) -> bool:
    """Whether the tuned forward instance (``mode``, ``pieces``) takes (F,
    B) at column capacity P (K1 stages the positions of P rows)."""
    return tuned_takes("spk_msg_fwd_blocks" + MODE_SUFFIX[pieces], F, B,
                       False, mode, F, B, P)


def _tuned_bwd(mode: int, wgrad: bool, F: int, B: int,
               pieces: int = 3) -> bool:
    """Whether the tuned backward instance takes (F, B)."""
    return tuned_takes("spk_msg_bwd_blocks" + MODE_SUFFIX[pieces], F, B,
                       wgrad, mode, int(wgrad), F, B)


def _fwd_schedule(refs: ColRefs, mode: int, F: int, B: int,
                  pieces: int = 3):
    """The forward kernels' (dsorted, grp, G): ``destination_schedule``
    with G from the instance's occupancy (``mode``: FWD_POS or FWD_GEO)."""
    nx, ny, _ = refs.qcol.shape
    G = _groups(refs.qcol.device, refs.P, nx * ny,
                "spk_msg_fwd_blocks" + MODE_SUFFIX[pieces], mode, F, B,
                refs.P)
    return (*destination_schedule(refs, G), G)


def _bwd_schedule(refs: ColRefs, n_cols: int, mode: int, wgrad: bool,
                  F: int, B: int, pieces: int = 3):
    """The backward kernels' (esorted, grp, G): ``source_schedule`` of the
    ``n_cols`` source columns, G from the occupancy of the instance
    (``mode``, ``wgrad``, ``pieces``)."""
    G = _groups(refs.qcol.device, refs.P, n_cols,
                "spk_msg_bwd_blocks" + MODE_SUFFIX[pieces], mode, int(wgrad),
                F, B)
    return (*source_schedule(refs, G), G)


def _gfw_partials(x, FW_aug, n_blocks: int, wgrad: bool):
    """The wgrad instances' per-block f64 gFW partials [blocks, B+1, 3F]
    (None without wgrad)."""
    if not wgrad:
        return None
    return x.new_empty((n_blocks, *FW_aug.shape), dtype=torch.float64)


def _with_gfw(out: tuple, gFWp):
    """``out`` and, for a wgrad launch, gFW: the f64 partials summed
    (deterministic) and rounded to f32."""
    return out if gFWp is None else (*out, gFWp.sum(0).to(torch.float32))


def with_gen_gfw(out: tuple, gFW):
    """``out`` and, for a wgrad launch of a general instance, its gFW."""
    return out if gFW is None else (*out, gFW)


def msg_bwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                   g_dq, g_dmu, wgrad: bool = False, pieces: int = 3):
    """K2: cotangents (dx, dmu, dR) of K1's outputs for (g_dq, g_dmu), and
    with ``wgrad`` also gFW [B+1, 3F], in the instance of ``pieces`` (the
    features and cotangents as ``feat`` gives them).

    Blocks own source-row ranges (``_bwd_schedule``), so dx, dmu and the
    own-column position cotangent have one writer per row; the
    destination-side position cotangents come as partials
    [G, 9, nx*ny, 3, P] (one per row range and bucket) that are summed
    here, as ``colblock_pallas.py:1494-1497`` sums them outside the TPU
    kernel, and so are the blocks' gFW partials."""
    pieces = check_pieces(pieces)
    x, mu, g_dq, g_dmu = (feat(t, pieces) for t in (x, mu, g_dq, g_dmu))
    _check(x, mu, R, FW_aug, coff_fm, cw, refs, pieces)
    nx, ny, Ktot, Ap, F, B = _shapes(x, cw, refs)
    _build.check(g_dq, "g_dq", (Ap, F), _feat_dtype(pieces))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F), _feat_dtype(pieces))
    dx = R.new_empty((Ap, 3 * F))
    dmu = R.new_empty((Ap, 3 * F))
    if not _tuned_bwd(BWD_FUSED, wgrad, F, B, pieces):
        G = gen_groups(R.device, refs.P, nx * ny, True, BWD_FUSED, wgrad, F,
                       B)
        gRo, gRd = _gen_position_partials(R, refs, G, F)
        gFW = bwd_gen(BWD_FUSED, pieces, x, mu, FW_aug,
                      *source_schedule(refs, G), G, g_dq, g_dmu, dx, dmu,
                      nx * ny, (nx, ny, refs.P, Ktot), F, B, 3 * F, wgrad,
                      R=R, coff=coff_fm, cw=cw, qcol=refs.qcol,
                      dcol=refs.dcol, koffs=refs.koffs_arg, rc=rc, gRo=gRo,
                      gRd=gRd)
        LAUNCHES[gen_name("msg_bwd" + MODE_SUFFIX[pieces])] += 1
        return with_gen_gfw((dx, dmu, _gen_dR(gRo, gRd, Ap)), gFW)
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_FUSED, wgrad, F, B,
                                    pieces)
    gRo = R.new_empty((nx * ny, 3, refs.P))
    gRd = R.new_empty((G, 9, nx * ny, 3, refs.P))
    gFWp = _gfw_partials(x, FW_aug, nx * ny * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd" + MODE_SUFFIX[pieces], p(x), p(mu), p(R),
                  p(FW_aug), p(coff_fm), p(cw), p(refs.qcol), p(refs.dcol),
                  p(esorted), p(grp), p(g_dq), p(g_dmu), p(dx), p(dmu),
                  p(gRo), p(gRd),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, float(rc))
    LAUNCHES["msg_bwd" + MODE_SUFFIX[pieces]] += 1
    dR = (gRo + gRd.sum((0, 1))).transpose(1, 2).reshape(Ap, 3)
    return _with_gfw((dx, dmu, dR), gFWp)


def msg_fwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                  pieces: int = 3):
    """Plain twin of K1 (autograd-able)."""
    rbf_aug, dirs = column_geometry(R, coff_fm, refs, cw, rc)
    return painn_message(x, mu, rbf_aug, dirs, FW_aug, refs, pieces)


def msg_bwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs: ColRefs, rc: float,
                  g_dq, g_dmu, pieces: int = 3):
    """Plain twin of K2: the VJP of ``msg_fwd_plain`` w.r.t. (x, mu, R,
    FW_aug), i.e. (dx, dmu, dR, gFW)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, mu, R, FW_aug)]
        out = msg_fwd_plain(*ins, coff_fm, cw, refs, rc, pieces)
        return torch.autograd.grad(out, ins, (g_dq, g_dmu))


def _bwd_feats(ctx, g_dq, g_dmu):
    """The saved features and the contiguous cotangents, in the form the
    backward instance of ``ctx.pieces`` reads."""
    return (feat(g_dq.contiguous(), ctx.pieces),
            feat(g_dmu.contiguous(), ctx.pieces))


class PaiNNMessageFullFused(torch.autograd.Function):
    """K1 forward, K2 backward (its wgrad instance when FW_aug needs a
    gradient), in the instances of ``pieces``; at one piece the bf16
    copies of x and mu are made once and kept for the backward."""

    @staticmethod
    def forward(ctx, x, mu, R, FW_aug, coff_fm, cw, refs, rc, pieces):
        x, mu = feat(x, pieces), feat(mu, pieces)
        ctx.save_for_backward(x, mu, R, FW_aug, coff_fm, cw)
        ctx.refs, ctx.rc, ctx.pieces = refs, rc, pieces
        return msg_fwd_kernel(x, mu, R, FW_aug, coff_fm, cw, refs, rc,
                              pieces)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        x, mu, R, FW_aug, coff_fm, cw = ctx.saved_tensors
        wgrad = ctx.needs_input_grad[3]
        dx, dmu, dR, *gFW = msg_bwd_kernel(
            x, mu, R, FW_aug, coff_fm, cw, ctx.refs, ctx.rc,
            *_bwd_feats(ctx, g_dq, g_dmu), wgrad, ctx.pieces)
        return (dx, dmu, dR, gFW[0] if wgrad else None, None, None, None,
                None, None)


def painn_message_columns_full_fused(x, mu, R, FW_aug, coff_fm, cw,
                                     refs: ColRefs, rc: float,
                                     pieces: int = 3):
    """PaiNN message over the column layout with the geometry recomputed
    from ``R`` [A', 3] (signature of ``schnetpack_tpu.ops.colblock.
    painn_message_columns_full_fused``; ``pieces``, the JAX package's
    ``PIECES``).  Returns dq [A', F], dmu [A', 3F].
    """
    pieces = check_pieces(pieces)
    if not x.is_cuda:
        return msg_fwd_plain(x, mu, R, FW_aug, coff_fm, cw, refs, rc, pieces)
    return PaiNNMessageFullFused.apply(x, mu, R, FW_aug, coff_fm, cw, refs,
                                       float(rc), pieces)


# ------------------------------------------------------------- hybrid path
def msg_fwd_geo_kernel(x, mu, geo, FW_aug, refs: ColRefs, pieces: int = 3):
    """K6: dq [A', F], dmu [A', 3F] from the stored geo [nx, ny, nch,
    Ktot] (nch = B+4 or B+5; the d channel is not read), in the instance
    of ``pieces`` (x, mu as ``feat`` gives them)."""
    pieces = check_pieces(pieces)
    x, mu = feat(x, pieces), feat(mu, pieces)
    nx, ny, Ktot = refs.qcol.shape
    B = FW_aug.shape[0] - 1
    nch = geo.shape[2]
    if nch not in (B + 4, B + 5):
        raise ValueError(f"geo has {nch} channels, want {B + 4} or {B + 5}")
    _check_common(x, mu, FW_aug, refs, B, pieces)
    _build.check(geo, "geo", (nx, ny, nch, Ktot))
    Ap, F = x.shape[0], x.shape[1] // 3
    dq = geo.new_empty((Ap, F))
    dmu = geo.new_empty((Ap, 3 * F))
    if not _tuned_fwd(FWD_GEO, F, B, refs.P, pieces):
        G = gen_groups(geo.device, refs.P, nx * ny, False, FWD_GEO, False, F,
                       B)
        fwd_gen(FWD_GEO, pieces, x, mu, FW_aug,
                *destination_schedule(refs, G), G, dq, dmu,
                (nx, ny, refs.P, Ktot), F, B, 3 * F, rbf=geo, nch=nch,
                qcol=refs.qcol, dcol=refs.dcol, koffs=refs.koffs_arg)
        LAUNCHES[gen_name("msg_fwd_geo" + MODE_SUFFIX[pieces])] += 1
        return dq, dmu
    dsorted, dgrp, G = _fwd_schedule(refs, FWD_GEO, F, B, pieces)
    p = _build.ptr
    _build.launch("spk_msg_fwd_geo" + MODE_SUFFIX[pieces], p(x), p(mu),
                  p(geo), p(FW_aug), p(refs.qcol), p(refs.dcol), p(dsorted),
                  p(dgrp), p(dq), p(dmu), nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, nch)
    LAUNCHES["msg_fwd_geo" + MODE_SUFFIX[pieces]] += 1
    return dq, dmu


def msg_bwd_geores_kernel(x, mu, geo, FW_aug, cw, refs: ColRefs, rc: float,
                          g_dq, g_dmu, wgrad: bool = False, pieces: int = 3):
    """K7: cotangents (dx, dmu, dR) of K6's outputs for (g_dq, g_dmu),
    the geometry chain taken from the stored geo [nx, ny, B+5, Ktot]; no
    positions.  Same schedule and partial sums as K2, and with ``wgrad``
    also gFW [B+1, 3F]; in the instance of ``pieces``."""
    pieces = check_pieces(pieces)
    x, mu, g_dq, g_dmu = (feat(t, pieces) for t in (x, mu, g_dq, g_dmu))
    nx, ny, Ktot = refs.qcol.shape
    B = cw.shape[0]
    _check_common(x, mu, FW_aug, refs, B, pieces)
    _build.check(geo, "geo", (nx, ny, B + 5, Ktot))
    _build.check(cw, "cw", (B, 2))
    Ap, F = x.shape[0], x.shape[1] // 3
    _build.check(g_dq, "g_dq", (Ap, F), _feat_dtype(pieces))
    _build.check(g_dmu, "g_dmu", (Ap, 3 * F), _feat_dtype(pieces))
    dx = geo.new_empty((Ap, 3 * F))
    dmu = geo.new_empty((Ap, 3 * F))
    if not _tuned_bwd(BWD_GEORES, wgrad, F, B, pieces):
        G = gen_groups(geo.device, refs.P, nx * ny, True, BWD_GEORES, wgrad,
                       F, B)
        gRo, gRd = _gen_position_partials(geo, refs, G, F)
        gFW = bwd_gen(BWD_GEORES, pieces, x, mu, FW_aug,
                      *source_schedule(refs, G), G, g_dq, g_dmu, dx, dmu,
                      nx * ny, (nx, ny, refs.P, Ktot), F, B, 3 * F, wgrad,
                      cw=cw, rbf=geo, nch=B + 5, qcol=refs.qcol,
                      dcol=refs.dcol, koffs=refs.koffs_arg, rc=rc, gRo=gRo,
                      gRd=gRd)
        LAUNCHES[gen_name("msg_bwd_geores" + MODE_SUFFIX[pieces])] += 1
        return with_gen_gfw((dx, dmu, _gen_dR(gRo, gRd, Ap)), gFW)
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_GEORES, wgrad, F, B,
                                    pieces)
    gRo = geo.new_empty((nx * ny, 3, refs.P))
    gRd = geo.new_empty((G, 9, nx * ny, 3, refs.P))
    gFWp = _gfw_partials(x, FW_aug, nx * ny * G, wgrad)
    p = _build.ptr
    _build.launch("spk_msg_bwd_geores" + MODE_SUFFIX[pieces], p(x), p(mu),
                  p(geo), p(FW_aug), p(cw), p(refs.qcol), p(refs.dcol),
                  p(esorted), p(grp), p(g_dq), p(g_dmu), p(dx), p(dmu),
                  p(gRo), p(gRd),
                  gFWp.data_ptr() if wgrad else None, nx, ny, refs.P, Ktot,
                  refs.koffs_arg, G, F, B, B + 5, float(rc))
    LAUNCHES["msg_bwd_geores" + MODE_SUFFIX[pieces]] += 1
    dR = (gRo + gRd.sum((0, 1))).transpose(1, 2).reshape(Ap, 3)
    return _with_gfw((dx, dmu, dR), gFWp)


def _geo_edge_major(geo, B: int):
    """(rbf_aug [.., B+1], dirs [.., 3]) per edge slot from the packed geo."""
    g = geo.movedim(2, -1)
    return g[..., :B + 1], g[..., B + 1:B + 4]


def msg_fwd_geo_plain(x, mu, geo, FW_aug, refs: ColRefs, pieces: int = 3):
    """Plain twin of K6 (autograd-able in x, mu and FW_aug)."""
    rbf_aug, dirs = _geo_edge_major(geo, FW_aug.shape[0] - 1)
    return painn_message(x, mu, rbf_aug, dirs, FW_aug, refs, pieces)


def msg_bwd_geores_plain(x, mu, geo, FW_aug, cw, refs: ColRefs, rc: float,
                         g_dq, g_dmu, pieces: int = 3):
    """Plain twin of K7: (dx, dmu, dR, gFW).  The message VJP by autograd
    with the stored channels as constants, then the geometry chain from
    the stored channels with K7's formulas (``csrc/colblock_message_bwd.cu``
    header note), folded to both ends of every edge."""
    B = cw.shape[0]
    rbf_aug, dirs = _geo_edge_major(geo, B)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, mu, rbf_aug, dirs, FW_aug)]
        out = painn_message(*leaves[:4], leaves[4], refs, pieces)
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
    gradient) on CUDA, in the instances of ``pieces``; their twins on the
    CPU."""

    @staticmethod
    def forward(ctx, x, mu, R, geo, FW_aug, cw, refs, rc, pieces):
        if x.is_cuda:
            x, mu = feat(x, pieces), feat(mu, pieces)
        ctx.save_for_backward(x, mu, geo, FW_aug, cw)
        ctx.refs, ctx.rc, ctx.pieces = refs, rc, pieces
        if x.is_cuda:
            return msg_fwd_geo_kernel(x, mu, geo, FW_aug, refs, pieces)
        return msg_fwd_geo_plain(x, mu, geo, FW_aug, refs, pieces)

    @staticmethod
    def backward(ctx, g_dq, g_dmu):
        x, mu, geo, FW_aug, cw = ctx.saved_tensors
        wgrad = ctx.needs_input_grad[4]
        if x.is_cuda:
            dx, dmu, dR, *gFW = msg_bwd_geores_kernel(
                x, mu, geo, FW_aug, cw, ctx.refs, ctx.rc,
                *_bwd_feats(ctx, g_dq, g_dmu), wgrad, ctx.pieces)
        else:
            dx, dmu, dR, *gFW = msg_bwd_geores_plain(
                x, mu, geo, FW_aug, cw, ctx.refs, ctx.rc, g_dq.contiguous(),
                g_dmu.contiguous(), ctx.pieces)
        return (dx, dmu, dR, None, gFW[0] if wgrad else None, None, None,
                None, None)


def painn_message_columns_fm_geores(x, mu, R, geo, FW_aug, coff_fm, cw,
                                    refs: ColRefs, rc: float,
                                    pieces: int = 3):
    """PaiNN message over the column layout on the packed geo [nx, ny,
    B+5, Ktot] of ``R`` (``colblock_geo.column_geometry_packed(...,
    with_d=True)`` under ``torch.no_grad()``), with the geo-resident
    backward (signature of ``schnetpack_tpu.ops.colblock.
    painn_message_columns_fm_geores``; ``coff_fm`` is not read; ``pieces``,
    the JAX package's ``PIECES``).  The position cotangent comes out of the
    backward only.  Returns dq [A', F], dmu [A', 3F]."""
    if geo.requires_grad:
        raise ValueError(
            "geo must be computed under torch.no_grad(): the message "
            "backward returns dR itself, a graph through geo would count "
            "the forces twice")
    return PaiNNMessageGeoRes.apply(x, mu, R, geo, FW_aug, cw, refs,
                                    float(rc), check_pieces(pieces))


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
    dx = torch.empty_like(x)
    dmu = torch.empty_like(mu)
    if not _tuned_bwd(BWD_SRC, wgrad, F, B):
        G = gen_groups(geo.device, refs.P, nx * ny, True, BWD_SRC, wgrad, F,
                       B)
        ggeo = geo.new_zeros((gen_tiles(F), *geo.shape))
        gFW = bwd_gen(BWD_SRC, 3, x, mu, FW_aug, *source_schedule(refs, G),
                      G, g_dq, g_dmu, dx, dmu, nx * ny,
                      (nx, ny, refs.P, Ktot), F, B, 3 * F, wgrad, rbf=geo,
                      nch=B + 4, qcol=refs.qcol, dcol=refs.dcol,
                      koffs=refs.koffs_arg, grbf=ggeo)
        LAUNCHES[gen_name("msg_bwd_src")] += 1
        return with_gen_gfw((dx, dmu, ggeo.sum(0)), gFW)
    esorted, grp, G = _bwd_schedule(refs, nx * ny, BWD_SRC, wgrad, F, B)
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
