"""The reduced-precision feature mode of the PaiNN column message.

Port of the JAX package's ``precision`` option (``ops/cellblock.py:66-78``
``PIECES``, ``ops/cellblock_pallas.py:37-46`` ``_split_f32``,
``ops/colblock_pallas.py:36-41`` ``_w_precision``).  There the mode is a
process global that every Pallas selection reads; here it is an argument,
``pieces``, of the message ops and of ``PaiNN``:

* ``pieces = 3`` ("f32"): everything exact in f32;
* ``pieces = 2`` ("mixed"): the source features x and mu, the destination
  cotangents, each edge's message and each edge's source cotangents are
  rounded to the sum of two bf16 terms (a 16-bit significand);
* ``pieces = 1`` ("bf16"): the same values rounded to bf16, and the
  filter's two cotangent products, grbf = gW FW_aug^T and gFW = rbf_aug^T
  gW, take bf16 operands with f32 sums (the TPU's ``Precision.DEFAULT``):
  on the card one bf16 tensor-core product in place of 3xTF32.

The filter product rbf_aug @ FW_aug itself stays f32.  The JAX kernels
run it at ``Precision.DEFAULT`` too, which the JAX package takes for bf16
operands on the TPU; with them the trained PaiNN-128x3's forces on the
bench box missed f32 by 0.130 of max |F| (a filter that is a small sum of
large terms), against 0.029 with the forward filter in f32, and on the
card the forward filter runs on f32 FMAs either way (PERF.md, section 6).
Positions, the per-edge geometry and the position cotangents stay exact
f32 in every mode (``colblock_geo.py:53``, ``colblock_pallas.py:1254``).

The JAX mode also rounds the positions themselves where they go through a
selection kernel: ``column_gather(R)`` / ``column_expand(R)`` of the
row-9 PaiNN path, SO3net and FieldSchNet on columns
(``atomistic/distances.py:48-49``), ``cell_gather(R)`` of the 27-cell
layout (``:58``) and the slab's halo gather.  At ``PIECES = 1`` that moves
the gathered positions by up to half a bf16 ulp of the coordinates
(0.062 A in a 20 A box).  The port runs the reduced modes only where the
JAX package keeps the geometry exact, PaiNN's ``full`` and ``hybrid``
column messages; the other blocked paths raise ``ReducedPrecisionPathError``.
"""
from __future__ import annotations

import torch

#: the calculators' ``precision`` names and their bf16 terms
PIECES = {"f32": 3, "mixed": 2, "bf16": 1}


#: the calculator layouts that run no kernel, where the mode changes
#: nothing
FLAT_LAYOUTS = ("all_pairs", "dense")


class ReducedPrecisionPathError(ValueError):
    """A reduced-precision mode on a path where the JAX package's mode
    rounds the positions (see the module's docstring)."""


def refuse(what: str, pieces: int) -> None:
    """Raise ``ReducedPrecisionPathError`` for ``what`` at ``pieces != 3``."""
    if pieces != 3:
        raise ReducedPrecisionPathError(
            f"{what} at pieces={pieces}: the JAX package's reduced-precision "
            "mode rounds the positions there (a selection kernel gathers "
            "them in PIECES bf16 terms, up to half a bf16 ulp of the "
            "coordinates), so the port runs it only with PaiNN's full and "
            "hybrid column messages (a no-op on the flat and dense layouts "
            "and for SchNet on 'cellblock'); use pieces=3")


def set_pieces(representation, pieces: int, layout: str) -> None:
    """Run ``representation`` at ``pieces`` on the calculator layout
    ``layout`` (a name of ``NEIGHBOR_LISTS``): a no-op on the flat and
    dense layouts; on the blocked ones the representation's own
    ``set_pieces`` (PaiNN, SchNet), else ``refuse``."""
    pieces = check_pieces(pieces)
    own = getattr(representation, "set_pieces", None)
    if layout in FLAT_LAYOUTS:
        return
    if own is None:
        refuse(f"{type(representation).__name__} on {layout!r}", pieces)
    else:
        own(pieces, layout)


def pieces_of(precision) -> int:
    """The bf16 terms of a calculator's ``precision`` (None: f32)."""
    if precision is None:
        return 3
    if precision not in PIECES:
        raise ValueError(f"precision must be None, 'f32', 'bf16' or "
                         f"'mixed', not {precision!r}")
    return PIECES[precision]


def check_pieces(pieces: int) -> int:
    if pieces not in (1, 2, 3):
        raise ValueError(f"pieces must be 1, 2 or 3, got {pieces!r}")
    return int(pieces)


def round_pieces(t: torch.Tensor, pieces: int) -> torch.Tensor:
    """The sum, in f32, of ``_split_f32``'s ``pieces`` bf16 terms of the
    float32 ``t`` (each term rounded to nearest even); ``t`` itself at 3,
    where the sum is exact."""
    if pieces >= 3:
        return t
    rest, total = t, None
    for k in range(pieces):
        p = rest.to(torch.bfloat16).to(t.dtype)
        total = p if total is None else total + p
        if k + 1 < pieces:
            rest = rest - p
    return total


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pieces):
        ctx.pieces = pieces
        return round_pieces(t, pieces)

    @staticmethod
    def backward(ctx, g):
        return round_pieces(g, ctx.pieces), None


def round_both(t: torch.Tensor, pieces: int) -> torch.Tensor:
    """``round_pieces`` of ``t`` whose backward rounds the cotangent the
    same way: the points where the TPU kernels split a per-edge value
    before a one-hot sum, in both directions."""
    return t if pieces >= 3 else _RoundBoth.apply(t, pieces)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _FilterBf16(torch.autograd.Function):
    """rbf_aug @ FW_aug in f32 whose VJP's products take bf16 operands with
    f32 sums: grbf = bf16(g) bf16(FW)^T, gFW = bf16(rbf)^T bf16(g)."""

    @staticmethod
    def forward(ctx, rbf_aug, FW_aug):
        ctx.save_for_backward(_bf16(rbf_aug), _bf16(FW_aug))
        return rbf_aug @ FW_aug

    @staticmethod
    def backward(ctx, g):
        rb, fw = ctx.saved_tensors
        gb = _bf16(g)
        grbf = gb @ fw.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gFW = None
        if ctx.needs_input_grad[1]:
            gFW = (rb.reshape(-1, rb.shape[-1]).transpose(0, 1)
                   @ gb.reshape(-1, gb.shape[-1]))
        return grbf, gFW


def filter_product(rbf_aug: torch.Tensor, FW_aug: torch.Tensor,
                   pieces: int) -> torch.Tensor:
    """The per-edge filter rbf_aug [..., B+1] @ FW_aug [B+1, 3F], its
    cotangent products in the precision of ``pieces`` (bf16 operands at
    one piece, ``_w_precision``'s ``Precision.DEFAULT``)."""
    if pieces == 1:
        return _FilterBf16.apply(rbf_aug, FW_aug)
    return rbf_aug @ FW_aug
