"""Segment aggregation over the flat pair list (port of
``schnetpack_tpu/ops/scatter.py``).

The reference's one aggregation primitive is a scatter-add over padded
index arrays.  Padded entries carry an index out of [0, num_segments)
(``num_segments`` itself by convention) or are zeroed by a mask first;
the sums drop out-of-range indices, as XLA's scatter does.

On CUDA tensors ``index_add_`` runs with float atomics, so the order of a
segment's f32 additions, and with it the last bits of the sum, can change
from one call to the next; on the CPU it is sequential.  The flat layout
launches no kernel of this package: these are plain PyTorch.

A pair list split over a mesh of ranks (``parallel/spatial.py``) crosses
between the replicated atom tables and the rank's share of the pairs in
two places, each an autograd function: ``enter_pairs`` (an atom table
taken onto the rank's pairs: identity forward, the cotangent summed over
the ranks backward) and ``leave_pairs`` (per-atom sums of the rank's
pairs: summed over the ranks forward, identity backward); each is the
other's backward.  Every replicated tensor then holds its true cotangent
on every rank.  ``pair_take`` and ``pair_sum`` are ``take`` and
``segment_sum`` through them, for every module that reads the pair list
itself (ZBL, Coulomb, Ewald's real-space sum, ``Strain``).
"""
from __future__ import annotations

from typing import Optional

import torch

#: up to this many segments (per-molecule sums), a float input of ndim <= 2
#: has its non-finite elements zeroed first (``scatter.py:52-62``)
FEW_SEGMENTS = 128


def _in_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every index outside [0, n) sent to n, the spare row."""
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index: a negative index counts from the end once, and
    the rest is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def segment_sum(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
                indices_are_sorted: bool = True) -> torch.Tensor:
    """Sum the rows of ``x`` [N, ...] into ``num_segments`` buckets given by
    ``idx`` [N]; out-of-range indices are dropped.

    For at most ``FEW_SEGMENTS`` segments and a float ``x`` of ndim <= 2,
    the reference sums with a one-hot product, where a non-finite padding
    row would reach every segment (0 * inf = nan); it zeroes non-finite
    elements first, and so does this.  Above that, the sum keeps exact
    scatter semantics.  ``indices_are_sorted`` is the reference's hint
    to XLA; it changes nothing here."""
    del indices_are_sorted
    if num_segments <= FEW_SEGMENTS and x.ndim <= 2 and x.is_floating_point():
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    out = x.new_zeros((num_segments + 1,) + x.shape[1:])
    return out.index_add(0, _in_range(idx, num_segments), x)[:num_segments]


def segment_mean(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
                 indices_are_sorted: bool = True,
                 min_count: float = 1.0) -> torch.Tensor:
    """Mean per segment; an empty segment gives zero."""
    total = segment_sum(x, idx, num_segments)
    count = segment_sum(x.new_ones(x.shape[:1]), idx, num_segments)
    count = count.clamp(min=min_count)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))


def segment_softmax(logits: torch.Tensor, idx: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None,
                    indices_are_sorted: bool = True) -> torch.Tensor:
    """Softmax within segments, shifted by each segment's max; entries
    with ``mask`` 0 get weight 0."""
    if mask is not None:
        logits = torch.where(mask > 0, logits,
                             torch.full_like(logits, -torch.inf))
    seg_max = logits.new_full((num_segments + 1,) + logits.shape[1:],
                              -torch.inf)
    ind = _in_range(idx, num_segments).long()
    ind = ind.reshape(ind.shape + (1,) * (logits.ndim - 1)).expand_as(logits)
    seg_max = seg_max.scatter_reduce(0, ind, logits, "amax",
                                     include_self=True)[:num_segments]
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    at = _clamped(idx, num_segments)
    shifted = logits - seg_max[at]
    exp = torch.where(torch.isfinite(shifted), torch.exp(shifted),
                      torch.zeros_like(shifted))
    denom = segment_sum(exp, idx, num_segments).clamp(min=1e-16)
    return exp / denom[at]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[idx]`` [*idx.shape, ...] for indices in range, by
    ``index_select``: its VJP is ``index_add_``, where that of ``x[idx]``
    is PyTorch's sort-based accumulating ``index_put_``, which took 10.9
    of the 37.0 device ms of a dense-layout PaiNN step at 10,976 atoms
    (NVIDIA H100 80GB HBM3, 700 W; PERF.md)."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` with ``jnp.take``'s fill mode: a negative
    index counts from the end, and an index out of range gives a NaN row
    (zeros for an integer ``x``)."""
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    ok = (wrapped >= 0) & (wrapped < n)
    rows = x[wrapped.clamp(0, max(n - 1, 0))]
    fill = torch.nan if x.is_floating_point() else 0
    ok = ok.reshape(ok.shape + (1,) * (x.ndim - 1))
    return torch.where(ok, rows, torch.full_like(rows, fill))


class _EnterPairs(torch.autograd.Function):
    """Identity forward; the cotangent summed over the mesh's ranks
    (``_LeavePairs``, so that a double backward keeps the ranks' terms)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _LeavePairs.apply(g, ctx.mesh), None


class _LeavePairs(torch.autograd.Function):
    """The sum over the mesh's ranks forward; identity backward (through
    ``_EnterPairs``, for a double backward)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return _EnterPairs.apply(g, ctx.mesh), None


def enter_pairs(x: torch.Tensor, mesh) -> torch.Tensor:
    """An atom table (equal on every rank) as the input of the rank's
    pairs (see the module's docstring); ``x`` where ``mesh`` is None."""
    return x if mesh is None else _EnterPairs.apply(x, mesh)


def leave_pairs(x: torch.Tensor, mesh) -> torch.Tensor:
    """Per-atom sums of the rank's pairs summed over the ranks; ``x`` where
    ``mesh`` is None."""
    return x if mesh is None else _LeavePairs.apply(x, mesh)


def pair_take(x: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """``take`` of an atom (or molecule) table onto the pairs, through
    ``enter_pairs``."""
    return take(enter_pairs(x, mesh), idx)


def pair_sum(x: torch.Tensor, idx: torch.Tensor, num_segments: int,
             mesh) -> torch.Tensor:
    """``segment_sum`` of per-pair values into atoms, through
    ``leave_pairs``."""
    return leave_pairs(segment_sum(x, idx, num_segments), mesh)
