"""Scatter-free neighbor gather over a symmetric dense neighbor list (port
of ``schnetpack_tpu/ops/neighbor_gather.py``).

The VJP of ``x[nbh]`` is a scatter-add.  In a full (two-way) neighbor
list every edge (i -> j) has its reverse (j -> i), so the cotangent

    dx[j] = sum over the slots (i, k) with nbh[i, k] == j of g[i, k]

is a gather over the reverse-edge map:

    dx[j] = sum_k mask[j, k] * g_flat[rev_flat[j, k]]

where ``rev_flat[j, k]`` is the flat slot index (i * K + k') of the
reverse of j's k-th edge.  Forward and backward are then gathers and sums
over the K axis, in plain PyTorch.  ``build_reverse_map`` makes
``rev_flat`` on the host when the list is built.
"""
from __future__ import annotations

import numpy as np
import torch


class NeighborGather(torch.autograd.Function):
    """y[a, k, ...] = x[nbh[a, k], ...]; its VJP gathers through
    ``rev_flat`` (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, nbh, rev_flat, mask):
        ctx.save_for_backward(rev_flat, mask)
        return x[nbh]

    @staticmethod
    def backward(ctx, g):
        # index_select, not g[rev]: a force loss differentiates this
        # backward again, and the VJP of g[rev] is the sort-based
        # accumulating index_put_ (40.3 of a dense train step's 57.0 device
        # ms, NVIDIA H100 80GB HBM3, 700 W; PERF.md), that of
        # index_select index_add_
        rev_flat, mask = ctx.saved_tensors
        A, K = rev_flat.shape
        picked = g.reshape((A * K,) + g.shape[2:]).index_select(
            0, rev_flat.reshape(-1))
        picked = picked.reshape((A, K) + g.shape[2:])
        m = mask.to(g.dtype).reshape((A, K) + (1,) * (g.ndim - 2))
        return (picked * m).sum(1), None, None, None


def neighbor_gather(x: torch.Tensor, nbh: torch.Tensor,
                    rev_flat: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``x[nbh]`` [A, K, ...] for x [A, ...], nbh [A, K]; ``rev_flat`` [A, K]
    is each slot's reverse slot (``build_reverse_map``) and ``mask`` [A, K]
    is 1 on real edges."""
    return NeighborGather.apply(x, nbh, rev_flat, mask)


def build_reverse_map(idx_i: np.ndarray, idx_j: np.ndarray,
                      offsets: np.ndarray, slots: np.ndarray,
                      n_atoms: int, n_neighbors: int) -> np.ndarray:
    """Host reverse-edge map of a full (symmetric) pair list.

    The arguments describe the real edges: center ``idx_i``, neighbor
    ``idx_j``, Cartesian ``offsets`` and each edge's dense slot.  Returns
    rev_flat [A, K] int32; padded slots point to slot 0 (their mask is 0,
    so nothing reaches them).  Raises ``ValueError`` where some edge has
    no reverse."""
    E = len(idx_i)
    rev_flat = np.zeros((n_atoms, n_neighbors), dtype=np.int32)
    if E == 0:
        return rev_flat
    off_q = np.round(np.asarray(offsets, np.float64), 5)
    key_self = np.stack(
        [idx_i, idx_j, off_q[:, 0], off_q[:, 1], off_q[:, 2]], axis=1)
    key_rev = np.stack(
        [idx_j, idx_i, -off_q[:, 0], -off_q[:, 1], -off_q[:, 2]], axis=1)
    order_self = np.lexsort(key_self.T[::-1])
    order_rev = np.lexsort(key_rev.T[::-1])
    if not np.allclose(key_self[order_self], key_rev[order_rev]):
        raise ValueError("pair list is not symmetric; cannot build reverse "
                         "map")
    rev = np.empty(E, dtype=np.int64)
    rev[order_rev] = order_self     # key_self[rev[e]] == key_rev[e]
    dense_pos = idx_i.astype(np.int64) * n_neighbors + slots
    rev_flat[idx_i, slots] = dense_pos[rev].astype(np.int32)
    return rev_flat
