"""Host neighbor lists (numpy).

``neighbor_list`` is the O(N^2) brute force of
``schnetpack_tpu/transform/neighborlist.py:39-91`` (a test oracle);
``cell_list_neighbor_list`` is the O(N) linked-cell list that the column
layout builder calls, vectorised over the 27 cell offsets.  Both return
``(idx_i, idx_j, S)`` with ``Rij = R[j] + S @ cell - R[i]`` and
``|Rij| < cutoff``, sorted by (i, j, S).
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _sorted(ii, jj, S) -> Edges:
    order = np.lexsort((S[:, 2], S[:, 1], S[:, 0], jj, ii))
    return (ii[order].astype(np.int64), jj[order].astype(np.int64),
            S[order].astype(np.int64))


def _empty() -> Edges:
    z = np.zeros(0, np.int64)
    return z, z, np.zeros((0, 3), np.int64)


def neighbor_list(positions: np.ndarray, cutoff: float,
                  cell: Optional[np.ndarray] = None,
                  pbc: Optional[np.ndarray] = None) -> Edges:
    """Brute-force full neighbor list over all periodic images in reach."""
    R = np.asarray(positions, np.float64)
    n = len(R)
    if n == 0:
        return _empty()
    if cell is None or pbc is None or not np.asarray(pbc).any():
        cell = np.eye(3)
        n_rep = np.zeros(3, np.int64)
    else:
        cell = np.asarray(cell, np.float64)
        heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
        n_rep = np.where(np.asarray(pbc, bool),
                         np.ceil(cutoff / heights).astype(np.int64), 0)
    out = []
    for s in itertools.product(*[range(-k, k + 1) for k in n_rep]):
        s = np.asarray(s, np.int64)
        diff = R[None, :, :] + s @ cell - R[:, None, :]
        d2 = np.einsum("ijk,ijk->ij", diff, diff)
        if not s.any():
            np.fill_diagonal(d2, np.inf)
        ii, jj = np.nonzero(d2 < cutoff * cutoff)
        out.append((ii, jj, np.broadcast_to(s, (len(ii), 3))))
    ii, jj, S = (np.concatenate(a) for a in zip(*out))
    return _sorted(ii, jj, S)


def cell_list_neighbor_list(positions: np.ndarray, cutoff: float,
                            cell: Optional[np.ndarray] = None,
                            pbc: Optional[np.ndarray] = None) -> Edges:
    """Linked-cell neighbor list, O(N) for a fixed density.

    Atoms are binned into cells no narrower than ``cutoff`` (periodic axes
    need at least 3 of them; smaller boxes use the brute force).  For each
    of the 27 cell offsets every atom of a cell is paired with every atom
    of the offset cell at once, on a [cells, C, C] block padded to the
    largest occupancy C.
    """
    R = np.asarray(positions, np.float64)
    n = len(R)
    if n == 0:
        return _empty()
    periodic = (cell is not None and pbc is not None
                and np.asarray(pbc).any())
    pbc_arr = np.asarray(pbc, bool) if periodic else np.zeros(3, bool)
    if periodic:
        basis = np.asarray(cell, np.float64)
        inv = np.linalg.inv(basis)
        heights = 1.0 / np.linalg.norm(inv, axis=0)
        frac = R @ inv
        if not pbc_arr.all():
            return neighbor_list(R, cutoff, cell, pbc)
        shift = np.floor(frac)
        frac = frac - shift
        Rw = R - shift @ basis
        ncell = np.floor(heights / cutoff).astype(np.int64)
        if (ncell < 3).any():
            return neighbor_list(R, cutoff, cell, pbc)
    else:
        lo = R.min(axis=0)
        extent = np.maximum(R.max(axis=0) - lo, 1e-3)
        frac = np.clip((R - lo) / extent, 0.0, 1.0 - 1e-12)
        shift = np.zeros_like(R)
        Rw = R
        basis = np.eye(3)
        ncell = np.maximum(1, np.floor(extent / cutoff)).astype(np.int64)
    bins = np.minimum((frac * ncell).astype(np.int64), ncell - 1)
    cid = (bins[:, 0] * ncell[1] + bins[:, 1]) * ncell[2] + bins[:, 2]
    n_cells = int(np.prod(ncell))
    counts = np.bincount(cid, minlength=n_cells)
    C = int(counts.max())
    order = np.argsort(cid, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - starts[cid[order]]
    table = np.full((n_cells, C), -1, np.int64)
    table[cid[order], slot] = order
    grid = np.stack(np.unravel_index(np.arange(n_cells), tuple(ncell)), 1)

    c2 = cutoff * cutoff
    out = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        nb = grid + np.asarray(off)
        img = np.floor_divide(nb, ncell)          # periodic image crossed
        if periodic:
            nb = nb - img * ncell
            ok = np.ones(n_cells, bool)
        else:
            ok = ((nb >= 0) & (nb < ncell)).all(axis=1)
            nb = np.clip(nb, 0, ncell - 1)
            img = np.zeros_like(img)
        nid = (nb[:, 0] * ncell[1] + nb[:, 1]) * ncell[2] + nb[:, 2]
        ai = table[ok]                            # [c, C]
        aj = table[nid[ok]]                       # [c, C]
        disp = (img[ok] @ basis)[:, None, None, :]
        diff = (Rw[aj][:, None, :, :] + disp) - Rw[ai][:, :, None, :]
        d2 = np.einsum("cijk,cijk->cij", diff, diff)
        valid = (ai[:, :, None] >= 0) & (aj[:, None, :] >= 0) & (d2 < c2)
        if not any(off):
            valid &= ai[:, :, None] != aj[:, None, :]
        c, a, b = np.nonzero(valid)
        i = ai[c, a]
        j = aj[c, b]
        # image shift of the unwrapped positions: R = Rw + shift @ basis
        S = img[ok][c] + shift[i] - shift[j]
        out.append((i, j, S))
    ii, jj, S = (np.concatenate(a) for a in zip(*out))
    return _sorted(ii, jj, np.rint(S).astype(np.int64))
