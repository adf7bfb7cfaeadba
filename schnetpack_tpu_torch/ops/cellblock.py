"""Column-bucketed neighbor layout, built on the host (numpy).

Port of ``ColumnLayout`` / ``build_column_layout`` from
``schnetpack_tpu/ops/cellblock.py:454-763`` with the same rules, so the
dims, the column capacity P and the bucket sizes come out identical:

* atoms are binned into an xy grid of columns no narrower than the build
  cutoff, sorted by (column, z) and padded to a per-column capacity P
  (multiple of 8);
* every edge goes to its destination column and the bucket
  c9 = (dx+1)*3 + (dy+1) of its source-column offset; buckets are ragged
  (capacity ``ksizes[c9]``, multiple of 8) and packed along one edge axis
  of length Ktot, bucket c9 at rows [koffs[c9], koffs[c9] + ksizes[c9]);
* within a bucket edges keep the order the neighbor list emits them in
  (stable sort), and every edge carries its Cartesian periodic offset.

The xy-grid autotune still charges the column depth P in multiples of 128
(the TPU's matrix-unit depth).  The Hopper kernels have no such quantum;
re-deriving the cost model for them is queued in ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..transform.neighborlist import cell_list_neighbor_list


class CapacityError(ValueError):
    """Sticky layout capacities (column/bucket) no longer fit."""


class ColumnLayout:
    """Column-bucketed edge layout (numpy arrays).

    Attributes (A' = nx*ny*P padded atom slots, A = real atoms):
        dims: (nx, ny, P, ksizes: tuple of 9 ints)
        order: [A'] original atom index per sorted slot (0 for pads)
        rank: [A] sorted slot of each original atom (slot = col*P + row)
        slot_mask: [A'] 1.0 for real atoms
        qcol / dcol: [nx, ny, Ktot] int32 in-column row of the source /
            destination (-1 pad)
        icol / jcol: [nx, ny, Ktot] int32 global sorted indices (0 pad)
        offcol: [nx, ny, Ktot, 3] Cartesian periodic offsets
        emask: [nx, ny, Ktot] float32 1.0 for real edges
    """

    __slots__ = ("dims", "order", "rank", "slot_mask", "qcol", "dcol",
                 "icol", "jcol", "offcol", "emask")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @property
    def ksizes(self):
        return self.dims[3]


def _pad8(v) -> int:
    return int(-(-int(v) // 8) * 8)


def _grid_dims(R, cutoff, cell, pbc):
    """Finest admissible grid + fractional transform (n [3], origin,
    basis, periodic [3]); every cell is at least ``cutoff`` high."""
    pbc = np.zeros(3, bool) if pbc is None else np.asarray(pbc, bool)
    if cell is None or not np.abs(cell).sum() > 0:
        cell = np.eye(3)
        pbc = np.zeros(3, bool)
    cell = np.asarray(cell, np.float64)
    if pbc.any():
        basis = cell.copy()
        heights = 1.0 / np.linalg.norm(np.linalg.inv(basis), axis=1)
    else:
        basis = np.eye(3)
        heights = np.zeros(3)
    origin = np.zeros(3)
    lo = R.min(axis=0) - 1e-6
    hi = R.max(axis=0) + 1e-6
    n = np.ones(3, np.int64)
    for k in range(3):
        if pbc[k]:
            n[k] = max(1, int(np.floor(heights[k] / cutoff)))
        else:
            extent = max(hi[k] - lo[k], 1e-3)
            n[k] = max(1, int(np.floor(extent / cutoff)))
            basis[k] = 0.0
            basis[k, k] = extent
            origin[k] = lo[k]
    return n, origin, basis, pbc


def _grid_stats(n, frac, wrap, ii, jj, S, capacity_headroom):
    """(P, ksizes, Ktot) of an xy grid, or None if the 9-column stencil
    does not hold every edge."""
    nx, ny = int(n[0]), int(n[1])
    bins = np.minimum((frac[:, :2] * [nx, ny]).astype(np.int64),
                      [nx - 1, ny - 1])
    bins_raw = bins + wrap[:, :2].astype(np.int64) * [nx, ny]
    col_id = bins[:, 0] * ny + bins[:, 1]
    occ = np.bincount(col_id, minlength=nx * ny)
    P = _pad8(int(occ.max(initial=1)) + capacity_headroom)
    d2 = bins_raw[jj] + S[:, :2] * [nx, ny] - bins_raw[ii]
    for k in range(2):
        if n[k] >= 3:
            if len(ii) and np.abs(d2[:, k]).max() > 1:
                return None
        else:
            d2[:, k] = np.mod(d2[:, k], n[k])
    c9 = (d2[:, 0] + 1) * 3 + (d2[:, 1] + 1)
    bcnt = np.bincount(col_id[ii] * 9 + c9,
                       minlength=nx * ny * 9).reshape(-1, 9)
    ks = tuple(_pad8(max(int(bcnt[:, b].max(initial=0)), 1))
               for b in range(9))
    return P, ks, int(sum(ks))


def _autotune_grid(n_max, frac, wrap, ii, jj, S, capacity_headroom,
                   min_grid=1):
    """Pick the square-ish xy grid minimising the padded kernel cost
    ``columns * Ktot * P_eff + 50 * columns * P`` (P_eff = P rounded up
    to 128), scanning from the finest grid down until the cost has not
    improved for four candidates.  ``min_grid`` asks for nx, ny >= 3
    (an alias-free stencil) where the box admits it."""
    lo = min_grid if n_max[0] >= min_grid and n_max[1] >= min_grid else 1
    best = None
    for floor_g in dict.fromkeys((lo, 1)):
        best_cost = None
        stale = 0
        for g in range(int(max(n_max[0], n_max[1])), 0, -1):
            cand = np.minimum(n_max, [g, g, 1])
            if cand[0] < floor_g or cand[1] < floor_g:
                continue
            st = _grid_stats(cand, frac, wrap, ii, jj, S, capacity_headroom)
            if st is None:
                continue
            P_c, _, Ktot_c = st
            ncol = int(cand[0]) * int(cand[1])
            cost = ncol * Ktot_c * (-(-P_c // 128) * 128) + 50 * ncol * P_c
            if best_cost is None or cost < best_cost * 0.98:
                best, best_cost = cand, cost
                stale = 0
            else:
                stale += 1
                if stale >= 4:
                    break
            if ncol == 1:
                break
        if best is not None:
            break
    return best


def build_column_layout(
    R: np.ndarray,
    cutoff: float,
    cell: Optional[np.ndarray] = None,
    pbc: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    bucket_size: Optional[Tuple[int, ...]] = None,
    capacity_headroom: int = 1,
    dims: Optional[Tuple[int, int, int]] = None,
    edges: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    min_grid: int = 1,
) -> ColumnLayout:
    """Bin atoms into xy columns and bucket edges by (destination column,
    c9).  ``capacity`` pins P and ``bucket_size`` the 9 bucket sizes
    (CapacityError when they no longer fit); ``dims`` pins the grid;
    ``edges`` supplies a precomputed (idx_i, idx_j, S) list for the build
    cutoff."""
    R = np.asarray(R, np.float64)
    A = len(R)
    n_max, origin, basis, pbc_arr = _grid_dims(R, cutoff, cell, pbc)
    frac_raw = (R - origin) @ np.linalg.inv(basis)
    wrap = np.where(pbc_arr, np.floor(frac_raw), 0.0)
    frac = np.where(pbc_arr, frac_raw - wrap,
                    np.clip(frac_raw, 0.0, 1.0 - 1e-9))

    if edges is None:
        use_cell = cell if (pbc_arr.any() and cell is not None) else None
        ii, jj, S = cell_list_neighbor_list(
            R, cutoff, use_cell, pbc_arr if pbc_arr.any() else None)
    else:
        ii, jj, S = edges
    S = np.asarray(S, np.int64)
    if cell is not None and np.abs(np.asarray(cell)).sum() > 0:
        off = S.astype(np.float64) @ np.asarray(cell, np.float64)
    else:
        off = np.zeros((len(ii), 3))

    if dims is not None:
        n = np.asarray(dims, np.int64)
    else:
        n = _autotune_grid(n_max, frac, wrap, ii, jj, S, capacity_headroom,
                           min_grid)
    n = np.array([int(n[0]), int(n[1]), 1], np.int64)
    nx, ny = int(n[0]), int(n[1])

    bins = np.minimum((frac * n).astype(np.int64), n - 1)
    bins_raw = bins + wrap.astype(np.int64) * n
    col_id = bins[:, 0] * ny + bins[:, 1]
    n_cols = nx * ny

    counts = np.bincount(col_id, minlength=n_cols)
    P = _pad8(int(counts.max(initial=1)) + capacity_headroom)
    if capacity is not None:
        if capacity < counts.max(initial=1):
            raise CapacityError(
                f"column capacity {capacity} < max occupancy {counts.max()}")
        P = capacity

    # sort atoms by (column, z)
    order_real = np.lexsort((frac[:, 2], col_id))
    starts = np.zeros(n_cols + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(A) - starts[col_id[order_real]]
    rank = np.empty(A, np.int64)
    rank[order_real] = col_id[order_real] * P + slot
    Ap = n_cols * P
    order = np.zeros(Ap, np.int64)
    slot_mask = np.zeros(Ap, np.float32)
    order[rank] = np.arange(A)
    slot_mask[rank] = 1.0

    d_bins = bins_raw[jj] + S * n[None, :] - bins_raw[ii]
    for k in range(2):
        if n[k] >= 3:
            if len(ii) and np.abs(d_bins[:, k]).max() > 1:
                raise ValueError(
                    "neighbor outside the 9-column stencil: xy cell edge < "
                    f"build cutoff (axis {k})")
        else:
            d_bins[:, k] = np.mod(d_bins[:, k], n[k])

    r_i = rank[ii]
    c9 = (d_bins[:, 0] + 1) * 3 + (d_bins[:, 1] + 1)
    src = rank[jj] % P
    dst = r_i % P
    bucket = (r_i // P) * 9 + c9
    n_buckets = n_cols * 9
    bcnt = np.bincount(bucket, minlength=n_buckets).reshape(n_cols, 9)
    ksizes = tuple(_pad8(max(int(bcnt[:, b].max(initial=0)), 1))
                   for b in range(9))
    if bucket_size is not None:
        want = tuple(int(w) for w in bucket_size)
        if any(w < int(bcnt[:, b].max(initial=0))
               for b, w in enumerate(want)):
            raise CapacityError(
                f"bucket sizes {want} < max occupancies "
                f"{tuple(int(v) for v in bcnt.max(axis=0))}")
        ksizes = want
    koffs = np.concatenate([[0], np.cumsum(ksizes)])
    Ktot = int(koffs[-1])

    e_order = np.argsort(bucket, kind="stable")
    b_s = bucket[e_order]
    b_starts = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(bcnt.reshape(-1), out=b_starts[1:])
    k_slot = np.arange(len(b_s)) - b_starts[b_s]
    row = (b_s // 9) * Ktot + koffs[b_s % 9] + k_slot

    qcol = np.full(n_cols * Ktot, -1, np.int32)
    dcol = np.full(n_cols * Ktot, -1, np.int32)
    icol = np.zeros(n_cols * Ktot, np.int32)
    jcol = np.zeros(n_cols * Ktot, np.int32)
    offcol = np.zeros((n_cols * Ktot, 3), np.float64)
    emask = np.zeros(n_cols * Ktot, np.float32)
    qcol[row] = src[e_order]
    dcol[row] = dst[e_order]
    icol[row] = r_i[e_order]
    jcol[row] = rank[jj][e_order]
    offcol[row] = off[e_order]
    emask[row] = 1.0

    shp = (nx, ny, Ktot)
    return ColumnLayout(
        dims=(nx, ny, P, ksizes),
        order=order.astype(np.int32),
        rank=rank.astype(np.int32),
        slot_mask=slot_mask,
        qcol=qcol.reshape(shp),
        dcol=dcol.reshape(shp),
        icol=icol.reshape(shp),
        jcol=jcol.reshape(shp),
        offcol=offcol.reshape(shp + (3,)),
        emask=emask.reshape(shp),
    )
