"""Blocked neighbor layouts, built on the host (numpy).

Port of ``schnetpack_tpu/ops/cellblock.py`` with the same rules, so every
array comes out identical to the JAX package's on the same inputs:

* ``build_column_layout`` / ``ColumnLayout`` (``cellblock.py:454-763``):
  atoms are binned into an xy grid of columns no narrower than the build
  cutoff, sorted by (column, z) and padded to a per-column capacity P
  (multiple of 8); every edge goes to its destination column and the
  bucket c9 = (dx+1)*3 + (dy+1) of its source-column offset; buckets are
  ragged (capacity ``ksizes[c9]``, multiple of 8) and packed along one
  edge axis of length Ktot, bucket c9 at rows [koffs[c9], koffs[c9] +
  ksizes[c9]); within a bucket edges keep the order the neighbor list
  emits them in (stable sort), and every edge carries its Cartesian
  periodic offset.
* ``build_cell_layout`` / ``CellLayout`` (``cellblock.py:202-451``), the
  27-cell atom layout: atoms are binned into a 3-d grid of cells no
  thinner than the build cutoff, sorted by cell id (stable) and padded to
  a per-cell capacity C (multiple of 8); atom i's k-th neighbor is
  encoded as the candidate index q = o*C + s_j of its source among the 27
  neighbor cells (``OFFSETS``), -1 for padding, with K (the slots per
  atom) rounded up to a multiple of ``K_MULTIPLE`` (the reference's
  default ``k_multiple``).

The xy-grid autotune of the column layout still charges the column depth
P in multiples of 128 (the TPU's matrix-unit depth), and the cell grid's
autotune the TPU's selection cost n_cells * C^2.  The Hopper kernels have
no such quantum; re-deriving the cost models for them is queued in
ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..transform.neighborlist import cell_list_neighbor_list


#: the 27 neighbor-cell offsets, o = ((dx+1)*3 + (dy+1))*3 + (dz+1)
#: (``schnetpack_tpu/ops/cellblock.py:52-55``)
OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)
#: the 27-cell layout's K (slots per atom) is a multiple of this
K_MULTIPLE = 2


class CapacityError(ValueError):
    """Sticky layout capacities (cell/column/bucket) no longer fit."""


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


class CellLayout:
    """27-cell atom layout (numpy arrays).

    Attributes (A' = nx*ny*nz*C padded atom slots, A = real atoms):
        dims: (nx, ny, nz, C, K)
        order: [A'] original atom index per sorted slot (0 for pads)
        rank: [A] sorted slot of each original atom (slot = cell*C + s)
        slot_mask: [A'] 1.0 for real atoms
        qidx: [nx, ny, nz, C, K] int32 candidate index o*C + s_j (-1 pad)
        nbh_idx: [A', K] int32 sorted-space neighbor index (0 pad)
        nbh_mask: [A', K] float32 1.0 for real edges
        nbh_offsets: [A', K, 3] Cartesian periodic offsets
    """

    __slots__ = ("dims", "order", "rank", "slot_mask", "qidx", "nbh_idx",
                 "nbh_mask", "nbh_offsets")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


def _autotune_cell_grid(R, origin, basis, pbc_arr, n_max):
    """Pick the cell grid minimising ``n_cells * C^2`` among the finest
    admissible grid ``n_max`` and four coarser ones (each axis divided by
    1.2 ... 1.9); a coarser grid must win by 5%."""
    frac = (R - origin) @ np.linalg.inv(basis)
    frac = np.where(pbc_arr, frac - np.floor(frac),
                    np.clip(frac, 0.0, 1.0 - 1e-9))
    best, best_cost = n_max, None
    for g in (1.0, 1.2, 1.4, 1.6, 1.9):
        n = np.maximum(1, (n_max / g).astype(np.int64))
        bins = np.minimum((frac * n).astype(np.int64), n - 1)
        cid = (bins[:, 0] * n[1] + bins[:, 1]) * n[2] + bins[:, 2]
        C = _pad8(int(np.bincount(cid).max(initial=1)) + 1)
        cost = float(np.prod(n)) * C * C
        if best_cost is None or cost < best_cost * 0.95:
            best, best_cost = n, cost
    return best


def build_cell_layout(
    R: np.ndarray,
    cutoff: float,
    cell: Optional[np.ndarray] = None,
    pbc: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    n_neighbors: Optional[int] = None,
    capacity_headroom: int = 1,
    dims: Optional[Tuple[int, int, int]] = None,
) -> CellLayout:
    """Bin atoms into cells, sort them cell-major and encode the neighbor
    list as candidate indices into the 27 surrounding cells.

    ``cutoff`` is the build cutoff (model cutoff + skin).  ``capacity``
    pins C (CapacityError when the occupancy exceeds it), ``n_neighbors``
    pins K (a plain ValueError when the degree exceeds it, as in the
    reference), ``dims`` pins the grid."""
    R = np.asarray(R, np.float64)
    A = len(R)
    n, origin, basis, pbc_arr = _grid_dims(R, cutoff, cell, pbc)
    if dims is not None:
        n = np.asarray(dims, np.int64)
    else:
        n = _autotune_cell_grid(R, origin, basis, pbc_arr, n)
    nx, ny, nz = (int(v) for v in n)

    frac_raw = (R - origin) @ np.linalg.inv(basis)
    wrap = np.where(pbc_arr, np.floor(frac_raw), 0.0)
    frac = np.where(pbc_arr, frac_raw - wrap,
                    np.clip(frac_raw, 0.0, 1.0 - 1e-9))
    bins = np.minimum((frac * n).astype(np.int64), n - 1)
    # unwrapped bins: the pair list's S is relative to the raw positions
    bins_raw = bins + wrap.astype(np.int64) * n
    cell_id = (bins[:, 0] * ny + bins[:, 1]) * nz + bins[:, 2]
    n_cells = nx * ny * nz

    counts = np.bincount(cell_id, minlength=n_cells)
    C = _pad8(int(counts.max(initial=1)) + capacity_headroom)
    if capacity is not None:
        if capacity < counts.max(initial=1):
            raise CapacityError(
                f"cell capacity {capacity} < max occupancy {counts.max()}")
        C = capacity

    order_real = np.argsort(cell_id, kind="stable")
    starts = np.zeros(n_cells + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(A) - starts[cell_id[order_real]]
    rank = np.empty(A, np.int64)
    rank[order_real] = cell_id[order_real] * C + slot
    Ap = n_cells * C
    order = np.zeros(Ap, np.int64)
    slot_mask = np.zeros(Ap, np.float32)
    order[rank] = np.arange(A)
    slot_mask[rank] = 1.0

    use_cell = cell if (pbc_arr.any() and cell is not None) else None
    ii, jj, S = cell_list_neighbor_list(
        R, cutoff, use_cell, pbc_arr if pbc_arr.any() else None)
    S = np.asarray(S, np.int64)
    if cell is not None and np.abs(np.asarray(cell)).sum() > 0:
        off = S.astype(np.float64) @ np.asarray(cell, np.float64)
    else:
        off = np.zeros((len(ii), 3))

    # offset in cells of j's image from i: in {-1, 0, 1} on axes of >= 3
    # cells; on tiny periodic grids (n_k <= 2) offsets alias modulo n_k
    # and any representative naming the same cell gathers the same rows
    # (the Cartesian offset is carried per edge)
    d_bins = bins_raw[jj] + S * n[None, :] - bins_raw[ii]
    for k in range(3):
        if n[k] >= 3:
            if len(ii) and np.abs(d_bins[:, k]).max() > 1:
                raise ValueError(
                    "neighbor outside the 27-cell stencil: cell edge < build "
                    f"cutoff (axis {k}, max bin delta "
                    f"{np.abs(d_bins[:, k]).max()})")
        else:
            d_bins[:, k] = np.mod(d_bins[:, k], n[k])
    o_index = ((d_bins[:, 0] + 1) * 3 + (d_bins[:, 1] + 1)) * 3 + (
        d_bins[:, 2] + 1)
    q = o_index * C + rank[jj] % C

    i_sorted = rank[ii]
    cnt_i = np.bincount(i_sorted, minlength=Ap)
    max_k = int(cnt_i.max(initial=1))
    K = int(-(-max_k // K_MULTIPLE) * K_MULTIPLE)
    if n_neighbors is not None:
        if n_neighbors < max_k:
            raise ValueError(f"n_neighbors {n_neighbors} < max degree {max_k}")
        K = n_neighbors

    edge_order = np.argsort(i_sorted, kind="stable")
    i_s = i_sorted[edge_order]
    e_starts = np.zeros(Ap + 1, np.int64)
    np.cumsum(cnt_i, out=e_starts[1:])
    k_slot = np.arange(len(i_s)) - e_starts[i_s]

    qidx = np.full((Ap, K), -1, np.int32)
    nbh_idx = np.zeros((Ap, K), np.int32)
    nbh_mask = np.zeros((Ap, K), np.float32)
    nbh_offsets = np.zeros((Ap, K, 3), np.float64)
    qidx[i_s, k_slot] = q[edge_order]
    nbh_idx[i_s, k_slot] = rank[jj][edge_order]
    nbh_mask[i_s, k_slot] = 1.0
    nbh_offsets[i_s, k_slot] = off[edge_order]
    return CellLayout(
        dims=(nx, ny, nz, C, K),
        order=order.astype(np.int32),
        rank=rank.astype(np.int32),
        slot_mask=slot_mask,
        qidx=qidx.reshape(nx, ny, nz, C, K),
        nbh_idx=nbh_idx,
        nbh_mask=nbh_mask,
        nbh_offsets=nbh_offsets,
    )
