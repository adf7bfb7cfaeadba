"""Host neighbor lists (numpy) and the neighbor-list transforms of the
data pipeline (port of ``schnetpack_tpu/transform/neighborlist.py``).

``neighbor_list`` is the O(N^2) brute force of ``neighborlist.py:39-91``;
``cell_list_neighbor_list`` is the O(N) linked-cell list from which
``ops/cellblock.py`` builds the column layout: the native C++ list
(``native/cellist.py``, as ``neighborlist.py:94-107``), with the brute
force only for a periodic cell under 3 cutoffs high.  A failed build of
the native list raises ``NativeBuildError``; nothing falls back silently.
``cell_list_numpy`` is the same linked-cell list in numpy, vectorised over
the 27 cell offsets: the plain version the tests hold the native list to.
All return ``(idx_i, idx_j, S)`` with ``Rij = R[j] + S @ cell - R[i]`` and
``|Rij| < cutoff``, sorted by (i, j, S).

The transforms add ``_idx_i``, ``_idx_j`` and Cartesian ``_offsets`` to a
sample.  The ASE, matscipy and vesin backends use their library where it
is importable and else fall back as the JAX package does: ASE to the brute
force, matscipy and vesin to the cell list.
"""
from __future__ import annotations

import importlib
import itertools
import os
import shutil
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from .. import properties
from ..native import cellist
from .base import Transform

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray]

#: optional backends found missing: a failed import is not cached by
#: Python, and the data pipeline asks once per molecule
_MISSING = set()


def _optional(module: str, name: str):
    """``module.name``, or None where the module is not installed."""
    if module in _MISSING:
        return None
    try:
        return getattr(importlib.import_module(module), name)
    except ImportError:
        _MISSING.add(module)
        return None


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
    """Linked-cell neighbor list, O(N) for a fixed density: the native C++
    list, or the brute force for a periodic cell under 3 cutoffs high
    (``cellist.UnsupportedGeometry``)."""
    try:
        return cellist.neighbor_list(positions, cutoff, cell, pbc)
    except cellist.UnsupportedGeometry:
        return neighbor_list(positions, cutoff, cell, pbc)


def cell_list_numpy(positions: np.ndarray, cutoff: float,
                    cell: Optional[np.ndarray] = None,
                    pbc: Optional[np.ndarray] = None) -> Edges:
    """The linked-cell list in numpy (the native list's plain version).

    Atoms are binned into cells no narrower than ``cutoff`` (periodic axes
    need at least 3 of them; smaller boxes, and mixed periodicity, use the
    brute force).  For each of the 27 cell offsets every atom of a cell is
    paired with every atom of the offset cell at once, on a [cells, C, C]
    block padded to the largest occupancy C.
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


class NeighborListTransform(Transform):
    """Adds ``_idx_i``, ``_idx_j`` and Cartesian ``_offsets`` to a sample;
    with ``long_range_cutoff`` > 0 the full list goes to the ``_lr`` keys
    and the short one keeps the pairs within ``cutoff``
    (``neighborlist.py:110-152``)."""

    is_preprocessor = True

    def __init__(self, cutoff: float, long_range_cutoff: float = -1.0,
                 backend: str = "auto"):
        self.cutoff = float(cutoff)
        self.long_range_cutoff = float(long_range_cutoff)
        self.backend = backend
        if 0 < self.long_range_cutoff < self.cutoff:
            raise ValueError("long_range_cutoff must be >= cutoff")

    def _build(self, R, cutoff, cell, pbc) -> Edges:
        if self.backend == "brute":
            return neighbor_list(R, cutoff, cell, pbc)
        return cell_list_neighbor_list(R, cutoff, cell, pbc)

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        R = np.asarray(inputs[properties.R])
        cell = inputs.get(properties.cell)
        pbc = inputs.get(properties.pbc)
        idx_i, idx_j, S = self._build(
            R, max(self.cutoff, self.long_range_cutoff), cell, pbc)
        if cell is not None and np.asarray(pbc).any():
            offsets = S.astype(np.float64) @ np.asarray(cell, np.float64)
        else:
            offsets = np.zeros((len(idx_i), 3), dtype=np.float64)
        if self.long_range_cutoff > 0:
            short = np.linalg.norm(R[idx_j] + offsets - R[idx_i],
                                   axis=1) < self.cutoff
            inputs[properties.idx_i_lr] = idx_i
            inputs[properties.idx_j_lr] = idx_j
            inputs[properties.offsets_lr] = offsets
            idx_i, idx_j, offsets = idx_i[short], idx_j[short], offsets[short]
        inputs[properties.idx_i] = idx_i
        inputs[properties.idx_j] = idx_j
        inputs[properties.offsets] = offsets
        return inputs


class ASENeighborList(NeighborListTransform):
    """``ase.neighborlist`` when ase is importable, else the brute force."""

    def _build(self, R, cutoff, cell, pbc) -> Edges:
        primitive_neighbor_list = _optional("ase.neighborlist",
                                            "primitive_neighbor_list")
        if primitive_neighbor_list is None:
            return neighbor_list(R, cutoff, cell, pbc)
        c = np.zeros((3, 3)) if cell is None else np.asarray(cell)
        p = np.zeros(3, bool) if pbc is None else np.asarray(pbc, bool)
        if not p.any() and np.allclose(c, 0):
            c = np.eye(3) * (2 * cutoff + np.ptp(R, axis=0).max() + 1.0)
        i, j, S = primitive_neighbor_list("ijS", p, c, R, cutoff,
                                          self_interaction=False)
        return _sorted(i, j, S)


class MatScipyNeighborList(NeighborListTransform):
    """matscipy when it is importable, else the cell list."""

    def _build(self, R, cutoff, cell, pbc) -> Edges:
        neighbour_list = _optional("matscipy.neighbours", "neighbour_list")
        if neighbour_list is None:
            return cell_list_neighbor_list(R, cutoff, cell, pbc)
        p = np.zeros(3, bool) if pbc is None else np.asarray(pbc, bool)
        if cell is None or not p.any():
            c = np.diag(R.max(0) - R.min(0) + 2 * cutoff + 1.0)
        else:
            c = np.asarray(cell)
        i, j, S = neighbour_list("ijS", positions=R, cutoff=cutoff, cell=c,
                                 pbc=p)
        return _sorted(i, j, S)


#: the reference's device-tensor backend; here the cell list serves
TorchNeighborList = NeighborListTransform


class VesinNeighborList(NeighborListTransform):
    """vesin when it is importable, else the cell list; mixed periodicity,
    which vesin lacks, falls back to the cell list with one warning
    (``neighborlist.py:200-243``)."""

    _warned_fallback = False

    def _build(self, R, cutoff, cell, pbc) -> Edges:
        VesinNL = _optional("vesin", "NeighborList")
        if VesinNL is None:
            return cell_list_neighbor_list(R, cutoff, cell, pbc)
        p = np.zeros(3, bool) if pbc is None else np.asarray(pbc, bool)
        c = np.zeros((3, 3)) if cell is None else np.asarray(cell, float)
        if not p.any():
            c = np.diag(R.max(0) - R.min(0) + 2 * cutoff + 1.0)
        elif not p.all():
            if not VesinNeighborList._warned_fallback:
                warnings.warn(
                    "vesin does not support mixed periodic boundary "
                    "conditions; falling back to the cell list for this "
                    "structure", stacklevel=2)
                VesinNeighborList._warned_fallback = True
            return cell_list_neighbor_list(R, cutoff, cell, pbc)
        i, j, S = VesinNL(cutoff=float(cutoff), full_list=True).compute(
            points=np.ascontiguousarray(R, float),
            box=np.ascontiguousarray(c, float), periodic=bool(p.any()),
            quantities="ijS")
        return _sorted(i, j, S)


class SkinNeighborList(Transform):
    """Verlet-skin wrapper: rebuilds only when an atom moved more than
    skin/2 since the last build (``neighborlist.py:246-276``)."""

    is_preprocessor = True

    def __init__(self, base: NeighborListTransform, skin: float = 0.3):
        self.base = base
        self.skin = float(skin)
        self.base.cutoff += skin
        self._last_positions = None
        self._cache = None

    def __call__(self, inputs):
        R = np.asarray(inputs[properties.R])
        rebuild = (
            self._cache is None
            or self._last_positions.shape != R.shape
            or np.max(np.sum((R - self._last_positions) ** 2, axis=1))
            > (self.skin / 2.0) ** 2)
        if rebuild:
            out = self.base(dict(inputs))
            self._cache = {k: out[k] for k in (
                properties.idx_i, properties.idx_j, properties.offsets)}
            self._last_positions = R.copy()
        inputs.update(self._cache)
        return inputs


class FilterNeighbors(Transform):
    """Keeps the pairs whose two atoms are both in ``selected_atoms``."""

    is_preprocessor = True

    def __init__(self, selected_atoms):
        self.selected = np.asarray(selected_atoms)

    def __call__(self, inputs):
        keep = (np.isin(inputs[properties.idx_i], self.selected)
                & np.isin(inputs[properties.idx_j], self.selected))
        for k in (properties.idx_i, properties.idx_j, properties.offsets):
            inputs[k] = inputs[k][keep]
        return inputs


class CollectAtomTriples(Transform):
    """Triples (i, j, k): every unordered pair of the neighbor pairs of one
    center, as indices into the pair list (``neighborlist.py:297-322``)."""

    is_preprocessor = True

    def __call__(self, inputs):
        idx_i = np.asarray(inputs[properties.idx_i])
        _, counts = np.unique(idx_i, return_counts=True)
        tj, tk = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
        off = 0
        for c in counts:
            pj, pk = np.triu_indices(c, k=1)
            tj.append(pj + off)
            tk.append(pk + off)
            off += c
        pair_j, pair_k = np.concatenate(tj), np.concatenate(tk)
        inputs[properties.idx_i_triples] = (idx_i[pair_j] if len(idx_i)
                                            else np.zeros(0, np.int64))
        inputs[properties.idx_j_triples] = pair_j
        inputs[properties.idx_k_triples] = pair_k
        return inputs


class CountNeighbors(Transform):
    """Adds each atom's number of neighbors (``_n_nbh``)."""

    is_preprocessor = True

    def __init__(self, sorted: bool = True):
        self.sorted = sorted

    def __call__(self, inputs):
        counts = np.bincount(inputs[properties.idx_i],
                             minlength=len(inputs[properties.Z]))
        inputs[properties.n_nbh] = counts.astype(np.int64)
        return inputs


class WrapPositions(Transform):
    """Wraps the positions into the cell along its periodic axes, a
    fractional coordinate within ``eps`` of 1 going to 0."""

    is_preprocessor = True

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def __call__(self, inputs):
        cell = np.asarray(inputs[properties.cell], dtype=np.float64)
        pbc = np.asarray(inputs[properties.pbc], bool)
        R = np.asarray(inputs[properties.R], dtype=np.float64)
        frac = R @ np.linalg.inv(cell)
        frac[:, pbc] = frac[:, pbc] % 1.0
        frac[:, pbc] = np.where(frac[:, pbc] >= 1.0 - self.eps, 0.0,
                                frac[:, pbc])
        inputs[properties.R] = frac @ cell
        return inputs


class CachedNeighborList(Transform):
    """Caches each sample's neighbor list on disk, ``nbl_<idx>.npz`` under
    ``cache_path``, written under a file lock (``neighborlist.py:
    362-399``)."""

    is_preprocessor = True

    def __init__(self, cache_path: str, base: NeighborListTransform,
                 keep_cache: bool = False):
        self.cache_path = cache_path
        self.base = base
        self.keep_cache = keep_cache
        os.makedirs(cache_path, exist_ok=True)

    def __call__(self, inputs):
        from ..utils.locking import file_lock

        idx = int(np.asarray(inputs.get(properties.idx, [-1])).reshape(-1)[0])
        cache_file = os.path.join(self.cache_path, f"nbl_{idx}.npz")
        keys = (properties.idx_i, properties.idx_j, properties.offsets)
        if idx >= 0 and os.path.exists(cache_file):
            with np.load(cache_file) as f:
                for k in keys:
                    inputs[k] = f[k]
            return inputs
        inputs = self.base(inputs)
        if idx >= 0:
            with file_lock(cache_file + ".lock"):
                np.savez(cache_file, **{k: inputs[k] for k in keys})
        return inputs

    def teardown(self):
        if not self.keep_cache:
            shutil.rmtree(self.cache_path, ignore_errors=True)
