"""Column-layout neighbor list with a Verlet skin for MD.

Port of ``CellBlockNeighborListMD`` (``schnetpack_tpu/md/neighborlist_md.py:
173-667``), layout="column", host builds only.  The state carried to the
model lives in sorted space: ``cell_order`` (original atom per slot),
``cell_rank`` (slot per atom), ``cell_Z``/``cell_idx_m``/``cell_atom_mask``
(0 on empty slots) and the layout's index and offset tensors.

Capacities are sticky so that the kernels see stable shapes: the first
build probes them on a jittered copy of the positions (``jitter_fraction``
of the skin) and pads every bucket by ``bucket_headroom``; later builds
reuse them and grow them monotonically on ``CapacityError``; ``retighten``
re-probes from the current (equilibrated) positions.  The skin criterion
(some atom moved more than skin/2 since the last build) is checked every
MD step as one device scalar; a host rebuild follows when it fires.  The
on-device re-bin of the JAX package (``ops/colblock_rebuild.py``) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import properties as structure
from ..ops.cellblock import CapacityError, build_column_layout
from ..transform.neighborlist import cell_list_neighbor_list
from .system import System


def _pad8(v) -> int:
    return int(-(-int(v) // 8) * 8)


def _depth(P_fresh: int) -> int:
    """Column capacity with 8 rows of headroom, unless that would cross a
    multiple of 128 (``neighborlist_md.py:343-348``)."""
    want = _pad8(P_fresh + 8)
    if (want - 1) // 128 > (_pad8(P_fresh) - 1) // 128:
        want = _pad8(P_fresh)
    return want


class CellBlockNeighborListMD:
    def __init__(self, cutoff: float, skin: float = 0.6,
                 capacity_headroom: int = 1, layout: str = "column",
                 jitter_fraction: float = 0.5,
                 bucket_headroom: float = 1.0 / 6.0):
        if layout != "column":
            raise NotImplementedError("the port has the column layout only")
        self.cutoff = float(cutoff)
        self.skin = float(skin)
        self.capacity_headroom = capacity_headroom
        self.jitter_fraction = float(jitter_fraction)
        self.bucket_headroom = float(bucket_headroom)
        self._dims = None      # (nx, ny, 1)
        self._C = None         # column capacity P
        self._K = None         # 9 bucket sizes
        self._layout = None
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._build_positions: Optional[torch.Tensor] = None
        #: host builds so far
        self.n_builds = 0

    def _grow(self, ks_fresh):
        return tuple(
            _pad8(b + max(16, int(b * self.bucket_headroom)))
            for b in ks_fresh)

    def build(self, system: System) -> None:
        if system.n_replicas != 1 or system.n_molecules != 1:
            raise NotImplementedError(
                "the port's column neighbor list takes one replica of one "
                "molecule or periodic box")
        R = system.positions[0].detach().double().cpu().numpy()
        cell = system.cells[0, 0].detach().double().cpu().numpy()
        pbc = system.pbc[0].cpu().numpy()
        use_pbc = pbc if pbc.any() else None
        use_cell = cell if np.abs(cell).sum() > 0 else None
        rc = self.cutoff + self.skin
        edges = cell_list_neighbor_list(R, rc, use_cell, use_pbc)

        def layout(**kw):
            return build_column_layout(
                R, rc, use_cell, use_pbc, edges=edges,
                capacity_headroom=self.capacity_headroom, **kw)

        # fully periodic boxes wider than 2*rc admit an alias-free stencil
        min_grid = 1
        if use_cell is not None and pbc.all():
            inv = np.linalg.inv(cell)
            if np.all(1.0 / np.linalg.norm(inv, axis=1) > 2 * rc):
                min_grid = 3

        def first_build():
            # probe capacities on a copy jittered by +-skin*jitter_fraction:
            # thermal motion shifts occupancies beyond the start geometry
            lay0 = layout(min_grid=min_grid)
            nx0, ny0, P0, ks0 = lay0.dims
            amp = self.skin * self.jitter_fraction
            jit = R + np.random.RandomState(0).uniform(-amp, amp, R.shape)
            try:
                lay1 = build_column_layout(
                    jit, rc, use_cell, use_pbc, dims=(nx0, ny0, 1),
                    capacity_headroom=self.capacity_headroom)
                _, _, P1, ks1 = lay1.dims
            except CapacityError:
                P1, ks1 = P0, ks0
            self._dims = (nx0, ny0, 1)
            self._C = _depth(max(P0, P1))
            self._K = self._grow(max(a, b) for a, b in zip(ks0, ks1))

        if self._dims is None:
            first_build()
        try:
            lay = layout(capacity=self._C, bucket_size=self._K,
                         dims=self._dims)
        except CapacityError:
            # grow the sticky shapes monotonically; a depth growing across
            # a multiple of 128 re-tunes the grid instead
            _, _, P2, ks2 = layout(dims=self._dims).dims
            P_want = _depth(P2)
            if (max(self._C, P_want) - 1) // 128 > (self._C - 1) // 128:
                first_build()
            else:
                self._C = max(self._C, P_want)
                self._K = tuple(max(a, b)
                                for a, b in zip(self._K, self._grow(ks2)))
            lay = layout(capacity=self._C, bucket_size=self._K,
                         dims=self._dims)
        nx, ny, P, ksizes = lay.dims
        self._dims, self._C, self._K = (nx, ny, 1), P, tuple(ksizes)
        self._layout = lay

        dev = system.positions.device
        dtype = system.positions.dtype
        real = torch.as_tensor(lay.slot_mask > 0, device=dev)
        order = torch.as_tensor(lay.order.astype(np.int64), device=dev)
        self._state = {
            structure.cell_qcol: torch.as_tensor(lay.qcol, device=dev),
            structure.cell_dcol: torch.as_tensor(lay.dcol, device=dev),
            structure.cell_coff_fm: torch.as_tensor(
                np.ascontiguousarray(np.moveaxis(lay.offcol, -1, 2)),
                dtype=dtype, device=dev),
            structure.cell_ksz: tuple(int(k) for k in ksizes),
            "cell_order": order,
            "cell_rank": torch.as_tensor(lay.rank.astype(np.int64),
                                         device=dev),
            "cell_Z": system.atomic_numbers[order] * real,
            "cell_idx_m": system.idx_m[order] * real,
            "cell_atom_mask": torch.as_tensor(lay.slot_mask, dtype=dtype,
                                              device=dev),
        }
        self._build_positions = system.positions.detach().clone()
        self.n_builds += 1

    def retighten(self, system: System,
                  jitter_fraction: Optional[float] = None,
                  bucket_headroom: Optional[float] = None) -> None:
        """Re-probe the capacities from the current positions, letting the
        sticky shapes shrink (call once after equilibration)."""
        old = (self.jitter_fraction, self.bucket_headroom)
        self._dims = self._C = self._K = None
        if jitter_fraction is not None:
            self.jitter_fraction = float(jitter_fraction)
        if bucket_headroom is not None:
            self.bucket_headroom = float(bucket_headroom)
        try:
            self.build(system)
        finally:
            self.jitter_fraction, self.bucket_headroom = old

    def displacement2(self, system: System) -> torch.Tensor:
        """Device scalar: max squared displacement since the last build."""
        d = system.positions - self._build_positions
        return (d * d).sum(-1).max()

    def maybe_rebuild(self, system: System) -> bool:
        """Skin check (one device scalar read); host rebuild if it fires."""
        if self._state is None:
            self.build(system)
            return True
        if float(self.displacement2(system)) <= (self.skin / 2.0) ** 2:
            return False
        self.build(system)
        return True

    def state(self) -> Dict[str, torch.Tensor]:
        return self._state
