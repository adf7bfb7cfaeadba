"""Neighbor lists with a Verlet skin for MD, and the all-pairs list.

Port of ``schnetpack_tpu/md/neighborlist_md.py``:

* ``AllPairsNeighborListMD`` (``:670-730``): the static index set of all
  ordered same-molecule pairs, made once on the host per ``idx_m`` and
  kept on the device; every call takes the minimum-image offsets of
  periodic molecules and the mask ``d < cutoff + cutoff_shell`` on the
  device (the flat layout).  No rebuilds.
* ``DenseNeighborListMD`` (``:38-170``): a dense [A, K] neighbor matrix
  built on the host from per-molecule cell lists of ``cutoff + skin``
  (``transform/neighborlist.py``), for ring polymers the union over beads;
  padded slots point to atom A - 1 with mask 0 and offset 0; the reverse
  map of ``ops/neighbor_gather.py`` rides along (``nbh_rev``).  K is the
  largest degree times ``headroom`` plus one, rounded up to
  ``k_multiple``, and never shrinks.  With R replicas the matrix is tiled
  R times with replica-shifted indices into the flattened [R * A] atom
  table.  Batched periodic boxes run here.
* ``CellBlockNeighborListMD`` (``:173-667``), with its two layouts:
  ``layout="column"`` (the default) and ``layout="atom"``, the 27-cell
  atom layout, below.

The skin criterion of the two skin lists (some atom moved more than
skin/2 since the last build) is checked every MD step as one device
scalar (``displacement2``, ``maybe_rebuild``).

The cell-blocked state carried to the model lives in sorted space:
``cell_order`` (original atom per slot), ``cell_rank`` (slot per atom),
``cell_Z``/``cell_idx_m``/``cell_atom_mask`` (0 on empty slots) and the
layout's index and offset tensors (column:
``cell_qcol``/``cell_dcol``/``cell_coff_fm``/``cell_ksz``; atom:
``cell_qidx``/``nbh_idx``/``nbh_mask``/``nbh_offsets`` and the
``CellRefs`` of ``cell_qidx``, whose cached schedules serve every step
until the next build).

Capacities are sticky so that the kernels see stable shapes: the first
build probes them on a jittered copy of the positions (``jitter_fraction``
of the skin) and pads every bucket by ``bucket_headroom``; later builds
reuse them and grow them monotonically on ``CapacityError``; ``retighten``
re-probes from the current (equilibrated) positions.  These host builds
run in numpy.  The skin criterion (some atom moved more than skin/2 since
the last build) is checked every MD step as one device scalar.  When it
fires, a fully periodic one-molecule box whose grid is at least 3 x 3
columns and whose box heights all exceed twice the build cutoff is
re-binned and rebuilt on the device (``ops/colblock_rebuild.py``, as
``neighborlist_md.py:483-507,610-664``): one more scalar read, the
overflow flag, and on overflow a host build, which grows the capacities.
Any other box rebuilds on the host.

Replicas (ring-polymer beads, ``neighborlist_md.py:228-262``) share one
column layout: the atoms are binned by their bead centroid and the edge
set is the union over beads of each bead's cell list, de-duplicated.  The
skin check takes the largest displacement over all beads, and the device
rebuild bins the centroid and keeps the union of the beads' edges.

Batched non-periodic molecules share one column layout
(``neighborlist_md.py:260-298``): each molecule gets its own x-slab of one
open domain, 2 (cutoff + skin) from the next, the columns are binned on
those translated copies while the kernels read the real positions, the
edges are the union of the molecules' own cell lists (over the beads), and
``cell_idx_m`` carries the molecule of every slot.  Batched periodic boxes
raise (they run on the dense list), and batched molecules rebuild on the
host only.

The atom layout (``neighborlist_md.py:401-428, 466-479``) takes one
replica of one molecule or box, with the reference's errors otherwise.
Its grid dims, cell capacity C and slots per atom K are sticky; when the
occupancy outgrows C (``CapacityError``) the layout is built afresh, while
a degree above the pinned K raises ``build_cell_layout``'s plain
``ValueError``, as in the reference.  It has no device rebuild
(``neighborlist_md.py:483-486``): every rebuild is a host build, counted
in ``n_builds``.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .. import properties as structure
from ..ops.cellblock import (
    CapacityError, build_cell_layout, build_column_layout,
)
from ..ops.cellblock_gather import CellRefs
from ..ops.colblock_rebuild import rebin_and_rebuild
from ..ops.neighbor_gather import build_reverse_map
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


def union_edges(R_all: np.ndarray, rc: float, cell, pbc):
    """The cell-list edges (i, j, S) of one replica, or for several the
    union over replicas, de-duplicated and sorted by (i, j, S)."""
    if len(R_all) == 1:
        return cell_list_neighbor_list(R_all[0], rc, cell, pbc)
    rows = np.unique(np.concatenate([
        np.column_stack(cell_list_neighbor_list(R, rc, cell, pbc))
        for R in R_all]), axis=0)
    return rows[:, 0], rows[:, 1], rows[:, 2:5]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class DenseNeighborListMD:
    """Dense [A, K] neighbor matrix with a Verlet skin (see the module's
    docstring).  ``cutoff`` and ``skin`` are in the system's length
    unit."""

    def __init__(self, cutoff: float, skin: float = 1.0, k_multiple: int = 4,
                 headroom: float = 1.15):
        self.cutoff = float(cutoff)
        self.skin = float(skin)
        self.k_multiple = k_multiple
        self.headroom = headroom
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._build_positions: Optional[torch.Tensor] = None
        #: host builds so far, and their wall time (seconds)
        self.n_builds = 0
        self.build_seconds = 0.0

    def build(self, system: System) -> None:
        """Host build from every molecule's cell list (union over beads)
        (``neighborlist_md.py:61-150``), timed into ``build_seconds``."""
        t0 = time.perf_counter()
        R_np = system.positions.detach().double().cpu().numpy()
        n_rep = system.n_replicas
        cells = system.cells[0].detach().double().cpu().numpy()
        pbc = _host(system.pbc)
        idx_m = _host(system.idx_m)
        A = R_np.shape[1]
        ii_all, jj_all, off_all = [], [], []
        for m in np.unique(idx_m):
            sel = np.nonzero(idx_m == m)[0]
            periodic = bool(pbc[m].any())
            sub_cell = cells[m] if periodic else None
            rows = np.concatenate([
                np.column_stack(cell_list_neighbor_list(
                    R_np[r, sel], self.cutoff + self.skin, sub_cell,
                    pbc[m] if periodic else None)).astype(np.int64)
                for r in range(n_rep)])
            if n_rep > 1 and len(rows):
                rows = np.unique(rows, axis=0)
            i, j, S = rows[:, 0], rows[:, 1], rows[:, 2:5]
            ii_all.append(sel[i])
            jj_all.append(sel[j])
            off_all.append(S.astype(np.float64) @ sub_cell if periodic
                           else np.zeros((len(i), 3)))
        ii = np.concatenate(ii_all)
        jj = np.concatenate(jj_all)
        off = np.concatenate(off_all)
        order = np.argsort(ii, kind="stable")
        ii, jj, off = ii[order], jj[order], off[order]

        counts = np.bincount(ii, minlength=A)
        max_count = int(counts.max(initial=1))
        K = int(-(-int(max_count * self.headroom + 1) // self.k_multiple)
                * self.k_multiple)
        if self._state is not None:       # K never shrinks
            K = max(K, self._state[structure.nbh_idx].shape[1])
        starts = np.zeros(A + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(len(ii)) - starts[ii]
        nbh = np.full((A, K), A - 1, np.int32)
        mask = np.zeros((A, K), np.float32)
        offs = np.zeros((A, K, 3), np.float64)
        nbh[ii, slots] = jj
        offs[ii, slots] = off
        mask[ii, slots] = 1.0
        rev = build_reverse_map(ii, jj, off, slots, A, K)
        if n_rep > 1:
            # one topology for every replica, its indices shifted into the
            # calculator's flattened [n_rep * A] atom table
            shift = np.repeat(np.arange(n_rep) * A, A)[:, None]
            nbh = np.tile(nbh, (n_rep, 1)) + shift.astype(np.int32)
            offs = np.tile(offs, (n_rep, 1, 1))
            mask = np.tile(mask, (n_rep, 1))
            rshift = np.repeat(np.arange(n_rep) * (A * K), A)[:, None]
            rev = np.tile(rev, (n_rep, 1)) + rshift.astype(rev.dtype)
        dev = system.positions.device
        dtype = system.positions.dtype
        self._state = {
            structure.nbh_idx: torch.as_tensor(nbh, device=dev),
            structure.nbh_offsets: torch.as_tensor(offs, dtype=dtype,
                                                   device=dev),
            structure.nbh_mask: torch.as_tensor(mask, dtype=dtype,
                                                device=dev),
            structure.nbh_rev: torch.as_tensor(rev, device=dev),
            structure.nbh_cutoff: torch.tensor(self.cutoff + self.skin,
                                               dtype=dtype, device=dev),
        }
        self._build_positions = system.positions.detach().clone()
        self.n_builds += 1
        self.build_seconds += time.perf_counter() - t0

    def displacement2(self, system: System) -> torch.Tensor:
        """Device scalar: max squared displacement since the last build."""
        d = system.positions - self._build_positions
        return (d * d).sum(-1).max()

    def maybe_rebuild(self, system: System) -> bool:
        """Skin check (one device scalar read); a host build when it
        fires."""
        if self._state is None or (float(self.displacement2(system))
                                   > (self.skin / 2.0) ** 2):
            self.build(system)
            return True
        return False

    def state(self) -> Dict[str, torch.Tensor]:
        return self._state


class AllPairsNeighborListMD:
    """Static all-pairs (same-molecule) index set, masked on the device at
    every call (see the module's docstring).  ``cutoff`` and
    ``cutoff_shell`` are in the system's length unit."""

    def __init__(self, cutoff: float, cutoff_shell: float = 0.0):
        self.cutoff = float(cutoff)
        self.cutoff_shell = float(cutoff_shell)
        self._static: Dict[tuple, tuple] = {}
        self._last = (None, None)      # (idx_m tensor, its pairs)

    def _static_pairs(self, idx_m: torch.Tensor, pbc: torch.Tensor):
        """(idx_i, idx_j) int32 on the device, sorted by (i, j), and
        whether any molecule is periodic; made once per ``idx_m`` (read on
        the host only when the tensor is not the last call's)."""
        if self._last[0] is idx_m:
            return self._last[1]
        idx_np = _host(idx_m)
        key = (idx_np.tobytes(), str(idx_m.device))
        if key not in self._static:
            same = idx_np[:, None] == idx_np[None, :]
            np.fill_diagonal(same, False)
            ii, jj = np.nonzero(same)
            order = np.lexsort((jj, ii))
            self._static[key] = (
                torch.as_tensor(ii[order].astype(np.int32),
                                device=idx_m.device),
                torch.as_tensor(jj[order].astype(np.int32),
                                device=idx_m.device),
                bool(_host(pbc).any()))
        self._last = (idx_m, self._static[key])
        return self._last[1]

    def get_neighbors(self, positions: torch.Tensor, cells: torch.Tensor,
                      idx_m: torch.Tensor, pbc: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Pairs of every replica (positions [R, A, 3], cells [R, M, 3, 3]
        in the system's unit): idx_i, idx_j [P], offsets [R, P, 3] and
        pair_mask [R, P] (``neighborlist_md.py:693-730``)."""
        idx_i, idx_j, periodic = self._static_pairs(idx_m, pbc)
        diff = positions[:, idx_j] - positions[:, idx_i]
        offsets = torch.zeros_like(diff)
        if periodic:
            pair_mol = idx_m[idx_i]
            has_cell = torch.linalg.det(cells).abs() > 1e-12    # [R, M]
            eye = torch.eye(3, dtype=cells.dtype, device=cells.device)
            safe = cells + eye * (~has_cell)[..., None, None]
            inv = torch.linalg.inv(safe)
            frac = torch.einsum("rpj,rpjk->rpk", diff, inv[:, pair_mol])
            wrap = pbc[pair_mol][None] & has_cell[:, pair_mol][..., None]
            shift = torch.where(wrap, -torch.round(frac),
                                torch.zeros_like(frac))
            offsets = torch.einsum("rpk,rpkj->rpj", shift,
                                   safe[:, pair_mol])
        d = torch.linalg.vector_norm(diff + offsets, dim=-1)
        return {
            structure.idx_i: idx_i,
            structure.idx_j: idx_j,
            structure.offsets: offsets,
            structure.pair_mask: (
                d < self.cutoff + self.cutoff_shell).to(positions.dtype),
        }


class CellBlockNeighborListMD:
    def __init__(self, cutoff: float, skin: float = 0.6,
                 capacity_headroom: int = 1, layout: str = "column",
                 jitter_fraction: float = 0.5,
                 bucket_headroom: float = 1.0 / 6.0):
        if layout not in ("column", "atom"):
            raise NotImplementedError(
                f"the port has the 'column' and 'atom' layouts, not {layout!r}")
        self.layout_kind = layout
        self.cutoff = float(cutoff)
        self.skin = float(skin)
        self.capacity_headroom = capacity_headroom
        self.jitter_fraction = float(jitter_fraction)
        self.bucket_headroom = float(bucket_headroom)
        self._dims = None      # (nx, ny, 1) or, atom layout, (nx, ny, nz)
        self._C = None         # column capacity P or cell capacity C
        self._K = None         # 9 bucket sizes or slots per atom K
        self._layout = None    # the last host build's layout
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._build_positions: Optional[torch.Tensor] = None
        self._dev_rebuild: Optional[dict] = None
        #: host builds so far, and their wall time (seconds)
        self.n_builds = 0
        self.build_seconds = 0.0
        #: rebuilds on the device so far
        self.n_device_builds = 0
        #: device rebuilds that overflowed the capacities (each followed by
        #: a host build)
        self.n_device_overflows = 0

    def _grow(self, ks_fresh):
        return tuple(
            _pad8(b + max(16, int(b * self.bucket_headroom)))
            for b in ks_fresh)

    def _geometry(self, system: System):
        """Host copies (bead positions [R, A, 3], their centroid, cell, pbc,
        use_cell, use_pbc) of the one box."""
        R_all = system.positions.detach().double().cpu().numpy()
        cell = system.cells[0, 0].detach().double().cpu().numpy()
        pbc = system.pbc[0].cpu().numpy()
        use_pbc = pbc if pbc.any() else None
        use_cell = cell if np.abs(cell).sum() > 0 else None
        return R_all, R_all.mean(axis=0), cell, pbc, use_cell, use_pbc

    def _sorted_state(self, lay, system: System) -> Dict[str, torch.Tensor]:
        """The sorted-space system arrays of a layout."""
        dev = system.positions.device
        real = torch.as_tensor(lay.slot_mask > 0, device=dev)
        order = torch.as_tensor(lay.order.astype(np.int64), device=dev)
        return {
            "cell_order": order,
            "cell_rank": torch.as_tensor(lay.rank.astype(np.int64),
                                         device=dev),
            "cell_Z": system.atomic_numbers[order] * real,
            "cell_idx_m": system.idx_m[order] * real,
            "cell_atom_mask": torch.as_tensor(
                lay.slot_mask, dtype=system.positions.dtype, device=dev),
        }

    def _build_atom(self, system: System) -> None:
        """Host build of the 27-cell atom layout (``neighborlist_md.py:
        401-419, 466-479``)."""
        if system.n_replicas != 1:
            raise NotImplementedError(
                "the 27-cell layout supports n_replicas == 1; "
                "use layout='column' for ring-polymer MD")
        if system.n_molecules != 1:
            raise NotImplementedError(
                "the 27-cell layout supports a single molecule; use "
                "layout='column' for batched molecules")
        _, R, _, _, use_cell, use_pbc = self._geometry(system)
        rc = self.cutoff + self.skin
        try:
            lay = build_cell_layout(R, rc, use_cell, use_pbc,
                                    capacity=self._C, n_neighbors=self._K,
                                    dims=self._dims,
                                    capacity_headroom=self.capacity_headroom)
        except CapacityError:
            lay = build_cell_layout(R, rc, use_cell, use_pbc,
                                    capacity_headroom=self.capacity_headroom)
        nx, ny, nz, C, K = lay.dims
        self._dims, self._C, self._K = (nx, ny, nz), C, K
        self._layout = lay
        dev = system.positions.device
        qidx = torch.as_tensor(lay.qidx, device=dev)
        self._state = {
            structure.cell_qidx: qidx,
            # one refs per build: the decode and source order cached on it
            # serve every step until the next build
            structure.cell_refs: CellRefs(qidx),
            structure.nbh_idx: torch.as_tensor(lay.nbh_idx, device=dev),
            structure.nbh_mask: torch.as_tensor(
                lay.nbh_mask, dtype=system.positions.dtype, device=dev),
            structure.nbh_offsets: torch.as_tensor(
                lay.nbh_offsets, dtype=system.positions.dtype, device=dev),
            **self._sorted_state(lay, system),
        }
        self._build_positions = system.positions.detach().clone()
        self._dev_rebuild = None

    def build(self, system: System) -> None:
        """Host build of the layout (timed into ``build_seconds``)."""
        t0 = time.perf_counter()
        if self.layout_kind == "atom":
            self._build_atom(system)
        else:
            self._build_column(system)
        self.n_builds += 1
        self.build_seconds += time.perf_counter() - t0

    def _batched_molecules(self, system: System, R_all, R, rc):
        """Binning positions and union edges of several non-periodic
        molecules (``neighborlist_md.py:260-298``): each molecule is
        translated into its own x-slab of one open domain, a gap of 2 rc
        from the next, so that no stencil bucket spans two molecules; the
        edges are each molecule's cell list, over the beads where there
        are replicas.  The kernels read the real positions."""
        if system.pbc.any() or bool(system.cells.abs().sum() > 0):
            raise NotImplementedError(
                "the column layout batches non-periodic molecules; "
                "use neighbor_list='dense' for multiple periodic boxes")
        idx_m = _host(system.idx_m)
        beads = R_all if len(R_all) > 1 else R[None]
        translation = np.zeros_like(R)
        x_cursor = 0.0
        rows = []
        for m in range(system.n_molecules):
            sel = np.nonzero(idx_m == m)[0]
            if len(sel) == 0:
                continue
            lo = R[sel].min(axis=0)
            hi = R[sel].max(axis=0)
            translation[sel] = [x_cursor - lo[0], -lo[1], -lo[2]]
            x_cursor += (hi[0] - lo[0]) + 2.0 * rc
            i, j, S = union_edges(beads[:, sel], rc, None, None)
            rows.append(np.column_stack([sel[i], sel[j], S]))
        rows = np.unique(np.concatenate(rows).astype(np.int64), axis=0)
        return R + translation, (rows[:, 0], rows[:, 1], rows[:, 2:5])

    def _build_column(self, system: System) -> None:
        R_all, R, cell, pbc, use_cell, use_pbc = self._geometry(system)
        rc = self.cutoff + self.skin
        if system.n_molecules == 1:
            edges = union_edges(R_all, rc, use_cell, use_pbc)
        else:
            R, edges = self._batched_molecules(system, R_all, R, rc)
            use_cell = use_pbc = None
            pbc = np.zeros(3, bool)

        def layout(**kw):
            return build_column_layout(
                R, rc, use_cell, use_pbc, edges=edges,
                capacity_headroom=self.capacity_headroom, **kw)

        # fully periodic boxes wider than 2*rc admit an alias-free stencil
        # and the on-device rebuild
        wide = bool(use_cell is not None and pbc.all() and np.all(
            1.0 / np.linalg.norm(np.linalg.inv(cell), axis=1) > 2 * rc))
        min_grid = 3 if wide else 1

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
        self._state = {
            structure.cell_qcol: torch.as_tensor(lay.qcol, device=dev),
            structure.cell_dcol: torch.as_tensor(lay.dcol, device=dev),
            structure.cell_coff_fm: torch.as_tensor(
                np.ascontiguousarray(np.moveaxis(lay.offcol, -1, 2)),
                dtype=dtype, device=dev),
            structure.cell_ksz: tuple(int(k) for k in ksizes),
            **self._sorted_state(lay, system),
        }
        self._build_positions = system.positions.detach().clone()

        # on-device rebuild eligibility (``neighborlist_md.py:483-507``):
        # one periodic box, not batched molecules
        self._dev_rebuild = None
        if wide and nx >= 3 and ny >= 3 and system.n_molecules == 1:
            self._dev_rebuild = {
                "cell": torch.as_tensor(cell, dtype=dtype, device=dev),
                "nx": nx, "ny": ny, "P": P, "ks": tuple(ksizes), "rc": rc,
            }

    def retighten(self, system: System,
                  jitter_fraction: Optional[float] = None,
                  bucket_headroom: Optional[float] = None) -> None:
        """Re-probe the capacities from the current positions, letting the
        sticky shapes shrink (call once after equilibration).  The jitter
        and headroom of the column layout's probe do not apply to the atom
        layout, which simply builds afresh."""
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
        """Skin check (one device scalar read); when it fires, a device
        rebuild where the box admits one, else (or on overflow) a host
        build."""
        if self._state is None:
            self.build(system)
            return True
        if float(self.displacement2(system)) <= (self.skin / 2.0) ** 2:
            return False
        if self._dev_rebuild is not None and self._rebuild_on_device(system):
            return True
        self.build(system)
        return True

    def _rebuild_on_device(self, system: System) -> bool:
        """Re-bin and rebuild the whole sorted-space state on the device;
        the only host read is the overflow flag.  False on overflow (the
        caller then builds on the host, which grows the capacities)."""
        info = self._dev_rebuild
        st = self._state
        new, ovf = rebin_and_rebuild(
            system.positions.detach(), st["cell_order"],
            st["cell_atom_mask"], st["cell_Z"], st["cell_idx_m"],
            info["cell"], info["nx"], info["ny"], info["P"], info["ks"],
            info["rc"])
        if bool(ovf):
            self.n_device_overflows += 1
            warnings.warn(
                f"device neighbor rebuild overflowed the capacities (P="
                f"{info['P']}, buckets {info['ks']}); rebuilding on the host",
                RuntimeWarning, stacklevel=3)
            return False
        dtype = system.positions.dtype
        self._state = {
            **st,
            structure.cell_qcol: new["qcol"],
            structure.cell_dcol: new["dcol"],
            structure.cell_coff_fm: new["coff_fm"].to(dtype),
            "cell_order": new["order"],
            "cell_rank": new["rank"],
            "cell_Z": new["Z"],
            "cell_idx_m": new["idx_m"],
            "cell_atom_mask": new["atom_mask"].to(dtype),
        }
        self._build_positions = system.positions.detach().clone()
        self.n_device_builds += 1
        return True

    def state(self) -> Dict[str, torch.Tensor]:
        return self._state
