"""Slab-decomposed column evaluation and MD on one card (port of
``schnetpack_tpu/parallel/columns.py``).

The JAX package shards the column layout over a mesh of devices, each
owning a slab of xy-columns, and runs the model under ``shard_map`` with
halo exchanges between neighbouring slabs (``ops/colblock_shard.py``).
Here the mesh is one CUDA device: the inputs carry the ``cell_shard``
marker, so the model takes the slab path (halo'd gathers and the row-12
message, K11/K12 and K20/K21 in their halo modes) on the whole box, whose
halo is the periodic wrap; the exchange between cards is ROADMAP.md's
Queue 1 item 9, and a mesh of more than one device raises.

Typical use (positions in Angstrom, masses in amu, energies in eV, ``dt``
in the matching time unit, 10.18 fs)::

    lay = build_column_layout(R, cutoff, cell, pbc, dims=(nx, ny, 1))
    mesh = make_column_mesh(1)
    eval_fn = make_sharded_column_eval(pot, params, inputs, mesh)
    energy, forces = eval_fn(column_inputs(lay, R, Z))

``SpatialColumnSimulator`` runs NVE velocity Verlet in chunks with a host
re-bin of the atoms at every chunk boundary.  The Langevin form (``kT``,
``gamma``) draws JAX's per-column ``fold_in`` noise streams and raises
here (ROADMAP.md).  The entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` to ``make_column_mesh``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import properties as P
from ..atomistic.distances import column_refs
from ..ops.cellblock import CapacityError, build_column_layout

_MULTI_CARD = ("the slab path runs on one card: the halo exchange between "
               "cards is ROADMAP.md Queue 1 item 9")


@dataclass(frozen=True)
class ColumnMesh:
    """The slab path's mesh: ``dims`` (px,) for x slabs or (px, py) for
    (x, y) blocks, all 1 on one card."""

    device: torch.device
    dims: Tuple[int, ...] = (1,)

    @property
    def two_d(self) -> bool:
        return len(self.dims) == 2


def make_column_mesh(n_devices: int = 1, dims=None,
                     device="cuda") -> ColumnMesh:
    """The one-card mesh: 1-D (x slabs), or 2-D with ``dims=(1, 1)``."""
    dims = (int(n_devices),) if dims is None else tuple(int(d) for d in dims)
    if int(np.prod(dims)) != 1 or n_devices != int(np.prod(dims)):
        raise NotImplementedError(f"mesh {dims}: {_MULTI_CARD}")
    return ColumnMesh(torch.device(device), dims)


def column_inputs(lay, R: np.ndarray, Z: np.ndarray, dtype=torch.float32,
                  mesh_2d: bool = False,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Model inputs of the slab path in sorted column space
    (``columns.py:54-94``): the layout's indices, the periodic offsets
    ``cell_coff`` [nx, ny, Ktot, 3], the edge mask ``cell_emask`` and the
    ``cell_shard`` marker (length 2 for a 2-D mesh).  The per-atom arrays
    stay flat [A'] for either mesh: on one card no axis is split."""
    mask = lay.slot_mask > 0
    order = lay.order

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    inputs = {
        P.R: t(R[order] * mask[:, None]),
        P.Z: t(Z[order] * mask, torch.int64),
        P.idx_m: t(np.zeros(len(order)), torch.int64),
        P.atom_mask: t(lay.slot_mask),
        P.n_atoms: t([len(order)], torch.int64),
        P.cell_qcol: t(lay.qcol, torch.int32),
        P.cell_dcol: t(lay.dcol, torch.int32),
        P.cell_coff: t(lay.offcol),
        P.cell_emask: t(lay.emask),
        P.cell_ksz: tuple(int(k) for k in lay.ksizes),
        P.cell_shard: t(np.zeros(2 if mesh_2d else 1), torch.int8),
    }
    return inputs


def _place(pot, params, mesh: ColumnMesh):
    """The potential on the mesh's card with ``params`` loaded, frozen (the
    evaluations differentiate with respect to positions only)."""
    if params is not None:
        pot.load_state_dict(params)
    return pot.to(mesh.device).requires_grad_(False)


def make_sharded_column_eval(pot, params, inputs, mesh: ColumnMesh):
    """(inputs) -> (energy [1], forces [A', 3]) in sorted column order
    (``columns.py:127-158``; map through ``lay.rank`` for the original
    order).  On one shard the global energy is the slab's own."""
    if P.cell_shard not in inputs:
        raise ValueError("the slab evaluation takes the inputs of "
                         "column_inputs (with the cell_shard marker)")
    pot = _place(pot, params, mesh)

    def evaluate(ins):
        out = pot(ins)
        return out[P.energy], out[P.forces]

    return evaluate


def make_sharded_column_chunk(pot, params, mesh: ColumnMesh, dt: float,
                              n_steps: int, gamma=None, kT=None):
    """(inputs, R, p, m) -> (R, p) after ``n_steps`` NVE velocity-Verlet
    steps on the slab path (``columns.py:288-385``; a mass of 0, at the
    padded slots, keeps a slot still)."""
    if gamma is not None or kT is not None:
        raise NotImplementedError(
            "the Langevin chunk draws JAX's per-column fold_in noise "
            "streams; the port runs NVE only (ROADMAP.md)")
    pot = _place(pot, params, mesh)

    def run(ins, R, p, m):
        ins = dict(ins)
        column_refs(ins)  # one refs (and its cached schedules) per chunk
        amask = ins[P.atom_mask][:, None]
        minv = torch.where(m > 0, 1.0 / m.clamp(min=1e-30),
                           torch.zeros_like(m))[:, None]

        def force(R_):
            ins[P.R] = R_
            return pot(ins)[P.forces] * amask

        with torch.no_grad():
            f = force(R)
            for _ in range(n_steps):
                p1 = p + 0.5 * dt * f
                R = R + dt * p1 * minv
                f = force(R)
                p = p1 + 0.5 * dt * f
        return R, p

    return run


def _pad8(v) -> int:
    return int(-(-int(v) // 8) * 8)


class SpatialColumnSimulator:
    """NVE MD on the slab path with a host re-bin at every chunk boundary
    (``columns.py:388-499``): inside a chunk the positions and momenta stay
    on the card in sorted column order; at its end they return to the
    host, the atoms are re-binned into columns, and the layout's
    capacities stay sticky (pinned at the first build with headroom, reset
    only when they no longer fit).

    Model units throughout (positions, energies, ``masses``, ``dt``).
    ``host_seconds`` sums the wall time of the re-bins (layout and inputs),
    ``chunk_ms`` lists each chunk's CUDA-event time (on a CUDA mesh)."""

    def __init__(self, pot, params, R, Z, masses, cell, mesh: ColumnMesh,
                 cutoff: float, skin: float = 0.6, dims=None,
                 dt: float = 0.5, kT=None, gamma=None,
                 dtype=torch.float32):
        if kT is not None or gamma is not None:
            raise NotImplementedError(
                "the Langevin form draws JAX's per-column fold_in noise "
                "streams; the port runs NVE only (ROADMAP.md)")
        self.pot, self.params = pot, params
        self.R = np.asarray(R, np.float64)
        self.p = np.zeros_like(self.R)
        self.Z = np.asarray(Z, np.int64)
        self.masses = np.asarray(masses, np.float64)
        self.cell = np.asarray(cell, np.float64)
        self.mesh = mesh
        self.cutoff, self.skin = float(cutoff), float(skin)
        self.dt = float(dt)
        self.dtype = dtype
        self.rebuilds = 0
        self.host_seconds = 0.0
        self.chunk_ms = []
        self._C = None
        self._K = None
        self._chunks = {}
        if dims is None:
            # the autotuned grid (nx, ny are multiples of a one-card mesh)
            lay0 = build_column_layout(self.R, self.cutoff + self.skin,
                                       self.cell, np.ones(3, bool))
            nx0, ny0 = lay0.qcol.shape[:2]
            dims = (nx0, ny0, 1)
        self._dims = tuple(dims)

    def layout(self):
        """The column layout of the current positions, with the sticky
        capacities (``columns.py:442-462``)."""
        rc = self.cutoff + self.skin
        pbc = np.ones(3, bool)
        try:
            lay = build_column_layout(
                self.R, rc, self.cell, pbc, dims=self._dims,
                capacity=self._C, bucket_size=self._K)
        except CapacityError:
            self._C = self._K = None
            lay = build_column_layout(self.R, rc, self.cell, pbc,
                                      dims=self._dims)
        if self._C is None:
            _, _, P0, ks0 = lay.dims
            self._C = _pad8(P0 + 8)
            self._K = tuple(_pad8(k + max(8, k // 8)) for k in ks0)
            lay = build_column_layout(
                self.R, rc, self.cell, pbc, dims=self._dims,
                capacity=self._C, bucket_size=self._K)
        return lay

    def _chunk_fn(self, n_steps):
        if n_steps not in self._chunks:
            self._chunks[n_steps] = make_sharded_column_chunk(
                self.pot, self.params, self.mesh, self.dt, n_steps)
        return self._chunks[n_steps]

    def simulate(self, n_steps: int, chunk_size: int = 50):
        dev = self.mesh.device
        left = int(n_steps)
        while left > 0:
            n = min(chunk_size, left)
            t0 = time.perf_counter()
            lay = self.layout()
            self.rebuilds += 1
            inputs = column_inputs(lay, self.R, self.Z, dtype=self.dtype,
                                   mesh_2d=self.mesh.two_d, device=dev)
            order, rank = lay.order, lay.rank
            smask = (lay.slot_mask > 0)

            def t(a):
                return torch.as_tensor(a, dtype=self.dtype, device=dev)

            R_s = t(self.R[order] * smask[:, None])
            p_s = t(self.p[order] * smask[:, None])
            m_s = t(self.masses[order] * smask)
            fn = self._chunk_fn(n)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.host_seconds += time.perf_counter() - t0
            timed = dev.type == "cuda"
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            Rn, pn = fn(inputs, R_s, p_s, m_s)
            if timed:
                end.record()
                end.synchronize()
                self.chunk_ms.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            self.R = Rn.double().cpu().numpy()[rank]
            self.p = pn.double().cpu().numpy()[rank]
            self.host_seconds += time.perf_counter() - t0
            left -= n
        return self.R, self.p
