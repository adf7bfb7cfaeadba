"""Slab-decomposed column evaluation and MD over a mesh of ranks (port of
``schnetpack_tpu/parallel/columns.py``).

The column layout is split over a mesh of ranks (``make_column_mesh``):
x slabs over ``px`` ranks, or (x, y) blocks over ``px * py``, nx a
multiple of px and ny of py.  Each rank holds its slab's columns and
atoms (``column_inputs``), runs the model on them, and before every
gather exchanges the boundary column planes with its neighbours
(``ops/colblock_shard.py``); K11/K12 and K20/K21 read the halo'd slab in
their halo modes.  Each rank differentiates its own slab's energy: the
exchange's backward brings the cross-rank force terms home, where the
JAX package differentiates ``psum(E) / n`` through its ``ppermute``s
(``model/base.py:163-183``), so the forces agree either way.  On one rank
the halo is the periodic wrap of the slab's own edge planes.

Typical use (positions in Angstrom, masses in amu, energies in eV, ``dt``
in the matching time unit, 10.18 fs), on every rank of a joined group::

    lay = build_column_layout(R, cutoff, cell, pbc, dims=(nx, ny, 1))
    mesh = make_column_mesh(2)                      # two x slabs
    inputs = column_inputs(lay, R, Z, mesh=mesh)    # this rank's slab
    energies, forces = make_sharded_column_eval(pot, params, inputs,
                                                mesh)(inputs)
    # energies [n]: each rank's partial (their sum is the box's energy);
    # forces: this rank's slab, sorted; gather_slabs(lay, mesh, forces)

``make_sharded_column_md`` and ``make_sharded_column_rpmd`` run NVE
velocity-Verlet chunks of one system or of a ring polymer (one slab
evaluation a bead, the harmonic springs between beads elementwise) on
each rank's slab.  ``make_sharded_column_chunk`` and
``SpatialColumnSimulator`` run NVE or, with ``kT`` and ``gamma``,
Langevin chunks; at every chunk boundary the ranks all-gather the
positions and momenta, each re-bins the whole box (so every rank builds
the same layout and capacities) and keeps its slab.  The Langevin noise
is JAX's: a normal draw for each (chunk key, half-step, global column)
from ``md/prng.py``'s threefry2x32, so a column's noise never depends on
how the columns are split, and the port draws the JAX package's noise up
to the ulps of ``erfinv``.  The entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` to ``make_column_mesh``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import properties as P
from ..atomistic.distances import column_refs
from ..md import prng
from ..ops.cellblock import CapacityError, build_column_layout
from ..ops.colblock_shard import COLS_AXIS, COLS_AXIS_Y
from .mesh import Mesh, MeshError, make_mesh


@dataclass(frozen=True)
class ColumnMesh(Mesh):
    """The slab path's mesh: axis ``cols`` (x slabs, ``dims`` (px,)) or
    ``cols``, ``cols_y`` ((x, y) blocks, ``dims`` (px, py))."""

    @property
    def dims(self) -> Tuple[int, ...]:
        return self.shape

    @property
    def two_d(self) -> bool:
        return len(self.shape) == 2

    def slab(self, nx: int, ny: int) -> Tuple[int, int, int, int]:
        """(x0, nx_loc, y0, ny_loc): this rank's columns of an (nx, ny)
        grid; ``MeshError`` where the mesh does not divide the grid."""
        px = self.shape[0]
        py = self.shape[1] if self.two_d else 1
        if nx % px or ny % py:
            raise MeshError(
                f"the column grid ({nx}, {ny}) does not split over the mesh "
                f"{self.dims}: nx must be a multiple of px and ny of py "
                "(pin the grid with build_column_layout(dims=...))")
        nxl, nyl = nx // px, ny // py
        cx = self.coords
        return cx[0] * nxl, nxl, (cx[1] * nyl if self.two_d else 0), nyl


def make_column_mesh(n_devices: int = 1, dims=None, device="cuda",
                     backend=None) -> ColumnMesh:
    """The slab path's mesh of ``n_devices`` ranks: 1-D x slabs, or
    ``dims=(px, py)`` (x, y) blocks (``columns.py:38-48``), on ``device``
    with ``backend`` (``parallel.mesh.make_mesh``; NCCL on ``cuda`` by
    default, gloo on the CPU)."""
    if dims is None:
        shape, axes = (int(n_devices),), (COLS_AXIS,)
    else:
        shape, axes = tuple(int(d) for d in dims), (COLS_AXIS, COLS_AXIS_Y)
        if int(np.prod(shape)) != int(n_devices):
            raise MeshError(f"dims {shape} hold {int(np.prod(shape))} "
                            f"ranks, not {n_devices}")
    return ColumnMesh(**vars(make_mesh(int(n_devices), axes, shape, device,
                                       backend)))


def _grid(lay) -> Tuple[int, int, int]:
    nx, ny, _ = lay.qcol.shape
    return nx, ny, len(lay.order) // (nx * ny)


def slab_of(lay, mesh, a):
    """This rank's part [A_loc, ...] of ``a`` [A', ...], an array in the
    layout's sorted column order (numpy or torch): its slab's columns, x
    major (all of ``a`` on one rank)."""
    if mesh is None or mesh.size == 1:
        return a
    nx, ny, Pc = _grid(lay)
    x0, nxl, y0, nyl = mesh.slab(nx, ny)
    block = a.reshape(nx, ny, Pc, *a.shape[1:])[x0:x0 + nxl, y0:y0 + nyl]
    return block.reshape(nxl * nyl * Pc, *a.shape[1:])


def gather_slabs(lay, mesh, a: torch.Tensor) -> torch.Tensor:
    """The whole [A', ...] array in sorted column order from each rank's
    slab ``a`` [A_loc, ...] (an all-gather; every rank gets it)."""
    if mesh is None or mesh.size == 1:
        return a
    nx, ny, Pc = _grid(lay)
    parts = mesh.all_gather(a)
    out = a.new_empty((nx, ny, Pc) + tuple(a.shape[1:]))
    for r, part in enumerate(parts):
        x0, nxl, y0, nyl = dataclasses.replace(mesh, rank=r).slab(nx, ny)
        out[x0:x0 + nxl, y0:y0 + nyl] = part.reshape(
            nxl, nyl, Pc, *a.shape[1:])
    return out.reshape(nx * ny * Pc, *a.shape[1:])


def _global_columns(mesh, nxl: int, nyl: int, dev) -> torch.Tensor:
    """The global column ids [nxl * nyl] of this rank's slab, x major."""
    cx = mesh.coords
    ny = nyl * (mesh.shape[1] if mesh.two_d else 1)
    gx = cx[0] * nxl + torch.arange(nxl, device=dev)
    gy = (cx[1] * nyl if mesh.two_d else 0) + torch.arange(nyl, device=dev)
    return (gx[:, None] * ny + gy[None, :]).reshape(-1)


def column_inputs(lay, R: np.ndarray, Z: np.ndarray, dtype=torch.float32,
                  mesh_2d: bool = False, device="cuda",
                  mesh=None) -> Dict[str, torch.Tensor]:
    """Model inputs of the slab path in sorted column space
    (``columns.py:54-124``): the layout's indices, the periodic offsets
    ``cell_coff`` [nx, ny, Ktot, 3], the edge mask ``cell_emask`` and the
    ``cell_shard`` marker (length 2 for a 2-D mesh).  On a mesh of several
    ranks they are this rank's slab (``slab_of``: its columns, its atoms
    flat [A_loc] x major, as JAX's ``_flatten_atoms`` views them) with the
    mesh under ``cell_mesh``; ``MeshError`` where the mesh does not divide
    the grid.  ``mesh_2d`` (one rank) or the mesh's ``two_d`` picks the
    marker."""
    mask = lay.slot_mask > 0
    order = lay.order
    multi = mesh is not None and mesh.size > 1
    if mesh is not None:
        mesh_2d, device = mesh.two_d, mesh.device
    nx, ny, Pc = _grid(lay)
    x0, nxl, y0, nyl = mesh.slab(nx, ny) if multi else (0, nx, 0, ny)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    def atoms(a, dt=dtype):
        return t(slab_of(lay, mesh, a), dt)

    def cols(a, dt=dtype):
        return t(a[x0:x0 + nxl, y0:y0 + nyl], dt)

    inputs = {
        P.R: atoms(R[order] * mask[:, None]),
        P.Z: atoms(Z[order] * mask, torch.int64),
        P.idx_m: atoms(np.zeros(len(order)), torch.int64),
        P.atom_mask: atoms(lay.slot_mask),
        P.n_atoms: t([nxl * nyl * Pc], torch.int64),
        P.cell_qcol: cols(lay.qcol, torch.int32),
        P.cell_dcol: cols(lay.dcol, torch.int32),
        P.cell_coff: cols(lay.offcol),
        P.cell_emask: cols(lay.emask),
        P.cell_ksz: tuple(int(k) for k in lay.ksizes),
        P.cell_shard: t(np.zeros(2 if mesh_2d else 1), torch.int8),
    }
    if multi:
        inputs[P.cell_mesh] = mesh
    return inputs


def _place(pot, params, mesh: ColumnMesh):
    """The potential on the mesh's card with ``params`` loaded, frozen (the
    evaluations differentiate with respect to positions only)."""
    if params is not None:
        pot.load_state_dict(params)
    return pot.to(mesh.device).requires_grad_(False)


def _with_mesh(ins, mesh):
    """``ins`` with the mesh of several ranks under ``cell_mesh``."""
    if mesh.size > 1 and P.cell_mesh not in ins:
        ins = dict(ins)
        ins[P.cell_mesh] = mesh
    return ins


def make_sharded_column_eval(pot, params, inputs, mesh: ColumnMesh):
    """(inputs) -> (energies [n], forces [A_loc, 3]): each rank's partial
    energy (every rank gets all n; their sum is the box's energy) and this
    rank's forces in sorted column order (``columns.py:127-158``;
    ``gather_slabs`` and ``lay.rank`` give the original order).  Every
    rank of the mesh calls it together."""
    if P.cell_shard not in inputs:
        raise ValueError("the slab evaluation takes the inputs of "
                         "column_inputs (with the cell_shard marker)")
    pot = _place(pot, params, mesh)

    def evaluate(ins):
        out = pot(_with_mesh(ins, mesh))
        E = out[P.energy]
        if mesh.size > 1:
            E = torch.cat(mesh.all_gather(E.detach()))
        return E, out[P.forces]

    return evaluate


def _flat(R: torch.Tensor, lead: int):
    """[lead..., nx, ny, P, 3] column-shaped positions (a 2-D mesh's
    input) as [lead..., A', 3], and the shape to give back."""
    if R.ndim == lead + 4:
        return R.reshape(*R.shape[:lead], -1, 3), R.shape
    return R, None


def _slab_force(pot, ins, mesh):
    """R -> the masked forces of the slab path on ``ins`` (whose column
    refs are made once here, for every evaluation of a chunk)."""
    ins = dict(_with_mesh(ins, mesh))
    column_refs(ins)
    amask = ins[P.atom_mask][:, None]

    def force(R):
        ins[P.R] = R
        return pot(ins)[P.forces] * amask

    return force, amask


def _verlet(force, R, p, dt: float, mass: float, n_steps: int):
    """``n_steps`` NVE velocity-Verlet steps of one mass
    (``columns.py:188-199``)."""
    with torch.no_grad():
        f = force(R)
        for _ in range(n_steps):
            p1 = p + 0.5 * dt * f
            R = R + dt * p1 / mass
            f = force(R)
            p = p1 + 0.5 * dt * f
    return R, p


def make_sharded_column_md(pot, params, inputs, mesh: ColumnMesh,
                           mass: float = 1.0, dt: float = 0.1,
                           n_steps: int = 5):
    """(inputs, R0, p0) -> (R_n, p_n): an NVE velocity-Verlet chunk of
    ``n_steps`` on the slab path with one ``mass`` for every atom
    (``columns.py:161-213``).  ``R0``/``p0`` are this rank's slab [A_loc,
    3] in sorted column order, or [nx_loc, ny_loc, P, 3] (a 2-D mesh's
    shape), which comes back."""
    pot = _place(pot, params, mesh)

    def run(ins, R0, p0):
        R, shape = _flat(R0, 0)
        p, _ = _flat(p0, 0)
        force, _ = _slab_force(pot, ins, mesh)
        R, p = _verlet(force, R, p, dt, mass, n_steps)
        if shape is not None:
            R, p = R.reshape(shape), p.reshape(shape)
        return R, p

    return run


def make_sharded_column_rpmd(pot, params, inputs, mesh: ColumnMesh,
                             n_beads: int = 2, mass: float = 1.0,
                             dt: float = 0.1, n_steps: int = 4,
                             omega: float = 1.0):
    """(inputs, R0, p0) -> (R_n, p_n): a ring-polymer velocity-Verlet
    chunk (``columns.py:215-281``).  ``R0``/``p0`` are this rank's slab
    [n_beads, A_loc, 3] (or [n_beads, nx_loc, ny_loc, P, 3]); each bead's
    potential force is one slab evaluation, and the spring force ``-m w^2 (2 R_b - R_{b-1} -
    R_{b+1})`` couples neighbouring beads of the ring."""
    pot = _place(pot, params, mesh)

    def run(ins, R0, p0):
        R, shape = _flat(R0, 1)
        p, _ = _flat(p0, 1)
        force, amask = _slab_force(pot, ins, mesh)

        def spring(R_):
            if n_beads == 1:
                return torch.zeros_like(R_)
            up = torch.roll(R_, -1, 0)
            dn = torch.roll(R_, 1, 0)
            return -mass * omega * omega * (2.0 * R_ - up - dn) * amask

        def total(R_):
            # the forces are masked already: amask is 0 or 1
            return torch.stack([force(R_[b]) for b in range(n_beads)]) \
                + spring(R_)

        R, p = _verlet(total, R, p, dt, mass, n_steps)
        if shape is not None:
            R, p = R.reshape(shape), p.reshape(shape)
        return R, p

    return run


#: int64 words a block of noise draws may hold (each of the hash's
#: temporaries is one such tensor)
NOISE_BLOCK = 1 << 24


def column_noise(key: torch.Tensor, half_steps, n_cols: int, Pcap: int,
                 col0: int = 0, cols=None) -> torch.Tensor:
    """The Langevin noise [len(half_steps), n_cols * Pcap, 3] of the chunk
    key ``key`` for the global columns [col0, col0 + n_cols), or for the
    ids ``cols`` [n_cols] (an (x, y) block's): for half-step h and column
    c, ``normal(fold_in(fold_in(key, h), c), (Pcap, 3))``
    (``columns.py:339-367``)."""
    h = torch.as_tensor(half_steps, dtype=torch.int64, device=key.device)
    if cols is None:
        cols = torch.arange(col0, col0 + n_cols, dtype=torch.int64,
                            device=key.device)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=key.device)
    keys = prng.fold_in(prng.fold_in(key, h)[:, None, :], cols[None, :])
    return prng.normal(keys, Pcap * 3).reshape(len(h), n_cols * Pcap, 3)


def make_sharded_column_chunk(pot, params, mesh: ColumnMesh, dt: float,
                              n_steps: int, gamma=None, kT=None):
    """(inputs, R, p, m, key) -> (R, p) after ``n_steps`` velocity-Verlet
    steps on the slab path (``columns.py:288-385``; a mass of 0, at the
    padded slots, keeps a slot still).  With ``gamma`` and ``kT`` each
    step is wrapped in Ornstein-Uhlenbeck half-steps ``p <- c1 p + c2 sig
    xi`` (c1 = exp(-gamma dt / 2), c2 = sqrt(1 - c1^2), sig = sqrt(m kT),
    0 at padded slots), with xi ``column_noise`` of ``key`` (a
    ``md/prng.py`` key) at half-steps 2 s and 2 s + 1 for this rank's
    global columns, so that the split never changes a column's noise; NVE
    takes no key.  ``R``, ``p``, ``m`` are this rank's slab, flat."""
    nvt = gamma is not None and kT is not None
    if nvt:
        c1 = float(np.exp(-0.5 * gamma * dt))
        c2 = float(np.sqrt(max(0.0, 1.0 - c1 * c1)))
    pot = _place(pot, params, mesh)

    def run(ins, R, p, m, key=None):
        force, _ = _slab_force(pot, ins, mesh)
        minv = torch.where(m > 0, 1.0 / m.clamp(min=1e-30),
                           torch.zeros_like(m))[:, None]
        if nvt:
            if key is None:
                raise ValueError("the Langevin chunk takes a key")
            key = key.to(R.device)
            nx, ny = ins[P.cell_qcol].shape[:2]
            Pcap = R.shape[0] // (nx * ny)
            cols = _global_columns(mesh, nx, ny, R.device)
            sig = torch.sqrt(torch.clamp(m * kT, min=0.0))[:, None]
            # the steps whose noise one block draws at once
            block = max(1, NOISE_BLOCK // (6 * R.shape[0]))

        with torch.no_grad():
            f = force(R)
            for step in range(n_steps):
                if nvt:
                    if step % block == 0:
                        last = min(step + block, n_steps)
                        xi = column_noise(key, range(2 * step, 2 * last),
                                          nx * ny, Pcap, cols=cols)
                    h = 2 * (step % block)
                    p = c1 * p + c2 * sig * xi[h]
                p1 = p + 0.5 * dt * f
                R = R + dt * p1 * minv
                f = force(R)
                p = p1 + 0.5 * dt * f
                if nvt:
                    p = c1 * p + c2 * sig * xi[h + 1]
        return R, p

    return run


def _pad8(v) -> int:
    return int(-(-int(v) // 8) * 8)


class SpatialColumnSimulator:
    """NVE or Langevin MD on the slab path with a host re-bin at every
    chunk boundary (``columns.py:388-499``): inside a chunk each rank's
    positions and momenta stay on its device in sorted column order; at
    its end the ranks all-gather them to the host, every rank re-bins the
    whole box into columns (the same layout on every rank) and keeps its
    slab, and the layout's capacities stay sticky (pinned at the first
    build with headroom, reset only when they no longer fit).  Every rank
    of the mesh builds one and calls ``simulate`` together; ``R`` and
    ``p`` hold the whole box on each.  With ``kT`` and
    ``gamma`` the chunks are Langevin chunks; each takes the second half
    of ``split(self.key)`` (the key of ``seed`` at first), as JAX's does.

    Model units throughout (positions, energies, ``masses``, ``dt``,
    ``kT``, ``gamma`` per time unit).
    ``host_seconds`` sums the wall time of the re-bins (layout and inputs),
    ``chunk_ms`` lists each chunk's CUDA-event time (on a CUDA mesh)."""

    def __init__(self, pot, params, R, Z, masses, cell, mesh: ColumnMesh,
                 cutoff: float, skin: float = 0.6, dims=None,
                 dt: float = 0.5, kT=None, gamma=None, seed: int = 0,
                 dtype=torch.float32):
        self.pot, self.params = pot, params
        self.R = np.asarray(R, np.float64)
        self.p = np.zeros_like(self.R)
        self.Z = np.asarray(Z, np.int64)
        self.masses = np.asarray(masses, np.float64)
        self.cell = np.asarray(cell, np.float64)
        self.mesh = mesh
        self.cutoff, self.skin = float(cutoff), float(skin)
        self.dt = float(dt)
        self.kT, self.gamma = kT, gamma
        self.key = prng.prng_key(seed)
        self.dtype = dtype
        self.rebuilds = 0
        self.host_seconds = 0.0
        self.chunk_ms = []
        self._C = None
        self._K = None
        self._chunks = {}
        if dims is None:
            # the autotuned grid, nx (ny) cut to a multiple of px (py)
            lay0 = build_column_layout(self.R, self.cutoff + self.skin,
                                       self.cell, np.ones(3, bool))
            nx0, ny0 = lay0.qcol.shape[:2]
            px = mesh.shape[0]
            py = mesh.shape[1] if mesh.two_d else 1
            dims = (max(nx0 // px, 1) * px, max(ny0 // py, 1) * py, 1)
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
                self.pot, self.params, self.mesh, self.dt, n_steps,
                gamma=self.gamma, kT=self.kT)
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
                                   mesh=self.mesh)
            order, rank = lay.order, lay.rank
            smask = (lay.slot_mask > 0)

            def t(a):
                return torch.as_tensor(slab_of(lay, self.mesh, a),
                                       dtype=self.dtype, device=dev)

            R_s = t(self.R[order] * smask[:, None])
            p_s = t(self.p[order] * smask[:, None])
            m_s = t(self.masses[order] * smask)
            fn = self._chunk_fn(n)
            self.key, sub = prng.split(self.key)
            sub = sub.to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.host_seconds += time.perf_counter() - t0
            timed = dev.type == "cuda"
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            Rn, pn = fn(inputs, R_s, p_s, m_s, sub)
            if timed:
                end.record()
                end.synchronize()
                self.chunk_ms.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            Rn, pn = (gather_slabs(lay, self.mesh, a) for a in (Rn, pn))
            self.R = Rn.double().cpu().numpy()[rank]
            self.p = pn.double().cpu().numpy()[rank]
            self.host_seconds += time.perf_counter() - t0
            left -= n
        return self.R, self.p
