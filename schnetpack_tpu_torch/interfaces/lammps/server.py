"""Model server for the LAMMPS pair style (Unix-domain-socket protocol;
parity: ``schnetpack_tpu/interfaces/lammps/server.py``).

The model runs in a persistent server process that owns the GPU; the
LAMMPS pair style (``pair_schnetpack_tpu.cpp``, a copy of the JAX
package's) connects over a Unix socket and exchanges one request per force
call.  The wire format is the JAX package's, so this server answers the
JAX package's compiled client and the port's copy alike.

Requests carry the full periodic structure the pair style assembled from
the LAMMPS neighbor list: atomic numbers (mapped from LAMMPS types by the
``pair_coeff`` type map), positions, the triclinic cell, and the explicit
edge list with per-edge Cartesian image offsets (the reference pair
style's convention, pair_schnetpack.cpp:238-276).  The server evaluates
the potential on that edge list and returns the total energy, per-atom
energies, forces, and the virial tensor

    W_ab = -dE/d(strain)_ab = sum_i F_i (x) R_i - sum_e g_e (x) off_e

(g_e = dE/d offset_e), so LAMMPS NPT barostats see the exact many-body
stress.

Wire format (little-endian):
  request:  int64 n_atoms, int64 n_edges,
            int32 Z[n], float64 R[n*3], float64 cell[9],
            int64 idx_i[e], int64 idx_j[e], float64 offsets[e*3]
  response: int64 n_atoms, float64 energy,
            float64 e_atom[n], float64 F[n*3], float64 W[9]
  shutdown: n_atoms == -1

Multi-rank (MPI domain decomposition — replaces the reference's per-rank
TorchScript evaluation, pair_schnetpack.cpp:346-352): each LAMMPS rank
sends a PARTIAL request carrying its local atoms (with global 0-based
tags) and its local edge list (destination local to the rank; source as a
global tag plus the ghost's absolute image position).  The server gathers
all nprocs parts of a step, assembles the global structure (the union of
per-rank edge lists is exactly the full directed edge list: every
destination atom is local to one rank), evaluates the model ONCE — so the
result is exact, with no message-passing locality error at domain
boundaries — and replies to each rank with its local forces, per-atom
energies, its energy share, and a 1/nprocs virial share (LAMMPS sums
energy/virial over ranks).

  partial request: int64 -2, int64 rank, int64 nprocs, int64 n_global,
            int64 n_local, int64 n_edges,
            int64 tags[n_local], int32 Z[n_local], float64 R[n_local*3],
            float64 cell[9], int64 idx_i[e], int64 idx_j[e]  (global tags),
            float64 xj_abs[e*3]   (neighbor image's absolute position)
  partial response: int64 n_local, float64 energy_share,
            float64 e_atom[n_local], float64 F[n_local*3], float64 W[9]
"""
from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ... import properties as P
from ...data.loader import round_up


class _StepAssembly:
    """Rendezvous for one simulation step's nprocs partial requests."""

    def __init__(self, nprocs: int):
        self.nprocs = nprocs
        self.parts: Dict[int, dict] = {}
        self.result = None
        self.cond = threading.Condition()

    def add_and_wait(self, rank: int, part: dict, evaluate):
        with self.cond:
            self.parts[rank] = part
            if len(self.parts) == self.nprocs:
                self.result = evaluate(self.parts)
                self.cond.notify_all()
            else:
                self.cond.wait_for(lambda: self.result is not None,
                                   timeout=600.0)
            return self.result


class LammpsModelServer:
    """Serve ``model`` (a port ``NeuralNetworkPotential``, ``params`` its
    state dict where given), frozen on ``device``: the card unless the
    caller asks for the CPU.

    One evaluation is one call of the model's heads on the request's edge
    list (``energy_outputs``: the flat layout, no kernel) and one
    ``torch.autograd.grad`` of the energy over (R, offsets), from which
    come the forces and the virial W = -(sum gR (x) R + sum gOff (x) off)
    (``server.py:109-131``).  Each connection is served on its own thread;
    grad mode is per thread in torch, so every evaluation enables it, and
    a lock keeps one evaluation at a time (the threads share the device's
    stream).
    """

    def __init__(
        self,
        model,
        params=None,
        cutoff: float = 5.0,
        socket_path: str = "/tmp/schnetpack_tpu.sock",
        energy_key: str = "energy",
        per_atom_energy_key: Optional[str] = None,
        atom_bucket: int = 256,
        pair_bucket: int = 4096,
        device="cuda",
    ):
        from ...cli import _device

        self.device = _device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.requires_grad_(False).to(self.device)
        self.cutoff = cutoff
        self.socket_path = socket_path
        self.energy_key = energy_key
        self.per_atom_energy_key = per_atom_energy_key
        self.atom_bucket = atom_bucket
        self.pair_bucket = pair_bucket
        self._lock = threading.Lock()

    def _run(self, batch: Dict[str, torch.Tensor]):
        """(E [1], e_atom [A], F [A, 3], W [3, 3]) of a padded batch."""
        R, off = batch[P.R], batch[P.offsets]
        with torch.enable_grad():
            leaves = (R.detach().requires_grad_(True),
                      off.detach().requires_grad_(True))
            out = self.model.energy_outputs({**batch, P.R: leaves[0],
                                             P.offsets: leaves[1]})
            E = out[self.energy_key][:1]
            gR, gOff = torch.autograd.grad(E.sum(), leaves)
        F = -gR * batch[P.atom_mask][:, None]
        gOff = gOff * batch[P.pair_mask][:, None]
        W = -(gR.t() @ R + gOff.t() @ off)
        if self.per_atom_energy_key:
            e_atom = out[self.per_atom_energy_key]
            e_atom = e_atom[:, 0] if e_atom.ndim == 2 else e_atom
        else:
            e_atom = torch.zeros_like(batch[P.atom_mask])
        return E.detach(), e_atom.detach(), F, W

    def evaluate(self, Z, R, cell, idx_i, idx_j, offsets):
        n = len(Z)
        e = len(idx_i)
        nA = round_up(n + 1, self.atom_bucket)
        nE = round_up(max(e, 1), self.pair_bucket)
        dt = np.float32
        batch = {
            P.Z: np.zeros(nA, np.int32),
            P.R: np.zeros((nA, 3), dt),
            P.cell: np.zeros((2, 3, 3), dt),
            P.pbc: np.zeros((2, 3), bool),
            P.idx_m: np.concatenate([np.zeros(n, np.int32),
                                     np.ones(nA - n, np.int32)]),
            P.idx_i: np.zeros(nE, np.int32),
            P.idx_j: np.zeros(nE, np.int32),
            P.offsets: np.zeros((nE, 3), dt),
            P.pair_mask: np.zeros(nE, dt),
            P.atom_mask: np.concatenate([np.ones(n, dt), np.zeros(nA - n, dt)]),
            P.n_atoms: np.array([n, nA - n]),
            P.mol_mask: np.array([1.0, 0.0], dt),
        }
        batch[P.Z][:n] = Z
        batch[P.R][:n] = R
        batch[P.cell][0] = cell
        batch[P.pbc][0] = True
        batch[P.idx_i][:e] = idx_i
        batch[P.idx_j][:e] = idx_j
        # padded pairs point at the padding atom far from everything
        batch[P.idx_i][e:] = nA - 1
        batch[P.idx_j][e:] = nA - 1
        batch[P.offsets][:e] = offsets
        batch[P.offsets][e:] = 1e3
        batch[P.pair_mask][:e] = 1.0
        batch[P.R][n:] = 5e4

        with self._lock:
            E, e_atom, F, W = self._run({
                k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()})
            E = float(E[0])
            e_atom = e_atom.double().cpu().numpy()[:n]
            F = F.double().cpu().numpy()[:n]
            W = W.double().cpu().numpy()
        if not self.per_atom_energy_key:
            e_atom = np.full(n, E / n, np.float64)
        return E, e_atom, F, W

    # ------------------------------------------------------------------
    def _evaluate_global(self, parts: Dict[int, dict]):
        """Assemble the nprocs partial structures, evaluate once, split
        the reply per rank."""
        any_part = next(iter(parts.values()))
        n_global = any_part["n_global"]
        Z = np.zeros(n_global, np.int32)
        R = np.zeros((n_global, 3), np.float64)
        for p in parts.values():
            Z[p["tags"]] = p["Z"]
            R[p["tags"]] = p["R"]
        ii = np.concatenate([p["idx_i"] for p in parts.values()])
        jj = np.concatenate([p["idx_j"] for p in parts.values()])
        # per-edge image offset from the neighbor's ABSOLUTE ghost
        # position (only the server knows the owning rank's wrapped
        # position of a remote neighbor)
        xj = np.concatenate([p["xj_abs"] for p in parts.values()])
        off = xj.reshape(-1, 3) - R[jj]
        E, e_atom, F, W = self.evaluate(Z, R, any_part["cell"], ii, jj, off)
        out = {}
        for rank, p in parts.items():
            t = p["tags"]
            e_loc = e_atom[t]
            out[rank] = (float(e_loc.sum()), e_loc, F[t], W / len(parts))
        return out

    def _get_assembly(self, nprocs: int) -> _StepAssembly:
        with self._alock:
            if self._assembly is None or self._assembly.result is not None:
                self._assembly = _StepAssembly(nprocs)
            return self._assembly

    # ------------------------------------------------------------------
    def serve_forever(self, max_requests: Optional[int] = None):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.socket_path)
        srv.listen(16)
        srv.settimeout(0.25)
        self._alock = threading.Lock()
        self._assembly = None
        self._served = 0
        self._stop = threading.Event()
        threads = []
        try:
            while not self._stop.is_set() and (
                max_requests is None or self._served < max_requests
            ):
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                t = threading.Thread(
                    target=self._handle_conn, args=(conn, max_requests),
                    daemon=True,
                )
                t.start()
                threads.append(t)
            for t in threads:
                t.join(timeout=60.0)
        finally:
            srv.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def _handle_conn(self, conn: socket.socket, max_requests: Optional[int]):
        try:
            while not self._stop.is_set():
                header = _recv_exact(conn, 16)
                if header is None:
                    break
                n, e = struct.unpack("<qq", header)
                if n == -1:
                    self._stop.set()
                    break
                if n == -2:
                    # partial (multi-rank) request; header's second field
                    # is the rank, the rest follows
                    self._handle_partial(conn, rank=e)
                else:
                    self._handle_single(conn, n, e)
                self._served += 1
                if max_requests is not None and self._served >= max_requests:
                    self._stop.set()
                    break
        finally:
            conn.close()

    def _handle_single(self, conn, n, e):
        Z = np.frombuffer(_recv_exact(conn, 4 * n), "<i4")
        R = np.frombuffer(_recv_exact(conn, 24 * n), "<f8").reshape(n, 3)
        cell = np.frombuffer(_recv_exact(conn, 72), "<f8").reshape(3, 3)
        ii = np.frombuffer(_recv_exact(conn, 8 * e), "<i8")
        jj = np.frombuffer(_recv_exact(conn, 8 * e), "<i8")
        off = np.frombuffer(_recv_exact(conn, 24 * e), "<f8").reshape(e, 3)
        E, e_atom, F, W = self.evaluate(Z, R, cell, ii, jj, off)
        conn.sendall(struct.pack("<q", n))
        conn.sendall(struct.pack("<d", E))
        conn.sendall(e_atom.astype("<f8").tobytes())
        conn.sendall(F.astype("<f8").tobytes())
        conn.sendall(W.astype("<f8").tobytes())

    def _handle_partial(self, conn, rank: int):
        nprocs, n_global, n, e = struct.unpack("<qqqq", _recv_exact(conn, 32))
        part = {
            "n_global": n_global,
            "tags": np.frombuffer(_recv_exact(conn, 8 * n), "<i8"),
            "Z": np.frombuffer(_recv_exact(conn, 4 * n), "<i4"),
            "R": np.frombuffer(_recv_exact(conn, 24 * n), "<f8").reshape(n, 3),
            "cell": np.frombuffer(_recv_exact(conn, 72), "<f8").reshape(3, 3),
            "idx_i": np.frombuffer(_recv_exact(conn, 8 * e), "<i8"),
            "idx_j": np.frombuffer(_recv_exact(conn, 8 * e), "<i8"),
            "xj_abs": np.frombuffer(_recv_exact(conn, 24 * e), "<f8"),
        }
        result = self._get_assembly(nprocs).add_and_wait(
            rank, part, self._evaluate_global)
        if result is None:
            raise RuntimeError("partial-step assembly timed out")
        e_share, e_atom, F, W = result[rank]
        conn.sendall(struct.pack("<q", n))
        conn.sendall(struct.pack("<d", e_share))
        conn.sendall(e_atom.astype("<f8").tobytes())
        conn.sendall(F.astype("<f8").tobytes())
        conn.sendall(W.astype("<f8").tobytes())


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytearray]:
    """``n`` bytes of ``conn`` read into one buffer; None where the peer
    closed first."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class ModelClient:
    """The wire format's client side in Python (a twin of
    ``spk_client.cpp``'s ``ModelClient``): one connection, reused for
    every request, as the pair style reuses its own."""

    def __init__(self, socket_path: str):
        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.connect(socket_path)

    def _reply(self, n: int):
        """(energy, e_atom [n], F [n, 3], W [3, 3]) of one response."""
        head = _recv_exact(self.conn, 16)
        if head is None:
            raise ConnectionError("the server closed the connection")
        n_back, energy = struct.unpack("<qd", head)
        if n_back != n:
            raise ConnectionError(f"the server answered for {n_back} atoms, "
                                  f"not {n}")
        body = np.frombuffer(_recv_exact(self.conn, 8 * (4 * n + 9)), "<f8")
        return (energy, body[:n].copy(), body[n:4 * n].reshape(n, 3).copy(),
                body[4 * n:].reshape(3, 3).copy())

    def evaluate(self, Z, R, cell, idx_i, idx_j, offsets):
        """One single-structure request (see the module's docstring)."""
        n, e = len(Z), len(idx_i)
        self.conn.sendall(b"".join([
            struct.pack("<qq", n, e), np.asarray(Z, "<i4").tobytes(),
            np.asarray(R, "<f8").tobytes(), np.asarray(cell, "<f8").tobytes(),
            np.asarray(idx_i, "<i8").tobytes(),
            np.asarray(idx_j, "<i8").tobytes(),
            np.asarray(offsets, "<f8").tobytes()]))
        return self._reply(n)

    def evaluate_partial(self, rank, nprocs, n_global, tags, Z, R, cell,
                         idx_i, idx_j, xj_abs):
        """One rank's partial request: (energy share, e_atom, F, W
        share) of its local atoms."""
        n, e = len(tags), len(idx_i)
        self.conn.sendall(b"".join([
            struct.pack("<qq", -2, rank),
            struct.pack("<qqqq", nprocs, n_global, n, e),
            np.asarray(tags, "<i8").tobytes(), np.asarray(Z, "<i4").tobytes(),
            np.asarray(R, "<f8").tobytes(), np.asarray(cell, "<f8").tobytes(),
            np.asarray(idx_i, "<i8").tobytes(),
            np.asarray(idx_j, "<i8").tobytes(),
            np.asarray(xj_abs, "<f8").tobytes()]))
        return self._reply(n)

    def shutdown(self):
        """Ask the server to stop (``n_atoms == -1``)."""
        self.conn.sendall(struct.pack("<qq", -1, 0))
        self.close()

    def close(self):
        self.conn.close()


def main(argv=None):
    """CLI: python -m schnetpack_tpu_torch.interfaces.lammps.server \\
    model_dir=<run dir or deployed artifact> socket=/tmp/spk.sock \\
    cutoff=5.0 [per_atom_energy_key=energy_per_atom] [device=cuda]"""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv)
    from ...utils import load_model

    device = kv.get("device", "cuda")
    model, _ = load_model(kv["model_dir"], device)
    server = LammpsModelServer(
        model,
        cutoff=float(kv.get("cutoff", 5.0)),
        socket_path=kv.get("socket", "/tmp/schnetpack_tpu.sock"),
        per_atom_energy_key=kv.get("per_atom_energy_key"),
        device=device,
    )
    print(f"serving on {server.socket_path}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
