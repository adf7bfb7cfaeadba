"""PyTorch port, the LAMMPS model server on the CPU against the JAX
package's (``schnetpack_tpu/interfaces/lammps/server.py``), on
``tests/test_lammps_interface.py``'s 10-atom periodic box (LAMMPS types 1/2
mapped to O/H) with one SchNet-16x2 (cutoff 3 A, per-atom energies) on
both sides, the weights moved by ``convert.params_from_jax``:

* both packages' ``test_client.cpp`` compile with g++, and each client
  gets from each server the same energy (1e-5 relative), per-atom energy
  sum, forces (within 1e-4 of the largest |F|) and virial (within 1e-4 of
  its largest entry);
* the port's server and the JAX server through the Python wire client
  (``ModelClient``): per-atom energies and the virial as above;
* the virial's trace against a float64 central difference of the port
  model's energy under isotropic strain (within 1e-4 of the virial's
  largest entry);
* a two-rank partial request against the single-domain reply (forces
  within 1e-6 eV/A, energy shares and virial shares summing to it);
* shutdown: the serving thread ends and removes its socket;
* the port's pair style compiles against its stub headers
  (``-fsyntax-only``).

Sockets live under a short ``tempfile.mkdtemp()`` (an ``AF_UNIX`` path
holds at most 107 bytes).
"""
import copy
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.interfaces.lammps.server import (
    LammpsModelServer as JServer,
)
from schnetpack_tpu_torch.interfaces.lammps.server import (
    LammpsModelServer, ModelClient,
)
from schnetpack_tpu_torch.transform.neighborlist import (
    NeighborListTransform,
)

from test_torch_port_interfaces import E_RTOL, F_SCALE_TOL, models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMMPS_DIRS = {
    "jax": os.path.join(ROOT, "schnetpack_tpu", "interfaces", "lammps"),
    "port": os.path.join(ROOT, "schnetpack_tpu_torch", "interfaces",
                         "lammps"),
}
CUTOFF = 3.0
VIRIAL_SCALE_TOL = 1e-4   # of the virial's largest entry
PARTIAL_ATOL = 1e-6       # eV/A, two ranks vs one domain


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sockdir():
    d = tempfile.mkdtemp(prefix="spk")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    out = {}
    for name, src in LAMMPS_DIRS.items():
        exe = str(tmp_path_factory.mktemp("bin") / f"test_client_{name}")
        subprocess.run(
            ["g++", "-O2", "-std=c++17", os.path.join(src, "test_client.cpp"),
             os.path.join(src, "spk_client.cpp"), "-I", src, "-o", exe],
            check=True, capture_output=True, timeout=120)
        out[name] = exe
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(4)
    n, L = 10, 6.5
    R = rng.uniform(0, L, size=(n, 3))
    cell = np.eye(3) * L
    types = rng.randint(1, 3, n)
    Z = np.array([{1: 8, 2: 1}[t] for t in types])
    _, jpot, tree, pot = models("schnet", per_atom=True, cutoff=CUTOFF)
    return jpot, tree, pot, R, cell, types, Z


def edges(R, cell):
    """The periodic edge list of the box (the pair style's convention)."""
    s = NeighborListTransform(CUTOFF)({
        P.Z: np.ones(len(R), int), P.R: R, P.cell: cell,
        P.pbc: np.ones(3, bool)})
    return s[P.idx_i], s[P.idx_j], s[P.offsets]


def serve(server, sock):
    """``server`` on ``sock`` in a thread until a shutdown request."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    return t


def stop(sock, thread):
    ModelClient(sock).shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive() and not os.path.exists(sock)


def servers(setup, sockdir, tag):
    jpot, tree, pot, *_ = setup
    kw = dict(cutoff=CUTOFF, per_atom_energy_key="energy_per_atom",
              atom_bucket=16, pair_bucket=256)
    socks = {k: os.path.join(sockdir, f"{tag}_{k}.sock")
             for k in ("port", "jax")}
    made = {"port": LammpsModelServer(copy.deepcopy(pot), None,
                                      socket_path=socks["port"],
                                      device="cpu", **kw),
            "jax": JServer(jpot, tree, socket_path=socks["jax"], **kw)}
    return made, socks, {k: serve(made[k], socks[k]) for k in made}


def client_eval(exe, sock, R, cell, types):
    stdin = [f"{len(R)} 2 {CUTOFF}",
             " ".join(f"{v:.17g}" for v in np.asarray(cell).ravel()), "8 1"]
    stdin += [f"{t} {r[0]:.17g} {r[1]:.17g} {r[2]:.17g}"
              for t, r in zip(types, R)]
    proc = subprocess.run([exe, sock], input="\n".join(stdin), text=True,
                          capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    vals = {line.split()[0]: line for line in lines}
    forces = np.array([[float(x) for x in line.split()[2:5]]
                       for line in lines if line.startswith("force")])
    return (float(vals["energy"].split()[1]),
            float(vals["energy_atom_sum"].split()[1]), forces,
            np.array([float(x) for x in vals["virial"].split()[1:]]
                     ).reshape(3, 3))


def close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_both_clients_get_the_jax_servers_answer(clients, setup, sockdir):
    *_, R, cell, types, Z = setup
    _, socks, threads = servers(setup, sockdir, "cli")
    try:
        res = {(c, s): client_eval(exe, socks[s], R, cell, types)
               for c, exe in clients.items() for s in socks}
    finally:
        for s in socks:
            stop(socks[s], threads[s])
    want = res[("jax", "jax")]
    for key, got in res.items():
        assert got[0] == pytest.approx(want[0], rel=E_RTOL), key
        assert got[1] == pytest.approx(want[0], rel=E_RTOL), key
        close(got[2], want[2], F_SCALE_TOL)
        close(got[3], want[3], VIRIAL_SCALE_TOL)


def test_wire_replies_and_virial_match_jax(setup, sockdir):
    *_, pot, R, cell, types, Z = setup
    ii, jj, off = edges(R, cell)
    made, socks, threads = servers(setup, sockdir, "wire")
    try:
        res = {}
        for k, sock in socks.items():
            c = ModelClient(sock)
            res[k] = c.evaluate(Z, R, cell, ii, jj, off)
            c.close()
    finally:
        for s in socks:
            stop(socks[s], threads[s])
    (E, e_atom, F, W), (jE, je, jF, jW) = res["port"], res["jax"]
    assert E == pytest.approx(jE, rel=E_RTOL)
    close(e_atom, je, F_SCALE_TOL)
    assert e_atom.sum() == pytest.approx(E, rel=E_RTOL)
    close(F, jF, F_SCALE_TOL)
    close(W, jW, VIRIAL_SCALE_TOL)

    # the trace against a float64 central difference of the strained
    # energy of the same weights (edges and images fixed)
    p64 = copy.deepcopy(pot).double().requires_grad_(False)
    n = len(R)

    def energy(lam):
        s = 1.0 + lam
        t = torch.as_tensor
        out = p64.energy_outputs({
            P.Z: t(Z), P.R: t(R * s), P.idx_m: t(np.zeros(n, np.int64)),
            P.atom_mask: t(np.ones(n)), P.n_atoms: t([n]),
            P.idx_i: t(ii), P.idx_j: t(jj), P.offsets: t(off * s),
            P.pair_mask: t(np.ones(len(ii))), P.cell: t(cell[None] * s)})
        return float(out["energy"][0])

    h = 1e-4
    dE = (energy(h) - energy(-h)) / (2 * h)
    assert abs(np.trace(W) + dE) <= VIRIAL_SCALE_TOL * np.abs(W).max()


def test_two_rank_partial_equals_one_domain(setup, sockdir):
    *_, pot, R, cell, types, Z = setup
    n, L = len(R), cell[0, 0]
    ii, jj, off = edges(R, cell)
    sock = os.path.join(sockdir, "ranks.sock")
    server = LammpsModelServer(
        copy.deepcopy(pot), cutoff=CUTOFF, socket_path=sock,
        per_atom_energy_key="energy_per_atom", atom_bucket=16,
        pair_bucket=256, device="cpu")
    thread = serve(server, sock)
    try:
        one = ModelClient(sock)
        E, e_atom, F, W = one.evaluate(Z, R, cell, ii, jj, off)
        one.close()
        owner = (R[:, 0] >= L / 2).astype(int)
        results = {}

        def rank(r):
            local = np.nonzero(owner == r)[0]
            sel = np.isin(ii, local)
            c = ModelClient(sock)
            results[r] = (local, c.evaluate_partial(
                r, 2, n, local, Z[local], R[local], cell, ii[sel], jj[sel],
                R[jj[sel]] + off[sel]))
            c.close()
        ranks = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
        for t in ranks:
            t.start()
        for t in ranks:
            t.join(timeout=120)
    finally:
        stop(sock, thread)
    assert set(results) == {0, 1}
    F2 = np.zeros_like(F)
    for local, (e_share, ea, f, w) in results.values():
        F2[local] = f
        np.testing.assert_allclose(w, W / 2, rtol=0, atol=PARTIAL_ATOL)
        assert e_share == pytest.approx(ea.sum())
    np.testing.assert_allclose(F2, F, rtol=0, atol=PARTIAL_ATOL)
    assert sum(r[1][0] for r in results.values()) == pytest.approx(
        E, rel=E_RTOL)


def test_the_port_pair_style_compiles_against_its_stubs():
    src = LAMMPS_DIRS["port"]
    for f in ("pair_schnetpack_tpu.cpp", "spk_client.h", "spk_client.cpp",
              "test_client.cpp", "patch_lammps.sh"):
        assert os.path.exists(os.path.join(src, f)), f
    res = subprocess.run(
        ["g++", "-fsyntax-only", "-std=c++17", "-I",
         os.path.join(src, "stubs"), "-I", src,
         os.path.join(src, "pair_schnetpack_tpu.cpp")],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_server_defaults_to_the_card(setup):
    *_, pot, R, cell, types, Z = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LammpsModelServer(copy.deepcopy(pot), cutoff=CUTOFF,
                          socket_path="/nonexistent/x.sock")
