"""PyTorch port, the interfaces on a card only (skipped without CUDA): the
trained PaiNN-128x3 (``scripts/assets/bench_painn_argon.msgpack``) from a
run directory, through ``utils.load_model`` onto the card, on a jittered
2,048-atom FCC argon box:

* ``SpkCalculator`` on the card against the same calculator on the CPU
  (forces within 1e-5 eV/A rms, energy 1e-5 relative), its cache, and no
  kernel launch (the flat layout runs none);
* ``LammpsModelServer`` on the card through the Python wire client: the
  forces within 1e-5 eV/A rms of the card's ``SpkCalculator``, a two-rank
  partial request equal to the single domain within 1e-6 eV/A, shutdown;
* ``deploy(export_program=True)`` exported on the card: the program's
  forces within 1e-6 of the eager model's largest |F| at the example
  batch.

No jax import: on a machine without jax run
``python -m pytest --noconftest -m gpu tests/test_torch_port_interfaces_gpu.py``.
"""
import copy
import os
import pickle
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from schnetpack_tpu_torch import deploy
from schnetpack_tpu_torch import properties as P
from schnetpack_tpu_torch.interfaces import SpkCalculator
from schnetpack_tpu_torch.interfaces.lammps.server import (
    LammpsModelServer, ModelClient,
)
from schnetpack_tpu_torch.ops import colblock_message as msg
from schnetpack_tpu_torch.ops import colblock_select as sel
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.transform.neighborlist import (
    NeighborListTransform,
)
from schnetpack_tpu_torch.utils import load_model

from test_torch_port_spkmd_gpu import ASSET, RUN_CONFIG, fcc_box

CUTOFF = 5.0
RMS_TOL = 1e-5            # eV/A
PARTIAL_ATOL = 1e-6       # eV/A
PROGRAM_SCALE_TOL = 1e-6  # of the largest |F|


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def run(tmp_path):
    os.makedirs(tmp_path / "run")
    with open(tmp_path / "run" / "model_config.pkl", "wb") as f:
        pickle.dump(RUN_CONFIG, f)
    shutil.copy(ASSET, tmp_path / "run" / "best_model")
    return str(tmp_path / "run")


def box():
    R, cell = fcc_box(8)
    return {P.Z: np.full(len(R), 18), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def counts():
    return sum(v for c in (msg.LAUNCHES, mix.LAUNCHES, sel.LAUNCHES)
               for v in c.values())


@pytest.mark.gpu
def test_spk_calculator_on_the_card(cuda_device, run):
    model, _ = load_model(run, device="cuda")
    cpu = SpkCalculator(copy.deepcopy(model).cpu(), cutoff=CUTOFF,
                        device="cpu")
    card = SpkCalculator(model, cutoff=CUTOFF)
    assert next(card.model.parameters()).is_cuda
    atoms = box()
    before = counts()
    got = card.calculate(atoms)
    assert counts() == before
    want = cpu.calculate(atoms)
    assert rms(got["forces"], want["forces"]) <= RMS_TOL
    assert got["energy"] == pytest.approx(want["energy"], rel=1e-5)
    card.calculate(atoms)
    assert card.n_evaluations == 1
    moved = dict(atoms, **{P.R: atoms[P.R] + 0.01})
    card.calculate(moved)
    assert card.n_evaluations == 2


def serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    for _ in range(400):
        if os.path.exists(server.socket_path):
            break
        time.sleep(0.05)
    return t


@pytest.mark.gpu
def test_lammps_server_on_the_card(cuda_device, run):
    model, _ = load_model(run, device="cuda")
    atoms = box()
    want = SpkCalculator(copy.deepcopy(model), cutoff=CUTOFF).calculate(atoms)
    s = NeighborListTransform(CUTOFF)(dict(atoms))
    ii, jj, off = s[P.idx_i], s[P.idx_j], s[P.offsets]
    Z, R, cell = atoms[P.Z], atoms[P.R], atoms[P.cell]
    sockdir = tempfile.mkdtemp(prefix="spk")
    server = LammpsModelServer(model, cutoff=CUTOFF,
                               socket_path=os.path.join(sockdir, "s.sock"))
    thread = serve(server)
    try:
        c = ModelClient(server.socket_path)
        E, e_atom, F, W = c.evaluate(Z, R, cell, ii, jj, off)
        c.close()
        assert rms(F, want["forces"]) <= RMS_TOL
        assert E == pytest.approx(want["energy"], rel=1e-5)
        owner = (R[:, 0] >= cell[0, 0] / 2).astype(int)
        parts = {}

        def rank(r):
            local = np.nonzero(owner == r)[0]
            mine = np.isin(ii, local)
            cl = ModelClient(server.socket_path)
            parts[r] = (local, cl.evaluate_partial(
                r, 2, len(R), local, Z[local], R[local], cell, ii[mine],
                jj[mine], R[jj[mine]] + off[mine]))
            cl.close()
        ts = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        F2 = np.zeros_like(F)
        for local, (_, _, f, w) in parts.values():
            F2[local] = f
            np.testing.assert_allclose(w, W / 2, rtol=0,
                                       atol=PARTIAL_ATOL * np.abs(W).max())
        np.testing.assert_allclose(F2, F, rtol=0, atol=PARTIAL_ATOL)
    finally:
        ModelClient(server.socket_path).shutdown()
        thread.join(timeout=60)
        shutil.rmtree(sockdir, ignore_errors=True)
    assert not thread.is_alive()


@pytest.mark.gpu
def test_exported_program_on_the_card(cuda_device, run, tmp_path):
    art = str(tmp_path / "model.spk")
    deploy.deploy(run, art, export_program=True)
    model, _, artifact = deploy.load_deployed(art)
    batch = deploy._example_batch(artifact["cutoff"], cuda_device)
    E, F = deploy.load_program(artifact)(batch)
    E0, F0 = deploy.energy_and_forces(model.requires_grad_(False))(batch)
    assert F.is_cuda
    scale = float(F0.abs().max())
    assert scale > 0
    assert float((F - F0).abs().max()) <= PROGRAM_SCALE_TOL * scale
