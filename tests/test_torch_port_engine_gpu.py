"""PyTorch port, the host cell list and the slab path's Langevin chunk on a
card only (skipped without CUDA).  No jax import: on a machine without
jax run ``python -m pytest --noconftest -m gpu
tests/test_torch_port_engine_gpu.py``.

* The native cell list feeds a column build on the card: its edges equal
  the numpy list's, the card's layout equals the CPU's, and the trained
  PaiNN-128x3's forces there agree with the twins' route on the CPU.
* A Langevin chunk of the slab path on the card: its noise equals the
  CPU's within 1e-6, a gamma = 0 chunk equals the NVE chunk bit for bit,
  K20/K21/K3/K4 run 3 times an evaluation, and the trajectory agrees with
  the same chunk on the CPU.
"""
import os

import numpy as np
import pytest
import torch

from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.md import CellBlockNeighborListMD, load_molecules
from schnetpack_tpu_torch.md import prng
from schnetpack_tpu_torch.ops import colblock_edge as edge
from schnetpack_tpu_torch.ops import painn_mixing as mix
from schnetpack_tpu_torch.units import _parse_unit, md_units
from torch_port_cases import fcc_argon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
CUTOFF, SKIN = 5.0, 0.6          # Angstrom
FORCE_RMS_TOL = 1e-4             # eV/Ang, card vs the CPU twins
DRAW_TOL = 1e-6
# 10 Langevin steps on the card against the CPU twins (Angstrom, and
# momenta in amu Angstrom per 10.18 fs)
MD_TOL = 1e-4
DT = 0.5 / 10.180505
KB_EV = 8.617333262e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def painn(slab=False):
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
    from schnetpack_tpu_torch.model import NeuralNetworkPotential
    from schnetpack_tpu_torch.representation import PaiNN

    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF,
              fuse="full"), [Atomwise(n_in=128), Forces()],
        input_modules=[PairwiseDistances()] if slab else [])
    params = params_from_jax(load_jax_params(ASSET))
    pot.load_state_dict(params)
    return pot, params


@pytest.mark.gpu
def test_native_list_feeds_a_cuda_column_build(cuda_device):
    from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
    from schnetpack_tpu_torch.transform.neighborlist import (
        cell_list_neighbor_list, cell_list_numpy,
    )

    R, cell = fcc_argon(6, jitter=0.1, seed=3)
    pbc = np.ones(3, bool)
    for a, b in zip(cell_list_neighbor_list(R, CUTOFF + SKIN, cell, pbc),
                    cell_list_numpy(R, CUTOFF + SKIN, cell, pbc)):
        np.testing.assert_array_equal(a, b)
    mol = {TP.Z: np.full(len(R), 18, np.int64), TP.R: R, TP.cell: cell,
           TP.pbc: pbc}
    conv = _parse_unit("Ang") * md_units().length
    out, states = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        pot, params = painn()
        nbl = CellBlockNeighborListMD(CUTOFF * conv, skin=SKIN * conv)
        calc = SchNetPackCalculator(pot, params, cutoff=CUTOFF,
                                    cutoff_shell=SKIN, neighbor_list=nbl)
        system = load_molecules([mol], device=dev)
        states[dev.type] = calc.init_state(system)
        out[dev.type] = (calc.calculate(system, states[dev.type]).forces[0]
                         / calc.force_conversion).cpu().double()
    for k in (TP.cell_qcol, TP.cell_dcol, "cell_order"):
        assert torch.equal(states["cuda"][k].cpu(), states["cpu"][k]), k
    rms = float((out["cuda"] - out["cpu"]).pow(2).mean().sqrt())
    assert rms <= FORCE_RMS_TOL, rms
    assert float(out["cpu"].abs().max()) > 1e-2


def _slab_start(dev):
    from schnetpack_tpu_torch.ops.cellblock import build_column_layout
    from schnetpack_tpu_torch.parallel import column_inputs, make_column_mesh

    R, cell = fcc_argon(4, jitter=0.1, seed=7)
    lay = build_column_layout(R, CUTOFF + SKIN, cell, np.ones(3, bool),
                              dims=(3, 3, 1))
    m = lay.slot_mask > 0
    p = np.random.RandomState(2).randn(len(R), 3) * np.sqrt(
        39.948 * KB_EV * 30.0)
    inputs = column_inputs(lay, R, np.full(len(R), 18), device=dev)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    start = (t(R[lay.order] * m[:, None]), t(p[lay.order] * m[:, None]),
             t(np.full(len(R), 39.948)[lay.order] * m))
    return lay, inputs, start, make_column_mesh(1, device=dev)


@pytest.mark.gpu
def test_langevin_slab_chunk_on_the_card(cuda_device):
    from schnetpack_tpu_torch.parallel import (
        column_noise, make_sharded_column_chunk,
    )

    kT, gamma, n = KB_EV * 30.0, 0.509, 10
    key = prng.split(prng.prng_key(5))[1]
    lay, inputs, start, mesh = _slab_start(cuda_device)
    nx, ny, Pcap, _ = lay.dims
    draws = [column_noise(key.to(d), range(2 * n), nx * ny, Pcap).cpu()
             for d in (cuda_device, "cpu")]
    assert float((draws[0] - draws[1]).abs().max()) <= DRAW_TOL
    pot, _ = painn(slab=True)
    nve = make_sharded_column_chunk(pot, None, mesh, DT, n)
    zero = make_sharded_column_chunk(pot, None, mesh, DT, n, gamma=0.0, kT=kT)
    a, b = nve(inputs, *start), zero(inputs, *start, key)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    lgv = make_sharded_column_chunk(pot, None, mesh, DT, n, gamma=gamma,
                                    kT=kT)
    before = {**edge.LAUNCHES, **mix.LAUNCHES}
    R_c, p_c = lgv(inputs, *start, key)
    torch.cuda.synchronize()
    after = {**edge.LAUNCHES, **mix.LAUNCHES}
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran == {k: 3 * (n + 1) for k in (
        "msg_fwd_edge", "msg_bwd_edge", "mix_fwd", "mix_bwd")}, ran
    assert not torch.equal(p_c, a[1])
    _, inputs_c, start_c, mesh_c = _slab_start(torch.device("cpu"))
    pot_c, _ = painn(slab=True)
    R_h, p_h = make_sharded_column_chunk(pot_c, None, mesh_c, DT, n,
                                         gamma=gamma, kT=kT)(
        inputs_c, *start_c, key)
    np.testing.assert_allclose(R_c.cpu().numpy(), R_h.numpy(), 0, MD_TOL)
    np.testing.assert_allclose(p_c.cpu().numpy(), p_h.numpy(), 0, MD_TOL)
