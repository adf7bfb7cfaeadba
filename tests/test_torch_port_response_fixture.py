"""PyTorch port, the response fixture ``tests/data/port_ref_response.npz``
(``scripts/make_port_reference_response.py``, the JAX package on the CPU)
checked on the CPU with the models ``chip_smoke.py``'s phase 12 builds:
its bench box is phase 4's; the seeded heads on ``train_bench``'s batch,
the seeded FieldSchNet-128x5's responses on ``field_molecules``, the
normal modes and rock salt's Ewald energy against the port at phase 12's
gates; the stress of the bench box on the 27-cell layout (the CPU twins
of K16-K19, ``slow``: 10,976 atoms).
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from schnetpack_tpu_torch import properties as TP  # noqa: E402
from schnetpack_tpu_torch.atomistic import (  # noqa: E402
    Atomwise, DipoleMoment, EnergyEwald, Forces, PairwiseDistances,
    Polarizability, Response,
)
from schnetpack_tpu_torch.data import collate, padding_for  # noqa: E402
from schnetpack_tpu_torch.md.vibrations import normal_modes  # noqa: E402
from schnetpack_tpu_torch.model import NeuralNetworkPotential  # noqa: E402
from schnetpack_tpu_torch.representation import (  # noqa: E402
    FieldSchNet, PaiNN,
)
from schnetpack_tpu_torch.train import as_tensors  # noqa: E402
from schnetpack_tpu_torch.transform import (  # noqa: E402
    NeighborListTransform,
)

REF = np.load(cs.RESPONSE_REFERENCE)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def test_fixture_box_is_phase_4s_box():
    box = np.load(cs.REFERENCE["full"])
    np.testing.assert_array_equal(REF["box_R"], box["R"])
    np.testing.assert_array_equal(REF["box_cell"], box["cell"])
    np.testing.assert_allclose(REF["box_forces"], box["forces"], rtol=0,
                               atol=1e-6)
    sigma = REF["box_stress"]
    np.testing.assert_allclose(sigma, sigma.T, rtol=0, atol=1e-12)


def _heads_potential():
    return cs.seeded(NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
              cutoff=cs.CUTOFF),
        [Atomwise(128), DipoleMoment(128, use_vector_representation=True),
         Polarizability(128)],
        input_modules=[PairwiseDistances(columns=False)]),
        cs.HEADS_SEED).requires_grad_(False)


def test_heads_fixture_on_the_cpu():
    pot = _heads_potential()
    samples = cs.train_samples()
    out = pot(as_tensors(collate(samples, padding_for(samples)), "cpu"))
    for k in (TP.energy, TP.dipole_moment, TP.partial_charges,
              TP.polarizability):
        assert cs.rel_err(out[k], REF[f"heads_{k}"]) <= cs.RESPONSE_RTOL, k


def test_normal_modes_fixture_on_the_cpu():
    pot = _heads_potential()
    energy = NeuralNetworkPotential(
        pot.representation, [pot.output_modules[0]],
        input_modules=[PairwiseDistances(columns=False)])
    freqs, _ = normal_modes(energy, cs.train_molecules()[0])
    df = np.abs(freqs - REF["freqs"]).max() / np.abs(REF["freqs"]).max()
    assert df <= cs.FREQ_RTOL


def test_field_fixture_on_the_cpu():
    props = list(cs.FIELD_RESPONSES)
    pot = cs.seeded(NeuralNetworkPotential(
        FieldSchNet(n_atom_basis=128, n_interactions=5, n_rbf=20,
                    cutoff=cs.CUTOFF, response_properties=props),
        [Atomwise(128), Response(response_properties=props)],
        input_modules=[PairwiseDistances(columns=False)]),
        cs.FIELD_SEED).requires_grad_(False)
    samples = [NeighborListTransform(cs.CUTOFF)(m)
               for m in cs.field_molecules()]
    out = pot(as_tensors(collate(samples, padding_for(samples)), "cpu"))
    for k in ["energy"] + props:
        assert np.isfinite(REF[f"field_{k}"]).all(), k
        assert cs.rel_err(out[k], REF[f"field_{k}"]) <= cs.RESPONSE_RTOL, k


def test_nacl_fixture_madelung_and_the_port():
    """The file's Ewald energy gives rock salt's Madelung constant, and the
    port's float64 sum on the same pairs gives the file's energy."""
    assert abs(REF["nacl_madelung"] / cs.MADELUNG_NACL - 1) <= 1e-8
    R, cell, q = cs.nacl(cs.NACL_CELLS)
    i, j, off = cs.nacl_pairs(R, cell, cs.NACL_RC)
    f64 = torch.float64
    ins = PairwiseDistances()({
        TP.R: torch.tensor(R), TP.cell: torch.tensor(cell[None]),
        TP.idx_i: torch.tensor(i), TP.idx_j: torch.tensor(j),
        TP.offsets: torch.tensor(off),
        TP.pair_mask: torch.ones(len(i), dtype=f64),
        TP.idx_m: torch.zeros(len(R), dtype=torch.long),
        TP.n_atoms: torch.tensor([len(R)]),
        TP.atom_mask: torch.ones(len(R), dtype=f64),
        TP.partial_charges: torch.tensor(q)})
    E = float(EnergyEwald(**cs.NACL_EWALD)(ins)["energy_ewald"][0])
    np.testing.assert_allclose(E, float(REF["nacl_energy"]), rtol=1e-12)


@pytest.mark.slow
def test_box_stress_on_the_27_cell_twins():
    """The trained PaiNN's stress on the bench box on the 27-cell layout
    (the CPU twins of K16-K19 and K3/K4) at phase 12's gate."""
    from schnetpack_tpu_torch.md import load_molecules

    R, cell = REF["box_R"].astype(np.float64), REF["box_cell"]
    pot, params = cs.layout_potential("painn")
    pot.load_state_dict(params)
    stress_pot = NeuralNetworkPotential(
        pot.representation, [pot.output_modules[0], Forces(calc_stress=True)],
        input_modules=[PairwiseDistances(columns=False)]).requires_grad_(False)
    system = load_molecules([cs.molecule(R, cell)], device="cpu")
    calc = cs.calculator(pot, params, layout="atom")
    out = stress_pot(calc.model_inputs(system, calc.init_state(system)))
    V = abs(np.linalg.det(cell))
    scale = (np.abs(R[:, :, None] * REF["box_forces"][:, None, :]).sum(0)
             / V).max()
    err = np.abs(out[TP.stress][0].double().numpy() - REF["box_stress"]).max()
    assert err / scale <= cs.STRESS_VIRIAL_TOL
