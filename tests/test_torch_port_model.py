"""PyTorch port, model level: PaiNN-128x3 with the trained bench asset,
energy and forces against the JAX ``NeuralNetworkPotential``.

The JAX side runs its flat pair-list layout (a layout independent of the
port's column path); the port runs the column path on the CPU (plain
twins of the kernels), in both ``fuse`` modes.
"""
import os

import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances
from schnetpack_tpu.data.loader import collate, padding_for
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.representation import PaiNN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "scripts", "assets", "bench_painn_argon.msgpack")
FIXTURE = os.path.join(ROOT, "tests", "data", "port_ref_painn_argon.npz")
CUTOFF = 5.0
# energy: f32 sums over 256 atoms in another order; forces: f32 roundoff
# of a 3-block message-passing gradient
E_RTOL = 1e-5
F_ATOL = 1e-4   # eV/Ang, max abs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fcc_box(n_cells: int, a: float = 5.26):
    """FCC argon supercell of n_cells^3 unit cells (``bench.py::fcc_box``)."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    return ((base[None] + grid) * a).reshape(-1, 3), np.eye(3) * a * n_cells


def port_potential(params=None, fuse="full"):
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20, cutoff=CUTOFF,
              fuse=fuse),
        [Atomwise(n_in=128), Forces()])
    if params is not None:
        pot.load_state_dict(params)
    return pot.requires_grad_(False)


def port_inputs(R, cell, build_cutoff):
    lay = build_column_layout(R, build_cutoff, cell, np.ones(3, bool),
                              min_grid=3)
    Rs = (R[lay.order] * lay.slot_mask[:, None]).astype(np.float32)
    inputs = {
        TP.R: torch.tensor(Rs),
        TP.Z: torch.tensor(np.where(lay.slot_mask > 0, 18, 0)),
        TP.idx_m: torch.zeros(len(lay.order), dtype=torch.int64),
        TP.atom_mask: torch.tensor(lay.slot_mask),
        TP.n_atoms: torch.tensor([len(R)]),
        TP.cell_qcol: torch.tensor(lay.qcol),
        TP.cell_dcol: torch.tensor(lay.dcol),
        TP.cell_coff_fm: torch.tensor(np.ascontiguousarray(
            np.moveaxis(lay.offcol, -1, 2)).astype(np.float32)),
        TP.cell_ksz: tuple(lay.ksizes),
    }
    return lay, inputs


def jax_energy_forces(R, cell, params):
    sample = NeighborListTransform(CUTOFF)({
        P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
        P.pbc: np.ones(3, bool)})
    batch = collate([sample], padding_for([sample]))
    pot = JNNP(
        representation=JPaiNN(n_atom_basis=128, n_interactions=3, n_rbf=20,
                              cutoff=CUTOFF),
        input_modules=[PairwiseDistances()],
        output_modules=[JAtomwise(output_key=P.energy), JForces()])
    out = pot.apply(params, batch)
    return float(np.asarray(out[P.energy])[0]), np.asarray(out[P.forces])[:len(R)]


def test_params_from_jax_covers_every_port_parameter():
    params = params_from_jax(load_jax_params(ASSET))
    pot = port_potential()
    state = pot.state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        assert v.shape == state[k].shape, k
    assert params["representation.FW_aug"].shape == (3, 21, 384)


@pytest.mark.parametrize("fuse", ["full", "hybrid"])
def test_energy_forces_match_jax_with_bench_asset(fuse):
    rng = np.random.RandomState(0)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.15, 0.15, R.shape)
    tree = load_jax_params(ASSET)
    E_ref, F_ref = jax_energy_forces(R, cell, tree)

    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    assert lay.dims[0] >= 3 and lay.dims[1] >= 3
    out = port_potential(params_from_jax(tree), fuse)(inputs)
    E = float(out[TP.energy][0])
    F = out[TP.forces].numpy()[lay.rank]
    np.testing.assert_allclose(E, E_ref, rtol=E_RTOL)
    assert np.abs(F - F_ref).max() <= F_ATOL


def test_reference_fixture_is_the_bench_box():
    """The full-size fixture (``scripts/make_port_reference.py``) holds the
    jittered 10,976-atom bench box with finite energy and forces whose net
    force vanishes (translation invariance of the reference)."""
    ref = np.load(FIXTURE)
    R0, cell = fcc_box(14)
    assert ref["R"].shape == (10976, 3) and ref["forces"].shape == (10976, 3)
    np.testing.assert_allclose(ref["cell"], cell)
    jitter = ref["R"] - R0
    assert np.abs(jitter).max() <= float(ref["jitter"]) + 1e-5
    assert np.isfinite(ref["energy"]) and np.isfinite(ref["forces"]).all()
    assert np.abs(ref["forces"].sum(0)).max() < 1e-2
