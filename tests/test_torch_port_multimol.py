"""PyTorch port, batched molecules on the column layout against the JAX
package (``tests/test_md_multimol.py``'s molecules and PaiNN-32x2, the
weights carried over by ``convert.params_from_jax``).

Each non-periodic molecule gets its own x-slab of one open domain
(``CellBlockNeighborListMD._batched_molecules``): the layout (slot order,
source and destination rows, offsets) equals the JAX list's, also for two
replicas (the union over beads); the column calculator's forces and
per-molecule energies match the JAX column calculator (rtol 2e-4, atol
2e-5, as ``test_md_multimol.py:70-91``) and the port's own ``all_pairs``
calculator; 40 MD steps stay finite, rebuilding on the host only; batched
periodic boxes raise with the JAX message.
"""
import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.neighborlist_md import (
    CellBlockNeighborListMD as JCellBlockNBL,
)
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import params_from_jax
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, MaxwellBoltzmannInit, Simulator, VelocityVerlet,
    load_molecules,
)
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.representation import PaiNN
from schnetpack_tpu_torch.units import _parse_unit, md_units

from test_md_multimol import CUTOFF, _mols, _potential

SHELL = 0.5             # Angstrom
F_RTOL, F_ATOL = 2e-4, 2e-5
E_RTOL, E_ATOL = 1e-4, 1e-5
CONV = _parse_unit("Ang") * md_units().length
LAYOUT_KEYS = ("qcol", "dcol", "offcol", "order", "slot_mask")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model():
    return _potential()


def port_model(params):
    pot = NeuralNetworkPotential(
        PaiNN(n_atom_basis=32, n_interactions=2, n_rbf=8, cutoff=CUTOFF,
              fuse="full"),
        [Atomwise(n_in=32), Forces()], input_modules=[PairwiseDistances()])
    pot.load_state_dict(params_from_jax(params))
    return pot.requires_grad_(False)


def port_calc(params, neighbor_list="cellblock"):
    if neighbor_list == "cellblock":
        neighbor_list = CellBlockNeighborListMD(CUTOFF * CONV,
                                                skin=SHELL * CONV)
    return SchNetPackCalculator(port_model(params), None, cutoff=CUTOFF,
                                cutoff_shell=SHELL,
                                neighbor_list=neighbor_list)


def _replicas(system, jsystem, n_rep):
    d = np.random.RandomState(4).uniform(
        -0.05, 0.05, (n_rep,) + tuple(system.positions.shape[1:])) * CONV
    return (system.replace(positions=system.positions + torch.tensor(
                d, dtype=torch.float32)),
            jsystem.replace(positions=jsystem.positions + d.astype(
                np.float32)))


@pytest.mark.parametrize("n_rep", [1, 2])
def test_multimol_column_matches_jax(jax_model, n_rep):
    """The layout of three overlapping molecules (and of two displaced
    replicas of them) equals the JAX list's; forces and per-molecule
    energies match the JAX column calculator and the port's all-pairs
    calculator."""
    pot, params = jax_model
    mols = _mols()
    jsys = jload_molecules(mols, n_replicas=n_rep)
    system = load_molecules(mols, n_replicas=n_rep, device="cpu")
    if n_rep > 1:
        system, jsys = _replicas(system, jsys, n_rep)
    jnbl = JCellBlockNBL(CUTOFF * CONV, skin=SHELL * CONV)
    jcalc = JCalculator(pot, params, cutoff=CUTOFF, cutoff_shell=SHELL,
                        neighbor_list=jnbl)
    jout = jcalc.calculate(jsys, jcalc.init_state(jsys))
    nbl = CellBlockNeighborListMD(CUTOFF * CONV, skin=SHELL * CONV)
    calc = port_calc(params, nbl)
    out = calc.calculate(system, calc.init_state(system))
    for k in LAYOUT_KEYS:
        np.testing.assert_array_equal(getattr(nbl._layout, k),
                                      np.asarray(getattr(jnbl._layout, k)),
                                      err_msg=k)
    # the slots carry their molecule's id, in slot order
    st = nbl.state()
    real = st["cell_atom_mask"] > 0
    ids = system.idx_m[st["cell_order"]]
    assert torch.equal(st["cell_idx_m"][real], ids[real])
    assert set(st["cell_idx_m"][real].tolist()) == {0, 1, 2}
    f = out.forces.numpy()
    assert np.isfinite(f).all() and np.abs(f).max() > 1e-3
    np.testing.assert_allclose(f, np.asarray(jout.forces), F_RTOL, F_ATOL)
    assert out.energy.shape == (n_rep, 3)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(jout.energy),
                               E_RTOL, E_ATOL)
    ref_calc = port_calc(params, "all_pairs")
    ref = ref_calc.calculate(system.replace(), ref_calc.init_state(system))
    np.testing.assert_allclose(f, ref.forces.numpy(), F_RTOL, F_ATOL)
    np.testing.assert_allclose(out.energy.numpy(), ref.energy.numpy(),
                               E_RTOL, E_ATOL)
    assert nbl._dev_rebuild is None


def test_multimol_column_md_runs(jax_model):
    """40 velocity-Verlet steps of three molecules on the column layout
    stay finite; rebuilds are host builds."""
    _, params = jax_model
    system = load_molecules(_mols(seed=3), device="cpu")
    system = MaxwellBoltzmannInit(50.0).initialize_system(
        system, torch.Generator().manual_seed(2))
    calc = port_calc(params)
    sim = Simulator(system, VelocityVerlet(0.5), calc, seed=0)
    sim.simulate(40, chunk_size=20)
    assert np.isfinite(sim.system.positions.numpy()).all()
    assert np.isfinite(sim.system.forces.numpy()).all()
    nbl = calc.nbl
    assert nbl.n_builds >= 1 and nbl.n_device_builds == 0


def test_multimol_periodic_rejected(jax_model):
    _, params = jax_model
    mols = _mols(n_mols=2, seed=5)
    for m in mols:
        m[P.cell] = np.eye(3) * 20.0
        m[P.pbc] = np.ones(3, bool)
    system = load_molecules(mols, device="cpu")
    calc = port_calc(params)
    with pytest.raises(NotImplementedError, match="dense"):
        calc.init_state(system)
