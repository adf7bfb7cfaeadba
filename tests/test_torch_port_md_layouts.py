"""PyTorch port, the flat and dense layouts in MD against the JAX package:

* the all-pairs list (``AllPairsNeighborListMD`` through
  ``PairwiseMDCalculator._pair_inputs``) and the dense neighbor matrix
  (``DenseNeighborListMD``) equal to the JAX package's: indices, masks and
  the reverse map bit for bit, offsets within 1e-6 nm, on three
  molecules, on two periodic boxes in one system and on two replicas;
* 20 NVE steps of a small PaiNN (F = 16, 2 interactions) on three
  molecules through ``SchNetPackCalculator`` with ``neighbor_list=
  "all_pairs"`` and ``"dense"`` against the JAX calculator, at
  ``test_torch_port_md.py``'s tolerances;
* dense against all-pairs for ring polymers of 1 and 4 beads
  (``tests/test_md_dense.py:70-113``) and for FieldSchNet (``:146-190``);
* the ensemble on the all-pairs list against its single members;
* ``spkmd`` with the calculator config as shipped (``neighbor_list:
  all_pairs``) on an extxyz of three molecules against the JAX ``spkmd``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.atomistic import Atomwise as JAtomwise
from schnetpack_tpu.atomistic import Forces as JForces
from schnetpack_tpu.atomistic import PairwiseDistances as JPairwiseDistances
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import VelocityVerlet as JVelocityVerlet
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import LJCalculator as JLJCalculator
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalculator
from schnetpack_tpu.md.cli import main as jspkmd
from schnetpack_tpu.md.neighborlist_md import (
    DenseNeighborListMD as JDenseNeighborListMD,
)
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.atomistic import Atomwise, Forces, PairwiseDistances
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.datasets import write_extxyz
from schnetpack_tpu_torch.md import (
    DenseNeighborListMD, RingPolymer, Simulator, VelocityVerlet,
    load_molecules,
)
from schnetpack_tpu_torch.md import cli
from schnetpack_tpu_torch.md.calculators import (
    EnsembleCalculator, LJCalculator, SchNetPackCalculator,
)
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.representation import FieldSchNet, PaiNN
from schnetpack_tpu_torch.units import _parse_unit, md_units

from test_torch_port_ensemble import PAINN_CONFIG, write_run_dir
from test_torch_port_md import MOM_ATOL, MOM_RTOL, POS_ATOL
from test_torch_port_model import ASSET
from test_torch_port_model_options import _perturbed
from torch_port_cases import fcc_argon

CUTOFF = 5.0
SHELL = 0.3              # Angstrom
OFFSET_ATOL = 1e-6       # nm
# one model evaluation, two layouts or two members (MD units, kJ/mol/nm)
E_RTOL, F_ATOL = 1e-5, 1e-3
CONV = _parse_unit("Ang") * md_units().length
#: the 27-atom lattice's cutoff: its 3.8 A spacing inside
LATTICE_CUTOFF = 4.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _molecules(seed=0, sizes=(6, 9, 12), d_min=2.0):
    """Argon molecules of ``sizes`` atoms in cubes of side 1.5 d_min
    n^(1/3), each atom at least ``d_min`` A from the others, the molecules
    3 A apart in x."""
    rng = np.random.RandomState(seed)
    out, x0 = [], 0.0
    for n in sizes:
        side = 1.5 * d_min * n ** (1.0 / 3.0)
        R = [rng.rand(3) * side]
        while len(R) < n:
            r = rng.rand(3) * side
            if np.linalg.norm(np.asarray(R) - r, axis=1).min() >= d_min:
                R.append(r)
        R = np.asarray(R) + [x0, 0.0, 0.0]
        x0 = R[:, 0].max() + 3.0
        out.append({P.Z: np.full(n, 18, np.int64), P.R: R})
    return out


def _boxes():
    """Two periodic argon boxes of 32 atoms, different cells."""
    out = []
    for seed, stretch in ((1, 1.0), (2, 1.08)):
        R, cell = fcc_argon(2, jitter=0.3, seed=seed, stretch=stretch)
        out.append({P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
                    P.pbc: np.ones(3, bool)})
    return out


def _systems(case):
    """(JAX system, port system) of a case; two replicas are displaced
    per bead by a seeded +-0.1 A."""
    mols = _boxes() if case == "boxes" else _molecules()
    n_rep = 2 if case == "replicas" else 1
    js = jload_molecules(mols, n_replicas=n_rep)
    s = load_molecules(mols, n_replicas=n_rep, device="cpu")
    if n_rep > 1:
        d = np.random.RandomState(7).uniform(
            -0.1, 0.1, s.positions.shape) * CONV
        js = js.replace(positions=js.positions + jnp.asarray(d, jnp.float32))
        s = s.replace(positions=s.positions + torch.tensor(d).float())
    return js, s


@pytest.mark.parametrize("case", ["molecules", "boxes", "replicas"])
def test_all_pairs_state_matches_jax(case):
    js, s = _systems(case)
    want = JLJCalculator(3.4, 0.01, CUTOFF, cutoff_shell=SHELL)._pair_inputs(
        js)
    got = LJCalculator(3.4, 0.01, CUTOFF, cutoff_shell=SHELL)._pair_inputs(
        s)
    for k in (P.idx_i, P.idx_j, P.pair_mask):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got[P.offsets].numpy(),
                               np.asarray(want[P.offsets]), rtol=0,
                               atol=OFFSET_ATOL * 10)   # Angstrom
    assert 0 < float(got[P.pair_mask].mean()) < 1
    if case == "boxes":
        assert np.abs(got[P.offsets].numpy()).max() > 1.0


@pytest.mark.parametrize("case", ["molecules", "boxes", "replicas"])
def test_dense_state_matches_jax(case):
    js, s = _systems(case)
    jnbl = JDenseNeighborListMD(CUTOFF * CONV, skin=0.5 * CONV)
    jnbl.build(js)
    want = jnbl.state()
    nbl = DenseNeighborListMD(CUTOFF * CONV, skin=0.5 * CONV)
    nbl.build(s)
    got = nbl.state()
    for k in (P.nbh_idx, P.nbh_mask, P.nbh_rev):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got[P.nbh_offsets].numpy(),
                               np.asarray(want[P.nbh_offsets]), rtol=0,
                               atol=OFFSET_ATOL)
    assert float(got[P.nbh_cutoff]) == pytest.approx(float(
        want[P.nbh_cutoff]))
    # K never shrinks; the skin test fires past skin/2
    K = got[P.nbh_idx].shape[1]
    far = s.replace(positions=s.positions * 0.5)
    nbl.build(far)
    assert nbl.state()[P.nbh_idx].shape[1] >= K
    assert not nbl.maybe_rebuild(far)
    moved = far.replace(positions=far.positions + 0.2 * CONV)
    assert nbl.maybe_rebuild(moved) and nbl.n_builds == 3


def _small_painn():
    """(JAX potential, its perturbed parameters, port potential) of a PaiNN
    at F = 16, 2 interactions, 8 Gaussians."""
    jpot = JNNP(representation=JPaiNN(n_atom_basis=16, n_interactions=2,
                                      n_rbf=8, cutoff=CUTOFF),
                input_modules=[JPairwiseDistances()],
                output_modules=[JAtomwise(output_key=P.energy), JForces()])
    js, _ = _systems("molecules")
    jcalc = JCalculator(jpot, None, cutoff=CUTOFF, neighbor_list="all_pairs")
    import jax

    tree = _perturbed(jax.jit(jpot.init)(
        jax.random.PRNGKey(0), jcalc._model_inputs(js)), seed=1)
    return jpot, tree, _port_painn(16, 2)


def _port_painn(F, T, cutoff=CUTOFF):
    return NeuralNetworkPotential(
        PaiNN(n_atom_basis=F, n_interactions=T, n_rbf=8, cutoff=cutoff,
              generator=torch.Generator().manual_seed(0)),
        [Atomwise(n_in=F), Forces()], input_modules=[PairwiseDistances()])


@pytest.mark.parametrize("layout", ["all_pairs", "dense"])
def test_nve_trajectory_matches_jax(layout):
    """20 NVE steps from the same momenta (100 K) on both packages."""
    jpot, tree, pot = _small_painn()
    js, s = _systems("molecules")
    sigma = np.sqrt(39.948 * md_units().mass * md_units().kB * 100.0)
    p0 = (sigma * np.random.RandomState(3).randn(1, s.total_atoms, 3)
          ).astype(np.float32)
    jcalc = JCalculator(jpot, tree, cutoff=CUTOFF, cutoff_shell=SHELL,
                        neighbor_list=layout)
    jsim = JSimulator(js.replace(momenta=jnp.asarray(p0)),
                      JVelocityVerlet(0.5), jcalc, progress=False,
                      log_keys=("energy",))
    jsim.simulate(20, chunk_size=20)
    want = jsim.state.system

    calc = SchNetPackCalculator(pot, params_from_jax(tree), cutoff=CUTOFF,
                                cutoff_shell=SHELL, neighbor_list=layout)
    sim = Simulator(s.replace(momenta=torch.tensor(p0)), VelocityVerlet(0.5),
                    calc)
    sim.simulate(20, chunk_size=10)
    assert (calc.nbl is None) == (layout == "all_pairs")
    np.testing.assert_allclose(sim.system.positions.numpy(),
                               np.asarray(want.positions), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(),
                               np.asarray(want.momenta), rtol=MOM_RTOL,
                               atol=MOM_ATOL)
    np.testing.assert_allclose(sim.system.energy.numpy(),
                               np.asarray(want.energy), rtol=1e-5)


def _argon27(seed):
    """27 argon atoms on a 3.8 A lattice in an 11.4 A box
    (``tests/test_md_dense.py::_argon_box``)."""
    rng = np.random.RandomState(seed)
    pos = (np.mgrid[0:3, 0:3, 0:3].reshape(3, -1).T * 3.8 + 0.8
           + rng.uniform(-0.05, 0.05, (27, 3)))
    return {P.Z: np.full(27, 18, np.int64), P.R: pos,
            P.cell: np.eye(3) * 11.4, P.pbc: np.ones(3, bool)}


def _both_layouts(pot, system, cutoff=LATTICE_CUTOFF):
    out = {}
    for layout in ("all_pairs", "dense"):
        calc = SchNetPackCalculator(pot, cutoff=cutoff, cutoff_shell=0.6,
                                    neighbor_list=layout)
        s = calc.calculate(system, calc.init_state(system))
        out[layout] = (s.energy, s.forces)
    return out


def _agree(out):
    (E_a, F_a), (E_d, F_d) = out["all_pairs"], out["dense"]
    torch.testing.assert_close(E_d, E_a, rtol=E_RTOL, atol=1e-4)
    torch.testing.assert_close(F_d, F_a, rtol=0, atol=F_ATOL)
    assert float(F_a.abs().max()) > 100 * F_ATOL


@pytest.mark.parametrize("n_replicas", [1, 4])
def test_dense_matches_all_pairs_rpmd(n_replicas):
    """Per-bead energies and forces of a ring polymer whose beads are
    spread by seeded +-0.15 A (the dense list is the union over beads)."""
    system = load_molecules([_argon27(0)], n_replicas=n_replicas,
                            device="cpu")
    if n_replicas > 1:
        disp = np.random.RandomState(7).randn(n_replicas, 27, 3) * 0.15
        system = system.replace(
            positions=system.positions + torch.tensor(disp * CONV).float())
    pot = _port_painn(16, 2, LATTICE_CUTOFF)
    _agree(_both_layouts(pot, system))
    calc = SchNetPackCalculator(pot, cutoff=LATTICE_CUTOFF,
                                cutoff_shell=0.6, neighbor_list="dense")
    if n_replicas > 1:
        sim = Simulator(system, RingPolymer(0.2, n_beads=n_replicas,
                                            temperature=30.0), calc)
        sim.simulate(10, chunk_size=5)
        assert torch.isfinite(sim.system.positions).all()


def test_field_schnet_dense_matches_flat():
    """FieldSchNet takes its dense branch behind the calculator's one-pair
    flat list, and agrees with the all-pairs list."""
    rep = FieldSchNet(n_atom_basis=16, n_interactions=2, n_rbf=8,
                      cutoff=LATTICE_CUTOFF,
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in rep.modules():
            if hasattr(m, "weight") and not m.weight.any():
                m.weight.normal_(0.0, 0.3)      # zero-initialised filters
    pot = NeuralNetworkPotential(rep, [Atomwise(n_in=16), Forces()],
                                 input_modules=[PairwiseDistances()])
    system = load_molecules([_argon27(6)], device="cpu")
    _agree(_both_layouts(pot, system))


def test_ensemble_runs_on_all_pairs():
    """The ensemble's mean and std on the all-pairs list against its
    members' single calculators on the three molecules."""
    _, s = _systems("molecules")
    pots = [_port_painn(16, 2), _port_painn(16, 2)]
    with torch.no_grad():
        for p in pots[1].parameters():
            p.mul_(1.05)
    calc = EnsembleCalculator(pots, cutoff=CUTOFF, cutoff_shell=SHELL)
    assert calc.nbl is None
    out = calc.calculate(s, calc.init_state(s))
    singles = []
    for pot in pots:
        c = SchNetPackCalculator(pot, cutoff=CUTOFF, cutoff_shell=SHELL)
        singles.append(c.calculate(s, c.init_state(s)).forces)
    F = torch.stack(singles)
    torch.testing.assert_close(out.forces, F.mean(0), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(out.properties["forces_uncertainty"],
                               F.std(0, correction=0), rtol=1e-5, atol=1e-5)
    assert float(out.properties["forces_uncertainty"].max()) > 0


def test_spkmd_shipped_calculator_config_matches_jax(tmp_path):
    """``spkmd`` with ``calculator.model_dir`` and nothing else of the
    calculator overridden: the shipped ``neighbor_list: all_pairs`` runs
    the three molecules, 20 NVE steps from zero momenta, against the JAX
    ``spkmd``."""
    run = write_run_dir(tmp_path / "run", PAINN_CONFIG,
                        load_jax_params(ASSET))
    xyz = str(tmp_path / "molecules.xyz")
    write_extxyz(xyz, [{"numbers": m[P.Z], "positions": m[P.R]}
                       for m in _molecules(seed=4, d_min=3.2)])
    argv = [f"system.molecule_file={xyz}", f"calculator.model_dir={run}",
            "dynamics=nve", "dynamics.n_steps=20", "dynamics.chunk_size=10",
            "system.initializer=null", "callbacks=hdf5"]
    jsim_dir = str(tmp_path / "jax")
    jspkmd(argv + [f"simulation_dir={jsim_dir}"])
    sim = cli.main(argv + [f"simulation_dir={tmp_path / 'port'}",
                           "device=cpu"])
    from schnetpack_tpu.md.data import HDF5Loader as JHDF5Loader

    want = JHDF5Loader(os.path.join(jsim_dir, "simulation.hdf5"))
    assert want.entries == 20
    assert sim.calculator.nbl is None and sim.system.n_molecules == 3
    np.testing.assert_allclose(sim.system.positions.numpy(),
                               want.get("positions", replica_idx=0)[-1:],
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(),
                               want.get("momenta", replica_idx=0)[-1:],
                               rtol=MOM_RTOL, atol=MOM_ATOL)
    assert float(sim.system.temperature.max()) > 0.05   # it moved
