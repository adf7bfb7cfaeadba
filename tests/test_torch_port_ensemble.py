"""PyTorch port, trained run directories and the ensemble calculator on the
CPU against the JAX package:

* ``load_model`` on a run directory written as the JAX training CLI
  writes one (``model_config.pkl``: the JAX ``configs/model`` config,
  composed, with a ``Forces`` head; ``best_model``: a flax-initialised,
  perturbed parameter tree) against the JAX model's energy and forces:
  PaiNN (its fused column path, where the config's ``PairwiseDistances``
  is dead), PaiNN with ``model/radial_basis=bessel`` (which reads it) and
  SchNet, all at F = 16, 2 interactions, 8 radial functions;
* the ensemble (the trained asset and a copy perturbed by seeded +-5%) on
  the 256-atom box against the JAX ``EnsembleCalculator``: mean forces and
  their population std within 1e-5 eV/A; the port's members over one set
  of inputs agree with two single calculators to float32 roundoff;
* ``spkmd`` with ``calculator.model_dir`` and
  ``calculator.neighbor_list=cellblock`` from ``system.initializer=null``,
  20 NVE steps, against the JAX ``spkmd`` on the same run directory, at
  ``test_torch_port_md.py``'s tolerances;
* the calculator options the port refuses raise at construction, each
  naming its ROADMAP item; the system's ``properties`` survive a restart.
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.config.compose import Composer as JComposer
from schnetpack_tpu.config.compose import instantiate as jinstantiate
from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators import (
    EnsembleCalculator as JEnsembleCalculator,
)
from schnetpack_tpu.md.calculators import (
    stack_ensemble_params as jstack_ensemble_params,
)
from schnetpack_tpu.md.cli import main as jspkmd
from schnetpack_tpu.ops import cellblock as jcellblock
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.cli import load_model
from schnetpack_tpu_torch.convert import load_jax_params, params_from_jax
from schnetpack_tpu_torch.datasets import write_extxyz
from schnetpack_tpu_torch.md import (
    CellBlockNeighborListMD, Simulator, VelocityVerlet, load_molecules,
)
from schnetpack_tpu_torch.md import cli
from schnetpack_tpu_torch.md.calculators import (
    EnsembleCalculator, SchNetPackCalculator,
)
from schnetpack_tpu_torch.md.simulator import LOG_KEYS
from schnetpack_tpu_torch.ops.precision import ReducedPrecisionPathError
from schnetpack_tpu_torch.model import NeuralNetworkPotential

from test_torch_port_md import MOM_ATOL, MOM_RTOL, POS_ATOL
from test_torch_port_model import (
    ASSET, CUTOFF, ROOT, fcc_box, port_inputs, port_potential,
)
from test_torch_port_model_options import (
    E_RTOL, F_ATOL, F_RTOL, _perturbed,
)
from test_torch_port_so3net import _box, _jax_column_inputs

JAX_TRAIN_CONFIGS = os.path.join(ROOT, "schnetpack_tpu", "configs")
ENSEMBLE_ATOL = 1e-5      # eV/A, the mean and the std of the members
PAINN_CONFIG = {
    "_target_": "schnetpack_tpu.model.NeuralNetworkPotential",
    "representation": {"_target_": "schnetpack_tpu.representation.PaiNN",
                       "n_atom_basis": 128, "n_interactions": 3,
                       "n_rbf": 20, "cutoff": 5.0},
    "input_modules": [{"_target_": "schnetpack_tpu.atomistic."
                                   "PairwiseDistances"}],
    "output_modules": [{"_target_": "schnetpack_tpu.atomistic.Atomwise",
                        "output_key": "energy"},
                       {"_target_": "schnetpack_tpu.atomistic.Forces"}],
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jcellblock, "IMPL", "xla")


def write_run_dir(path, model_cfg, tree):
    """A run directory as the JAX training CLI writes it."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.pkl"), "wb") as f:
        pickle.dump(model_cfg, f)
    with open(os.path.join(path, "best_model"), "wb") as f:
        pickle.dump(jax.device_get(tree), f)
    return str(path)


def jax_model_config(overrides):
    """The JAX training config's ``model`` node at F = 16, 2 interactions,
    8 radial functions, with a ``Forces`` head."""
    cfg = JComposer([JAX_TRAIN_CONFIGS]).compose("train", overrides + [
        "model.representation.n_atom_basis=16",
        "model.representation.n_interactions=2",
        "model.representation.n_rbf=8"])["model"]
    cfg["output_modules"].append(
        {"_target_": "schnetpack_tpu.atomistic.Forces"})
    return cfg


@pytest.mark.parametrize("case", ["painn", "painn_bessel", "schnet"])
def test_load_model_matches_jax(tmp_path, case):
    overrides = {"painn": ["model=painn"],
                 "painn_bessel": ["model=painn", "model/radial_basis=bessel"],
                 "schnet": ["model=schnet"]}[case]
    model_cfg = jax_model_config(overrides)
    R, cell = _box(3, seed=1, jitter=0.3, stretch=1.1)
    lay, inputs = port_inputs(R, cell, CUTOFF + 0.6)
    jin = _jax_column_inputs(lay, inputs)
    jpot = jinstantiate(model_cfg)
    tree = _perturbed(jpot.init(jax.random.PRNGKey(0), jin), seed=1)
    out = jpot.apply(tree, jin)
    run = write_run_dir(tmp_path / "run", model_cfg, tree)

    pot, params = load_model(run, device="cpu")
    assert isinstance(pot, NeuralNetworkPotential)
    assert set(params) == set(pot.state_dict())
    got = pot.requires_grad_(False)(dict(inputs))
    np.testing.assert_allclose(float(got[TP.energy][0]),
                               float(np.asarray(out[P.energy])[0]),
                               rtol=E_RTOL)
    np.testing.assert_allclose(got[TP.forces].numpy(),
                               np.asarray(out[P.forces]), rtol=F_RTOL,
                               atol=F_ATOL)
    # the config's PairwiseDistances runs where the representation reads
    # its displacements on the column layout, and only there
    rij = pot.input_modules[0](dict(inputs))
    assert (TP.col_rij in rij) == (case == "painn_bessel")


def test_load_model_names_an_unknown_target(tmp_path):
    cfg = dict(PAINN_CONFIG, representation={
        "_target_": "schnetpack_tpu.representation.NotAModel"})
    run = write_run_dir(tmp_path / "run", cfg, load_jax_params(ASSET))
    with pytest.raises(ValueError, match="representation.NotAModel"):
        load_model(run, device="cpu")


def perturbed_asset(seed=5, scale=0.05):
    """The trained asset with every parameter scaled by a seeded 1 +-
    ``scale``."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        node = np.asarray(node, np.float32)
        return node * (1 + scale * rng.uniform(-1, 1, node.shape)).astype(
            np.float32)
    return walk(load_jax_params(ASSET))


def argon_box(seed=3):
    rng = np.random.RandomState(seed)
    R, cell = fcc_box(4)
    R = R + rng.uniform(-0.1, 0.1, R.shape)
    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def port_calculator(params):
    return SchNetPackCalculator(port_potential(), params, cutoff=CUTOFF,
                                cutoff_shell=0.6, neighbor_list="cellblock")


def test_ensemble_matches_jax():
    trees = [load_jax_params(ASSET), perturbed_asset()]
    mol = argon_box()

    jpot = jinstantiate(PAINN_CONFIG)
    jcalc = JEnsembleCalculator(
        jpot, jstack_ensemble_params([jax.tree.map(np.asarray, t)
                                      for t in trees]), cutoff=CUTOFF,
        neighbor_list="all_pairs")
    js = jcalc.calculate(jload_molecules([mol]))

    members = [params_from_jax(t) for t in trees]
    calc = EnsembleCalculator([port_potential(p) for p in members],
                              cutoff=CUTOFF, cutoff_shell=0.6,
                              neighbor_list="cellblock")
    system = load_molecules([mol], device="cpu")
    s = calc.calculate(system, calc.init_state(system))
    to_ev = 1.0 / calc.force_conversion
    f_unc = s.properties["forces_uncertainty"]
    assert f_unc.shape == s.forces.shape
    # the members differ by far more than the tolerance
    assert float(f_unc.max()) * to_ev > 50 * ENSEMBLE_ATOL
    np.testing.assert_allclose(s.forces.numpy() * to_ev,
                               np.asarray(js.forces) * to_ev, rtol=0,
                               atol=ENSEMBLE_ATOL)
    np.testing.assert_allclose(
        f_unc.numpy() * to_ev,
        np.asarray(js.properties["forces_uncertainty"]) * to_ev, rtol=0,
        atol=ENSEMBLE_ATOL)
    e_conv = calc.energy_conversion
    np.testing.assert_allclose(
        s.properties["energy_uncertainty"].numpy() / e_conv,
        np.asarray(js.properties["energy_uncertainty"]) / e_conv, rtol=1e-4,
        atol=1e-5)

    # the members over one set of inputs equal two single calculators
    singles = []
    for p in members:
        c = port_calculator(p)
        singles.append(c.calculate(system, c.init_state(system)).forces)
    F = torch.stack(singles)
    # MD units (kJ/mol/nm): 1e-5 is 1e-8 eV/A
    torch.testing.assert_close(s.forces, F.mean(0), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(f_unc, F.std(0, correction=0), rtol=1e-5,
                               atol=1e-5)


def test_spkmd_model_dir_matches_jax(tmp_path):
    run = write_run_dir(tmp_path / "run", PAINN_CONFIG,
                        load_jax_params(ASSET))
    xyz = str(tmp_path / "argon.xyz")
    mol = argon_box()
    write_extxyz(xyz, [{"numbers": mol[P.Z], "positions": mol[P.R],
                        "cell": mol[P.cell]}])
    argv = [f"system.molecule_file={xyz}", f"calculator.model_dir={run}",
            "calculator.neighbor_list=cellblock", "dynamics=nve",
            "dynamics.n_steps=20", "dynamics.chunk_size=10",
            "system.initializer=null", "callbacks=hdf5"]
    jsim_dir = str(tmp_path / "jax")
    jspkmd(argv + [f"simulation_dir={jsim_dir}"])
    sim = cli.main(argv + [f"simulation_dir={tmp_path / 'port'}",
                           "device=cpu"])
    from schnetpack_tpu.md.data import HDF5Loader as JHDF5Loader

    want = JHDF5Loader(os.path.join(jsim_dir, "simulation.hdf5"))
    assert want.entries == 20
    np.testing.assert_allclose(sim.system.positions.numpy(),
                               want.get("positions", replica_idx=0)[-1:],
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(sim.system.momenta.numpy(),
                               want.get("momenta", replica_idx=0)[-1:],
                               rtol=MOM_RTOL, atol=MOM_ATOL)
    assert float(sim.system.temperature.max()) > 0.05   # it moved
    assert sim.calculator.nbl.n_builds == 1


def tiny_potential():
    from schnetpack_tpu_torch.atomistic import (
        Atomwise, Forces, PairwiseDistances,
    )
    from schnetpack_tpu_torch.representation import PaiNN

    return NeuralNetworkPotential(
        PaiNN(n_atom_basis=16, n_interactions=1, n_rbf=8, cutoff=CUTOFF),
        [Atomwise(n_in=16), Forces()],
        input_modules=[PairwiseDistances(columns=False)])


@pytest.mark.parametrize("options,error,match", [
    (dict(neighbor_list="cellblock_atom", precision="bf16"),
     ReducedPrecisionPathError, "rounds the positions"),
    (dict(neighbor_list="dense", stress_key="stress"), ValueError,
     "calc_stress"),
    (dict(neighbor_list="cellblock_atom", precision="mixed"),
     ReducedPrecisionPathError, "rounds the positions"),
    (dict(neighbor_list=CellBlockNeighborListMD(CUTOFF, layout="atom"),
          precision="bf16"), ReducedPrecisionPathError,
     "rounds the positions"),
    (dict(neighbor_list="cellblock", stress_key="stress"),
     ValueError, "column layout"),
    (dict(neighbor_list="cellblock_atom", stress_key="stress"),
     ValueError, "calc_stress"),
    (dict(neighbor_list="verlet"), ValueError, "cellblock"),
    (dict(neighbor_list="cellblock", precision="f16"), ValueError,
     "precision"),
])
def test_calculator_refuses_at_construction(options, error, match):
    with pytest.raises(error, match=match):
        SchNetPackCalculator(tiny_potential(), cutoff=CUTOFF, **options)


@pytest.mark.parametrize("neighbor_list,precision", [
    ("cellblock", None), ("cellblock", "f32"), ("all_pairs", None),
    ("dense", "f32"), ("cellblock", "bf16"), ("all_pairs", "mixed")])
def test_calculator_takes_the_jax_keys(neighbor_list, precision):
    """The JAX calculator's keys build and compute, on every layout (the
    flat and dense ones agree with the column one)."""
    calc = SchNetPackCalculator(
        tiny_potential(), cutoff=CUTOFF, neighbor_list=neighbor_list,
        precision=precision, stress_key=None,
        required_properties=["energy", "forces"])
    system = load_molecules([argon_box()], device="cpu")
    s = calc.calculate(system, calc.init_state(system))
    assert torch.isfinite(s.forces).all()
    if neighbor_list != "cellblock":
        col = SchNetPackCalculator(calc.model, cutoff=CUTOFF,
                                   neighbor_list="cellblock")
        want = col.calculate(system, col.init_state(system))
        torch.testing.assert_close(s.forces, want.forces, rtol=1e-4,
                                   atol=1e-4)


def test_properties_survive_a_restart(tmp_path):
    members = [params_from_jax(load_jax_params(ASSET)),
               params_from_jax(perturbed_asset())]
    calc = EnsembleCalculator([port_potential(p) for p in members],
                              cutoff=CUTOFF, cutoff_shell=0.6,
                              neighbor_list="cellblock")
    system = load_molecules([argon_box()], device="cpu")
    sim = Simulator(system, VelocityVerlet(0.5), calc,
                    log_keys=LOG_KEYS + calc.property_keys)
    sim.simulate(2, chunk_size=2)
    assert sim.logs[0]["forces_uncertainty"].shape == (2, 1, 256, 3)
    saved = pickle.loads(pickle.dumps(sim.state_dict()))
    other = Simulator(load_molecules([argon_box(seed=4)], device="cpu"),
                      VelocityVerlet(0.5), calc)
    other.restart_simulation(saved)
    assert set(other.system.properties) == {"forces_uncertainty",
                                            "energy_uncertainty"}
    for k, v in sim.system.properties.items():
        assert torch.equal(other.system.properties[k], v), k
