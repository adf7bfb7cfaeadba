"""PyTorch port, the ASE interface on the CPU against the JAX package
(``schnetpack_tpu/interfaces/ase_interface.py``), both sides with the same
weights (a JAX model config, flax-initialised and perturbed, loaded into
the port through ``cli.model_from_config``) at F = 16, 2 interactions, 8
radial functions:

* ``AtomsConverter``'s batches: every key, integers and floats, equal;
* ``SpkCalculator``'s energy (1e-5 relative), forces (within 1e-4 of the
  largest |F|) and stress (within 1e-4 of its largest entry) against the
  JAX ``SpkCalculator``, with PaiNN and SchNet, on a molecule and on a
  periodic box, and in kcal/mol and Bohr;
* the cache (an unchanged structure evaluates nothing, moved positions
  once) and the ASE shim's ``check_state``, ``calculation_required`` and
  ``get_property`` against the JAX shim's;
* ``SpkEnsembleCalculator``'s mean and population std against the JAX
  ensemble's vmap (forces within 1e-4 of the largest |F|);
* ``AseInterface.optimize``'s three files, read by the JAX package's
  ``read_extxyz_file``; ``compute_normal_modes`` against the JAX one's
  (within 1e-3 of the largest |frequency|: finite differences of f32
  forces); ``run_md`` runs and stays finite (its momenta draw from a
  ``torch.Generator``, so no comparison with JAX's key).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.config.compose import instantiate as jinstantiate
from schnetpack_tpu.data.loader import PaddingSpec, collate as jcollate
from schnetpack_tpu.datasets.xyz import read_extxyz_file as jread_extxyz
from schnetpack_tpu.interfaces import ase_interface as jase
from schnetpack_tpu.transform.neighborlist import (
    NeighborListTransform as JNeighborListTransform,
)
from schnetpack_tpu_torch.cli import model_from_config
from schnetpack_tpu_torch.interfaces import ase_interface as tase

from test_torch_port_model_options import _perturbed

CUTOFF = 4.0
E_RTOL = 1e-5             # energy, relative
F_SCALE_TOL = 1e-4        # forces, of the largest |F|
FREQ_SCALE_TOL = 1e-3     # normal modes, of the largest |frequency|


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def model_config(rep="painn", stress=False, per_atom=False, cutoff=CUTOFF):
    """A JAX model config (the JAX package's target names) at F = 16."""
    head = {"_target_": "schnetpack_tpu.atomistic.Atomwise",
            "output_key": "energy"}
    if per_atom:
        head["per_atom_output_key"] = "energy_per_atom"
    return {
        "_target_": "schnetpack_tpu.model.NeuralNetworkPotential",
        "representation": {
            "_target_": "schnetpack_tpu.representation." + {
                "painn": "PaiNN", "schnet": "SchNet"}[rep],
            "n_atom_basis": 16, "n_interactions": 2, "n_rbf": 8,
            "cutoff": cutoff},
        "input_modules": [
            {"_target_": "schnetpack_tpu.atomistic.PairwiseDistances"}],
        "output_modules": [head, {
            "_target_": "schnetpack_tpu.atomistic.Forces",
            "calc_stress": stress}],
    }


def water():
    return {
        P.Z: np.array([8, 1, 1]),
        P.R: np.array([[0.0, 0, 0], [0.76, 0.59, 0], [-0.76, 0.59, 0]]),
        P.cell: np.zeros((3, 3)),
        P.pbc: np.zeros(3, bool),
    }


def molecule(seed=0, n=7):
    rng = np.random.RandomState(seed)
    return {P.Z: rng.choice([1, 6, 8], n), P.R: rng.uniform(0, 3.0, (n, 3)),
            P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}


def box(seed=0, n=12, L=6.0):
    rng = np.random.RandomState(seed)
    cell = np.diag([L, L * 1.05, L * 0.95])
    cell[1, 0] = 0.3
    return {P.Z: rng.choice([1, 8], n), P.R: rng.uniform(0, 1, (n, 3)) @ cell,
            P.cell: cell, P.pbc: np.ones(3, bool)}


def models(rep="painn", stress=False, per_atom=False, seed=0,
           cutoff=CUTOFF):
    """(config, JAX potential, flax tree, port potential on the CPU) with
    the same weights."""
    cfg = model_config(rep, stress, per_atom, cutoff)
    jpot = jinstantiate(copy.deepcopy(cfg))
    sample = JNeighborListTransform(CUTOFF)(water())
    tree = _perturbed(jpot.init(jax.random.PRNGKey(seed), jcollate(
        [sample], PaddingSpec(16, 256, 2))), seed)
    pot, _ = model_from_config(copy.deepcopy(cfg), tree, "cpu")
    return cfg, jpot, tree, pot


def forces_close(got, want, tol=F_SCALE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_atoms_converter_matches_jax():
    structures = [water(), molecule(1), box(2)]
    got = tase.AtomsConverter(cutoff=CUTOFF, device="cpu")(structures)
    want = jase.AtomsConverter(cutoff=CUTOFF)(structures)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
        assert got[k].device.type == "cpu"


@pytest.mark.parametrize("rep,where,units", [
    ("painn", "molecule", ("eV", "Ang")),
    ("painn", "box", ("eV", "Ang")),
    ("schnet", "molecule", ("eV", "Ang")),
    ("schnet", "box", ("eV", "Ang")),
    ("painn", "box", ("kcal/mol", "Bohr")),
])
def test_spk_calculator_matches_jax(rep, where, units):
    stress = where == "box"
    _, jpot, tree, pot = models(rep, stress=stress)
    atoms = molecule(3) if where == "molecule" else box(4)
    kw = dict(cutoff=CUTOFF, energy_unit=units[0], position_unit=units[1])
    got = tase.SpkCalculator(pot, device="cpu", **kw).calculate(atoms)
    want = jase.SpkCalculator(jpot, tree, **kw).calculate(atoms)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=E_RTOL)
    forces_close(got["forces"], want["forces"])
    if stress:
        forces_close(got["stress"], want["stress"])


def test_calculator_cache_evaluates_only_changed_structures():
    _, _, _, pot = models("schnet")
    calc = tase.SpkCalculator(pot, cutoff=CUTOFF, device="cpu")
    res = calc.calculate(water())
    assert calc.n_evaluations == 1
    assert calc.calculate(water()) is res
    assert calc.get_forces(water()) is res["forces"]
    assert calc.n_evaluations == 1
    moved = water()
    moved[P.R][1, 0] += 0.05
    res2 = calc.calculate(moved)
    assert calc.n_evaluations == 2 and res2["energy"] != res["energy"]
    calc.calculate(moved)
    assert calc.n_evaluations == 2


def test_ase_shim_protocol_matches_jax():
    _, jpot, tree, pot = models("schnet")
    calcs = {"port": tase.SpkCalculator(pot, cutoff=CUTOFF, device="cpu"),
             "jax": jase.SpkCalculator(jpot, tree, cutoff=CUTOFF)}
    w = water()
    w2 = dict(w, **{P.R: w[P.R] + np.array([[0.0, 0, 0], [0.07, 0, 0],
                                             [0, 0, 0.03]])})
    w3 = dict(w2, **{P.Z: np.array([8, 1, 8])})
    seen = {}
    for name, calc in calcs.items():
        log = [calc.calculation_required(w, ["energy"]),
               calc.check_state(w)]
        e0 = calc.get_property("energy", w)
        log += [calc.calculation_required(w, ["energy", "forces"]),
                calc.calculation_required(w, ["energy", "dipole_moment"]),
                calc.check_state(w), calc.check_state(w2),
                calc.check_state(w3), calc.calculation_required(w2, ["energy"]),
                calc.get_property("energy", w2, allow_calculation=False)]
        f1 = calc.get_property("forces", w2)
        with pytest.raises(KeyError, match="dipole_moment"):
            calc.get_property("dipole_moment", w2)
        seen[name] = (log, e0, f1)
    assert seen["port"][0] == seen["jax"][0]
    np.testing.assert_allclose(seen["port"][1], seen["jax"][1], rtol=E_RTOL)
    forces_close(seen["port"][2], seen["jax"][2])


def test_ensemble_matches_jax():
    _, jpot, tree, pot = models("painn", seed=0)
    _, _, tree2, pot2 = models("painn", seed=1)
    got = tase.SpkEnsembleCalculator(
        [pot, pot2], cutoff=CUTOFF, device="cpu",
        uncertainty=[tase.RelativeUncertainty(),
                     tase.AbsoluteUncertainty()]).calculate(molecule(5))
    want = jase.SpkEnsembleCalculator(
        jpot, [tree, tree2], cutoff=CUTOFF,
        uncertainty=[jase.RelativeUncertainty(),
                     jase.AbsoluteUncertainty()]).calculate(molecule(5))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=E_RTOL)
    forces_close(got["forces"], want["forces"])
    scale = np.abs(want["forces"]).max()
    np.testing.assert_allclose(got["forces_uncertainty"],
                               want["forces_uncertainty"], rtol=0,
                               atol=F_SCALE_TOL * scale)
    np.testing.assert_allclose(got["energy_uncertainty"],
                               want["energy_uncertainty"], rtol=0,
                               atol=E_RTOL * abs(want["energy"]))


def test_optimize_writes_three_files_the_jax_reader_reads(tmp_path):
    _, _, _, pot = models("schnet")
    calc = tase.SpkCalculator(pot, cutoff=CUTOFF, device="cpu")
    w = water()
    w[P.R] = w[P.R] + np.random.RandomState(1).rand(3, 3) * 0.05
    iface = tase.AseInterface(w, calc, working_dir=str(tmp_path))
    info = iface.optimize(fmax=5e-3, steps=40)
    assert info["fmax"].shape == (1,)
    frames = jread_extxyz(str(tmp_path / "optimization.extxyz"))
    assert len(frames) >= 2
    np.testing.assert_array_equal(frames[0]["numbers"], [8, 1, 1])
    np.testing.assert_allclose(frames[-1]["positions"],
                               np.asarray(iface.atoms[P.R]), atol=1e-8)
    assert "energy=" in frames[0]["comment"]
    final = jread_extxyz(str(tmp_path / "optimization_final.extxyz"))
    np.testing.assert_allclose(final[0]["positions"],
                               np.asarray(iface.atoms[P.R]), atol=1e-8)
    log = (tmp_path / "optimization.log").read_text().splitlines()
    assert log[0].startswith("BatchwiseLBFGS")
    assert len(log) == len(frames) + 1


def test_normal_modes_match_jax():
    _, jpot, tree, pot = models("painn")
    got = tase.AseInterface(water(), tase.SpkCalculator(
        pot, cutoff=CUTOFF, device="cpu")).compute_normal_modes(delta=0.01)
    want = jase.AseInterface(water(), jase.SpkCalculator(
        jpot, tree, cutoff=CUTOFF)).compute_normal_modes(delta=0.01)
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FREQ_SCALE_TOL * np.abs(want).max())


def test_run_md_runs_and_stays_finite():
    _, _, _, pot = models("painn")
    iface = tase.AseInterface(molecule(6), tase.SpkCalculator(
        pot, cutoff=CUTOFF, device="cpu"))
    R0 = iface.atoms[P.R].copy()
    sim = iface.run_md(20, temperature=100.0, time_step=0.25)
    assert sim.n_simulated == 20
    assert np.isfinite(iface.atoms[P.R]).all()
    assert not np.allclose(iface.atoms[P.R], R0)
    assert torch.isfinite(sim.system.forces).all()


def test_the_entry_points_default_to_the_card():
    _, _, _, pot = models("schnet")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tase.SpkCalculator(pot, cutoff=CUTOFF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tase.AtomsConverter(cutoff=CUTOFF)
