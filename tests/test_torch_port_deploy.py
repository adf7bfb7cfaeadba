"""PyTorch port, ``deploy.py`` and ``utils`` on the CPU against the JAX
package (``schnetpack_tpu/deploy.py``, ``schnetpack_tpu/utils``), on a
run directory written as the JAX training CLI writes one (PaiNN-16x2 with
a ``Forces`` head, flax-initialised and perturbed):

* the port's artifact loaded by the JAX ``load_deployed`` and the JAX
  package's artifact by the port's: the same config, parameters and
  metadata, and energies (1e-5 relative) and forces (within 1e-4 of the
  largest |F|) of each side's calculator on a molecule;
* the port's ``utils.load_model`` on the run directory and on the
  artifact, and with a registered migration applied to an old config;
* ``export_program=true`` on the CPU: the program's energy and forces at
  the example batch within 1e-6 of the largest |F| of the eager model's;
  ``export_stablehlo=true`` refused naming ``export_program``;
* ``convert``'s metadata on an ASE DB equal to the JAX ``convert``'s;
* ``print_config``'s output equal to the JAX one's.
"""
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import deploy as jdeploy
from schnetpack_tpu.data.atoms import ASEAtomsData as JASEAtomsData
from schnetpack_tpu.interfaces import ase_interface as jase
from schnetpack_tpu.utils import print_config as jprint_config
from schnetpack_tpu_torch import deploy as tdeploy
from schnetpack_tpu_torch import utils as tutils
from schnetpack_tpu_torch.data.atoms import ASEAtomsData
from schnetpack_tpu_torch.interfaces import ase_interface as tase
from schnetpack_tpu_torch.utils import compatibility

from test_torch_port_interfaces import (
    CUTOFF, E_RTOL, forces_close, models, molecule,
)

PROGRAM_SCALE_TOL = 1e-6  # of the largest |F|, the exported program


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    cfg, _, tree, _ = models("painn")
    path = tmp_path_factory.mktemp("run")
    with open(path / "model_config.pkl", "wb") as f:
        pickle.dump(cfg, f)
    with open(path / "best_model", "wb") as f:
        pickle.dump(jax.device_get(tree), f)
    return str(path)


def port_forces(model, atoms, cutoff):
    return tase.SpkCalculator(model, cutoff=cutoff,
                              device="cpu").calculate(atoms)


def jax_forces(model, params, atoms, cutoff):
    return jase.SpkCalculator(model, params, cutoff=cutoff).calculate(atoms)


def test_artifacts_load_across_packages(run_dir, tmp_path):
    mol = molecule(7)
    ours, theirs = str(tmp_path / "port.spk"), str(tmp_path / "jax.spk")
    tdeploy.deploy(run_dir, ours, device="cpu")
    jdeploy.deploy(run_dir, theirs)
    a_port = pickle.load(open(ours, "rb"))
    a_jax = pickle.load(open(theirs, "rb"))
    assert a_port.keys() == a_jax.keys()
    for k in ("format", "model_config", "cutoff", "model_outputs"):
        assert a_port[k] == a_jax[k], k
    assert "energy_per_atom" in a_port["model_outputs"]
    jax.tree.map(np.testing.assert_array_equal, a_port["params"],
                 a_jax["params"])

    jmodel, jparams, meta = jdeploy.load_deployed(ours)
    model, params, art = tdeploy.load_deployed(theirs, device="cpu")
    assert art["cutoff"] == meta["cutoff"] == CUTOFF
    assert model.model_outputs == jmodel.model_outputs
    got, want = port_forces(model, mol, CUTOFF), jax_forces(
        jmodel, jparams, mol, CUTOFF)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=E_RTOL)
    forces_close(got["forces"], want["forces"])
    # each side's own artifact gives the same numbers
    again = port_forces(tdeploy.load_deployed(ours, "cpu")[0], mol, CUTOFF)
    np.testing.assert_array_equal(again["forces"], got["forces"])


def test_load_model_takes_a_run_directory_or_an_artifact(run_dir, tmp_path):
    art = str(tmp_path / "m.spk")
    tdeploy.deploy(run_dir, art, per_atom_energy=False, device="cpu")
    m1, p1 = tutils.load_model(run_dir, device="cpu")
    m2, p2 = tutils.load_model(art, device="cpu")
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    mol = molecule(2)
    np.testing.assert_array_equal(port_forces(m1, mol, CUTOFF)["forces"],
                                  port_forces(m2, mol, CUTOFF)["forces"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tutils.load_model(run_dir)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdeploy.load_deployed(art)


def test_a_registered_migration_is_applied(run_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(compatibility, "_MIGRATIONS", [])
    old = str(tmp_path / "old_run")
    shutil.copytree(run_dir, old)
    cfg = pickle.load(open(os.path.join(old, "model_config.pkl"), "rb"))
    cfg["_version"] = "0.0.5"
    cfg["representation"]["num_features"] = cfg["representation"].pop(
        "n_atom_basis")
    with open(os.path.join(old, "model_config.pkl"), "wb") as f:
        pickle.dump(cfg, f)

    @tutils.register_migration("0.0.9")
    def rename(model_cfg):
        rep = model_cfg["representation"]
        rep["n_atom_basis"] = rep.pop("num_features")
        return model_cfg

    @tutils.register_migration("0.0.1")
    def never(model_cfg):
        raise AssertionError("a migration for older configs ran")

    model, _ = tutils.load_model(old, device="cpu")
    assert model.representation.n_atom_basis == 16
    assert tutils.migrate_config({"_version": "0.2.0", "x": 1}) == {"x": 1}


def test_exported_program_matches_eager(run_dir, tmp_path):
    art = str(tmp_path / "prog.spk")
    tdeploy.deploy(run_dir, art, export_program=True, device="cpu")
    model, _, artifact = tdeploy.load_deployed(art, device="cpu")
    batch = tdeploy._example_batch(artifact["cutoff"], "cpu")
    assert artifact["torch_program_example_shapes"] == {
        k: tuple(v.shape) for k, v in batch.items()}
    E, F = tdeploy.load_program(artifact)(batch)
    E0, F0 = tdeploy.energy_and_forces(model.requires_grad_(False))(batch)
    eager = model(batch)
    np.testing.assert_allclose(F0.numpy(), eager["forces"].numpy(), rtol=0,
                               atol=PROGRAM_SCALE_TOL * float(
                                   eager["forces"].abs().max()))
    scale = float(F0.abs().max())
    assert scale > 0
    np.testing.assert_allclose(F.numpy(), F0.numpy(), rtol=0,
                               atol=PROGRAM_SCALE_TOL * scale)
    np.testing.assert_allclose(E.numpy(), E0.numpy(), rtol=E_RTOL)
    with pytest.raises(SystemExit, match="export_program"):
        tdeploy.main(["deploy", f"model_dir={run_dir}",
                      f"out={tmp_path / 'x.spk'}", "export_stablehlo=true"])


def test_convert_sets_the_jax_metadata(tmp_path):
    db = str(tmp_path / "a.db")
    ASEAtomsData.create(db, distance_unit="Bohr",
                        property_unit_dict={"energy": "Ha"})
    shutil.copy(db, str(tmp_path / "b.db"))
    refs = str(tmp_path / "refs.npz")
    np.savez(refs, energy=np.arange(5.0))
    kw = dict(distance_unit="Ang", property_units="energy:eV,forces:eV/Ang",
              atomrefs_file=refs)
    tdeploy.convert(db, **kw)
    jdeploy.convert(str(tmp_path / "b.db"), **kw)
    got = ASEAtomsData(db).metadata
    assert got == JASEAtomsData(str(tmp_path / "b.db")).metadata
    assert got["_property_unit_dict"] == {"energy": "eV",
                                          "forces": "eV/Ang"}


def test_print_config_matches_jax(capsys):
    config = {"run": {"id": "x", "path": "runs"}, "data": {"batch_size": 4},
              "model": {"representation": {"n_atom_basis": 16}},
              "other": 1, "globals": {"cutoff": 5.0, "arr": (1, 2)}}
    tutils.print_config(config)
    ours = capsys.readouterr().out
    jprint_config(config)
    assert ours == capsys.readouterr().out and "├─ model" in ours
    assert tutils.int2precision(32) is torch.float32
    assert tutils.as_dtype("bfloat16") is torch.bfloat16
    assert tutils.required_fields_from_properties(
        ["polarizability", "dipole_moment", "shielding"]) == [
        "electric_field", "magnetic_field"]
