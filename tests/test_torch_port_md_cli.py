"""PyTorch port, ``spkmd`` on the CPU against the JAX package:

* the port's YAML reader against ``yaml.safe_load`` on every config file
  of the port and on override values, and ``save_config`` round trips;
* the composed config of every group and name against the JAX
  ``Composer``'s, targets mapped to the port (and the port's ``device``
  key aside);
* ``load_structures`` against the JAX one;
* the simulator's default log keys are the JAX package's eight;
* ``spkmd calculator=lj dynamics=nve system.initializer=null`` on the
  8-atom cluster of ``tests/test_md_cli.py``: the port's trajectory file
  against the JAX ``spkmd``'s, the same datasets and attrs, positions
  within 1e-5 nm;
* ``dynamics=npt`` on the 32-atom LJ argon box of
  ``test_npt_gle.py::argon_fcc`` (``calculator.calc_stress=true``): it runs
  in the port, and matches the JAX ``dynamics=nve barostat=nhc_iso`` route
  (the same barostat constants; the JAX ``dynamics=npt`` builds its
  integrator before the barostat and fails);
* ``restart=`` appends to the trajectory file, and 20 + 10 steps equal 30;
* the options the port refuses raise before the first step;
* ``calculator=orca`` runs a stub ORCA executable;
* an ensemble's ``model_dirs`` string is split and stripped.
"""
import glob
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from schnetpack_tpu.config.compose import Composer as JComposer
from schnetpack_tpu.md.cli import load_structures as jload_structures
from schnetpack_tpu.md.cli import main as jspkmd
from schnetpack_tpu_torch.config import miniyaml
from schnetpack_tpu_torch.config.compose import Composer, save_config
from schnetpack_tpu_torch.md import cli
from schnetpack_tpu_torch.md.simulator import LOG_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(ROOT, "schnetpack_tpu", "md", "md_configs")
PORT_CONFIGS = os.path.join(ROOT, "schnetpack_tpu_torch", "md", "md_configs")
CONFIG_FILES = sorted(os.path.relpath(p, PORT_CONFIGS) for p in glob.glob(
    os.path.join(PORT_CONFIGS, "**", "*.yaml"), recursive=True))
GROUPS = [(os.path.dirname(f), os.path.basename(f)[:-5])
          for f in CONFIG_FILES if os.path.dirname(f)]
# positions after 20 f32 steps of both packages
POS_ATOL = 1e-5       # nm
OVERRIDE_VALUES = [
    "1", "-3", "+7", "0x1f", "017", "0b101", "1_000", "1:30", "0", "1.5",
    "5.0e-4", "1.0e+3", "1e-3", "3.", ".5", ".inf", "-.Inf", ".nan", "true",
    "False", "yes", "off", "null", "~", "", "???", "${globals.cutoff}",
    "mdsim_${petname:}", "[a, b]", "[run1,run2]", "[1, 2.0, null, [x]]",
    "{a: 1, b: [x, y]}", "[]", "{}", "'quoted # not a comment'",
    '"double \\n quoted"', "'it''s'", "x # a comment", "- item",
    "key: value", "schnetpack_tpu_torch.md.simulation_hooks.NHCThermostat",
    "/tmp/run dir/water.xyz", "a:b", "12:30:45", "energy", "Ang",
    "kcal/mol"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def to_port(node):
    """A JAX config with its targets mapped to the port's classes."""
    if isinstance(node, dict):
        return {k: (v.replace("schnetpack_tpu.", "schnetpack_tpu_torch.", 1)
                    if k == "_target_" else to_port(v))
                for k, v in node.items()}
    if isinstance(node, list):
        return [to_port(v) for v in node]
    return node


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_yaml_reader_matches_pyyaml_on_configs(name):
    path = os.path.join(PORT_CONFIGS, name)
    with open(path) as f:
        text = f.read()
    assert miniyaml.loads(text) == yaml.safe_load(text)
    # and the port's file is the JAX package's, targets mapped, plus the
    # port's device key
    want = to_port(yaml.safe_load(open(os.path.join(JAX_CONFIGS, name))))
    got = miniyaml.loads(text)
    if name == "config.yaml":
        assert got.pop("device") == "cuda"
    assert got == want


def test_yaml_reader_matches_pyyaml_on_values():
    for v in OVERRIDE_VALUES:
        want = yaml.safe_load(v)
        got = miniyaml.loads(v)
        assert got == want or (got != got and want != want), (v, got, want)
        assert type(got) is type(want), (v, got, want)


def test_save_config_round_trips(tmp_path):
    cfg = Composer([PORT_CONFIGS]).compose("config", [
        "calculator=ensemble", "calculator.model_dirs=[run a,run2]",
        "thermostat=piglet", "+extra={x: [1, 2.5e-4, null], y: 'a: b'}",
        "+empty=[]", "+nested=[[1, 2], [3]]", "+quote='it''s'"])
    path = str(tmp_path / "config.yaml")
    save_config(cfg, path)
    with open(path) as f:
        text = f.read()
    assert yaml.safe_load(text) == cfg
    assert miniyaml.loads(text) == cfg


@pytest.mark.parametrize("group,name", GROUPS)
def test_composed_config_matches_jax(group, name):
    argv = [f"{group}={name}", "simulation_dir=sim"]
    want = to_port(JComposer([JAX_CONFIGS]).compose("config", argv))
    got = Composer([PORT_CONFIGS]).compose("config", argv)
    assert got.pop("device") == "cuda"
    assert got == want


def test_load_structures_matches_jax(tmp_path):
    path = str(tmp_path / "two.xyz")
    with open(path, "w") as f:
        f.write("2\nargon dimer\nAr 0 0 0\nAr 3.8 0.2 0.1\n"
                '3\nLattice="6 0 0 0 6 0 0 0 6" pbc="T T T"\n'
                "O 0 0 0\nH 0.76 0.67 0\nH -0.76 0.67 1e-3\n")
    want, got = jload_structures(path), cli.load_structures(path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="reads \\(ext\\)xyz only"):
        cli.load_structures(str(tmp_path / "water.pdb"))


def test_default_log_keys_are_the_jax_packages():
    import inspect

    from schnetpack_tpu.md import Simulator as JSimulator
    from schnetpack_tpu_torch.md import Simulator

    jdefault = inspect.signature(JSimulator).parameters["log_keys"].default
    assert LOG_KEYS == tuple(jdefault)
    assert inspect.signature(Simulator).parameters[
        "log_keys"].default == LOG_KEYS


def argon_cluster_xyz(path):
    """``tests/test_md_cli.py``'s 8-atom argon cluster."""
    rng = np.random.RandomState(0)
    pos = np.array([[i * 3.9, j * 3.9, k * 3.9] for i in range(2)
                    for j in range(2) for k in range(2)]) + rng.rand(8, 3) * 0.05
    with open(path, "w") as f:
        f.write("8\nargon cluster\n" + "".join(
            f"Ar {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in pos))


def argon_box_xyz(path, jitter=0.05):
    """``test_npt_gle.py::argon_fcc`` (32 atoms, a = 5.26 A), displaced by
    a seeded jitter."""
    from schnetpack_tpu_torch.datasets import write_extxyz

    a = 5.26
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    pos = np.concatenate([(base + [i, j, k]) * a for i in range(2)
                          for j in range(2) for k in range(2)])
    pos = pos + jitter * np.random.RandomState(1).randn(*pos.shape)
    write_extxyz(path, [{"numbers": np.full(32, 18), "positions": pos,
                         "cell": np.eye(3) * 2 * a}])


def read_h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        for g in ("molecules", "properties"):
            out[g + "/attrs"] = dict(f[g].attrs)
            for k in f[g]:
                out[f"{g}/{k}"] = f[f"{g}/{k}"][:]
    return out


def assert_files_match(got, want, pos_atol=POS_ATOL):
    assert sorted(got) == sorted(want)
    for g in ("molecules", "properties"):
        a, b = got.pop(g + "/attrs"), want.pop(g + "/attrs")
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, err_msg=k)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
    np.testing.assert_allclose(got["molecules/positions"],
                               want["molecules/positions"], rtol=0,
                               atol=pos_atol)
    np.testing.assert_allclose(got["molecules/cells"],
                               want["molecules/cells"], rtol=0, atol=pos_atol)
    np.testing.assert_allclose(got["properties/temperature"],
                               want["properties/temperature"], rtol=1e-3,
                               atol=1e-3)


def test_spkmd_lj_file_matches_jax(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    argv = [f"system.molecule_file={xyz}", "calculator=lj", "dynamics=nve",
            "dynamics.n_steps=20", "dynamics.chunk_size=10",
            "system.initializer=null"]
    jspkmd(argv + [f"simulation_dir={tmp_path / 'jax'}"])
    sim = cli.main(argv + [f"simulation_dir={tmp_path / 'port'}",
                           "device=cpu"])
    got = read_h5(str(tmp_path / "port" / "simulation.hdf5"))
    want = read_h5(str(tmp_path / "jax" / "simulation.hdf5"))
    assert got["molecules/positions"].shape == (20, 1, 8, 3)
    # the last frame is the simulator's state
    np.testing.assert_array_equal(got["molecules/positions"][-1],
                                  sim.system.positions.numpy())
    # from rest the cluster moves ~1e-5 nm in 20 steps: hold the
    # displacements to a few float32 ulps of the positions (3e-8 nm)
    moved = got["molecules/positions"] - got["molecules/positions"][0]
    assert np.abs(moved).max() > 5e-6
    np.testing.assert_allclose(
        moved, want["molecules/positions"] - want["molecules/positions"][0],
        rtol=0, atol=2e-7)
    assert_files_match(got, want)


def test_spkmd_npt_matches_jax_barostat_route(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    argon_box_xyz(xyz)
    argv = [f"system.molecule_file={xyz}", "calculator=lj",
            "calculator.calc_stress=true", "calculator.cutoff=5.0",
            "dynamics.n_steps=20", "dynamics.chunk_size=10",
            "system.initializer=null", "callbacks=hdf5"]
    jspkmd(argv + ["dynamics=nve", "barostat=nhc_iso",
                   f"simulation_dir={tmp_path / 'jax'}"])
    sim = cli.main(argv + ["dynamics=npt", f"simulation_dir={tmp_path}/port",
                           "device=cpu"])
    assert type(sim.integrator).__name__ == "NPTVelocityVerlet"
    assert sim.integrator.barostat is sim.device_hooks[0]
    got = read_h5(str(tmp_path / "port" / "simulation.hdf5"))
    want = read_h5(str(tmp_path / "jax" / "simulation.hdf5"))
    assert_files_match(got, want)
    cells = got["molecules/cells"]
    assert np.abs(cells[-1] - cells[0]).max() > 1e-9      # the box moved


def test_spkmd_restart_appends(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    argv = [f"system.molecule_file={xyz}", "calculator=lj", "dynamics=nvt",
            "thermostat=langevin", "thermostat.temperature_bath=40",
            "thermostat.time_constant=20", "dynamics.chunk_size=10",
            "callbacks.checkpoint.every_n_steps=20",
            "system.initializer.temperature=40", "device=cpu"]
    whole = cli.main(argv + ["dynamics.n_steps=30",
                             f"simulation_dir={tmp_path / 'whole'}"])
    part = str(tmp_path / "part")
    cli.main(argv + ["dynamics.n_steps=20", f"simulation_dir={part}"])
    with pytest.raises(FileExistsError):
        cli.main(argv + ["dynamics.n_steps=10", f"simulation_dir={part}"])
    resumed = cli.main(argv + [
        "dynamics.n_steps=10", f"simulation_dir={part}",
        f"restart={os.path.join(part, 'checkpoint.pkl')}"])
    assert resumed.n_simulated == 30
    assert torch.equal(resumed.system.positions, whole.system.positions)
    got = read_h5(os.path.join(part, "simulation.hdf5"))
    want = read_h5(str(tmp_path / "whole" / "simulation.hdf5"))
    assert got["molecules/positions"].shape[0] == 30
    for k in want:
        if not k.endswith("attrs"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("override,error,match", [
    ("dynamics.integrator._target_="
     "schnetpack_tpu_torch.md.NPTVelocityVerlet", ValueError,
     "needs a barostat"),
    ("system.molecule_file=water.pdb", ValueError, "reads \\(ext\\)xyz"),
])
def test_spkmd_refuses_before_the_first_step(tmp_path, override, error,
                                             match):
    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    argv = [f"system.molecule_file={xyz}", "calculator=lj", "dynamics=nve",
            f"simulation_dir={tmp_path / 'sim'}", "device=cpu", override]
    with pytest.raises(error, match=match):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "sim" / "simulation.hdf5")


def test_spkmd_runs_the_orca_calculator(tmp_path):
    """``calculator=orca`` (refused before the ORCA calculator was ported)
    runs the executable it is given: a stub of LJ argon
    (``test_torch_port_orca.write_stub``)."""
    from schnetpack_tpu_torch.md.calculators import OrcaCalculator
    from test_torch_port_orca import write_stub

    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    sim = cli.main([
        f"system.molecule_file={xyz}", "calculator=orca",
        f"calculator.orca_path={write_stub(tmp_path)}",
        f"calculator.working_dir={tmp_path / 'orca'}", "dynamics=nve",
        "dynamics.n_steps=2", "device=cpu",
        f"simulation_dir={tmp_path / 'sim'}"])
    assert isinstance(sim.calculator, OrcaCalculator)
    assert sim.n_simulated == 2
    assert torch.isfinite(sim.system.forces).all()
    assert float(sim.system.forces.abs().max()) > 0
    got = read_h5(os.path.join(str(tmp_path / "sim"), "simulation.hdf5"))
    assert got["molecules/positions"].shape[0] == 2


@pytest.mark.parametrize("value", ["[run1,run2]", "[run1, run2]",
                                   " [run1 ,  run2] ", ["run1", "run2"]])
def test_ensemble_model_dirs_are_stripped(value):
    """An ensemble's ``model_dirs`` string names the same run directories
    with or without spaces after its commas (the JAX parse keeps them,
    and ``load_model(' run2')`` fails)."""
    assert cli._model_dirs(value) == ["run1", "run2"]
