"""PyTorch port, the ORCA parsers and calculator on the CPU against the JAX
package (``schnetpack_tpu/md/parsers/orca_parser.py``,
``schnetpack_tpu/md/calculators/orca.py``):

* the parsers on ``tests/test_orca_parser.py``'s synthetic files (the main
  output, the hessian files, the block engine's full property set): equal
  dicts;
* ``OrcaCalculator`` with a stub ``orca`` executable (a Python script that
  reads the ``.inp`` and writes ORCA's ``FINAL SINGLE POINT ENERGY`` and
  ``CARTESIAN GRADIENT`` blocks of a Lennard-Jones argon potential): its
  ``.inp`` files byte for byte the JAX calculator's, its energies (1e-5
  relative) and forces (within 1e-4 of the largest |F|) those of the JAX
  ``OrcaCalculator.calculate`` called eagerly, its forces -dE/dR of the
  stub's potential (within 1e-6 of the largest |F|: the gradient's 12
  printed decimals and f32);
* ``spkmd calculator=orca`` on the port: 20 NVE steps of
  ``tests/test_md_cli.py``'s 8-atom argon cluster, total energy drift
  <= 1e-4 eV/atom;
* the JAX ``spkmd calculator=orca`` raises: its ``Simulator`` runs the
  steps as one jitted scan, and the calculator's ``np.asarray`` of the
  traced positions fails (a reference-side fault, ROADMAP Queue 3).
"""
import os
import sys

import numpy as np
import pytest
import torch

from schnetpack_tpu.md import load_molecules as jload_molecules
from schnetpack_tpu.md.calculators.orca import (
    OrcaCalculator as JOrcaCalculator,
)
from schnetpack_tpu.md.cli import main as jspkmd
from schnetpack_tpu.md.parsers import orca_parser as jparser
from schnetpack_tpu_torch import properties as P
from schnetpack_tpu_torch.md import cli, load_molecules
from schnetpack_tpu_torch.md.calculators import OrcaCalculator
from schnetpack_tpu_torch.md.parsers import orca_parser as tparser
from schnetpack_tpu_torch import units
from schnetpack_tpu_torch.units import _parse_unit, md_units

from test_orca_parser import (
    HESS_FILE, MAIN_OUTPUT, MAIN_WITH_RESPONSE, _matrix_block,
)
from test_torch_port_md_cli import argon_cluster_xyz

EPS, SIGMA = 0.0104, 3.4            # eV, Angstrom: LJ argon
HARTREE, BOHR = units.Hartree, units.Bohr       # eV, Angstrom
DRIFT_TOL = 1e-4                    # eV per atom
E_RTOL, F_SCALE_TOL = 1e-5, 1e-4
LJ_FORCE_TOL = 1e-6                 # of the largest |F|

STUB = '''#!{python}
"""A stand-in for the orca executable: LJ argon from the .inp's atoms."""
import sys

EPS, SIGMA, HARTREE, BOHR = {eps!r}, {sigma!r}, {hartree!r}, {bohr!r}
lines = open(sys.argv[1]).read().splitlines()
start = lines.index("* xyz 0 1") + 1
atoms = [ln.split() for ln in lines[start:lines.index("*", start)]]
R = [[float(x) for x in a[1:4]] for a in atoms]
E, G = 0.0, [[0.0, 0.0, 0.0] for _ in R]
for i in range(len(R)):
    for j in range(len(R)):
        if i == j:
            continue
        d = [R[i][k] - R[j][k] for k in range(3)]
        r2 = sum(x * x for x in d)
        sr6 = (SIGMA * SIGMA / r2) ** 3
        E += 2 * EPS * (sr6 * sr6 - sr6)
        for k in range(3):
            G[i][k] += 4 * EPS * (6 * sr6 - 12 * sr6 * sr6) / r2 * d[k]
print("FINAL SINGLE POINT ENERGY %.12f" % (E / HARTREE))
print("------------------\\nCARTESIAN GRADIENT\\n------------------\\n")
for k, (a, g) in enumerate(zip(atoms, G)):
    g = [x * BOHR / HARTREE for x in g]
    print("%4d   %s  : %16.12f %16.12f %16.12f" % (k + 1, a[0], *g))
'''


def write_stub(directory):
    """The stub orca executable in ``directory``/bin; its path."""
    os.makedirs(os.path.join(str(directory), "bin"), exist_ok=True)
    path = os.path.join(str(directory), "bin", "orca")
    with open(path, "w") as f:
        f.write(STUB.format(python=sys.executable, eps=EPS, sigma=SIGMA,
                            hartree=HARTREE, bohr=BOHR))
    os.chmod(path, 0o755)
    return path


def lj_forces(R):
    """-dE/dR of the stub's potential, eV/A, float64."""
    d = R[:, None] - R[None]
    r = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(r, np.inf)
    sr6 = (SIGMA / r) ** 6
    return -np.sum((4 * EPS * (6 * sr6 - 12 * sr6 ** 2) / r ** 2)[..., None]
                   * d, axis=1)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, (list, tuple)):
            assert len(got[k]) == len(v)
            for a, b in zip(got[k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_parsers_match_jax(tmp_path):
    main = tmp_path / "mol.out"
    main.write_text(MAIN_OUTPUT)
    (tmp_path / "mol.hess").write_text(HESS_FILE)
    _same(tparser.OrcaMainFileParser().parse_file(str(main)),
          jparser.OrcaMainFileParser().parse_file(str(main)))
    for props in (None, ["energy", "hessian"]):
        _same(tparser.OrcaParser(props).parse(str(main)),
              jparser.OrcaParser(props).parse(str(main)))
    rng = np.random.RandomState(0)
    big = tmp_path / "big.hess"
    big.write_text("$orca_hessian_file\n\n" + _matrix_block(
        "$hessian", rng.randn(9, 9)) + "\n$vibrational_frequencies\n3\n"
        "   0     1.0\n   1     2.0\n   2     3.0\n\n"
        + _matrix_block("$normal_modes", rng.randn(9, 9)) + "\n$end\n")
    _same(tparser.OrcaHessianFileParser().parse_file(str(big)),
          jparser.OrcaHessianFileParser().parse_file(str(big)))
    resp = tmp_path / "resp.out"
    resp.write_text(MAIN_WITH_RESPONSE)
    got, want = tparser.make_main_block_parser(), \
        jparser.make_main_block_parser()
    got.parse_file(str(resp))
    want.parse_file(str(resp))
    _same(got.get_parsed(), want.get_parsed())
    deriv = rng.randn(9, 6)
    np.testing.assert_array_equal(
        tparser.format_polarizability_derivatives(deriv),
        jparser.format_polarizability_derivatives(deriv))
    assert tparser.ppm2au == jparser.ppm2au


def test_calculator_matches_jax_called_eagerly(tmp_path):
    stub = write_stub(tmp_path)
    rng = np.random.RandomState(2)
    mols = [{P.Z: np.full(n, 18), P.R: rng.uniform(0, 1, (n, 3)) * 2.5
             + np.arange(n)[:, None] * np.array([3.6, 0.4, 0.2])}
            for n in (4, 3)]
    dirs = {k: str(tmp_path / k) for k in ("port", "jax")}
    system = load_molecules(mols, n_replicas=2, device="cpu")
    system = system.replace(positions=system.positions + 0.01 * torch.arange(
        2.0)[:, None, None])
    calc = OrcaCalculator(orca_path=stub, working_dir=dirs["port"])
    got = calc.calculate(system)
    jsys = jload_molecules(mols, n_replicas=2)
    jsys = jsys.replace(positions=jsys.positions + 0.01 * np.arange(
        2.0)[:, None, None])
    want = JOrcaCalculator(orca_path=stub,
                           working_dir=dirs["jax"]).calculate(jsys)
    names = sorted(f for f in os.listdir(dirs["jax"]) if f.endswith(".inp"))
    assert names == ["mol_0_0.inp", "mol_0_1.inp", "mol_1_0.inp",
                     "mol_1_1.inp"]
    assert sorted(f for f in os.listdir(dirs["port"])
                  if f.endswith(".inp")) == names
    for n in names:
        with open(os.path.join(dirs["port"], n), "rb") as a, \
                open(os.path.join(dirs["jax"], n), "rb") as b:
            assert a.read() == b.read(), n
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=E_RTOL)
    F, jF = got.forces.numpy(), np.asarray(want.forces)
    np.testing.assert_allclose(F, jF, rtol=0,
                               atol=F_SCALE_TOL * np.abs(jF).max())
    # -dE/dR of the stub's potential at the positions of the .inp files
    # (the f32 positions' digits), per molecule and replica, in eV/A
    md = md_units()
    to_ev_ang = (_parse_unit("eV") * md.energy) / (_parse_unit("Ang")
                                                   * md.length)
    idx_m = system.idx_m.numpy()
    for r in range(2):
        for m in range(2):
            with open(os.path.join(dirs["port"], f"mol_{r}_{m}.inp")) as f:
                rows = f.read().splitlines()[2:-1]
            want_f = lj_forces(np.array([[float(x) for x in row.split()[1:]]
                                         for row in rows]))
            np.testing.assert_allclose(
                F[r, idx_m == m] / to_ev_ang, want_f, rtol=0,
                atol=LJ_FORCE_TOL * np.abs(want_f).max())


def test_spkmd_with_orca_conserves_energy(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    stub = write_stub(tmp_path)
    sim = cli.main([
        f"system.molecule_file={xyz}", "calculator=orca",
        f"calculator.orca_path={stub}",
        f"calculator.working_dir={tmp_path / 'orca'}", "dynamics=nve",
        "dynamics.n_steps=20", "dynamics.chunk_size=10",
        "system.initializer.temperature=50.0", "device=cpu",
        f"simulation_dir={tmp_path / 'sim'}"])
    assert isinstance(sim.calculator, OrcaCalculator)
    assert sim.n_simulated == 20
    logs = {k: np.concatenate([lg[k] for lg in sim.logs])
            for k in ("energy", "kinetic_energy")}
    e_conv = _parse_unit("eV") * md_units().energy
    total = (logs["energy"] + logs["kinetic_energy"])[:, 0, 0] / e_conv
    drift = np.abs(total - total[0]).max() / sim.system.total_atoms
    assert drift <= DRIFT_TOL
    assert os.path.exists(tmp_path / "orca" / "mol_0_0.out")
    assert float(logs["kinetic_energy"][-1].max()) > 0


def test_jax_spkmd_with_orca_fails_under_jit(tmp_path):
    xyz = str(tmp_path / "argon.xyz")
    argon_cluster_xyz(xyz)
    stub = write_stub(tmp_path)
    import jax

    with pytest.raises(jax.errors.TracerArrayConversionError):
        jspkmd([f"system.molecule_file={xyz}", "calculator=orca",
                f"calculator.orca_path={stub}",
                f"calculator.working_dir={tmp_path / 'orca'}",
                "dynamics=nve", "dynamics.n_steps=2",
                f"simulation_dir={tmp_path / 'sim'}"])
