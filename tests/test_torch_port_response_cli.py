"""PyTorch port, the response slice's entry points against the JAX
package:

* ``md/vibrations.normal_modes`` of a 7-atom molecule under PaiNN-16x2;
* ``transform/response.SplitShielding``;
* ``datasets/qm9.parse_qm9_xyz`` and ``QM9`` built from a synthetic
  archive (QM9's xyz flavour with ``*^`` exponents, an
  ``uncharacterized.txt``) written in ``tmp_path``, against the JAX
  ``QM9`` built from the same files;
* the ``qm9_atomwise``, ``qm9_dipole`` and ``response`` experiments
  composing, and their models building through ``load_model``'s table;
* one train step of the ``response`` experiment's losses (energy,
  forces, dipole, polarizability, shielding) with FieldSchNet-16x2 in
  float64: the loss and every parameter's gradient, which differentiates
  the polarizability a third time, against the JAX task;
* ``spktrain experiment=qm9_dipole`` and ``experiment=response`` end to
  end at small widths, their run directories through ``load_model``;
* NPT with a trained model: the calculator's stress through
  ``System.stress`` to ``NHCBarostatIsotropic`` and ``NPTVelocityVerlet``
  on ``all_pairs``, 10 steps of a 108-atom argon box in float64 against
  the JAX ``Simulator``; and the simulator's refusals.
"""
import os
import tarfile

import jax
import numpy as np
import pytest
import torch

from schnetpack_tpu import atomistic as ja
from schnetpack_tpu import properties as P
from schnetpack_tpu.data.loader import collate, padding_for
from schnetpack_tpu.datasets import QM9 as JQM9
from schnetpack_tpu.datasets.qm9 import parse_qm9_xyz as jparse
from schnetpack_tpu.md import NPTVelocityVerlet as JNPTVelocityVerlet
from schnetpack_tpu.md import Simulator as JSimulator
from schnetpack_tpu.md import simulation_hooks as jhooks
from schnetpack_tpu.md.calculators import SchNetPackCalculator as JCalc
from schnetpack_tpu.md.vibrations import normal_modes as jnormal_modes
from schnetpack_tpu.model import NeuralNetworkPotential as JNNP
from schnetpack_tpu.representation import PaiNN as JPaiNN
from schnetpack_tpu.train import AtomisticTask as JTask
from schnetpack_tpu.train import ModelOutput as JModelOutput
from schnetpack_tpu.transform.response import SplitShielding as JSplitShielding
from schnetpack_tpu.transform.neighborlist import NeighborListTransform
from schnetpack_tpu_torch import atomistic as ta
from schnetpack_tpu_torch import cli
from schnetpack_tpu_torch import properties as TP
from schnetpack_tpu_torch.convert import params_from_jax, params_to_jax
from schnetpack_tpu_torch.data import ASEAtomsData
from schnetpack_tpu_torch.datasets import QM9, parse_qm9_xyz
from schnetpack_tpu_torch.md import (
    NPTVelocityVerlet, Simulator, load_molecules,
)
from schnetpack_tpu_torch.md import simulation_hooks as hooks
from schnetpack_tpu_torch.md.calculators import SchNetPackCalculator
from schnetpack_tpu_torch.md.vibrations import normal_modes
from schnetpack_tpu_torch.model import NeuralNetworkPotential
from schnetpack_tpu_torch.representation import PaiNN
from schnetpack_tpu_torch.train import AtomisticTask, ModelOutput, as_tensors
from schnetpack_tpu_torch.transform import SplitShielding
from test_torch_port_heads import init_tree, painn_pair
from test_torch_port_layouts import _molecule
from test_torch_port_npt import BARO, DT, argon_fcc, momenta, systems
from test_torch_port_response import _field_pair, field_batch

CUTOFF = 5.0
# frequencies: the Hessian's f32 roundoff (SECOND_RTOL of its largest
# entry) over the largest |frequency|
FREQ_RTOL = 1e-4
# float64 runs: the step-0 forces of the two packages agree to 6e-8 of
# their largest (an f32-rounded constant on one side), far under the f32
# roundoff of a model evaluation.  The train step: the loss, relative; per
# leaf, max |diff| over the leaf's largest entry (``params_to_jax`` also
# rounds the port's gradient to f32)
LOSS_RTOL, LEAF_TOL = 1e-8, 1e-5
# the NPT run: positions (nm) after 10 steps; the momenta, cells and
# stress (and the step-0 stress) over their largest entry
NPT_STEPS = 10
NPT_ATOL = 1e-8
NPT_RTOL = 1e-6
RESPONSE_OUTPUTS = (("energy", 1.0), ("forces", 5.0),
                    ("dipole_moment", 0.01), ("polarizability", 0.01),
                    ("shielding", 0.1))
QM9_SYMBOLS = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


# ------------------------------------------------------------ vibrations
def test_normal_modes_match_jax():
    rng = np.random.RandomState(8)
    mol = _molecule(rng, 7)
    samples = [NeighborListTransform(CUTOFF)(mol)]
    b = collate(samples, padding_for(samples))
    jpot, pot = painn_pair([ja.Atomwise(output_key=P.energy)],
                           [ta.Atomwise(16)])
    tree = init_tree(jpot, b)
    want, _ = jnormal_modes(jpot, tree, mol)
    pot.load_state_dict(params_from_jax(tree))
    got, vecs = normal_modes(pot.requires_grad_(False), mol)
    assert got.shape == want.shape == (21,)
    scale = np.abs(want).max()
    assert scale > 100.0                         # cm^-1: real modes
    np.testing.assert_allclose(got, want, rtol=0, atol=FREQ_RTOL * scale)
    np.testing.assert_allclose(vecs.T @ vecs, np.eye(21), atol=1e-10)


def test_split_shielding_matches_jax():
    rng = np.random.RandomState(0)
    Z = np.array([1, 6, 8, 1, 7, 6])
    sigma = rng.randn(6, 3, 3)
    want = JSplitShielding(atomic_numbers=[1, 6, 8])(
        {P.Z: Z, P.shielding: sigma})
    got = SplitShielding(atomic_numbers=[1, 6, 8])(
        {TP.Z: Z, TP.shielding: sigma})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------- QM9
def _qm9_text(index, Z, R, rng):
    """One molecule in QM9's xyz flavour: a comment line of the tag, the
    index and 15 properties, coordinates (one in ``*^`` notation) and a
    charge column, then three trailing lines."""
    props = rng.randn(15)
    lines = [str(len(Z)), "gdb %d\t" % index
             + "\t".join(f"{v:.6f}" for v in props)]
    for k, (z, r) in enumerate(zip(Z, R)):
        x = ("%.6f" % r[0]) if k else ("%.4f*^0" % r[0])
        lines.append(f"{QM9_SYMBOLS[z]}\t{x}\t{r[1]:.6f}\t{r[2]:.6f}\t0.0")
    lines += ["100.0\t200.0", "C\tC", "InChI=1S/fake"]
    return "\n".join(lines) + "\n", props


def write_qm9_archive(raw_dir, n=12, seed=0, skip=(3,)):
    """A QM9 archive of ``n`` molecules of 3-7 atoms and an
    ``uncharacterized.txt`` naming ``skip`` (1-based); returns the
    molecules' (Z, R, properties)."""
    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    written = []
    with tarfile.open(os.path.join(raw_dir, "dsgdb9nsd.xyz.tar.bz2"),
                      "w:bz2") as tar:
        for i in range(1, n + 1):
            mol = _molecule(rng, rng.randint(3, 8))
            Z = rng.choice([1, 6, 7, 8, 9], len(mol[P.Z]))
            text, props = _qm9_text(i, Z, mol[P.R], rng)
            path = os.path.join(raw_dir, f"dsgdb9nsd_{i:06d}.xyz")
            with open(path, "w") as f:
                f.write(text)
            tar.add(path, arcname=os.path.basename(path))
            os.remove(path)
            written.append((Z, mol[P.R], props))
    with open(os.path.join(raw_dir, "uncharacterized.txt"), "w") as f:
        f.write("\n" * 9 + "".join(f"  {i}  0 0\n" for i in skip)
                + "footer\n")
    return written


def test_parse_qm9_xyz_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    mol = _molecule(rng, 5)
    text, props = _qm9_text(7, np.array([6, 1, 1, 8, 9]), mol[P.R], rng)
    Z, R, got = parse_qm9_xyz(text)
    jZ, jR, want = jparse(text)
    np.testing.assert_array_equal(Z, jZ)
    np.testing.assert_array_equal(R, jR)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["energy_U0"], [props[10]], rtol=1e-6)


def test_qm9_database_matches_jax(tmp_path):
    """The port's and the JAX ``QM9`` built from one archive: the same
    molecules (the uncharacterized one dropped), properties, units and
    atom references."""
    raw = str(tmp_path / "raw")
    written = write_qm9_archive(raw)
    dbs = []
    for cls, name in ((QM9, "port"), (JQM9, "jax")):
        dm = cls(datapath=str(tmp_path / name / "qm9.db"), raw_dir=raw,
                 batch_size=4, num_train=6, num_val=3, num_test=2)
        dm.prepare_data()
        dbs.append(dm.datapath)
    port = ASEAtomsData(dbs[0])
    from schnetpack_tpu.data.atoms import ASEAtomsData as JASEAtomsData
    jax_db = JASEAtomsData(dbs[1])
    assert len(port) == len(jax_db) == len(written) - 1
    assert port.units == jax_db.units
    for k in ("energy_U0", "zpve"):
        np.testing.assert_array_equal(port.atomrefs[k], jax_db.atomrefs[k])
    kept = [w for i, w in enumerate(written) if i + 1 != 3]
    for i in range(len(port)):
        a, b = port[i], jax_db[i]
        np.testing.assert_array_equal(a[TP.Z], kept[i][0])
        for k in ("energy_U0", "dipole_moment", TP.R):
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------- experiments
@pytest.mark.parametrize("experiment,outputs", [
    ("qm9_atomwise", ["energy_U0"]),
    ("qm9_dipole", [P.dipole_moment, P.partial_charges]),
    ("response", [P.energy, P.forces, P.dipole_moment, P.polarizability,
                  P.shielding])])
def test_experiment_composes_and_builds(experiment, outputs):
    cfg = cli.default_composer().compose("train", [
        f"experiment={experiment}", "model.representation.n_atom_basis=16",
        "model.representation.n_interactions=1", "data.datapath=x.db"])
    model = cli._build(cli.jax_targets(cfg["model"]), {})
    assert sorted(model.model_outputs) == sorted(outputs)
    task_names = [o["name"] for o in cfg["task"]["outputs"]]
    assert set(task_names) <= set(model.model_outputs)


def _response_batch():
    """``field_batch``'s two molecules in float64 with seeded labels of
    every response output (shielding per atom)."""
    b, A, M = field_batch()
    rng = np.random.RandomState(9)
    b = {k: (np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32
             else np.asarray(v)) for k, v in b.items()}
    nA, nM = len(b[P.Z]), len(b[P.n_atoms])
    b[P.energy] = rng.randn(nM)
    b[P.forces] = rng.randn(nA, 3)
    b[P.dipole_moment] = rng.randn(nM, 3)
    b[P.polarizability] = rng.randn(nM, 3, 3)
    b[P.shielding] = rng.randn(nA, 3, 3)
    return b


def test_response_train_step_matches_jax_in_float64():
    props = [P.forces, P.dipole_moment, P.polarizability, P.shielding]
    b = _response_batch()
    jpot, pot = _field_pair(props)
    with jax.enable_x64(True):
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                            init_tree(jpot, field_batch()[0]))
        jtask = JTask(jpot, [JModelOutput(k, loss_weight=w)
                             for k, w in RESPONSE_OUTPUTS])
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            jtask.loss_and_outputs, has_aux=True))(tree, b)
        jgrads = jax.device_get(jgrads)
    pot.load_state_dict(params_from_jax(tree))
    pot = pot.double()
    task = AtomisticTask(pot, [ModelOutput(k, loss_weight=w)
                               for k, w in RESPONSE_OUTPUTS])
    loss, out, grads = task.gradients(task.create_state(),
                                      as_tensors(b, "cpu"))
    assert out[TP.polarizability].requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = params_to_jax(pot, grads)["params"]

    def leaves(node, path=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield path + "/" + k, np.asarray(v, np.float64)
    want = dict(leaves(jgrads["params"]))
    got = dict(leaves(got))
    assert set(got) == set(want)
    for k, w in want.items():
        if not w.any():         # the last block's dipole update feeds nothing
            assert not got[k].any(), k
            continue
        err = np.abs(got[k] - w).max() / np.abs(w).max()
        assert err <= LEAF_TOL, (k, err)


# ------------------------------------------------------------ spktrain
def _overrides(tmp_path, experiment, extra):
    return [f"experiment={experiment}", f"run.path={tmp_path}/runs",
            f"run.id={experiment}", f"run.data_dir={tmp_path}/data",
            "data.num_train=8", "data.num_val=2", "data.num_test=2",
            "data.batch_size=4", "trainer.progress=false",
            "trainer.max_epochs=2", "model.representation.n_atom_basis=16",
            "model.representation.n_interactions=1",
            "model.representation.n_rbf=8", "device=cpu",
            "print_config=false"] + extra


def write_response_db(path, n=12, seed=3):
    """A custom database of ``n`` molecules (H, C, O) with energy,
    forces, dipole, polarizability and shielding labels."""
    rng = np.random.RandomState(seed)
    ds = ASEAtomsData.create(path, distance_unit="Ang", property_unit_dict={
        "energy": "eV", "forces": "eV/Ang", "dipole_moment": "e*Ang",
        "polarizability": "Ang^3", "shielding": "ppm"})
    systems_ = []
    for _ in range(n):
        mol = _molecule(rng, rng.randint(4, 8))
        A = len(mol[P.Z])
        systems_.append(dict(
            numbers=rng.choice([1, 6, 8], A), positions=mol[P.R],
            energy=rng.randn(1), forces=rng.randn(A, 3),
            dipole_moment=rng.randn(1, 3), polarizability=rng.randn(1, 3, 3),
            shielding=rng.randn(A, 3, 3)))
    ds.add_systems(systems_)


def _check_run(run, fit_out):
    metrics, task, state, dm = fit_out
    assert np.isfinite(metrics["test_loss"])
    for f in ("best_model", "model_config.pkl", "checkpoints/last.ckpt"):
        assert os.path.exists(os.path.join(run, f)), f
    best = torch.load(os.path.join(run, "checkpoints", "best.ckpt"),
                      weights_only=False)
    state.load_state_dict(best["state"])
    batch = as_tensors(next(iter(dm.test_dataloader())), "cpu")
    M = int(batch[TP.mol_mask].sum())
    want = task.model(batch)
    loaded, _ = cli.load_model(run, "cpu")
    got = loaded(batch)
    for k in task.model.model_outputs:
        w, g = want[k].detach(), got[k].detach()
        if w.shape[0] == batch[TP.n_atoms].shape[0]:
            w, g = w[:M], g[:M]
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_spktrain_qm9_dipole(tmp_path):
    write_qm9_archive(str(tmp_path / "raw"), n=14)
    cfg = cli.default_composer().compose("train", _overrides(
        tmp_path, "qm9_dipole", [f"data.raw_dir={tmp_path}/raw"]))
    out = cli.fit(cfg)
    assert {P.dipole_moment, P.partial_charges} <= set(
        out[1].model.model_outputs)
    _check_run(str(tmp_path / "runs" / "qm9_dipole"), out)


def test_spktrain_response(tmp_path):
    db = str(tmp_path / "response.db")
    write_response_db(db)
    cfg = cli.default_composer().compose("train", _overrides(
        tmp_path, "response", [f"data.datapath={db}"]))
    out = cli.fit(cfg)
    _check_run(str(tmp_path / "runs" / "response"), out)


# ------------------------------------------------------------------ NPT
def _stress_models():
    """(JAX potential and float64 tree, port potential) of PaiNN-16x1
    with ``Forces(calc_stress=True)``."""
    common = dict(n_atom_basis=16, n_interactions=1, n_rbf=8, cutoff=CUTOFF)
    jpot = JNNP(representation=JPaiNN(**common),
                input_modules=[ja.PairwiseDistances()],
                output_modules=[ja.Atomwise(output_key=P.energy),
                                ja.Forces(calc_stress=True)])
    s = NeighborListTransform(CUTOFF)(argon_fcc(reps=3))
    # weights scaled down (a softer potential keeps the 20 steps smooth)
    # in f32, so that both packages hold the same numbers
    tree = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) * np.float32(0.3)).astype(
            np.float64), init_tree(jpot, collate([s], padding_for([s]))))
    pot = NeuralNetworkPotential(
        PaiNN(**common), [ta.Atomwise(16), ta.Forces(calc_stress=True)],
        input_modules=[ta.PairwiseDistances()])
    pot.load_state_dict(params_from_jax(tree))
    return jpot, tree, pot.double()


def test_npt_with_a_model_stress_matches_jax():
    mol = argon_fcc(reps=3)
    p = momenta(mol)
    jpot, tree, pot = _stress_models()
    with jax.enable_x64(True):
        js, s = systems(mol, 1, p)
        jcalc = JCalc(jpot, tree, cutoff=CUTOFF, stress_key=P.stress)
        calc = SchNetPackCalculator(pot, cutoff=CUTOFF, stress_key=P.stress)
        s0 = calc.calculate(s, calc.init_state(s))
        js0 = jcalc.calculate(js)
        scale = np.abs(np.asarray(js0.stress)).max()
        np.testing.assert_allclose(s0.stress.numpy(), np.asarray(js0.stress),
                                   rtol=0, atol=NPT_RTOL * scale)
        assert scale > 1e-6
        jb = jhooks.NHCBarostatIsotropic(**BARO)
        b = hooks.NHCBarostatIsotropic(**BARO)
        jsim = JSimulator(js, JNPTVelocityVerlet(DT, jb), jcalc,
                          simulator_hooks=[jb], progress=False,
                          log_keys=("energy",))
        jsim.simulate(NPT_STEPS, chunk_size=NPT_STEPS)
        want = jsim.state.system
    sim = Simulator(s, NPTVelocityVerlet(DT, b), calc, simulator_hooks=[b],
                    log_keys=("energy",))
    sim.simulate(NPT_STEPS, chunk_size=10)
    for k in ("positions", "momenta", "cells", "stress"):
        w = np.asarray(getattr(want, k))
        atol = NPT_ATOL if k == "positions" else NPT_RTOL * np.abs(w).max()
        np.testing.assert_allclose(getattr(sim.system, k).numpy(), w,
                                   rtol=0, atol=atol, err_msg=k)
    assert not torch.equal(sim.system.cells, s.cells)   # the box moved


@pytest.mark.parametrize("neighbor_list", ["dense", "cellblock_atom"])
def test_npt_refuses_a_skin_neighbor_list(neighbor_list):
    _, _, pot = _stress_models()
    calc = SchNetPackCalculator(pot, cutoff=CUTOFF, stress_key=P.stress,
                                neighbor_list=neighbor_list)
    s = load_molecules([argon_fcc(reps=3)], dtype=torch.float64,
                       device="cpu")
    b = hooks.NHCBarostatIsotropic(**BARO)
    with pytest.raises(ValueError, match="all_pairs"):
        Simulator(s, NPTVelocityVerlet(DT, b), calc, simulator_hooks=[b])
