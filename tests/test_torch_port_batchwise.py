"""PyTorch port, batchwise relaxation on the CPU against the JAX package
(``schnetpack_tpu/interfaces/batchwise.py``), both sides with the same
weights (``test_torch_port_interfaces.models``):

* ``BatchwiseCalculator`` and ``BatchwiseEnsembleCalculator`` on 4
  molecules in one batch: energies 1e-5 relative, forces within 1e-4 of
  the largest |F|;
* ``batchwise_lbfgs``: driven by one calculator, the port's and the JAX
  package's float64 host recursions give equal positions bit for bit, with
  and without a fixed-atoms mask; each driven by its own package's model,
  the positions after each of the first 5 iterations within 1e-5 A of
  each other (the forces differ by f32 roundoff, ~1e-7 eV/A here), with
  and without the mask (the fixed atoms do not move), and the same
  convergence flags and iteration counts at a loose fmax.  The initial
  Hessian guess ``alpha`` is 1 eV/A^2, the scale of these random-weight
  models' curvature: at ASE's 70, made for stiff bonds, the first step is
  ~1% of the model's own and the second step's curvature pair (a difference
  of two nearly equal f32 forces) amplifies the roundoff ~1e3 on both
  sides alike (up to 8e-5 A apart after 5 iterations on the CPU);
* per-structure curvature (``tests/test_interfaces.py:175``): relaxing
  [A, B] gives A the trajectory of relaxing [A] alone.
"""
import numpy as np
import pytest
import torch

from schnetpack_tpu import properties as P
from schnetpack_tpu.interfaces import ase_interface as jase
from schnetpack_tpu.interfaces import batchwise as jbw
from schnetpack_tpu_torch.interfaces import ase_interface as tase
from schnetpack_tpu_torch.interfaces import batchwise as tbw

from test_torch_port_interfaces import (
    CUTOFF, E_RTOL, forces_close, models, molecule, water,
)

POS_ATOL = 1e-5           # Angstrom, LBFGS positions over 5 iterations
ALPHA = 1.0               # eV/A^2, the initial Hessian guess (see above)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def calculators():
    _, jpot, tree, pot = models("painn")
    port = tbw.BatchwiseCalculator(
        pot, None, tase.AtomsConverter(cutoff=CUTOFF, device="cpu"))
    jax_ = jbw.BatchwiseCalculator(jpot, tree,
                                   jase.AtomsConverter(cutoff=CUTOFF))
    return port, jax_


def structures(n=4, seed=5):
    """``n`` molecules of 5, 6, ... atoms on sites of a 1.3 A grid, jittered
    by +-0.15 A.  (On random clumps with atoms under 1 A apart the
    recursion's curvature is ill-conditioned: one step amplified the f32
    force roundoff of both sides ~300x, to 2.2e-5 A after 5 iterations.)"""
    rng = np.random.RandomState(seed)
    grid = np.array([(i, j, k) for i in range(3) for j in range(3)
                     for k in range(3)], float)
    out = []
    for s in range(n):
        k = 5 + s
        R = (grid[rng.choice(len(grid), k, replace=False)] * 1.3
             + rng.uniform(-0.15, 0.15, (k, 3)))
        out.append({P.Z: rng.choice([1, 6, 8], k), P.R: R,
                    P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)})
    return out


def test_batchwise_calculator_matches_jax(calculators):
    port, jax_ = calculators
    e, f = port.calculate(structures())
    je, jf = jax_.calculate(structures())
    assert e.shape == je.shape == (4,)
    np.testing.assert_allclose(e, je, rtol=E_RTOL)
    assert [x.shape for x in f] == [x.shape for x in jf]
    forces_close(np.concatenate(f), np.concatenate(jf))


def test_batchwise_ensemble_matches_jax():
    _, jpot, tree, pot = models("painn", seed=0)
    _, _, tree2, pot2 = models("painn", seed=2)
    port = tbw.BatchwiseEnsembleCalculator(
        [pot, pot2], converter=tase.AtomsConverter(cutoff=CUTOFF,
                                                   device="cpu"))
    jax_ = jbw.BatchwiseEnsembleCalculator(
        jpot, [tree, tree2], jase.AtomsConverter(cutoff=CUTOFF))
    e, f = port.calculate(structures())
    je, jf = jax_.calculate(structures())
    np.testing.assert_allclose(e, je, rtol=E_RTOL)
    forces_close(np.concatenate(f), np.concatenate(jf))


def fixed_mask(mols, fixed):
    mask = np.zeros(sum(len(m[P.Z]) for m in mols), bool)
    if fixed:
        mask[[0, 3, 7, 20]] = True
    return mask


@pytest.mark.parametrize("fixed", [False, True])
def test_lbfgs_recursion_equals_jax_on_one_calculator(calculators, fixed):
    port, _ = calculators
    mols = structures()
    mask = fixed_mask(mols, fixed)
    kw = dict(fmax=1e-6, maxstep_total=12, memory=5,
              fixed_atoms_mask=np.nonzero(mask)[0] if fixed else None)
    got, ginfo = tbw.batchwise_lbfgs(port, mols, **kw)
    want, winfo = jbw.batchwise_lbfgs(port, mols, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[P.R], w[P.R])
    for k in ("converged", "iterations", "energies", "fmax"):
        np.testing.assert_array_equal(ginfo[k], winfo[k], err_msg=k)


@pytest.mark.parametrize("fixed", [False, True])
def test_lbfgs_positions_match_jax_over_five_iterations(calculators, fixed):
    port, jax_ = calculators
    mols = structures()
    mask = fixed_mask(mols, fixed)
    kw = dict(fmax=1e-6, memory=5, alpha=ALPHA,
              fixed_atoms_mask=np.nonzero(mask)[0] if fixed else None)
    x0 = np.concatenate([m[P.R] for m in mols])
    for it in range(1, 6):
        got, ginfo = tbw.batchwise_lbfgs(port, mols, maxstep_total=it, **kw)
        want, winfo = jbw.batchwise_lbfgs(jax_, mols, maxstep_total=it, **kw)
        xg = np.concatenate([s[P.R] for s in got])
        xw = np.concatenate([s[P.R] for s in want])
        np.testing.assert_allclose(xg, xw, rtol=0, atol=POS_ATOL,
                                   err_msg=f"iteration {it}")
        np.testing.assert_array_equal(ginfo["converged"], winfo["converged"])
    assert not np.allclose(xg, x0)
    if fixed:
        np.testing.assert_array_equal(xg[mask], x0[mask])
        assert (np.abs(xg - x0).max(axis=1)[~mask] > 0).all()


def test_lbfgs_convergence_flags_match_jax(calculators):
    port, jax_ = calculators
    mols = structures()
    got, ginfo = tbw.batchwise_lbfgs(port, mols, fmax=0.5, maxstep_total=60)
    want, winfo = jbw.batchwise_lbfgs(jax_, mols, fmax=0.5,
                                      maxstep_total=60)
    assert ginfo["converged"].all() and winfo["converged"].all()
    np.testing.assert_array_equal(ginfo["converged"], winfo["converged"])
    np.testing.assert_array_equal(ginfo["iterations"], winfo["iterations"])
    assert (ginfo["fmax"] < 0.5).all()
    np.testing.assert_allclose(ginfo["energies"], winfo["energies"],
                               rtol=E_RTOL)


class _QuadraticCalculator:
    """E_m = 0.5 k_m |R - R0_m|^2: each molecule its own Hessian."""

    def __init__(self, ks, centers):
        self.ks = ks
        self.centers = centers

    def calculate(self, structures):
        es, fs = [], []
        for s, k, c in zip(structures, self.ks, self.centers):
            d = np.asarray(s[P.R], np.float64) - c
            es.append(0.5 * k * float((d ** 2).sum()))
            fs.append(-k * d)
        return np.array(es), fs


def test_lbfgs_keeps_per_structure_curvature():
    rng = np.random.RandomState(3)
    R0a, R0b = rng.randn(4, 3), rng.randn(6, 3)
    A = {P.Z: np.array([6] * 4), P.R: R0a + rng.randn(4, 3) * 0.4,
         P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}
    B = {P.Z: np.array([8] * 6), P.R: R0b + rng.randn(6, 3) * 0.4,
         P.cell: np.zeros((3, 3)), P.pbc: np.zeros(3, bool)}
    kw = dict(fmax=1e-6, maxstep_total=60, memory=10)
    both, info_both = tbw.batchwise_lbfgs(
        _QuadraticCalculator([1.0, 50.0], [R0a, R0b]), [A, B], **kw)
    alone, info_a = tbw.batchwise_lbfgs(
        _QuadraticCalculator([1.0], [R0a]), [A], **kw)
    np.testing.assert_allclose(both[0][P.R], alone[0][P.R], atol=1e-10)
    assert info_both["iterations"][0] == info_a["iterations"][0]
    np.testing.assert_allclose(both[0][P.R], R0a, atol=1e-5)
    np.testing.assert_allclose(both[1][P.R], R0b, atol=1e-5)
    assert tbw.ASEBatchwiseLBFGS is tbw.batchwise_lbfgs


def test_lbfgs_writes_a_trajectory_per_structure(calculators, tmp_path):
    port, _ = calculators
    from schnetpack_tpu.datasets.xyz import read_extxyz_file

    traj = str(tmp_path / "relax.extxyz")
    log = str(tmp_path / "relax.log")
    _, info = tbw.batchwise_lbfgs(port, [water(), molecule(3)],
                                  maxstep_total=3, trajectory=traj,
                                  logfile=log)
    for m, n in ((0, 3), (1, 7)):
        frames = read_extxyz_file(str(tmp_path / f"relax_m{m}.extxyz"))
        assert len(frames) == 4 and len(frames[0]["numbers"]) == n
    assert len(open(log).read().splitlines()) == 5
